"""Minimal Standard MIDI File writer and reader (pure Python and numpy).

A copy of ``arvae_tpu/utils/midi.py`` (importing any module of the JAX
package imports jax), so both packages write the same bytes for the same
notes: single-track type-0 files of monophonic note-on/note-off events at 480
ticks a quarter, each onset and release rounded as ``round(t * 480)``
and a note-off sorted before a note-on at the same tick; plus a reader
that skips the one-byte channel messages and SysEx payloads, and a
piano-roll rasteriser on the dataset's 6-ticks-a-quarter grid.
"""

from __future__ import annotations

import os
import struct
from typing import List, Sequence, Tuple

import numpy as np

TICKS_PER_QUARTER = 480

# (midi_pitch, start_quarters, duration_quarters); pitch -1 = rest (skipped)
NoteEvent = Tuple[int, float, float]


def _var_len(value: int) -> bytes:
    """MIDI variable-length quantity encoding."""
    buf = value & 0x7F
    out = bytearray()
    while value >> 7:
        value >>= 7
        buf <<= 8
        buf |= (value & 0x7F) | 0x80
    while True:
        out.append(buf & 0xFF)
        if buf & 0x80:
            buf >>= 8
        else:
            break
    return bytes(out)


def write_midi(
    notes: Sequence[NoteEvent],
    path: str,
    tempo_bpm: float = 120.0,
    velocity: int = 90,
) -> None:
    """Writes note events (quarter-note units) as a type-0 SMF."""
    events = []  # (tick, priority, message-bytes)
    for pitch, start, dur in notes:
        if pitch < 0 or dur <= 0:
            continue
        on = int(round(start * TICKS_PER_QUARTER))
        off = int(round((start + dur) * TICKS_PER_QUARTER))
        events.append((on, 1, bytes([0x90, pitch & 0x7F, velocity])))
        events.append((off, 0, bytes([0x80, pitch & 0x7F, 0])))
    events.sort(key=lambda e: (e[0], e[1]))

    track = bytearray()
    # tempo meta event
    usec_per_quarter = int(60_000_000 / tempo_bpm)
    track += _var_len(0) + bytes([0xFF, 0x51, 0x03])
    track += struct.pack(">I", usec_per_quarter)[1:]
    prev = 0
    for tick, _, msg in events:
        track += _var_len(tick - prev) + msg
        prev = tick
    track += _var_len(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, TICKS_PER_QUARTER))
        f.write(b"MTrk" + struct.pack(">I", len(track)) + bytes(track))


def read_midi(path: str) -> List[NoteEvent]:
    """Reads back note events from a (simple, single-track) SMF."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"MThd"
    _, fmt, ntrk, division = struct.unpack(">IHHH", data[4:14])
    pos = 14
    notes = []
    for _ in range(ntrk):
        assert data[pos : pos + 4] == b"MTrk"
        (length,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        track = data[pos + 8 : pos + 8 + length]
        pos += 8 + length
        t = 0
        i = 0
        running = None
        active = {}
        while i < len(track):
            delta = 0
            while True:
                b = track[i]
                i += 1
                delta = (delta << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            t += delta
            status = track[i]
            if status & 0x80:
                i += 1
                running = status
            else:
                status = running
            if status == 0xFF:  # meta
                i += 1  # type
                mlen = 0
                while True:
                    b = track[i]
                    i += 1
                    mlen = (mlen << 7) | (b & 0x7F)
                    if not b & 0x80:
                        break
                i += mlen
            elif status & 0xF0 in (0x90, 0x80):
                pitch, vel = track[i], track[i + 1]
                i += 2
                is_on = (status & 0xF0) == 0x90 and vel > 0
                if is_on:
                    active[pitch] = t
                elif pitch in active:
                    start = active.pop(pitch)
                    notes.append(
                        (pitch, start / division, (t - start) / division)
                    )
            elif status in (0xF0, 0xF7):
                # SysEx: variable-length payload length, then payload —
                # treating it as a 2-data-byte channel message would
                # desync the parser on any externally produced file
                slen = 0
                while True:
                    b = track[i]
                    i += 1
                    slen = (slen << 7) | (b & 0x7F)
                    if not b & 0x80:
                        break
                i += slen
            else:
                # other channel messages: Program Change (0xC0) and
                # Channel Pressure (0xD0) carry ONE data byte; the rest
                # (0xA0 poly pressure, 0xB0 control, 0xE0 pitch bend)
                # carry two.
                i += 1 if status & 0xF0 in (0xC0, 0xD0) else 2
    notes.sort(key=lambda n: n[1])
    return notes


def notes_to_pianoroll(
    notes: Sequence[NoteEvent], ticks_per_quarter: int = 6
) -> np.ndarray:
    """Note events → (T, 128) binary pianoroll at the dataset tick grid."""
    if not notes:
        return np.zeros((1, 128), dtype=np.float32)
    end = max(s + d for _, s, d in notes)
    T = int(np.ceil(end * ticks_per_quarter))
    roll = np.zeros((max(T, 1), 128), dtype=np.float32)
    for pitch, start, dur in notes:
        if pitch < 0:
            continue
        a = int(round(start * ticks_per_quarter))
        b = int(round((start + dur) * ticks_per_quarter))
        roll[a : max(b, a + 1), pitch] = 1.0
    return roll
