"""The port's MeasureVAE trainer on a random token corpus.

``TokenCorpus`` and ``bench_vocab`` are copies of the port's
``utils/step_probe.py`` helpers: what the music trainer reads of a
dataset, and the vocabulary of ``scripts/bench_measure_vae.py``
(specials, then chromatic pitch names from MIDI 36 up).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from arvae_tpu_torch.data.attributes import MusicAttributes
from arvae_tpu_torch.data.device_data import DeviceSplit
from arvae_tpu_torch.models.measure_vae import MeasureVAE
from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer


def bench_vocab(n: int) -> Dict[int, str]:
    names = ["__", "START", "END", "rest"]
    spell = ["C", "C#", "D", "E-", "E", "F", "F#", "G", "A-", "A", "B-", "B"]
    midi = 36
    while len(names) < n:
        names.append(f"{spell[midi % 12]}{midi // 12 - 1}")
        midi += 1
    return {i: s for i, s in enumerate(names)}


class TokenCorpus:
    """Measures of tokens, with what the music trainer reads of a dataset."""

    class_name = "4by4_FolkNBarDataset_1_"
    beat_subdivisions, time_sig_num, time_sig_den = 6, 4, 4

    def __init__(self, rows, index2note):
        self.rows = rows
        self.index2note_dicts = index2note
        self.note2index_dicts = {v: k for k, v in index2note.items()}

    def get_dataset(self):
        return self.rows, self.rows

    def attrs(self, device):
        return MusicAttributes(self.index2note_dicts, device)


def record_outputs(trainer) -> Tuple[Dict[str, List[torch.Tensor]], object]:
    """({"fed": ..., "logits": ...}, the hook's handle): lists that receive,
    for each training forward of the model, the tokens its decoder fed
    back (``samples``) and its ReLU head (``weights``): the program's
    outputs that the reference judges."""
    out: Dict[str, List[torch.Tensor]] = {"fed": [], "logits": []}

    def hook(module, args, result):
        if module.training:
            out["fed"].append(result.samples.detach().clone())
            out["logits"].append(result.weights.detach().clone())

    return out, trainer.model.register_forward_hook(hook)


def alter_row(cfg: dict, x: torch.Tensor) -> None:
    """Moves each token of ``x``'s first row to the next id (a fault of
    ``faults.py``)."""
    x[0] = (x[0] + 1) % cfg["model"]["num_notes"]


def build(cfg: dict, traffic: dict, seed: int, device, inputs: Dict[str, torch.Tensor]):
    """(trainer, training split): ``MeasureVAETrainer`` with the
    configuration's model and objective, ``rand`` = ``seed``."""
    m, o = cfg["model"], cfg["objective"]
    rows = inputs["tokens"].cpu().numpy()
    corpus = TokenCorpus(rows, bench_vocab(m["num_notes"]))
    model = MeasureVAE(m["num_notes"], note_embedding_dim=m["note_embedding_dim"],
                       num_encoder_layers=m["num_encoder_layers"],
                       encoder_hidden_size=m["encoder_hidden_size"],
                       encoder_dropout_prob=m["encoder_dropout_prob"],
                       latent_space_dim=m["latent_space_dim"],
                       num_decoder_layers=m["num_decoder_layers"],
                       decoder_hidden_size=m["decoder_hidden_size"],
                       decoder_dropout_prob=m["decoder_dropout_prob"],
                       decoder_type=m["decoder_type"], sampling=m["sampling"])
    trainer = MeasureVAETrainer(corpus, model, device, lr=o["lr"], reg_type=tuple(o["reg_type"]),
                                reg_dim=tuple(o["reg_dim"]), beta=o["beta"], gamma=o["gamma"],
                                capacity=o["capacity"], rand=seed, delta=o["delta"])
    split = DeviceSplit(rows, None, (traffic["seq_len"],), "tokens", trainer.device, trainer.ctx)
    return trainer, split
