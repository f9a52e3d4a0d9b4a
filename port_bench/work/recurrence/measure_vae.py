"""The recurrence's work in a MeasureVAE training step: the encoder's
biGRU chains and the beat GRU's, forward and backward, and the tick
loop forward and backward (its chains, row products and weight
gradients), each counted once whatever kernel does it."""

from port_bench.work import kernels

TICKS_PER_BEAT, BEATS = 6, 4


def calls(cfg: dict, traffic: dict):
    m = cfg["model"]
    B, T = traffic["batch"], traffic["seq_len"]
    He, Hd = m["encoder_hidden_size"], m["decoder_hidden_size"]
    out = []
    for backward in (False, True):
        out += [kernels.gru_chain(T, 2, B, He, backward)] * m["num_encoder_layers"]
        out += [kernels.gru_chain(BEATS, 1, B, Hd, backward)] * m["num_decoder_layers"]
        out.append(kernels.hier_tick_chain(T, B, Hd, m["note_embedding_dim"], m["num_notes"],
                                           TICKS_PER_BEAT, backward, m["num_decoder_layers"]))
    return out


def least_seconds(cfg: dict, traffic: dict, peaks: dict) -> float:
    return sum(w.least_seconds(peaks) for w in calls(cfg, traffic))
