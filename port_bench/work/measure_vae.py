"""Model FLOPs of a MeasureVAE training step: every matrix product of
the forward (the GRUs' input and hidden products, the heads and dense
layers, the tick loop's products), counted from the shapes, times three
for forward and backward (every product's input traces back to a
learned leaf, so the backward needs both its products). Embedding
lookups and elementwise work count nothing."""

BEATS = 4


def mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def forward_flops(cfg: dict, traffic: dict) -> int:
    m = cfg["model"]
    B, T = traffic["batch"], traffic["seq_len"]
    V, E, Z = m["num_notes"], m["note_embedding_dim"], m["latent_space_dim"]
    He, Le = m["encoder_hidden_size"], m["num_encoder_layers"]
    Hd, Ld = m["decoder_hidden_size"], m["num_decoder_layers"]
    f = 0
    for k in range(Le):
        f += 2 * (mm(B * T, E if k == 0 else 2 * He, 3 * He) + T * mm(B, He, 3 * He))
    f += 2 * (mm(B, 2 * He * Le, 2 * He) + mm(B, 2 * He, Z))
    f += mm(B, Z, Hd * Ld)
    for k in range(Ld):
        f += mm(B * BEATS, 1 if k == 0 else Hd, 3 * Hd) + BEATS * mm(B, Hd, 3 * Hd)
    f += mm(B * BEATS, Hd, Hd * Ld) + mm(B * BEATS, Hd, Hd) + mm(B * BEATS, Hd, 3 * Hd)
    f += T * B * (mm(1, E, 3 * Hd) + (2 * Ld - 1) * mm(1, Hd, 3 * Hd) + mm(1, Hd, V))
    return f


def step_flops(cfg: dict, traffic: dict) -> int:
    return 3 * forward_flops(cfg, traffic)
