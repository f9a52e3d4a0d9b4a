"""Model FLOPs of a dSprites AR-VAE training step: the convolutions
(``2·C_out·C_in·K²`` an output pixel), the transposed convolutions
(``2·C_in·C_out·K²`` an input pixel) and the dense layers, counted from
the shapes, times three for forward and backward, less the first
convolution's input gradient (its input is the data)."""


def layer_flops(cfg: dict):
    """[FLOPs a row] of each layer's forward, encoder first."""
    m = cfg["model"]
    S, C, K, Z, (h1, h2) = (m["image_size"], m["channels"], m["kernel"],
                            m["latent_space_dim"], m["dense"])
    convs = [2 * C * (1 if i == 0 else C) * K * K * (S >> (i + 1)) ** 2 for i in range(4)]
    flat = C * (S // 16) ** 2
    dense = [2 * flat * h1, 2 * h1 * h2, 2 * 2 * h2 * Z, 2 * Z * h2, 2 * h2 * h1, 2 * h1 * flat]
    deconvs = [2 * C * (1 if i == 3 else C) * K * K * (S >> (4 - i)) ** 2 for i in range(4)]
    return convs + dense + deconvs


def step_flops(cfg: dict, traffic: dict) -> int:
    layers = layer_flops(cfg)
    return traffic["batch"] * (3 * sum(layers) - layers[0])
