"""Model FLOPs of a dSprites fader training step, counted from the shapes
as ``dsprites_vae.py`` counts the VAE's (``2·m·k·n`` a product; a
backward twice its forward: the input and the weight gradients):

- the discriminator's update: the encoder's forward (no gradient), the
  discriminator's forward and backward, less its first layer's input
  gradient (its input, the code, is detached);
- the fader's update: the encoder's and the decoder's forward and
  backward, less the first convolution's input gradient (its input is
  the data), and the discriminator's forward and its input gradients
  (the gradient reaches the code through it, and none of its weights).
"""

from port_bench.work.dsprites_vae import layer_flops


def encoder_decoder_flops(cfg: dict):
    """([FLOPs a row] of each encoder layer's forward, the same of the
    decoder's): the VAE's layers with the mean head alone and the
    decoder's first layer taking z plus the attributes."""
    m = cfg["model"]
    Z, A, h2 = m["latent_space_dim"], m["num_attributes"], m["dense"][1]
    layers = layer_flops(cfg)  # 4 convolutions, 6 dense, 4 transposed convolutions
    encoder = layers[:6] + [2 * h2 * Z]
    decoder = [2 * (Z + A) * h2] + layers[8:]
    return encoder, decoder


def disc_flops(cfg: dict):
    """[FLOPs a row] of each discriminator layer's forward."""
    m = cfg["model"]
    widths = [m["latent_space_dim"], *m["disc_hidden"], m["num_attributes"]]
    return [2 * a * b for a, b in zip(widths, widths[1:])]


def step_flops(cfg: dict, traffic: dict) -> int:
    encoder, decoder = encoder_decoder_flops(cfg)
    disc = disc_flops(cfg)
    disc_update = sum(encoder) + 3 * sum(disc) - disc[0]
    fader_update = 3 * (sum(encoder) + sum(decoder)) - encoder[0] + 2 * sum(disc)
    return traffic["batch"] * (disc_update + fader_update)
