"""Flax → PyTorch parameter conversion for ``MnistVAE``, ``DspritesVAE``,
the fader networks and their discriminator, ``MeasureVAE`` and the MNIST
ResNet judge.

The exact inverses of ``convert_mnist_vae``, ``convert_dsprites_vae``
and ``convert_measure_vae`` in ``arvae_tpu/utils/torch_convert.py``, so a
test can load the same weights into both packages; the judge
(``arvae_tpu/training/resnet_judge.py``) maps onto torchvision's
ResNet-18 names, its BatchNorm statistics included; the fader networks
are the VAEs without ``enc_log_std`` (that module has no fader
converter: the tests carry the other direction). That module maps the
hierarchical decoder only; for the SR decoders the port's parameters
carry the Flax tree's names (``decoder.z2in1.weight`` is ``z2in1_w``
transposed, ``decoder.gru.*`` is ``gru``), so their conversion here is
the same per-kind mapping. Per layer kind:

- conv kernels: flax HWIO → torch OIHW;
- transposed-conv kernels: flax HWIO → torch IOHW, spatially rotated
  180° (flax's ``ConvTranspose`` correlates with the kernel, torch's is
  the adjoint of a conv). The Flax ``MnistVAE`` decoder's pad(3) + Conv
  is the stride-1 transposed conv with that same kernel, so it maps the
  same way;
- linear weights: (in, out) → (out, in);
- GRU weights: ``w_ih`` (I, 3H) → ``weight_ih_l{k}[_reverse]`` (3H, I),
  the same (r, z, n) gate order;
- the dense layers next to the conv stack also undo the flatten order:
  flax flattens a conv map as (H, W, C), torch as (C, H, W).

Input is the nested ``{name: {"kernel", "bias"}}`` parameter mapping of
arrays (anything ``np.asarray`` accepts); output is a ``state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch


def _chw_to_hwc_perm(c: int, h: int, w: int) -> np.ndarray:
    """Index permutation taking a (C,H,W)-flattened vector to the (H,W,C)
    flattening."""
    idx = np.arange(c * h * w).reshape(c, h, w)
    return np.transpose(idx, (1, 2, 0)).reshape(-1)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, order="C"))


def _linear(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": _t(np.asarray(p["kernel"]).T),
        f"{prefix}.bias": _t(np.asarray(p["bias"])),
    }


def _linear_flatten_in(p, prefix, c, h, w):
    """Linear consuming a flattened conv map: input rows HWC → CHW."""
    inv = np.argsort(_chw_to_hwc_perm(c, h, w))
    k = np.asarray(p["kernel"])[inv, :]
    return {f"{prefix}.weight": _t(k.T), f"{prefix}.bias": _t(np.asarray(p["bias"]))}


def _linear_flatten_out(p, prefix, c, h, w):
    """Linear producing a flattened conv map: output columns HWC → CHW."""
    inv = np.argsort(_chw_to_hwc_perm(c, h, w))
    k = np.asarray(p["kernel"])[:, inv]
    return {
        f"{prefix}.weight": _t(k.T),
        f"{prefix}.bias": _t(np.asarray(p["bias"])[inv]),
    }


def _conv(p, prefix):
    # flax (H, W, I, O) -> torch Conv2d (O, I, H, W)
    return {
        f"{prefix}.weight": _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))),
        f"{prefix}.bias": _t(np.asarray(p["bias"])),
    }


def _convtranspose(p, prefix):
    # flax (H, W, I, O) -> torch ConvTranspose2d (I, O, H, W), rotated 180°
    w = np.transpose(np.asarray(p["kernel"]), (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return {f"{prefix}.weight": _t(w), f"{prefix}.bias": _t(np.asarray(p["bias"]))}


def dsprites_vae_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``DspritesVAE`` params → ``state_dict`` of the port's model."""
    sd: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate((0, 2, 4, 6)):
        sd.update(_conv(params[f"enc_convs_{i}"], f"enc_conv.{idx}"))
        sd.update(_convtranspose(params[f"dec_convs_{i}"], f"dec_conv.{idx}"))
    sd.update(_linear_flatten_in(params["enc_denses_0"], "enc_lin.0", 32, 4, 4))
    sd.update(_linear(params["enc_denses_1"], "enc_lin.2"))
    sd.update(_heads(params))
    sd.update(_linear(params["dec_denses_0"], "dec_lin.0"))
    sd.update(_linear(params["dec_denses_1"], "dec_lin.2"))
    sd.update(_linear_flatten_out(params["dec_denses_2"], "dec_lin.4", 32, 4, 4))
    return sd


def _heads(params) -> Dict[str, torch.Tensor]:
    """The mean head, and the log-std head where there is one (the fader
    networks have none)."""
    sd = _linear(params["enc_mean"], "enc_mean")
    if "enc_log_std" in params:
        sd.update(_linear(params["enc_log_std"], "enc_log_std"))
    return sd


def mnist_vae_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``MnistVAE`` params → ``state_dict`` of the port's model."""
    sd: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate((0, 3, 6)):
        sd.update(_conv(params[f"enc_convs_{i}"], f"enc_conv.{idx}"))
        sd.update(_convtranspose(params[f"dec_convs_{i}"], f"dec_conv.{idx}"))
    sd.update(_linear_flatten_in(params["enc_dense"], "enc_lin.0", 8, 19, 19))
    sd.update(_heads(params))
    sd.update(_linear(params["dec_denses_0"], "dec_lin.0"))
    sd.update(_linear_flatten_out(params["dec_denses_1"], "dec_lin.2", 8, 19, 19))
    return sd


def fader_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``MnistFaderNetwork`` or ``DspritesFaderNetwork`` params (told
    apart by MNIST's one ``enc_dense``) → ``state_dict`` of the port's."""
    return (mnist_vae_from_flax if "enc_dense" in params else dsprites_vae_from_flax)(params)


def fader_discriminator_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``ImageFaderDiscriminator`` params (``Dense_{0,1,2}``) →
    ``state_dict`` of the port's (``layers.{0,3,6}``)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate((0, 3, 6)):
        sd.update(_linear(params[f"Dense_{i}"], f"layers.{idx}"))
    return sd


def _batch_norm(p, stats, prefix):
    return {
        f"{prefix}.weight": _t(np.asarray(p["scale"])),
        f"{prefix}.bias": _t(np.asarray(p["bias"])),
        f"{prefix}.running_mean": _t(np.asarray(stats["mean"])),
        f"{prefix}.running_var": _t(np.asarray(stats["var"])),
        f"{prefix}.num_batches_tracked": torch.tensor(0),
    }


def _conv_no_bias(p, prefix):
    return {f"{prefix}.weight": _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))}


def resnet_judge_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``MnistResNet`` variables (``params`` and ``batch_stats``) →
    ``state_dict`` of the port's judge: ``Conv_0``/``BatchNorm_0`` →
    ``conv1``/``bn1``, ``BasicBlock_i`` → ``layer{i // 2 + 1}.{i % 2}``
    (its third conv and norm, the residual projection, →
    ``downsample.0``/``.1``), ``Dense_0`` → ``fc``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = _conv_no_bias(params["Conv_0"], "conv1")
    sd.update(_batch_norm(params["BatchNorm_0"], stats["BatchNorm_0"], "bn1"))
    for i in range(8):
        p, st = params[f"BasicBlock_{i}"], stats[f"BasicBlock_{i}"]
        prefix = f"layer{i // 2 + 1}.{i % 2}"
        names = (("conv1", "bn1"), ("conv2", "bn2"), ("downsample.0", "downsample.1"))
        for j, (conv, bn) in enumerate(names):
            if f"Conv_{j}" in p:
                sd.update(_conv_no_bias(p[f"Conv_{j}"], f"{prefix}.{conv}"))
                sd.update(_batch_norm(p[f"BatchNorm_{j}"], st[f"BatchNorm_{j}"],
                                      f"{prefix}.{bn}"))
    sd.update(_linear(params["Dense_0"], "fc"))
    return sd


def _gru(layers: Sequence[Any], prefix: str, bidirectional: bool) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for layer, lp in enumerate(layers):
        for d, p in enumerate(lp if bidirectional else [lp]):
            sfx = f"_l{layer}" + ("_reverse" if d == 1 else "")
            sd[f"{prefix}.weight_ih{sfx}"] = _t(np.asarray(p["w_ih"]).T)
            sd[f"{prefix}.weight_hh{sfx}"] = _t(np.asarray(p["w_hh"]).T)
            sd[f"{prefix}.bias_ih{sfx}"] = _t(np.asarray(p["b_ih"]))
            sd[f"{prefix}.bias_hh{sfx}"] = _t(np.asarray(p["b_hh"]))
    return sd


def _dense(p: Mapping[str, Any], name: str, prefix: str) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": _t(np.asarray(p[f"{name}_w"]).T),
        f"{prefix}.bias": _t(np.asarray(p[f"{name}_b"])),
    }


def _decoder_from_flax(dec: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Any of the three decoders, told apart by their parameter trees:
    ``tick_gru`` (hierarchical), ``z2in1_w`` (SR), ``z2in_w`` (SR without
    input)."""
    if "tick_gru" in dec:
        sd = {"decoder.note_embedding_layer.weight": _t(np.asarray(dec["embedding"])),
              "decoder.b_0": _t(np.asarray(dec["b_0"])),
              "decoder.x_0": _t(np.asarray(dec["x_0"]))}
        sd.update(_dense(dec, "z2beat", "decoder.z_to_beat_rnn_input.0"))
        sd.update(_gru(dec["beat_gru"], "decoder.rnn_beat", bidirectional=False))
        sd.update(_dense(dec, "beat2tickh", "decoder.beat_emb_to_tick_rnn_hidden.0"))
        sd.update(_dense(dec, "beat2ticki", "decoder.beat_emb_to_tick_rnn_input.0"))
        sd.update(_gru(dec["tick_gru"], "decoder.rnn_tick", bidirectional=False))
        sd.update(_dense(dec, "out", "decoder.tick_emb_to_note_emb.0"))
        return sd
    sd = _gru(dec["gru"], "decoder.gru", bidirectional=False)
    sd.update(_dense(dec, "out", "decoder.out"))
    if "z2in1_w" in dec:
        sd["decoder.embedding.weight"] = _t(np.asarray(dec["embedding"]))
        sd["decoder.x_0"] = _t(np.asarray(dec["x_0"]))
        sd.update(_dense(dec, "z2in1", "decoder.z2in1"))
        sd.update(_dense(dec, "z2in2", "decoder.z2in2"))
    else:
        sd.update(_dense(dec, "z2in", "decoder.z2in"))
    return sd


def measure_vae_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``MeasureVAE`` params (any decoder type, any number of
    layers) → ``state_dict`` of the port's model: the encoder and the
    hierarchical decoder under the reference PyTorch module's names, the
    SR decoders under the Flax tree's."""
    enc = params["encoder"]
    sd: Dict[str, torch.Tensor] = {
        "encoder.note_embedding_layer.weight": _t(np.asarray(enc["embedding"])),
    }
    sd.update(_gru(enc["gru"], "encoder.lstm", bidirectional=True))
    sd.update(_dense(enc, "mean1", "encoder.linear_mean.0"))
    sd.update(_dense(enc, "mean2", "encoder.linear_mean.2"))
    sd.update(_dense(enc, "std1", "encoder.linear_log_std.0"))
    sd.update(_dense(enc, "std2", "encoder.linear_log_std.2"))
    sd.update(_decoder_from_flax(params["decoder"]))
    return sd
