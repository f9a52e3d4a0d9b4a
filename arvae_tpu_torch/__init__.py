"""PyTorch + CUDA port of the image AR-VAE training path.

Mirrors the layout of ``arvae_tpu`` (``core``, ``data``, ``ops``,
``models``, ``training``, ``utils``) so each module has an obvious
counterpart. The package imports ``torch`` and numpy only: it never
imports ``jax`` or ``arvae_tpu``, so it runs on a machine that has
neither. The AR regulariser runs as a hand-written CUDA kernel pair
(``csrc/reg_loss.cu``) on CUDA tensors and as plain PyTorch on CPU
tensors; see ``ops/reg_kernel.py``.
"""
