"""Install arvae_tpu as a package (parity with the reference's
setup.py, which makes `arvae` pip-installable). The CLIs stay at the
repo root like the reference's; the library installs as `arvae_tpu`.
"""

from setuptools import find_packages, setup

setup(
    name="arvae_tpu",
    version="1.0",
    description=(
        "TPU-native attribute-based regularization for VAE latent spaces"
    ),
    packages=find_packages(include=["arvae_tpu", "arvae_tpu.*",
                                    "arvae_tpu_torch", "arvae_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "pandas",
        "matplotlib",
        "seaborn",
        "Pillow",
        "scikit-learn",
        "scipy",
        "click",
        "tensorboardX",
    ],
)
