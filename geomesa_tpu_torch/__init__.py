"""geomesa_tpu_torch: the PyTorch + CUDA port of geomesa_tpu for NVIDIA
Hopper GPUs.

The port stands beside the JAX package and imports nothing of it (nor of
JAX): modules it needs from there are copied, trimmed, and name their
counterpart in their docstrings. The Pallas kernels on the ported path
are hand-written CUDA kernels under ``csrc/``, each with a plain PyTorch
version beside its wrapper. Entry points run on the card (``cuda:0``)
unless the caller passes ``device="cpu"``.
"""

#: the package version, the reference's (``geomesa_tpu/__init__.py:33``)
__version__ = "0.1.0"
