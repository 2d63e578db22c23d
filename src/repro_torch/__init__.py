"""PyTorch + CUDA port of the SPARTA reproduction, for one NVIDIA H100.

The JAX package (``src/repro``) is the reference; this package keeps its
module layout and public names, imports neither JAX nor anything of it, and
runs its entry points on the card unless the caller passes ``device="cpu"``.
"""
