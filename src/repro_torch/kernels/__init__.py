"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; see :mod:`repro_torch.kernels.common` for the modes."""
