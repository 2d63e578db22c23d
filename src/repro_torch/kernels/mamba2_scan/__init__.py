from repro_torch.kernels.mamba2_scan.ops import mamba2_decode_step, mamba2_scan  # noqa: F401
