from repro_torch.kernels.stackdist.ops import stack_scan  # noqa: F401
