"""The port's figure drivers (``python -m repro_torch.bench.fig10``)."""
