"""The port's simulator core: traces, keys, LRU sweeps and the CPI model."""
