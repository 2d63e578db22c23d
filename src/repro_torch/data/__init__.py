"""Data for training: the deterministic synthetic pipeline."""
