"""Model configurations: the port's own copies of the JAX package's
``src/repro/configs/`` dataclasses and registry."""
