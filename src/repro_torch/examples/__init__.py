"""The JAX package's ``examples/`` as modules of the port, each on the card
unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_paged [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_distributed [--device cpu]

Each prints the JAX example's lines and has a ``main(argv) -> dict`` that
returns the numbers it printed.
"""
