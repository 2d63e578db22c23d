"""Step functions over the model zoo: the optimizer, the training step and
the prefill step."""
