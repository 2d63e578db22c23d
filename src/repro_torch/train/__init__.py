"""Step functions over the model zoo (the prefill step; training comes later)."""
