"""Plain float32 PyTorch references of the benchmark's configurations."""
