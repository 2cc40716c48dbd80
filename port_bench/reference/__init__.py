"""Plain PyTorch references of the configurations (float32, no kernels)."""
