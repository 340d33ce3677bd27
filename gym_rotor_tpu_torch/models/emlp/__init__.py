"""emlp of the PyTorch/CUDA port."""
