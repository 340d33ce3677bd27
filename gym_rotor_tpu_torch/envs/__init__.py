"""envs of the PyTorch/CUDA port."""
