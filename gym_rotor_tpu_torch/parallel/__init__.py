"""Training supersteps and the process group of the PyTorch/CUDA port."""
