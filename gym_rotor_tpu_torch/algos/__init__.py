"""Learners of the PyTorch/CUDA port."""
