"""Rendering of the PyTorch/CUDA port (matplotlib, imported on use)."""
from .renderer import Renderer

__all__ = ["Renderer"]
