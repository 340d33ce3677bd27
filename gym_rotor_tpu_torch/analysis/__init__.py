"""Offline analysis of the driver's logs (port of ``gym_rotor_tpu/analysis``;
NumPy only, matplotlib imported inside the plotting functions)."""
from . import draw_plot, learning_curves

__all__ = ["draw_plot", "learning_curves"]
