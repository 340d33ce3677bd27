"""Single-device training superstep of the PyTorch/CUDA port."""
