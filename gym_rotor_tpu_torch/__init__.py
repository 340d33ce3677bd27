"""PyTorch/CUDA port of gym_rotor_tpu for NVIDIA Hopper.

The module layout mirrors ``gym_rotor_tpu`` so each function's JAX
counterpart sits at the same path.  The port imports torch, numpy and scipy
only.  Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; they raise when no card is present and the caller
did not ask for the CPU.

The hot path goes through hand-written CUDA kernels
(``kernels/csrc/*.cu``: the env tick, the acting EMLP actors, the replay
ring, the EMLP block forward and backward, the flat optimizer, the
spectral power iteration, SAC's squashed sample, PPO's GAE and clipped
surrogate); each has a plain PyTorch twin beside its wrapper, which is
what runs on CPU tensors.  ``make("Quad-v0" | "Coupled-v0" |
"Decoupled-v0")`` gives the Gym API's single envs (``envs/gym_api.py``);
``python -m gym_rotor_tpu_torch.train`` is the training driver, with the
JAX ``train.py``'s flags (``train.py``: ``Learner``, ``main``).
"""
from .registry import make, register
from .utils.config import Config

__all__ = ["Config", "make", "register"]
