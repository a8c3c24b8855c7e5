"""Package-wide numerics policy and device selection.

Counterpart of foundationpose_tpu/jax_config.py:13, which pins f32
matmuls. Geometry must be exact f32; network code opts in to bf16 by
casting. On the card a float32 matmul already runs in full f32 by
default, but cuDNN runs float32 convolutions in TF32 (about three
decimal digits) unless told otherwise, so both switches are set here.
Imported by every module of the package that computes on tensors.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve `device`; raise when CUDA is asked for and no card exists.

    There is no silent move to the CPU: a caller that wants the CPU
    plain path asks for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    return dev


def indexed_device(device: str | torch.device = "cuda") -> torch.device:
    """default_device(device), a card with its index ("cuda" is the current
    card), so that a module already on that card is not copied."""
    dev = default_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
