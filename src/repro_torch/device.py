"""Where the port runs: the card, unless the caller names another device.

Every entry point takes ``device=None`` and means ``cuda:0`` by it.  Only
an explicit ``device="cpu"`` (what the CPU tests pass) runs on the CPU;
nothing falls back from the card to the CPU.  A sharded entry point given
a mesh runs on this rank's device instead: the card the launcher made
current (``LOCAL_RANK``, torchrun's convention, which ``DeviceMesh``
follows) on a CUDA mesh, the CPU on a CPU mesh.
"""
from __future__ import annotations

import torch

__all__ = ["default_device", "resolve", "require_fp32_matmul"]


def default_device() -> torch.device:
    """``cuda:0``; raises ``RuntimeError`` when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def resolve(device=None, mesh=None) -> torch.device:
    """``None`` -> the card (this rank's, given a CUDA ``mesh``; the CPU
    on a CPU mesh); anything else is taken as the caller's explicit
    choice."""
    if device is not None:
        return torch.device(device)
    if mesh is None:
        return default_device()
    if mesh.device_type != "cuda":
        return torch.device(mesh.device_type)
    default_device()                     # raises without a card
    return torch.device("cuda", torch.cuda.current_device())


def require_fp32_matmul() -> None:
    """Pin full-fp32 matrix products on the card.

    TF32 keeps about three decimal digits, which flips near-tied
    neighbours and breaks id parity with the reference, so the port never
    allows it (PyTorch's default is the same; this states and checks it).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul could not be disabled")
