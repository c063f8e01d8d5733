"""PyTorch + CUDA port of the two-level ANN search, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module and imports neither ``jax`` nor ``repro``.  Its
entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``; see :mod:`repro_torch.device`.

Nothing is imported here: each subpackage is imported on its own, so a
module that is not ported yet can never break the import of one that is.
"""
