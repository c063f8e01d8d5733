"""Hand-written Hopper kernels, their plain PyTorch versions, and the
device dispatch (``ops``).  Sources live in ``csrc/`` and are built at
first use by ``_build``."""
