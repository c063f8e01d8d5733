"""Architecture configs and the ``--arch`` / ``--shape`` registry."""
from repro_torch.configs.registry import ARCHS, SHAPES, get_arch, get_shapes

__all__ = ["ARCHS", "SHAPES", "get_arch", "get_shapes"]
