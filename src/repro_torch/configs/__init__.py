from .base import ArchConfig, InputShape, SHAPES, smoke_shape
from .registry import ARCHS, get_arch

__all__ = ["ArchConfig", "InputShape", "SHAPES", "smoke_shape", "ARCHS", "get_arch"]
