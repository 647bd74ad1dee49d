"""Geometry ops on fixed-capacity masked tensors, and the hand-written CUDA
kernels' wrappers (each with its plain PyTorch version)."""

from .pointcloud import PointCloud  # noqa: F401
