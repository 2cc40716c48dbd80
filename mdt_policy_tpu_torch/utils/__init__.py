"""Utilities of the port."""

from .fnv import fnv1_32, fnv1_64, fnv1a_32, fnv1a_64

__all__ = ["fnv1_32", "fnv1_64", "fnv1a_32", "fnv1a_64"]
