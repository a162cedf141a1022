"""Reactive records: network bends and model rewrites."""

from .bend import Bend
from .rewrite import Rewrite, apply_rewrites

__all__ = ["Bend", "Rewrite", "apply_rewrites"]
