"""Lookup and ray-cast ops, and the fused beam-weight kernel."""
from . import lookup

__all__ = ["lookup"]
