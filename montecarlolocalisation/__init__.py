"""JAX Monte Carlo localization / robotics simulation framework.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the reference
ROS/C++ stack Bright8787/MonteCarloLocalisation (pink_fundamentals): particle
filter localization, closed-loop motion control, reactive exploration, maze
mapping, planning, and mission execution -- as pure-functional, jit-compiled
programs that scale over particles (shard_map), episodes (vmap), and chips
(jax.sharding.Mesh).
"""
from . import config
from .config import FilterConfig, DEFAULT_CONFIG

__version__ = "0.1.0"
__all__ = ["config", "FilterConfig", "DEFAULT_CONFIG"]
