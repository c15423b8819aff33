"""Test config: force an 8-device virtual CPU platform BEFORE any jax use.

Multi-chip sharding tests run on a simulated 8-device mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), per SURVEY.md §4.
The platform is JAX_PLATFORMS when set (the card-only tests, marked
`gpu`, run with JAX_PLATFORMS=cuda), else the CPU.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# Persistent XLA compilation cache: the suite is compile-bound (hundreds
# of small jit episodes), and identical HLO recurs both across test files
# within one run and across runs — warm runs skip most of that work.
# Location: JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache
# (utils/compile_cache).  Keyed by backend+flags; safe to delete any time.
from montecarlolocalisation.utils.compile_cache import (  # noqa: E402
    configure_compile_cache,
)

configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def default_map():
    import os.path as osp

    from montecarlolocalisation.maps import from_map_file

    path = osp.join(
        osp.dirname(__file__), "..", "montecarlolocalisation", "maps",
        "default_map.txt",
    )
    return from_map_file(path)
