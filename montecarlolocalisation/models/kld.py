"""KLD-sampling statistic: how many particles does the posterior need?

Fox's KLD-sampling (NIPS 2001; the `kld_err`/`kld_z` machinery that ships
as ROS AMCL's default) sizes the particle set from the SPREAD of the
posterior: bin the cloud into a fixed (x, y, θ) histogram, count the
occupied bins k, and bound the number of samples n so that, with
probability 1 − δ, the K-L divergence between the sample distribution and
the true posterior (as seen through the histogram) stays below ε:

    n(k) = (k − 1) / (2ε) · [1 − 2/(9(k−1)) + sqrt(2/(9(k−1))) · z]³

(the Wilson–Hilferty chi-square quantile approximation; z is the standard
normal upper quantile for 1 − δ).  A converged cloud occupies a handful of
bins → tiny n; a global-localization cloud fills the free space → n grows
to the cap.

No reference counterpart — the reference's N = 1500 is a compile-time
constant (monte_carlo.cpp:84).  jit shapes are static, so this module does
NOT resize inside the step the way AMCL's sampler does: it computes the
target as a device scalar, and the serving layer (io/server.py,
`adapt_mode="kld"`) snaps the live filter onto its halving lattice of
compiled step sizes (models/resample.resize_particles) — KLD theory
deciding, elastic-budget machinery executing.

Device notes: the occupied-bin count is a sort + adjacent-diff over a
strided subsample (static size, so one jit signature per particle count).
The sort-based distinct count avoids both a scatter and a [S, B] one-hot
product (B = total bins can reach 10⁴ on large maps).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..config import KLDConfig
from ..maps.grid import MazeMap


def bin_ids(particles, m: MazeMap, cfg: KLDConfig):
    """[N, 3] poses -> [N] int32 histogram bin ids (x, y, θ packed).

    Bin geometry follows AMCL's kd-tree convention: `bin_xy` meters in x/y
    (anchored at the map origin), `bin_theta` radians in heading.  Poses
    outside the map extent clip into the border bins — they are invalid
    poses that score ~0 weight anyway, and clipping keeps the id range
    static for the packing.
    """
    nx = max(1, math.ceil((m.extent_x - m.origin_x) / cfg.bin_xy))
    ny = max(1, math.ceil((m.extent_y - m.origin_y) / cfg.bin_xy))
    nt = max(1, math.ceil(2.0 * math.pi / cfg.bin_theta))
    ix = jnp.clip(jnp.floor((particles[:, 0] - m.origin_x) / cfg.bin_xy)
                  .astype(jnp.int32), 0, nx - 1)
    iy = jnp.clip(jnp.floor((particles[:, 1] - m.origin_y) / cfg.bin_xy)
                  .astype(jnp.int32), 0, ny - 1)
    # normalize_angle keeps θ in [-π, π); shift to [0, 2π) for binning.
    it = jnp.clip(jnp.floor((particles[:, 2] + math.pi) / cfg.bin_theta)
                  .astype(jnp.int32), 0, nt - 1)
    return (it * ny + iy) * nx + ix


def occupied_bin_count(particles, m: MazeMap, cfg: KLDConfig):
    """Number of distinct occupied (x, y, θ) bins, as an int32 scalar.

    Counts over a strided subsample of at most `cfg.subsample` particles —
    after a systematic resample the array is ordered by ancestor, so a
    stride is a stratified draw from the same posterior; sorting 8k ids is
    microseconds while sorting 1M would dominate small serving steps.
    (A subsample can only UNDER-count bins, i.e. under-size n — the
    serving policy's lost-transition snap to n_max backstops that.)
    """
    n = particles.shape[0]
    s = min(n, cfg.subsample)
    stride = n // s
    ids = bin_ids(particles[: s * stride : stride], m, cfg)
    ids = jnp.sort(ids)
    return jnp.int32(1) + jnp.sum(
        (ids[1:] != ids[:-1]).astype(jnp.int32))


def kld_target(k, cfg: KLDConfig):
    """Wilson–Hilferty bound n(k) as a float32 scalar (k may be traced).

    k <= 1 (the whole cloud in one bin) needs no statistical resolution:
    returns 1.0 and lets the serving policy clamp to its n_min.
    """
    kf = jnp.maximum(k.astype(jnp.float32) - 1.0, 1.0)  # k-1, floored
    a = 2.0 / (9.0 * kf)
    n = kf / (2.0 * cfg.epsilon) * (1.0 - a + jnp.sqrt(a) * cfg.z) ** 3
    return jnp.where(k <= 1, jnp.float32(1.0), n)


def particle_target(particles, m: MazeMap, cfg: KLDConfig):
    """[N, 3] posterior sample -> KLD-required particle count (f32 scalar)."""
    return kld_target(occupied_bin_count(particles, m, cfg), cfg)
