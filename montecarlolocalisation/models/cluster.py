"""k-means pose clustering + confidence estimation (accelerator-native).

Reference: monte_carlo.cpp:802-949.
  * kMeansClustering: K=3, <=20 iterations, random particle init, xy-only,
    early exit when assignments stop changing, empty clusters reseeded from a
    random particle.
  * best cluster by summed particle WEIGHT; theta via sin/cos mean of the
    best cluster's members; confidence = fraction of ALL particles within
    0.4 m of the best center; below threshold -> (-1, -1, -1) sentinel.

K is tiny and static, so the per-cluster work is UNROLLED into K
elementwise distance/mask/reduce chains over [N] arrays — no [N, K]
broadcasts or one-hot matmuls materialize.  The early exit becomes a
carried `done` mask over the fixed iteration count so everything stays
inside jit.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import ClusterConfig
from ..utils.angles import circular_mean


def kmeans(key, xy, cfg: ClusterConfig):
    """xy: [N, 2] -> (centers [K, 2], assignments [N]).

    The Lloyd loop runs as a dense scan over the fixed iteration count
    (`_kmeans_dense`), on every platform and under vmap.
    """
    n = xy.shape[0]
    k = cfg.k
    k_init, k_iters = jax.random.split(key)
    init_idx = jax.random.randint(k_init, (k,), 0, n)
    centers0 = xy[init_idx]
    iter_keys = jax.random.split(k_iters, cfg.max_iters)
    # Reseed candidates for empty clusters, one set per iteration
    # (monte_carlo.cpp:861-864).
    reseed_idx = jax.vmap(
        lambda kk: jax.random.randint(kk, (k,), 0, n))(iter_keys)
    reseed = xy[reseed_idx]  # [I, K, 2]
    return _kmeans_dense(xy, centers0, reseed, cfg)


def _kmeans_dense(xy, centers0, reseed, cfg: ClusterConfig):
    n = xy.shape[0]
    k = cfg.k
    assign0 = jnp.zeros((n,), jnp.int32)
    x = xy[:, 0]
    y = xy[:, 1]

    def body(carry, reseed_t):
        centers, assign, done = carry
        # Assignment: running argmin over the K unrolled distances.
        new_assign = jnp.zeros((n,), jnp.int32)
        best = (x - centers[0, 0]) ** 2 + (y - centers[0, 1]) ** 2
        for i in range(1, k):
            di = (x - centers[i, 0]) ** 2 + (y - centers[i, 1]) ** 2
            closer = di < best
            new_assign = jnp.where(closer, i, new_assign)
            best = jnp.where(closer, di, best)
        changed = jnp.any(new_assign != assign)
        # Early exit BEFORE the update step (monte_carlo.cpp:841-844).
        do_update = changed & ~done
        # Update: K masked mean reductions.
        means = []
        counts = []
        for i in range(k):
            mi = (new_assign == i).astype(jnp.float32)
            ci = jnp.sum(mi)
            counts.append(ci)
            means.append(jnp.stack([jnp.sum(mi * x), jnp.sum(mi * y)])
                         / jnp.maximum(ci, 1.0))
        means = jnp.stack(means)                          # [K, 2]
        # Empty clusters reseed from random particles (:861-864).
        means = jnp.where((jnp.stack(counts) > 0)[:, None], means,
                          reseed_t)
        centers = jnp.where(do_update, means, centers)
        assign = jnp.where(do_update, new_assign, assign)
        done = done | ~changed
        return (centers, assign, done), None

    (centers, assign, _), _ = jax.lax.scan(
        body, (centers0, assign0, jnp.bool_(False)), reseed)
    return centers, assign


def cluster_confidence(
    key, particles, weights, threshold, cfg: ClusterConfig,
    weighted: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Returns (confidence_ratio, best_pose[3] or (-1,-1,-1) sentinel).

    `threshold` is the (dynamic) confident-level threshold the ratio is gated
    against (monte_carlo.cpp:935-943); the counting radius is the fixed
    cfg.near_radius=0.4 regardless of the cluster_threshold parameter — a
    reference quirk preserved here (the cluster_distance arg at :887 is
    unused).

    `weighted=False` (default) is the reference semantics: the confidence
    ratio counts PARTICLES near the best center and the pose is the raw
    k-means center — correct when resampling runs every tick, so post-
    resample weights are uniform.  `weighted=True` is the importance-
    weighted form for the ESS-gated schedule (carried non-uniform weights):
    the ratio is the WEIGHT fraction near the center, and the reported
    pose is the weight-weighted mean of the best cluster's members — the
    two coincide exactly when weights are uniform.
    """
    xy = particles[:, :2]
    centers, assign = kmeans(key, xy, cfg)
    cluster_w = jnp.stack([
        jnp.sum(jnp.where(assign == i, weights, 0.0)) for i in range(cfg.k)
    ])
    best = jnp.argmax(cluster_w)
    cx, cy = centers[best, 0], centers[best, 1]
    member = (assign == best).astype(jnp.float32)
    if weighted:
        w_sum = jnp.maximum(jnp.sum(weights), 1e-30)
        mw = member * weights
        mw_sum = jnp.maximum(jnp.sum(mw), 1e-30)
        cx = jnp.sum(mw * xy[:, 0]) / mw_sum
        cy = jnp.sum(mw * xy[:, 1]) / mw_sum
        theta = circular_mean(particles[:, 2], weights=mw)
        d2 = (xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2
        ratio = jnp.sum(
            jnp.where(d2 <= cfg.near_radius**2, weights, 0.0)) / w_sum
    else:
        theta = circular_mean(particles[:, 2], weights=member)
        d2 = (xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2
        ratio = jnp.mean((d2 <= cfg.near_radius**2).astype(jnp.float32))
    best_pose = jnp.where(
        ratio > threshold,
        jnp.stack([cx, cy, theta]),
        jnp.full((3,), -1.0, jnp.float32),
    )
    return ratio, best_pose
