"""Episode-parallel sweeps: vmap the whole filter over independent episodes.

The headline new capability vs the reference (BASELINE.json config 4): one
robot's 10 Hz filter becomes a datagen engine — vmap over episodes x seeds
(x maps via separate calls), sharded over the mesh's 'episode' axis for
multi-chip scale-out.  Each episode is an independent filter run, so this
axis is embarrassingly parallel (pure data parallelism across devices and hosts).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import FilterConfig
from ..maps import symmetry as _sym
from ..maps.grid import MazeMap
from ..models import filter as mcl
from ..sim import robot

# jit cache for the episode runners: re-wrapping a closure in jax.jit on
# every call would retrace/recompile the full vmapped scan each time (the
# datagen loop calls these once per seed/map chunk).  Keyed on the map's
# buffer identity + static config/shapes.
_JIT_CACHE: dict = {}


def simulate_episode_batch(
    key, m: MazeMap, cfg: FilterConfig, scan_angles, num_ticks: int,
    batch: int, start_pose=(1.25, 1.25, 0.0),
):
    """vmap the scripted wanderer -> (encoders [E,T,2], scans [E,T,B],
    poses [E,T,3])."""
    keys = jax.random.split(key, batch)
    gen = functools.partial(
        robot.generate_wander_episode, m=m, cfg=cfg, scan_angles=scan_angles,
        num_ticks=num_ticks, start_pose=start_pose)
    return jax.vmap(lambda k: gen(k))(keys)


def run_episode_batch(
    key, m: MazeMap, cfg: FilterConfig, encoders, scan_ranges, scan_angles,
    mesh: Optional[Mesh] = None, episode_axis: str = "episode",
    tick_chunk: Optional[int] = None, known_map: Optional[MazeMap] = None,
) -> Tuple[mcl.MCLState, mcl.MCLOutput]:
    """Run the filter over a batch of episodes: vmap(init + lax.scan).

    encoders [E, T, 2], scan_ranges [E, T, B].  With `mesh`, the episode
    batch is sharded over its `episode_axis` (data parallelism; no
    cross-episode collectives needed).

    `tick_chunk` splits the tick scan into host-synced segments of that
    many ticks (bit-identical results: the per-tick RNG rides in the
    carried MCLState).  Each segment costs one ~ms host round trip.
    """
    batch = encoders.shape[0]
    keys = jax.random.split(key, batch)
    angles = jnp.asarray(scan_angles, jnp.float32)
    encoders = jnp.asarray(encoders, jnp.float32)
    scan_ranges = jnp.asarray(scan_ranges, jnp.float32)
    if mesh is not None:
        sh = NamedSharding(mesh, P(episode_axis))
        keys = jax.device_put(keys, sh)
        encoders = jax.device_put(encoders, sh)
        scan_ranges = jax.device_put(scan_ranges, sh)

    num_ticks = encoders.shape[1]
    km_id = None if known_map is None else id(known_map.occ)
    if tick_chunk is None or tick_chunk >= num_ticks:
        cache_key = ("batch", id(m.occ), km_id, cfg, encoders.shape,
                     scan_ranges.shape, angles.shape)
        fn = _JIT_CACHE.get(cache_key)
        if fn is None:
            def one(k, enc, ranges, ang):
                st = mcl.init_state(k, m, cfg, known_map=known_map)
                return mcl.run_episode(st, enc, ranges, ang, m, cfg,
                                       known_map=known_map)

            fn = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None)))
            _JIT_CACHE[cache_key] = fn
        return fn(keys, encoders, scan_ranges, angles)

    init_key = ("batch-init", id(m.occ), km_id, cfg, batch)
    init_fn = _JIT_CACHE.get(init_key)
    if init_fn is None:
        init_fn = jax.jit(jax.vmap(
            lambda k: mcl.init_state(k, m, cfg, known_map=known_map)))
        _JIT_CACHE[init_key] = init_fn
    states = init_fn(keys)
    outs_chunks = []
    for t0 in range(0, num_ticks, tick_chunk):
        enc_c = encoders[:, t0:t0 + tick_chunk]
        rng_c = scan_ranges[:, t0:t0 + tick_chunk]
        ck = ("batch-chunk", id(m.occ), km_id, cfg, enc_c.shape, rng_c.shape,
              angles.shape)
        cf = _JIT_CACHE.get(ck)
        if cf is None:
            cf = jax.jit(jax.vmap(
                lambda st, e, r, a: mcl.run_episode(st, e, r, a, m, cfg,
                                                    known_map=known_map),
                in_axes=(0, 0, 0, None)))
            _JIT_CACHE[ck] = cf
        states, outs = cf(states, enc_c, rng_c, angles)
        jax.block_until_ready(states.particles)   # bound execution time
        outs_chunks.append(outs)
    outs = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=1), *outs_chunks)
    return states, outs


def run_multimap_sweep(
    key, maps: MazeMap, cfg: FilterConfig, scan_angles, num_ticks: int,
    episodes_per_map: int = 1, start_pose=(1.25, 1.25, 0.0),
) -> Tuple[mcl.MCLState, mcl.MCLOutput, jax.Array]:
    """Randomized-maps sweep (BASELINE config 4): vmap over maps x episodes.

    `maps` is a stacked MazeMap (maps.generator.generate_map_batch); the
    map arrays are traced under vmap, so lookups take the one-hot path
    automatically.  Returns (final_states, outputs, true_poses) with leading
    [n_maps * episodes_per_map] axes.
    """
    n_maps = maps.occ.shape[0]
    total = n_maps * episodes_per_map
    keys = jax.random.split(key, (total, 2))  # typed-key-safe shape
    angles = jnp.asarray(scan_angles, jnp.float32)

    def one(m_arrays, ks):
        enc, ranges, poses = robot.generate_wander_episode(
            ks[0], m_arrays, cfg, angles, num_ticks, start_pose=start_pose)
        st = mcl.init_state(ks[1], m_arrays, cfg)
        final, outs = mcl.run_episode(st, enc, ranges, angles, m_arrays, cfg)
        return final, outs, poses

    # Repeat each map episodes_per_map times along the batch axis.
    rep = lambda x: jnp.repeat(x, episodes_per_map, axis=0)
    maps_b = jax.tree_util.tree_map(rep, maps)
    cache_key = ("multimap", id(maps.occ), cfg, total, num_ticks,
                 angles.shape, tuple(start_pose))
    fn = _JIT_CACHE.get(cache_key)
    if fn is None:
        fn = jax.jit(jax.vmap(one))
        _JIT_CACHE[cache_key] = fn
    return fn(maps_b, keys)


def sweep_rmse(final_states: mcl.MCLState, true_poses, sym=None,
               tol_xy: float = 0.4) -> dict:
    """Batch convergence metrics for a sweep (pose RMSE on final tick).

    With `sym` (a maps.symmetry.SymmetryGroup), adds alias-aware metrics:
    the maze's isometry group makes global localization ambiguous up to the
    group, so `alias_*` measure error against the BEST alias of the truth
    and `alias_converged_frac` counts episodes confident AND within tol_xy
    of any alias — the physically meaningful convergence rate.
    """
    best = final_states.best_pose                      # [E, 3]
    truth = jnp.asarray(true_poses)[:, -1, :]          # [E, 3]
    ok = best[:, 0] >= 0
    err = jnp.where(
        ok, jnp.hypot(best[:, 0] - truth[:, 0], best[:, 1] - truth[:, 1]),
        jnp.nan)
    dth = jnp.arctan2(jnp.sin(best[:, 2] - truth[:, 2]),
                      jnp.cos(best[:, 2] - truth[:, 2]))
    out = dict(
        converged_frac=jnp.mean(ok.astype(jnp.float32)),
        rmse_xy=jnp.sqrt(jnp.nanmean(err**2)),
        rmse_theta=jnp.sqrt(jnp.nanmean(jnp.where(ok, dth, jnp.nan) ** 2)),
    )
    if sym is not None:
        ae = _sym.alias_errors(best, truth, sym)
        a_err = jnp.where(ok, ae["err_xy"], jnp.nan)
        out.update(
            alias_rmse_xy=jnp.sqrt(jnp.nanmean(a_err**2)),
            alias_rmse_theta=jnp.sqrt(jnp.nanmean(
                jnp.where(ok, ae["err_theta"], jnp.nan) ** 2)),
            alias_converged_frac=jnp.mean(
                (ok & (ae["err_xy"] < tol_xy)).astype(jnp.float32)),
            true_mode_frac=jnp.mean(
                (ok & (ae["alias_idx"] == 0)
                 & (ae["err_xy"] < tol_xy)).astype(jnp.float32)),
        )
        # Cloud-as-mixture metrics (per-episode decomposition over the
        # truth's orbit, then sweep means): how concentrated the final
        # cloud is on its winning mode and how tightly that mode tracks —
        # independent of WHICH alias each seed picked.
        mt = _sym.mixture_tracking(final_states.particles,
                                   final_states.weights, truth, sym,
                                   stray_radius=tol_xy)
        # An episode whose cloud is ENTIRELY stray has no dominant mode
        # and a NaN per-episode radius; tracked_frac tells consumers how
        # many episodes the aggregate actually covers (nanmean over zero
        # tracked episodes is NaN — "no data", not "tight tracking").
        tr = mt["tracking_rmse_xy"]
        tracked = jnp.isfinite(tr)
        out.update(
            dominant_mass_mean=jnp.mean(mt["dominant_mass"]),
            stray_mass_mean=jnp.mean(mt["stray_mass"]),
            tracking_rmse_xy=jnp.sqrt(jnp.nanmean(tr ** 2)),
            tracked_episodes_frac=jnp.mean(tracked.astype(jnp.float32)),
        )
    return out


def run_episode_replicas(key, m, cfg, encoders, scan_ranges, scan_angles,
                         replicas: int = 4, known_map=None,
                         tick_chunk=None):
    """Evidence-selected filter replicas over an episode BATCH.

    Runs the batch `replicas` times with independent filter RNG streams
    and keeps, PER EPISODE, the replica with the highest accumulated log
    total likelihood weight (sum_t log sum_i lik_t,i — the SIR evidence
    proxy MCLOutput.total_weight exposes).  The relocalization analog of
    slam.run_slam_replicas: on aliased partial maps, which mode a filter
    locks is seed-chaotic, and the evidence statistic discriminates the
    true mode (measured on half-explored maps at T=300: interval
    credit alone 46/96 episodes relocalized -> 62/96 with K=4 —
    BENCH_DETAILS round-5 reloc table).  Cost is replicas x the batch.

    Returns (final_state_of_winners, outs_of_winners, info) where info
    has per-episode `chosen` indices and the [K, B] evidence matrix.
    Selection runs on host (K small); device work is K batched runs.
    """
    import numpy as np

    finals, outs, evs = [], [], []
    for r in range(replicas):
        f, o = run_episode_batch(
            jax.random.fold_in(key, r), m, cfg, encoders, scan_ranges,
            scan_angles, known_map=known_map, tick_chunk=tick_chunk)
        finals.append(f)
        outs.append(o)
        evs.append(np.log(np.maximum(
            np.asarray(o.total_weight, np.float64), 1e-30)).sum(axis=1))
    ev = np.stack(evs)                                    # [K, B]
    chosen = np.argmax(ev, axis=0)                        # [B]
    b_idx = np.arange(chosen.shape[0])

    def pick(leaves):
        stacked = np.stack([np.asarray(x) for x in leaves])   # [K, B, ...]
        return jnp.asarray(stacked[chosen, b_idx])

    final = jax.tree_util.tree_map(lambda *xs: pick(xs), *finals)
    out = jax.tree_util.tree_map(lambda *xs: pick(xs), *outs)
    return final, out, dict(chosen=chosen, log_evidence=ev)
