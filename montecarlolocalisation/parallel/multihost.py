"""Multi-host (DCN) scale-out: episode sweeps sharded across processes.

SURVEY.md §2.4/§5: the reference's cross-machine story is ROS TCPROS; the
JAX equivalent is `jax.distributed` — one JAX process per host, the
EPISODE axis laid out across hosts (episodes are embarrassingly parallel,
so the only DCN traffic is the final metric gather), and the PARTICLE axis
kept inside each host so its collectives (psum/all_gather in
parallel.distributed) stay on the host's device interconnect.

Single-host use is a strict subset: every helper degrades to the local
mesh path, which is what the unit tests (and the 8-device virtual CPU
mesh) exercise.  The real multi-host bring-up is:

    # on every host, before any other jax call:
    from montecarlolocalisation.parallel import multihost
    multihost.initialize()                      # env-driven (see below)
    mesh = multihost.make_multihost_mesh()      # episode over DCN
    local = multihost.process_episode_slice(total_episodes)  # my episodes
    ... build per-host inputs for `local` ...
    out = multihost.run_multihost_episode_batch(...)

Dry-run path (documented, no second host needed): the same calls with
num_processes=1 produce the identical program; the driver's
dryrun_multichip and tests/test_multihost.py cover it on the CPU mesh.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import FilterConfig
from ..maps.grid import MazeMap
from . import episodes as _episodes


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed for a multi-host run; returns whether a
    multi-process runtime was actually started.

    Arguments default to the MCL_COORDINATOR / MCL_NUM_PROCESSES /
    MCL_PROCESS_ID environment variables; whatever remains unset is passed
    as None so jax.distributed's own auto-detection applies (managed
    clusters populate it from the scheduler).  MCL_PROCESS_ID is REQUIRED
    with MCL_NUM_PROCESSES on clusters without auto-detection — it has no
    safe default (every host claiming process 0 deadlocks the
    coordinator).  An explicit single-process configuration is a no-op so
    the same launch script works on one host — call this unconditionally,
    before any other JAX API touches the backend.
    """
    env = os.environ.get
    num = num_processes if num_processes is not None else (
        int(env("MCL_NUM_PROCESSES")) if env("MCL_NUM_PROCESSES") else None)
    if num is not None and num <= 1:
        return False
    coord = coordinator_address or env("MCL_COORDINATOR")
    if num is None and coord is None:
        # Nothing configured and nothing to auto-detect from our side:
        # stay a plain single-process run.
        return False
    pid = process_id if process_id is not None else (
        int(env("MCL_PROCESS_ID")) if env("MCL_PROCESS_ID") else None)
    if num is not None and pid is None:
        raise ValueError(
            "multi-process run needs a per-host process id: set "
            "MCL_PROCESS_ID (0..num_processes-1) on each host or pass "
            "process_id=")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=num, process_id=pid)
    return True


def make_multihost_mesh(particle_shards: int = 1,
                        episode_axis: str = "episode",
                        particle_axis: str = "particle") -> Mesh:
    """(episode, particle) mesh with the episode axis spanning hosts.

    Particle shards stay within a host (their psum/all_gather collectives
    stay on the host's device interconnect); the episode axis takes everything else —
    across hosts it is pure data parallelism, so the DCN only carries the
    final gathers.  Single-host this reduces to distributed.make_mesh.
    """
    local = jax.local_device_count()
    if particle_shards > local:
        raise ValueError(
            f"particle_shards={particle_shards} exceeds the "
            f"{local} devices of one host: particle collectives would "
            "cross DCN")
    n_proc = jax.process_count()
    ep_local = local // particle_shards
    if n_proc > 1:
        from jax.experimental import mesh_utils

        try:
            devs = mesh_utils.create_hybrid_device_mesh(
                (ep_local, particle_shards), (n_proc, 1))
        except ValueError:
            # Backends without slice attribution (multi-process CPU — the
            # local integration-test topology — or single-slice pods):
            # per-process blocks stacked process-major, so a particle row
            # can never span hosts (the within-host invariant) even when
            # particle_shards does not divide the local device count.
            per_proc = []
            for p in range(n_proc):
                mine = sorted((d for d in jax.devices()
                               if d.process_index == p),
                              key=lambda d: d.id)
                per_proc.append(np.asarray(
                    mine[: ep_local * particle_shards]).reshape(
                        ep_local, particle_shards))
            devs = np.concatenate(per_proc, axis=0)
    else:
        devs = np.asarray(jax.devices()[: ep_local * particle_shards]
                          ).reshape(ep_local, particle_shards)
    return Mesh(devs, axis_names=(episode_axis, particle_axis))


def process_episode_slice(total_episodes: int) -> Tuple[int, int]:
    """(start, count) of this process's episode block.

    Episodes are dealt in contiguous equal blocks (total must divide
    evenly — sweeps choose their sizes, so no ragged support).
    """
    n_proc = jax.process_count()
    if total_episodes % n_proc:
        raise ValueError(
            f"{total_episodes} episodes do not divide over {n_proc} hosts")
    per = total_episodes // n_proc
    return jax.process_index() * per, per


def global_episode_array(local_values, mesh: Mesh,
                         episode_axis: str = "episode"):
    """Assemble per-process episode blocks into one global array.

    `local_values` holds THIS process's episodes (leading axis =
    episodes/process); the result is the [total_episodes, ...] global
    array sharded P(episode_axis).  Single-process it is a device_put.
    """
    sh = NamedSharding(mesh, P(episode_axis))
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(local_values), sh)
    return jax.make_array_from_process_local_data(
        sh, np.asarray(local_values))


def all_processes_value(x):
    """Fetch a (possibly sharded) result to every host as numpy.

    The cross-host gather of sweep outputs — the only DCN collective an
    episode sweep needs.  Single-process: plain device_get.
    """
    if jax.process_count() == 1:
        return jax.device_get(x)
    from jax.experimental import multihost_utils

    return multihost_utils.process_allgather(x, tiled=True)


def run_multihost_episode_batch(
    key, m: MazeMap, cfg: FilterConfig, local_encoders, local_scan_ranges,
    scan_angles, mesh: Optional[Mesh] = None,
    episode_axis: str = "episode",
):
    """Episode sweep with per-host inputs: the DCN-era run_episode_batch.

    Each process passes ONLY its own episode block ([E_local, T, ...],
    from process_episode_slice); blocks are assembled into global arrays
    sharded over `episode_axis` and the vmapped filter runs as one global
    jit program.  `key` must be identical on every process (episode seeds
    derive from the GLOBAL episode index, so results are independent of
    the host count).  Returns (final_states, outputs) still sharded; pass
    through all_processes_value for host-side numpy.
    """
    mesh = mesh if mesh is not None else make_multihost_mesh(
        episode_axis=episode_axis)
    local_e = np.asarray(local_encoders).shape[0]
    # Per-episode keys fold the GLOBAL episode index into the shared base
    # key (typed key arrays cannot cross the process-local assembly, and
    # this makes results independent of the host count by construction).
    start = jax.process_index() * local_e
    idx = global_episode_array(
        np.arange(start, start + local_e, dtype=np.int32), mesh,
        episode_axis)
    enc = global_episode_array(
        np.asarray(local_encoders, np.float32), mesh, episode_axis)
    ranges = global_episode_array(
        np.asarray(local_scan_ranges, np.float32), mesh, episode_axis)
    angles = jnp.asarray(scan_angles, jnp.float32)

    from ..models import filter as mcl

    cache_key = ("multihost", id(m.occ), cfg, enc.shape, ranges.shape,
                 angles.shape)
    fn = _episodes._JIT_CACHE.get(cache_key)
    if fn is None:
        def run(base_key, idx, enc, ranges):
            def one(i, e, r):
                st = mcl.init_state(jax.random.fold_in(base_key, i), m, cfg)
                return mcl.run_episode(st, e, r, angles, m, cfg)

            return jax.vmap(one)(idx, enc, ranges)

        fn = jax.jit(run)
        _episodes._JIT_CACHE[cache_key] = fn
    return fn(key, idx, enc, ranges)
