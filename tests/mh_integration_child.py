"""Child process for the 2-process jax.distributed integration test.

Usage: python mh_integration_child.py <pid> <nproc> <port>
Simulates this process's episode block deterministically from GLOBAL
episode indices, runs the multihost sweep, allgathers the results, and
prints one JSON line — identical across processes AND host counts.
"""
import json
import os
import os.path as osp
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=nproc, process_id=pid)

    import numpy as np

    from montecarlolocalisation.config import FilterConfig
    from montecarlolocalisation.maps import from_map_file
    from montecarlolocalisation.parallel import multihost
    from montecarlolocalisation.sim import robot

    m = from_map_file(osp.join(
        osp.dirname(osp.abspath(__file__)), "..",
        "montecarlolocalisation", "maps", "default_map.txt"))
    cfg = FilterConfig(num_particles=128)
    angles = np.deg2rad(np.linspace(-118, 118, 8)).astype(np.float32)
    total, ticks = 8, 12  # 8 episodes: one per global device of the
    # 2-proc x 4-local (or 1-proc x 8... capped to local) CPU topology

    mesh = multihost.make_multihost_mesh(particle_shards=1)
    start, count = multihost.process_episode_slice(total)
    sim_base = jax.random.PRNGKey(42)
    enc, scans = [], []
    for g in range(start, start + count):
        e, s, _ = robot.generate_wander_episode(
            jax.random.fold_in(sim_base, g), m, cfg, angles, ticks)
        enc.append(np.asarray(e))
        scans.append(np.asarray(s))

    final, outs = multihost.run_multihost_episode_batch(
        jax.random.PRNGKey(7), m, cfg, np.stack(enc), np.stack(scans),
        angles, mesh=mesh)
    conf = multihost.all_processes_value(final.confidence)
    best = multihost.all_processes_value(final.best_pose)
    print(json.dumps(dict(
        pid=pid,
        nproc=jax.process_count(),
        ndev=jax.device_count(),
        mesh=dict(mesh.shape),
        confidence=[round(float(c), 6) for c in np.asarray(conf)],
        best=[[round(float(v), 5) for v in row] for row in np.asarray(best)],
    )), flush=True)


if __name__ == "__main__":
    main()
