"""Multi-host (DCN) scaffold tests — single-process on the CPU mesh.

A second host cannot exist in CI; these tests pin the parts that are
host-count-sensitive: the mesh layout rule (particle axis never crosses a
host), the episode partitioning arithmetic, and the end-to-end sweep in
the single-process degenerate configuration (which is the same jit
program the multi-process path runs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.parallel import episodes, multihost


def test_initialize_single_process_noop(monkeypatch):
    monkeypatch.delenv("MCL_NUM_PROCESSES", raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False


def test_mesh_layout():
    mesh = multihost.make_multihost_mesh(particle_shards=2)
    assert mesh.axis_names == ("episode", "particle")
    assert mesh.devices.shape == (4, 2)
    with pytest.raises(ValueError):
        multihost.make_multihost_mesh(particle_shards=16)


def test_process_episode_slice(monkeypatch):
    start, count = multihost.process_episode_slice(12)
    assert (start, count) == (0, 12)
    # Simulate a 4-host run: the pure arithmetic must tile the range.
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    seen = []
    for pid in range(4):
        monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
        s, c = multihost.process_episode_slice(12)
        assert c == 3
        seen.extend(range(s, s + c))
    assert sorted(seen) == list(range(12))
    with pytest.raises(ValueError):
        multihost.process_episode_slice(10)


def test_global_episode_array_and_gather():
    mesh = multihost.make_multihost_mesh()
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    g = multihost.global_episode_array(x, mesh)
    assert g.shape == (8, 2)
    back = multihost.all_processes_value(g)
    np.testing.assert_array_equal(np.asarray(back), x)


def test_multihost_episode_batch_runs(default_map):
    m = default_map
    cfg = FilterConfig(num_particles=300,
                       sensor=SensorModelConfig(lookup_mode="gather"))
    angles = np.deg2rad(np.linspace(-118, 118, 12)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    _, count = multihost.process_episode_slice(8)
    enc, ranges, _ = episodes.simulate_episode_batch(
        key, m, cfg, angles, num_ticks=20, batch=count)
    mesh = multihost.make_multihost_mesh()
    final, outs = multihost.run_multihost_episode_batch(
        jax.random.PRNGKey(1), m, cfg, np.asarray(enc), np.asarray(ranges),
        angles, mesh=mesh)
    conf = multihost.all_processes_value(final.confidence)
    assert conf.shape == (8,)
    assert np.all(conf >= 0.0) and np.all(conf <= 1.0)
    assert np.isfinite(multihost.all_processes_value(final.particles)).all()


@pytest.mark.slow
def test_two_process_distributed_integration():
    """REAL jax.distributed 2-process run (local CPU, DCN-style topology):
    both processes must produce the same gathered results, bit-identical
    to a single-process run of the same 8 episodes (host-count
    independence by construction of the global-index episode keys)."""
    import json
    import os.path as osp
    import socket
    import subprocess
    import sys

    child = osp.join(osp.dirname(__file__), "mh_integration_child.py")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    def run(pid, nproc, port):
        return subprocess.Popen(
            [sys.executable, child, str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    p0, p1 = run(0, 2, port), run(1, 2, port)
    try:
        out0, err0 = p0.communicate(timeout=240)
        out1, err1 = p1.communicate(timeout=240)
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert p0.returncode == 0, err0[-800:]
    assert p1.returncode == 0, err1[-800:]
    r0 = json.loads(out0.strip().splitlines()[-1])
    r1 = json.loads(out1.strip().splitlines()[-1])
    assert r0["nproc"] == 2 and r0["ndev"] == 8
    assert r0["mesh"] == {"episode": 8, "particle": 1}
    # allgather delivered the same global results to both processes.
    assert r0["confidence"] == r1["confidence"]
    assert r0["best"] == r1["best"]

    pref = run(0, 1, 0)
    outr, errr = pref.communicate(timeout=240)
    assert pref.returncode == 0, errr[-800:]
    rr = json.loads(outr.strip().splitlines()[-1])
    assert rr["confidence"] == r0["confidence"]
    assert rr["best"] == r0["best"]
