"""Smoke test: the main paths of the filter on one GPU, at real sizes.

Usage:
  python chip_smoke.py               every phase on one GPU (exits non-zero
                                     when JAX finds no GPU)
  python chip_smoke.py --rehearse    every phase at tiny sizes on the CPU;
                                     never prints a result line
  python chip_smoke.py --multichip   only the sharded steps, on four GPUs,
                                     each compared with one device

Phases (one GPU):
  1. device: platform, device kind and count; the card's name and power
     limit from nvidia-smi, read by a child process that does not use JAX.
  2. beam weights at 1M particles x 34 beams, ray_mode {analytic, fixed} x
     beam_combine {sum, log}: the path the filter step dispatches to on the
     card vs the plain dense gather path on the card, and the card's ray
     casts and weights on a 4096-particle subsample vs the float64 NumPy
     oracle (tests/oracle.py) on the host.
  3. the main paths end to end: (a) the full MCL step at 1M x 34 under
     lax.scan, with its device-time split per stage from a profiler trace;
     (b) the JSONL server at 1500 x 34 and 100k x 34; (c) the fleet server,
     256 robots x 1500 x 34; (d) the 1024-episode global-localization sweep
     (accuracy guard: converged_frac >= 0.70); (e) the SLAM preset, 1000
     ticks at P=128, plus its likelihood field and bilinear sample against
     float64 NumPy; (f) __graft_entry__.entry() jitted on the card.
Every check that fails exits non-zero.  The last line of stdout, printed
only after every phase passed on a GPU, is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import math
import os
import os.path as osp
import subprocess
import sys
import time

import numpy as np

HERE = osp.dirname(osp.abspath(__file__))

FULL = dict(n_weights=1_000_000, n_oracle=4096, n_step=1_000_000,
            step_chunk=8, step_iters=3, serve=(1500, 100_000),
            serve_frames=50, fleet_robots=256, fleet_n=1500, fleet_ticks=20,
            sweep=(1024, 300, 500), slam_ticks=1000, slam_p=128,
            mc_particles=4_000_000, mc_ep_particles=1_000_000)
TINY = dict(n_weights=4096, n_oracle=256, n_step=2048, step_chunk=2,
            step_iters=1, serve=(256, 1024), serve_frames=5, fleet_robots=4,
            fleet_n=256, fleet_ticks=3, sweep=(8, 20, 128), slam_ticks=30,
            slam_p=16, mc_particles=8192, mc_ep_particles=1024)
BEAMS = 34
# Beams allowed to disagree between two float32 casts, as a fraction of
# all beams: a fixed-march sample or an analytic hit that sits within an
# ulp of a pixel edge can land on either side (ops/analytic.py module
# docstring: pixel-boundary ties).
BEAM_TOL = dict(fixed=1e-5, analytic=1e-4)
RTOL = 1e-5
# Log-combine weights are exp(log-sum - max); the log-sum of 34 floored
# logs (|value| up to 34 |log 1e-6| ~ 470) accumulated in another order
# can move by up to ~34 float32 ulps at 470, about 5e-4.
LOG_ATOL = 1e-3


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit, from a child that has no JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _oracle():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "mcl_oracle", osp.join(HERE, "tests", "oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _maze():
    from montecarlolocalisation.maps import from_map_file

    return from_map_file(osp.join(HERE, "montecarlolocalisation", "maps",
                                  "default_map.txt"))


def _particles(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.0, 4.9, n), rng.uniform(0.0, 4.9, n),
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def _angles(n: int = BEAMS) -> np.ndarray:
    return np.deg2rad(np.linspace(-118.0, 118.0, n)).astype(np.float32)


# ---------------------------------------------------------------------------
# Phase 2: the beam-weight path against its references
# ---------------------------------------------------------------------------
def phase_weights(S) -> None:
    import jax
    import jax.numpy as jnp

    from montecarlolocalisation.config import SensorModelConfig
    from montecarlolocalisation.models import sensor

    oracle_mod = _oracle()
    m = _maze()
    orc = oracle_mod.Oracle(np.asarray(m.occ))
    n, n_o = S["n_weights"], S["n_oracle"]
    parts_np = _particles(n)
    parts = jnp.asarray(parts_np)
    angles = _angles()
    p64 = parts_np[:n_o].astype(np.float64)
    ox = p64[:, 0] + 0.1 * np.cos(p64[:, 2])
    oy = p64[:, 1] + 0.1 * np.sin(p64[:, 2])
    ray = p64[:, 2:3] - angles.astype(np.float64)     # negated beam angles
    for rm in ("analytic", "fixed"):
        cfg_d = SensorModelConfig(ray_mode=rm, lookup_mode="gather")
        d_card = np.asarray(jax.jit(lambda p: sensor.expected_ranges(
            m, p, jnp.asarray(angles), cfg_d))(parts))
        if rm == "fixed":
            q = d_card / cfg_d.ray_step
            check(np.all((np.abs(q - np.round(q)) < 1e-4)
                         | (d_card == cfg_d.max_range)),
                  "fixed: dense hit distances are not multiples of the step")
            d_host = np.array([[orc.raycast(ox[i], oy[i], ray[i, j])
                                for j in range(BEAMS)] for i in range(n_o)])
        else:
            d_host = orc.raycast_exact(ox[:, None], oy[:, None], ray)
        d_err = np.abs(d_card[:n_o] - d_host)
        beam_bad = d_err > 1e-4
        lim_o = math.floor(BEAM_TOL[rm] * beam_bad.size)
        say(f"phase2 {rm}: card dense casts vs float64 oracle, "
            f"{n_o}x{BEAMS} beams: {int(beam_bad.sum())} differ by > 1e-4 m "
            f"(limit {lim_o} = {BEAM_TOL[rm]:g} of beams), max |err| "
            f"elsewhere {d_err[~beam_bad].max():.3e} m")
        check(beam_bad.sum() <= lim_o, f"{rm}: casts disagree with oracle")
        obs = np.asarray(sensor.simulate_scan(
            m, jnp.array([1.25, 1.25, 0.3]), angles, cfg_d).ranges)
        scan = sensor.make_scan(angles, obs)
        for comb in ("sum", "log"):
            cfg = dataclasses.replace(cfg_d, beam_combine=comb,
                                      lookup_mode="auto")
            path = sensor.resolve_lookup_mode(m, parts, cfg, 0.1)
            w_step = np.asarray(jax.jit(lambda p: sensor.beam_weights(
                m, p, scan, cfg, 0.1))(parts))
            w_dense = np.asarray(jax.jit(lambda p: sensor._beam_weights_dense(
                m, p, scan, dataclasses.replace(cfg, lookup_mode="gather"),
                0.1, "gather"))(parts))
            check(np.isfinite(w_step).all(), f"{rm}/{comb}: non-finite")
            if comb == "sum":
                err = np.abs(w_step - w_dense) / np.maximum(
                    np.abs(w_dense), 1e-30)
                tol, what = RTOL, f"rtol={RTOL:g}"
            else:
                # The log-sums are accumulated in another order: compare
                # the logs (LOG_ATOL).
                lg = lambda w: np.log(np.maximum(w, 1e-30))
                err = np.abs(lg(w_step) - lg(w_dense))
                tol, what = LOG_ATOL, f"log-weight atol={LOG_ATOL:g}"
            bad = err > tol
            lim = math.floor(BEAM_TOL[rm] * n * BEAMS)
            rest = err[~bad].max() if (~bad).any() else 0.0
            say(f"phase2 {rm}/{comb}: step path '{path}' vs dense gather, "
                f"{n}x{BEAMS}: {int(bad.sum())} particles differ beyond "
                f"{what} (limit {lim}: {BEAM_TOL[rm]:g} of beams), "
                f"max err elsewhere {rest:.3e}")
            check(bad.sum() <= lim, f"{rm}/{comb}: step path vs dense")
            if comb != "sum":
                continue
            # Reference weights from the float64 casts (monte_carlo.cpp:
            # 623-682 semantics), on subsample particles whose beams all
            # agree with the oracle.
            ok_p = ~beam_bad.any(axis=1)
            sig = cfg.sigma
            diff = np.abs(obs.astype(np.float64) - d_host)
            gauss = np.where(diff <= cfg.gauss_max_diff, np.exp(
                -diff ** 2 / (2 * sig * sig)) / (sig * math.sqrt(2 * math.pi)),
                0.0)
            rand = (np.abs(obs.astype(np.float64) - cfg.max_range)
                    < cfg.rand_window)
            w_host = np.sum(cfg.w_hit * gauss + cfg.w_rand * rand, axis=1)
            valid = np.array([orc.is_valid_pos(*p[:2]) for p in p64])
            w_host = np.where(valid, w_host, 0.0)
            e = np.abs(w_step[:n_o] - w_host)[ok_p]
            tol = RTOL * np.abs(w_host[ok_p]) + 1e-6
            say(f"phase2 {rm}/sum: step path vs float64 oracle weights, "
                f"{int(ok_p.sum())} particles: max |err| {e.max():.3e} "
                f"(tol rtol={RTOL:g} + atol 1e-6)")
            check(np.all(e <= tol), f"{rm}: weights disagree with oracle")


# ---------------------------------------------------------------------------
# Phase 3: main paths end to end
# ---------------------------------------------------------------------------
def phase_full_step(S, rehearse: bool) -> None:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, HERE)
    import bench
    from montecarlolocalisation.utils import profiling

    n, chunk = S["n_step"], S["step_chunk"]
    step, state, ranges = bench.make_full_step(
        n, BEAMS, ray_mode="analytic", scan_chunk=chunk)
    enc = jnp.float32(0.1)
    t0 = time.perf_counter()
    state = step(state, enc, enc, ranges)
    jax.block_until_ready(state.particles)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(S["step_iters"]):
        state = step(state, enc, enc, ranges)
    jax.block_until_ready(state.particles)
    ms = (time.perf_counter() - t0) / (S["step_iters"] * chunk) * 1e3
    check(bool(jnp.isfinite(state.particles).all()), "full step: non-finite")
    split = ""
    if not rehearse:
        logdir = osp.join(HERE, "chiprun_out", "smoke_trace")
        hlo = step.lower(state, enc, enc, ranges).compile().as_text()
        jax.profiler.start_trace(logdir)
        state = step(state, enc, enc, ranges)
        jax.block_until_ready(state.particles)
        jax.profiler.stop_trace()
        sc = profiling.scope_device_times(
            logdir, hlo, ("motion", "weights", "resample", "cluster"))
        split = " device ms/step: " + ", ".join(
            f"{k} {v / chunk * 1e3:.3f}" for k, v in sorted(sc.items()))
    say(f"phase3a full mcl_step {n}x{BEAMS} analytic, lax.scan {chunk}/"
        f"dispatch, {S['step_iters']} dispatches: {ms:.3f} ms/step wall, "
        f"compile {t_compile:.1f} s;{split}")


def _episode(m, cfg, angles, ticks, seed=0):
    import jax

    from montecarlolocalisation.sim import robot

    enc, scans, _ = robot.generate_wander_episode(
        jax.random.PRNGKey(seed), m, cfg, angles, ticks,
        start_pose=(1.25, 1.25, 0.0))
    return np.asarray(enc), np.asarray(scans)


def phase_server(S) -> None:
    from montecarlolocalisation import presets
    from montecarlolocalisation.io.server import MCLServer

    for n in S["serve"]:
        world = presets.make_world(num_particles=n, num_beams=BEAMS)
        enc, scans = _episode(world.maze, world.cfg, world.angles,
                              S["serve_frames"])
        lines = [json.dumps(dict(encoder_left=float(e[0]),
                                 encoder_right=float(e[1]),
                                 ranges=[float(r) for r in row]))
                 for e, row in zip(enc, scans)]
        srv = MCLServer(world.maze, world.cfg, world.angles)
        out = io.StringIO()
        t0 = time.perf_counter()
        srv.serve(lines[:1], out)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv.serve(lines[1:], out)
        t_rest = time.perf_counter() - t0
        replies = [json.loads(r) for r in out.getvalue().splitlines()]
        check(len(replies) == len(lines), f"server {n}: reply count")
        for r in replies:
            check("error" not in r, f"server {n}: {r.get('error')}")
            check(all(math.isfinite(v) for v in r["exact_pose"]),
                  f"server {n}: non-finite pose")
        say(f"phase3b MCLServer.serve {n}x{BEAMS}: {len(replies)} JSONL "
            f"replies parsed, poses finite; first tick (compile) "
            f"{t_first:.2f} s, then {t_rest / (len(lines) - 1) * 1e3:.3f} "
            f"ms/tick wall")


def phase_fleet(S) -> None:
    import jax

    from montecarlolocalisation import presets
    from montecarlolocalisation.io.fleet import MCLFleetServer
    from montecarlolocalisation.parallel import episodes

    r, n, t = S["fleet_robots"], S["fleet_n"], S["fleet_ticks"]
    world = presets.make_world(num_particles=n, num_beams=BEAMS)
    enc, scans, _ = episodes.simulate_episode_batch(
        jax.random.PRNGKey(0), world.maze, world.cfg, world.angles, t, r,
        start_pose=(1.25, 1.25, 0.0))
    enc, scans = np.asarray(enc), np.asarray(scans)
    fleet = MCLFleetServer(world.maze, world.cfg, world.angles, n_robots=r)
    t0 = time.perf_counter()
    out = fleet.tick(enc[:, 0, 0], enc[:, 0, 1], scans[:, 0])
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(1, t):
        out = fleet.tick(enc[:, k, 0], enc[:, k, 1], scans[:, k])
    t_rest = time.perf_counter() - t0
    check(np.isfinite(np.asarray(out["exact_pose"], np.float64)).all(),
          "fleet: non-finite pose")
    say(f"phase3c MCLFleetServer {r} robots x {n}x{BEAMS}: {t} ticks, "
        f"first (compile) {t_first:.2f} s, then "
        f"{t_rest / max(t - 1, 1) * 1e3:.3f} ms/tick wall")


def phase_sweep(S, rehearse: bool) -> None:
    from montecarlolocalisation import presets

    batch, ticks, n = S["sweep"]
    # What tools/convergence_study.py --particles 500 runs.
    world = presets.make_world(num_particles=n, ray_mode="fixed")
    world = dataclasses.replace(world, cfg=dataclasses.replace(
        world.cfg, resample=dataclasses.replace(world.cfg.resample,
                                                method="systematic")))
    t0 = time.perf_counter()
    met = presets.run_sweep(world, batch=batch, num_ticks=ticks, seed=0)
    wall = time.perf_counter() - t0
    frac = float(met["converged_frac"])
    say(f"phase3d run_sweep {batch} episodes x {ticks} ticks x {n} "
        f"particles, fixed, systematic, seed 0: converged_frac {frac:.4f} "
        f"(guard >= 0.70), wall {wall:.1f} s incl. compile")
    check(rehearse or frac >= 0.70, f"sweep converged_frac {frac} < 0.70")


def _field_reference(lo, scfg):
    """float64 NumPy hit field (slam.hit_field) and blur."""
    lo = lo.astype(np.float64)
    l_occ = scfg.mapping.l_occ
    s = 1.0 / (1.0 + np.exp(-4.0 * (lo - 0.5 * l_occ)))
    s0 = 1.0 / (1.0 + math.exp(2.0 * l_occ))
    wall = np.maximum(0.0, (s - s0) / (1.0 - s0))

    def kern(k):
        idx = np.arange(k, dtype=np.float64)
        d = np.abs(idx[:, None] - idx[None, :])
        g = np.exp(-0.5 * (d / scfg.field_sigma_px) ** 2)
        return np.where(d <= scfg.field_radius_px, g, 0.0)

    h, w = lo.shape[-2:]
    blurred = np.einsum("ia,pab,bj->pij", kern(h), wall, kern(w))
    return np.clip(blurred, 0.0, 1.0), wall


def _bilinear_reference(field, ex, ey, mcfg):
    field = field.astype(np.float64)
    p, h, w = field.shape
    u = (ex.astype(np.float64) - mcfg.origin_x) / mcfg.resolution - 0.5
    v = (ey.astype(np.float64) - mcfg.origin_y) / mcfg.resolution - 0.5
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    u, v = np.clip(u, 0, w - 1), np.clip(v, 0, h - 1)
    c0 = np.minimum(np.floor(u).astype(int), w - 2)
    r0 = np.minimum(np.floor(v).astype(int), h - 2)
    fu, fv = u - c0, v - r0
    pi = np.arange(p)[:, None]
    val = ((1 - fv) * (1 - fu) * field[pi, r0, c0]
           + (1 - fv) * fu * field[pi, r0, c0 + 1]
           + fv * (1 - fu) * field[pi, r0 + 1, c0]
           + fv * fu * field[pi, r0 + 1, c0 + 1])
    return np.where(inb, val, 0.0)


def phase_slam(S) -> None:
    import jax
    import jax.numpy as jnp

    from montecarlolocalisation import presets
    from montecarlolocalisation.config import MappingConfig, SLAMConfig
    from montecarlolocalisation.models import slam

    world = presets.make_world()
    m = world.maze
    t0 = time.perf_counter()
    out = presets.run_slam(world, seed=0, num_ticks=S["slam_ticks"],
                           num_particles=S["slam_p"], relocalize=False)
    wall = time.perf_counter() - t0
    check(bool(out["poses_finite"]), "slam: non-finite poses")
    say(f"phase3e run_slam {S['slam_ticks']} ticks, P={S['slam_p']}: "
        f"F1 {out['f1']:.4f} (explored edges {out['f1_explored']:.4f}), "
        f"final error {out['slam_final_err_m']:.4f} m, poses finite, "
        f"wall {wall:.1f} s incl. compile")
    # Likelihood field and bilinear sample vs float64 NumPy at the
    # preset's size: these are the matrix products that run in TF32 on
    # the card unless they ask for more precision.
    mc = MappingConfig(height=m.height, width=m.width,
                       resolution=float(m.resolution),
                       origin_x=float(m.origin_x), origin_y=float(m.origin_y))
    scfg = SLAMConfig(num_particles=S["slam_p"], mapping=mc)
    rng = np.random.default_rng(1)
    lo = rng.uniform(-8.0, 8.0, (S["slam_p"], m.height, m.width)).astype(
        np.float32)
    ex = rng.uniform(-0.2, m.width * m.resolution + 0.2,
                     (S["slam_p"], 64)).astype(np.float32)
    ey = rng.uniform(-0.2, m.height * m.resolution + 0.2,
                     (S["slam_p"], 64)).astype(np.float32)
    blur, sharp = jax.jit(lambda x: slam.hit_field(x, scfg))(jnp.asarray(lo))
    samp = jax.jit(lambda f, a, b: slam._bilinear(f, a, b, mc))(
        blur, jnp.asarray(ex), jnp.asarray(ey))
    ref_blur, ref_sharp = _field_reference(lo, scfg)
    ref_samp = _bilinear_reference(np.asarray(blur), ex, ey, mc)
    e_blur = np.abs(np.asarray(blur) - ref_blur).max()
    e_sharp = np.abs(np.asarray(sharp) - ref_sharp).max()
    e_samp = np.abs(np.asarray(samp) - ref_samp).max()
    # The same blur at the default matmul precision, for contrast (TF32
    # on this card): what the explicit precision protects against.
    kh = slam._blur_matrix(m.height, scfg.field_sigma_px,
                           scfg.field_radius_px)
    kw = slam._blur_matrix(m.width, scfg.field_sigma_px,
                           scfg.field_radius_px)
    blur_def = jax.jit(lambda w: jnp.clip(jnp.einsum(
        "ia,pab,bj->pij", kh, w, kw), 0.0, 1.0))(sharp)
    e_def = np.abs(np.asarray(blur_def) - ref_blur).max()
    tol = 1e-5
    say(f"phase3e hit_field [{S['slam_p']},{m.height},{m.width}] vs float64: "
        f"blurred max |err| {e_blur:.2e}, sharp {e_sharp:.2e}; bilinear "
        f"sample max |err| {e_samp:.2e} (tol {tol:g}); the blur at the "
        f"default matmul precision: {e_def:.2e}")
    check(max(e_blur, e_sharp, e_samp) <= tol, "slam field vs float64")


def phase_graft_entry() -> None:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, HERE)
    import __graft_entry__ as g

    fn, args = g.entry()
    t0 = time.perf_counter()
    state, out = jax.jit(fn)(*args)
    jax.block_until_ready(state.particles)
    check(bool(jnp.isfinite(state.particles).all()), "graft entry")
    say(f"phase3f __graft_entry__.entry() jitted: "
        f"{state.particles.shape[0]} particles, finite, "
        f"{time.perf_counter() - t0:.1f} s incl. compile")


# ---------------------------------------------------------------------------
# --multichip: the sharded steps on four devices vs one device
# ---------------------------------------------------------------------------
def phase_multichip(S) -> None:
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from montecarlolocalisation.config import (FilterConfig, MappingConfig,
                                               ResampleConfig, SLAMConfig,
                                               SensorModelConfig)
    from montecarlolocalisation.models import filter as mcl
    from montecarlolocalisation.models import sensor, slam
    from montecarlolocalisation.parallel import distributed as dist

    check(len(jax.devices()) >= 4, "--multichip needs four devices")
    failures = []

    def expect(ok, what):
        # Keep going: every comparison is reported before the exit code.
        if not ok:
            failures.append(what)
            say(f"multichip check FAILED: {what}")

    m = _maze()
    angles = _angles()
    scan = sensor.simulate_scan(m, jnp.array([1.25, 1.25, 0.0]), angles,
                                SensorModelConfig(ray_mode="fixed"))
    n = S["mc_particles"]

    # 1. Particle-sharded step, 1x4 mesh, ring exchange.  The analytic
    # caster: on the GPU each shard runs the fused kernel.
    mesh = dist.make_mesh(n_particle_shards=4)
    cfg = FilterConfig(num_particles=n,
                       sensor=SensorModelConfig(ray_mode="analytic"))
    st0 = mcl.init_state(jax.random.PRNGKey(0), m, cfg)
    local = jax.jit(functools.partial(mcl.mcl_step, m=m, cfg=cfg))
    sharded_step = dist.make_sharded_step(mesh, m, cfg)
    st_l, st_s = st0, dist.shard_state(st0, mesh)
    t0 = time.perf_counter()
    for i in range(3):
        e = jnp.float32(0.05 * i)
        st_l, _ = local(st_l, e, e, scan)
        st_s, _ = sharded_step(st_s, e, e, scan)
    jax.block_until_ready(st_s.particles)
    wall = time.perf_counter() - t0
    pl_, ps_ = np.asarray(st_l.particles), np.asarray(st_s.particles)
    d_cent = max(abs(pl_[:, 0].mean() - ps_[:, 0].mean()),
                 abs(pl_[:, 1].mean() - ps_[:, 1].mean()))
    d_conf = abs(float(st_l.confidence) - float(st_s.confidence))
    wsum = float(jnp.sum(st_s.weights))
    path = sensor.resolve_lookup_mode(m, st0.particles, cfg.sensor, 0.1)
    say(f"multichip 1x4 particle-sharded step, {n}x{BEAMS} analytic "
        f"(weights path '{path}'), ring exchange, "
        f"3 steps vs one device: centroid diff {d_cent:.4f} m (< 0.4), "
        f"confidence diff {d_conf:.4f} (< 0.5), weight sum {wsum:.6f}, "
        f"{wall:.1f} s incl. compile")
    expect(np.isfinite(ps_).all() and d_cent < 0.4 and d_conf < 0.5
          and abs(wsum - 1.0) < 1e-5, "particle-sharded step vs local")

    # Same particles in, no motion noise, tiny ESS tau: both paths skip
    # the resample, so the carried weights compare directly.
    cfg_w = dataclasses.replace(
        cfg, motion=dataclasses.replace(cfg.motion, alpha_1=0.0,
                                        alpha_2=0.0, alpha_3=0.0,
                                        alpha_4=0.0),
        resample=ResampleConfig(method="systematic", ess_threshold=0.05))
    st0 = mcl.init_state(jax.random.PRNGKey(5), m, cfg_w)
    z = jnp.float32(0.0)
    w_l = np.asarray(jax.jit(functools.partial(
        mcl.mcl_step, m=m, cfg=cfg_w))(st0, z, z, scan)[0].weights)
    w_s = np.asarray(dist.make_sharded_step(mesh, m, cfg_w)(
        dist.shard_state(st0, mesh), z, z, scan)[0].weights)
    err = np.abs(w_s - w_l) / np.maximum(np.abs(w_l), 1e-30)
    bad = err > 1e-4
    lim = math.floor(BEAM_TOL["analytic"] * n * BEAMS)
    say(f"multichip 1x4 carried weights vs one device: {int(bad.sum())} "
        f"particles differ beyond rtol 1e-4 (limit {lim}: analytic "
        f"pixel-boundary ties, {BEAM_TOL['analytic']:g} of beams), max rel "
        f"err elsewhere {err[~bad].max():.3e}, over all {err.max():.3e}")
    expect(bad.sum() <= lim, "sharded weights vs local")

    # Ring systematic draw vs the single-device expansion (ring_vs_single).
    st = ring_vs_single(mesh, n)
    say(f"multichip ring systematic draw, {n} rows over 4 shards: "
        f"monotone {st['monotone']}; max |offspring - N w| "
        f"{st['dev_ring']:.3f} (one device {st['dev_one']:.3f}, limit 2); "
        f"vs one device "
        f"{st['moved']} rows moved, by at most {st['shift']} slots")
    expect(st["monotone"] and st["dev_ring"] <= 2.0,
           "ring systematic draw vs single device")

    # 2. Episode x particle 2x2 mesh.
    mesh2 = dist.make_mesh(n_particle_shards=2, n_episode_shards=2)
    ne, n_ep = 4, S["mc_ep_particles"]
    cfg2 = FilterConfig(num_particles=n_ep,
                        sensor=SensorModelConfig(ray_mode="analytic"))
    state = dist.init_batched_state(jax.random.PRNGKey(0), m, cfg2, ne)
    ranges = jnp.broadcast_to(scan.ranges, (ne, BEAMS))
    enc = jnp.full((ne,), 0.3, jnp.float32)
    ep_sh = NamedSharding(mesh2, P("episode"))
    sc_b = sensor.Scan(angles=jnp.asarray(angles),
                       ranges=jax.device_put(ranges, ep_sh),
                       mask=jnp.ones((BEAMS,), dtype=bool))
    t0 = time.perf_counter()
    st2, out2 = dist.make_sharded_step_batched(mesh2, m, cfg2)(
        dist.shard_state(state, mesh2, episode_axis="episode"),
        jax.device_put(enc, ep_sh), jax.device_put(enc, ep_sh), sc_b)
    jax.block_until_ready(st2.particles)
    wall = time.perf_counter() - t0
    st_loc, _ = jax.jit(jax.vmap(
        lambda s, e, r: mcl.mcl_step(s, e, e, sensor.Scan(
            jnp.asarray(angles), r, jnp.ones((BEAMS,), bool)), m, cfg2)))(
        state, enc, ranges)
    a, b = np.asarray(st2.particles), np.asarray(st_loc.particles)
    d = np.abs(a[..., :2].mean(axis=1) - b[..., :2].mean(axis=1)).max()
    say(f"multichip 2x2 episode x particle step, {ne} episodes x "
        f"{n_ep}x{BEAMS}: per-episode centroid diff vs one device "
        f"{d:.4f} m (< 0.4), shapes {a.shape}, {wall:.1f} s incl. compile")
    expect(np.isfinite(a).all() and a.shape == b.shape and d < 0.4,
          "2x2 batched step vs local")

    # 3. Sharded SLAM, P=128 over 4.
    mc = MappingConfig(height=m.height, width=m.width,
                       resolution=float(m.resolution),
                       origin_x=float(m.origin_x), origin_y=float(m.origin_y))
    scfg = SLAMConfig(num_particles=128, mapping=mc,
                      sensor=SensorModelConfig(ray_mode="fixed"))
    s0 = slam.init_slam(jax.random.PRNGKey(0), (1.25, 1.25, 0.0), scfg)
    ones = jnp.ones((BEAMS,), jnp.float32)
    s_step = dist.make_sharded_slam_step(mesh, scfg)
    s2, info = s_step(dist.shard_slam_state(s0, mesh), jnp.float32(0.3),
                      jnp.float32(0.32), scan.ranges, jnp.asarray(angles),
                      ones)
    s_l, info_l = jax.jit(lambda s: slam.slam_step(
        s, jnp.float32(0.3), jnp.float32(0.32), scan.ranges,
        jnp.asarray(angles), ones, scfg))(s0)
    dpose = np.abs(np.asarray(info["pose"]) - np.asarray(info_l["pose"]))
    wsum = float(jnp.sum(s2.weights))
    say(f"multichip sharded SLAM, P=128 over 4: weight sum {wsum:.6f}, "
        f"posterior-mean pose diff vs one device {dpose[:2].max():.4f} m "
        f"(< 0.05), map evidence {float(jnp.abs(s2.logodds).sum()):.1f} "
        f"(one device {float(jnp.abs(s_l.logodds).sum()):.1f})")
    expect(abs(wsum - 1.0) < 1e-5 and np.isfinite(np.asarray(info["pose"])
                                                  ).all()
          and dpose[:2].max() < 0.05, "sharded SLAM vs local")
    # Maps ride with their poses through the ring exchange: particle i's
    # map holds the constant i/32 (below the log-odds clamp) and its pose
    # x = 10 + i.
    ids = jnp.arange(128, dtype=jnp.float32)
    sf = dataclasses.replace(
        slam.init_slam(jax.random.PRNGKey(1), (1.25, 1.25, 0.0),
                       dataclasses.replace(scfg, ess_threshold=1.1)),
        poses=jnp.stack([10.0 + ids, jnp.full((128,), 1.25),
                         jnp.zeros((128,))], axis=-1),
        logodds=jnp.broadcast_to(ids[:, None, None] / 32.0,
                                 (128, m.height, m.width)),
        weights=(ids + 1.0) ** 3 / jnp.sum((ids + 1.0) ** 3))
    s3, info3 = dist.make_sharded_slam_step(
        mesh, dataclasses.replace(scfg, ess_threshold=1.1))(
        dist.shard_slam_state(sf, mesh), jnp.float32(0.0), jnp.float32(0.0),
        scan.ranges, jnp.asarray(angles), jnp.zeros((BEAMS,), jnp.float32))
    src = np.asarray(s3.poses)[:, 0] - 10.0
    maps = np.asarray(s3.logodds)
    ride = bool(info3["resampled"]) and np.allclose(
        32.0 * maps[:, 0, 0], src, atol=1e-3) and np.allclose(
        32.0 * maps[:, 5, 7], src, atol=1e-3)
    say(f"multichip sharded SLAM ring resample: maps ride with poses: "
        f"{ride}")
    expect(ride, "sharded SLAM maps vs poses")
    check(not failures, "; ".join(failures))


def ring_vs_single(mesh, n: int) -> dict:
    """The ring systematic draw (parallel/distributed) vs the one-device
    expansion on the same weights and u0.

    Rows carry their source index, so the draw reads back as indices.  A
    systematic draw gives source i between floor and ceil of N w_i
    offspring, in non-decreasing source order.  The ring builds the
    float32 CDF from per-shard prefix sums, one device from one scan; at
    millions of rows the two CDFs differ by more than 1/N (CPU, 4M rows:
    11% of rows move, by up to 25 slots), so the check is the invariant,
    |offspring_i - N w_i| <= 2 (one slot of rounding either side), not
    equality; the moves are reported.
    """
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from montecarlolocalisation.models import resample as rs
    from montecarlolocalisation.parallel import distributed as dist

    k_w, k_u = jax.random.split(jax.random.PRNGKey(11))
    w = jax.random.uniform(k_w, (n,)) ** 8
    norm = w / jnp.sum(w)
    rows = jnp.stack([jnp.arange(n, dtype=jnp.float32),
                      jnp.zeros((n,)), jnp.zeros((n,))], axis=-1)
    u0 = jax.random.uniform(k_u, ())
    one = np.asarray(rs.systematic_indices(jnp.cumsum(norm), u0))
    ring = np.asarray(jax.jit(jax.shard_map(
        functools.partial(dist._ring_systematic_draw, u0=u0,
                          axis_name="particle"),
        mesh=mesh, in_specs=(P("particle"), P("particle")),
        out_specs=P("particle")))(rows, norm))[:, 0].astype(np.int64)
    nw = n * np.asarray(norm, np.float64)

    def dev(idx):
        return float(np.abs(np.bincount(idx, minlength=n) - nw).max())

    return dict(monotone=bool(np.all(np.diff(ring) >= 0)),
                dev_ring=dev(ring), dev_one=dev(one),
                moved=int((ring != one).sum()),
                shift=int(np.abs(ring - one).max()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU; prints no result line")
    ap.add_argument("--multichip", action="store_true",
                    help="only the sharded steps, on four devices")
    args = ap.parse_args()
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.multichip:
            flags = os.environ.get("XLA_FLAGS", "")
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=4").strip()
    sys.path.insert(0, HERE)
    import jax

    from montecarlolocalisation.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    devs = jax.devices()
    dev = devs[0]
    say(f"phase1 device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)}")
    if not args.rehearse and dev.platform != "gpu":
        print("chip_smoke: JAX found no GPU", file=sys.stderr)
        return 2
    if not args.rehearse:
        say(card_line())
    S = TINY if args.rehearse else FULL
    try:
        if args.multichip:
            phase_multichip(S)
        else:
            phase_weights(S)
            phase_full_step(S, args.rehearse)
            phase_server(S)
            phase_fleet(S)
            phase_sweep(S, args.rehearse)
            phase_slam(S)
            phase_graft_entry()
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    if args.rehearse:
        say("rehearsal complete (CPU, tiny sizes): no result line")
        return 0
    print(json.dumps(dict(ok=True, device=dict(
        platform=dev.platform, kind=dev.device_kind, count=len(devs)))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
