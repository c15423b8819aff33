"""Render an MCL episode to image frames: PPM strip and (optional) GIF.

The diagnostic the sweeps were missing (ROADMAP item 7): when an episode
locks onto a maze alias, the convergence numbers alone cannot show it —
a frame strip of the particle cloud over time makes it obvious at a
glance (reference analog: watching the RViz PoseArray topics,
monte_carlo.cpp:563-608).

Usage:
  python tools/render_episode.py --simulate --ticks 150 --out ep.gif
  python tools/render_episode.py --log montecarlolocalisation/data/replay_6x6.npz
  python tools/render_episode.py --simulate --kidnap 80 --strip strip.ppm

Outputs a horizontal PPM contact strip always (no imaging dependency) and
an animated GIF when PIL is importable.
"""
from __future__ import annotations

import argparse
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.io.logs import EpisodeLog
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.utils import viz

DEFAULT_MAP = osp.join(osp.dirname(osp.abspath(__file__)), "..",
                       "montecarlolocalisation", "maps",
                       "default_map.txt")


def run_and_capture(m, cfg, log: EpisodeLog, every: int, scale: int):
    """Host loop over ticks, snapshotting a frame every `every` ticks."""
    import jax
    import jax.numpy as jnp

    from montecarlolocalisation.models import filter as mcl
    from montecarlolocalisation.models import sensor

    angles = jnp.asarray(log.scan_angles, jnp.float32)
    step = jax.jit(
        lambda st, el, er, rg, mk: mcl.mcl_step(
            st, el, er,
            sensor.Scan(angles=angles, ranges=rg, mask=mk), m, cfg))
    state = mcl.init_state(jax.random.PRNGKey(cfg.num_particles), m, cfg)
    occ = np.asarray(m.occ)
    mask_all = (np.ones_like(log.scan_ranges, dtype=bool)
                if log.scan_mask is None else np.asarray(log.scan_mask))
    frames, labels = [], []
    for t in range(log.num_ticks):
        state, _ = step(state, jnp.float32(log.encoders[t, 0]),
                        jnp.float32(log.encoders[t, 1]),
                        jnp.asarray(log.scan_ranges[t], jnp.float32),
                        jnp.asarray(mask_all[t]))
        if t % every == 0 or t == log.num_ticks - 1:
            truth = (log.true_poses[t]
                     if log.true_poses is not None else None)
            frames.append(viz.render_filter(
                occ, particles=state.particles, weights=state.weights,
                best_pose=state.best_pose, true_pose=truth,
                resolution=float(m.resolution), scale=scale))
            labels.append(t)
    return frames, labels


def run_closed_loop_capture(m, cfg, num_ticks: int, seed: int, every: int,
                            scale: int, beams: int):
    """Closed-loop plan execution with the controller debug markers the
    reference publishes to RViz: the heading-error arrow
    (moveToPosition_server.cpp:94-130,623) on the world frame, and the APF
    Attract/Repel force arrows + influence circle (avf.cpp:292-294,
    potential_field.cpp:446-447) as a robot-frame side panel.
    """
    import jax
    import jax.numpy as jnp

    from montecarlolocalisation.config import APFConfig
    from montecarlolocalisation.control import controllers as C
    from montecarlolocalisation.planning import bfs
    from montecarlolocalisation.sim import closed_loop
    from montecarlolocalisation.utils.angles import normalize_angle

    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, beams)).astype(np.float32)
    walls = np.asarray(m.walls, np.uint8)
    path = bfs.bfs_path(walls, (1, 1), (m.n_rows - 2, m.n_cols - 2))
    wps = closed_loop.mission_waypoints(path, float(m.cell_meters))[1:]
    _, outs = jax.jit(lambda k: closed_loop.run_closed_loop(
        k, m, cfg, jnp.asarray(wps), num_ticks, angles,
        known_start=True))(jax.random.PRNGKey(seed))
    true_p = np.asarray(outs.true_pose)
    est_p = np.asarray(outs.est_pose)
    wp_idx = np.asarray(outs.wp_idx)
    occ = np.asarray(m.occ)
    # potential_field gains: the preset with live repulsion (global_apf
    # faithfully keeps the reference's repel_gain = 0,
    # moveToPosition_server.cpp:54-56 — its repel arrow would be empty).
    apf_cfg = APFConfig.potential_field()
    scfg = cfg.sensor

    frames, labels = [], []
    for t in range(0, num_ticks, every):
        img = viz.render_filter(occ, best_pose=est_p[t],
                                true_pose=true_p[t],
                                resolution=float(m.resolution), scale=scale)
        wp = wps[min(int(wp_idx[t]), len(wps) - 1)]
        est = est_p[t]
        if est[0] >= 0:
            err = normalize_angle(
                np.arctan2(wp[1] - est[1], wp[0] - est[0]) - est[2])
            img = viz.draw_heading_error(img, est, float(err),
                                         resolution=float(m.resolution),
                                         scale=scale)
        # APF side panel: the robot-frame force field at the TRUE pose
        # (scan re-simulated there; target = current waypoint in the
        # robot frame, matching the reference's "laser"-frame markers).
        from montecarlolocalisation.models import sensor as sensor_mod

        scan = sensor_mod.simulate_scan(m, jnp.asarray(true_p[t]),
                                        jnp.asarray(angles), scfg)
        r = np.asarray(scan.ranges)
        a = np.asarray(scan.angles)
        px_r, py_r = r * np.cos(a), r * np.sin(a)
        th = true_p[t, 2]
        dxw, dyw = wp[0] - true_p[t, 0], wp[1] - true_p[t, 1]
        tx = dxw * np.cos(-th) - dyw * np.sin(-th)
        ty = dxw * np.sin(-th) + dyw * np.cos(-th)
        forces = C.apf_forces(jnp.float32(tx), jnp.float32(ty),
                              jnp.float32(0.0), jnp.float32(0.0),
                              jnp.asarray(px_r), jnp.asarray(py_r),
                              jnp.asarray(scan.mask), apf_cfg)
        apf_img = viz.render_apf(px_r, py_r, np.asarray(scan.mask), forces)
        # Pad/crop the side panel to the map frame's height.
        h = img.shape[0]
        ah, aw = apf_img.shape[:2]
        panel = np.full((h, aw, 3), 255, np.uint8)
        panel[:min(h, ah), :] = apf_img[:min(h, ah)]
        frames.append(np.concatenate([img, panel], axis=1))
        labels.append(t)
    return frames, labels


def run_slam_capture(m, num_ticks: int, seed: int, every: int,
                     scale: int, beams: int):
    """SLAM map-growth frames: best particle's log-odds grid rendered as
    greyscale (unknown mid-grey, free light, walls dark), true pose in
    green, SLAM estimate in red."""
    import jax
    import jax.numpy as jnp

    from montecarlolocalisation.config import (FilterConfig,
                                                   MappingConfig,
                                                   SLAMConfig)
    from montecarlolocalisation.models import slam
    from montecarlolocalisation.sim import robot

    fcfg = FilterConfig()
    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, beams)).astype(np.float32)
    scfg = SLAMConfig(
        num_particles=64,
        mapping=MappingConfig(height=m.height, width=m.width,
                              resolution=float(m.resolution),
                              origin_x=float(m.origin_x),
                              origin_y=float(m.origin_y)),
        sensor=fcfg.sensor, motion=fcfg.motion,
        keyframe_trans=0.15, keyframe_rot=0.5)
    start = (1.25, 1.25, 0.0)
    enc, scans, truth = robot.generate_wander_episode(
        jax.random.PRNGKey(seed), m, fcfg, angles, num_ticks,
        start_pose=start, slip_noise=0.05, explore=True)
    enc, scans, truth = map(np.asarray, (enc, scans, truth))
    ja = jnp.asarray(angles)
    step = jax.jit(lambda st, e, r: slam.slam_step(
        st, e[0], e[1], r, ja, jnp.ones_like(r), scfg))
    st = slam.init_slam(jax.random.PRNGKey(seed + 1), start, scfg)

    def to_px(x, y):
        c = int((x - m.origin_x) / float(m.resolution) * scale)
        r = int((y - m.origin_y) / float(m.resolution) * scale)
        return r, c

    frames, labels = [], []
    for t in range(num_ticks):
        st, info = step(st, jnp.asarray(enc[t]), jnp.asarray(scans[t]))
        if t % every and t != num_ticks - 1:
            continue
        lo = np.asarray(slam.best_map(st))
        grey = np.clip(127.0 - 100.0 * np.tanh(lo / 4.0), 0, 255
                       ).astype(np.uint8)
        img = np.repeat(np.repeat(grey, scale, 0), scale, 1)
        img = np.stack([img] * 3, -1)
        est = np.asarray(info["pose"])
        for pose, color in ((truth[t], (0, 200, 0)),
                            (est, (220, 0, 0))):
            r, c = to_px(pose[0], pose[1])
            rr = slice(max(r - scale // 2, 0), r + scale // 2 + 1)
            cc = slice(max(c - scale // 2, 0), c + scale // 2 + 1)
            img[rr, cc] = color
        frames.append(img)
        labels.append(t)
    return frames, labels


def save_strip(frames, path: str, max_frames: int = 12) -> None:
    idx = np.linspace(0, len(frames) - 1, min(max_frames, len(frames)))
    strip = np.concatenate([frames[int(i)] for i in idx], axis=1)
    viz.save_ppm(strip, path)


def save_gif(frames, path: str, ms_per_frame: int = 120) -> bool:
    try:
        from PIL import Image
    except ImportError:
        return False
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=ms_per_frame, loop=0)
    return True


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--log", help="EpisodeLog .npz to replay")
    src.add_argument("--simulate", action="store_true",
                     help="generate a wander episode on the default map")
    src.add_argument("--closed-loop", action="store_true",
                     help="closed-loop plan execution with controller "
                          "debug markers (heading-error arrow + APF "
                          "force/influence panel)")
    src.add_argument("--slam", action="store_true",
                     help="RBPF SLAM map growth: the best particle's "
                          "log-odds grid per frame (walls darken, carved "
                          "free space lightens, unknown grey) with the "
                          "TRUE pose (green) and the SLAM estimate (red)")
    ap.add_argument("--map", default=DEFAULT_MAP)
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--particles", type=int, default=1500)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--every", type=int, default=5,
                    help="capture a frame every N ticks")
    ap.add_argument("--scale", type=int, default=8, help="pixels per map px")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kidnap", type=int, default=0,
                    help="simulate a kidnap event at this tick (0 = none)")
    ap.add_argument("--out", default="episode.gif")
    ap.add_argument("--strip", default="episode_strip.ppm")
    args = ap.parse_args()

    m = from_map_file(args.map)
    cfg = FilterConfig(num_particles=args.particles,
                       sensor=SensorModelConfig())

    if args.slam:
        frames, labels = run_slam_capture(m, args.ticks, args.seed,
                                          args.every, args.scale,
                                          args.beams)
        save_strip(frames, args.strip)
        print(f"wrote {args.strip} ({len(frames)} frames, ticks "
              f"{labels[0]}...{labels[-1]})")
        if save_gif(frames, args.out):
            print(f"wrote {args.out}")
        return

    if args.closed_loop:
        frames, labels = run_closed_loop_capture(
            m, cfg, args.ticks, args.seed, args.every, args.scale,
            args.beams)
        save_strip(frames, args.strip)
        print(f"wrote {args.strip} ({len(frames)} frames, ticks "
              f"{labels[0]}...{labels[-1]})")
        if save_gif(frames, args.out):
            print(f"wrote {args.out}")
        return

    if args.log:
        log = EpisodeLog.load(args.log)
    else:
        import jax

        from montecarlolocalisation.sim import robot

        angles = np.deg2rad(
            np.linspace(-118.0, 118.0, args.beams)).astype(np.float32)
        kw = (dict(kidnap_tick=args.kidnap, kidnap_pose=(3.65, 3.65, 1.57))
              if args.kidnap else {})
        enc, ranges, poses = robot.generate_wander_episode(
            jax.random.PRNGKey(args.seed), m, cfg, angles, args.ticks, **kw)
        log = EpisodeLog(encoders=np.asarray(enc),
                         scan_ranges=np.asarray(ranges),
                         scan_angles=angles, true_poses=np.asarray(poses))

    frames, labels = run_and_capture(m, cfg, log, args.every, args.scale)
    save_strip(frames, args.strip)
    print(f"wrote {args.strip} ({len(frames)} frames, ticks {labels[0]}..."
          f"{labels[-1]})")
    if save_gif(frames, args.out):
        print(f"wrote {args.out}")
    else:
        print("PIL unavailable: GIF skipped (strip written)")


if __name__ == "__main__":
    main()
