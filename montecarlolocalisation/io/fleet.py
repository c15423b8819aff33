"""Fleet serving: MANY live filters in one batched device step.

The reference deploys one filter per robot process (monte_carlo.cpp:1153,
one ROS node per Create).  An accelerator is orders of magnitude faster
than one robot needs, so the deployment unit here is a FLEET: R robots'
filter states live on the device as one batched pytree ([R, N, 3]
particles, [R] scalars) and every tick is ONE vmapped `mcl_step` dispatch —
the same batching that makes the episode sweeps fast (the fused
beam-weight kernel folds the robot axis into its episode grid axis under
vmap).

Protocol (JSONL; one fleet frame per line, arrays indexed by robot):

  {"encoder_left": [R], "encoder_right": [R], "ranges": [R][B],
   "mask": [R][B]?}
  -> {"tick": t, "exact_pose": [R][3], "cell_pose": [R][3],
      "confidence": [R], "song": [R], "wanderer_cmd": [R],
      "n_injected": [R]}

  Raw LaserScan frames (per-robot filterLaserReadings host-side):
  {"encoder_left": [R], "encoder_right": [R], "raw_scans": [R scan dicts]}

  Commands:
    {"cmd": "reset", "seed": n?}                 whole fleet
    {"cmd": "reset", "robot": i, "seed": n?}     one robot (kidnap/redeploy
                                                 without disturbing the rest)
    {"cmd": "checkpoint"|"restore", "path": p}   fleet pytree (.npz)
    {"cmd": "stats"}                             per-robot confidence
    {"cmd": "shutdown"}

Scale-out: pass `mesh=` (e.g. parallel.distributed.make_mesh()) and the
robot axis is sharded over devices — frames are device_put with a
P('robot'-axis) NamedSharding and XLA runs each shard's robots locally
(pure data parallelism: no cross-robot collectives exist by construction).

Pipelined mode (`pipeline=True`): each tick DISPATCHES this frame's step
(JAX async dispatch — returns as soon as the work is enqueued) and
returns the PREVIOUS tick's output, so the fetch of tick t-1 overlaps the
device computing tick t.  Per-tick cost drops from (RTT + compute +
fetch) to ~max(RTT, compute): the host round trip stops stacking on top
of the step.  Outputs lag one
tick (standard serving double-buffer); `flush()` drains the in-flight
tick.  The JSONL protocol is unchanged — replies are simply offset — and
every reply carries its own "tick" index.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import IO, Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FilterConfig
from ..maps.grid import MazeMap
from ..models import filter as mcl
from ..models import sensor
from . import logs


class MCLFleetServer:
    """R device-resident filters; one compiled vmapped step per tick."""

    def __init__(self, m: MazeMap, cfg: FilterConfig, angles,
                 n_robots: int, seed: int = 0, mesh=None,
                 robot_axis: str = "episode", pipeline: bool = False):
        if n_robots < 1:
            raise ValueError("n_robots must be >= 1")
        self.m = m
        self.cfg = cfg
        self.n_robots = n_robots
        self.angles = np.asarray(angles, np.float32)
        self._angles_dev = jnp.asarray(self.angles)
        self.tick_count = 0
        self.pipeline = pipeline
        self._pending = None  # (tick_index, device MCLOutput) in flight
        self._sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._sharding = NamedSharding(mesh, P(robot_axis))

        nb = len(self.angles)

        def one_step(state, frame):
            sc = sensor.Scan(angles=self._angles_dev,
                             ranges=frame[2:2 + nb],
                             mask=frame[2 + nb:] > 0.5)
            return mcl.mcl_step(state, frame[0], frame[1], sc, m, cfg)

        self._step = jax.jit(jax.vmap(one_step))
        self._init_one = jax.jit(
            lambda k: mcl.init_state(k, m, cfg))
        # [R, 2 + 2B] f32: ONE upload per fleet tick.
        self._frame = np.zeros((n_robots, 2 + 2 * nb), np.float32)
        self.reset(seed)

    # -- lifecycle -----------------------------------------------------------

    def _place(self, state):
        if self._sharding is None:
            return state
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, self._sharding), state)

    def reset(self, seed: int = 0) -> None:
        """Re-init the whole fleet (robot r gets fold_in(seed, r))."""
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(seed),
            jnp.arange(self.n_robots, dtype=jnp.uint32))
        self.state = self._place(jax.vmap(
            lambda k: mcl.init_state(k, self.m, self.cfg))(keys))
        self.tick_count = 0

    def reset_robot(self, robot: int, seed: int = 0) -> None:
        """Re-init ONE robot's filter in place (redeploy/kidnap handling);
        the other robots' states are untouched."""
        if not 0 <= robot < self.n_robots:
            raise ValueError(f"robot {robot} out of range "
                             f"[0, {self.n_robots})")
        fresh = self._init_one(jax.random.fold_in(
            jax.random.PRNGKey(seed), np.uint32(robot)))
        self.state = self._place(jax.tree_util.tree_map(
            lambda batch, one: batch.at[robot].set(one), self.state, fresh))

    def checkpoint(self, path: str) -> None:
        logs.save_pytree(path, self.state)

    def restore(self, path: str) -> None:
        self.state = self._place(logs.load_pytree(path, self.state))

    # -- ticks ---------------------------------------------------------------

    def tick(self, encoder_left, encoder_right, ranges, mask=None):
        """One fleet update: every robot advances one filter tick.

        Synchronous mode returns this tick's output dict.  Pipelined mode
        (``pipeline=True``) returns the PREVIOUS tick's output (``None``
        on the first tick) — the dispatch of this tick overlaps the fetch
        of the last one; drain the final in-flight tick with `flush()`.
        """
        r, nb = self.n_robots, len(self.angles)
        ranges = np.asarray(ranges, np.float32)
        if ranges.shape != (r, nb):
            raise ValueError(
                f"ranges has shape {ranges.shape}; fleet expects "
                f"({r}, {nb}) — one row per robot on the beam table")
        f = self._frame
        f[:, 0] = np.asarray(encoder_left, np.float32)
        f[:, 1] = np.asarray(encoder_right, np.float32)
        f[:, 2:2 + nb] = ranges
        f[:, 2 + nb:] = (1.0 if mask is None
                         else np.asarray(mask, np.float32))
        # jnp.asarray copies the packed buffer out of self._frame at
        # dispatch time, so the buffer is safe to refill next tick even
        # while this step is still in flight (async dispatch).
        frame = jnp.asarray(f)
        if self._sharding is not None:
            frame = jax.device_put(frame, self._sharding)
        self.state, out = self._step(self.state, frame)
        self.tick_count += 1
        if not self.pipeline:
            return self._out_dict(out, self.tick_count)
        prev = self.flush()
        self._pending = (self.tick_count, out)
        return prev

    def flush(self) -> Optional[dict]:
        """Fetch and return the in-flight tick's output (pipelined mode);
        None if nothing is pending."""
        if self._pending is None:
            return None
        t, out = self._pending
        self._pending = None
        return self._out_dict(out, t)

    def tick_raw(self, encoder_left, encoder_right, raws) -> dict:
        """Fleet update from R raw LaserScan dicts (filtered host-side)."""
        if len(raws) != self.n_robots:
            raise ValueError(f"got {len(raws)} raw scans for "
                             f"{self.n_robots} robots")
        nb = len(self.angles)
        radii = np.empty((self.n_robots, nb), np.float32)
        masks = np.empty((self.n_robots, nb), np.float32)
        for i, raw in enumerate(raws):
            _, rad, msk = sensor.filter_scan(
                np.asarray(raw["ranges"], np.float64),
                float(raw["angle_min"]), float(raw["angle_increment"]),
                float(raw.get("range_min", 0.0)),
                float(raw.get("range_max", self.cfg.sensor.max_range)),
                self.cfg.sensor, pad_to=nb)
            radii[i], masks[i] = rad, msk
        return self.tick(encoder_left, encoder_right, radii, masks)

    def _out_dict(self, out: mcl.MCLOutput, tick: int) -> dict:
        o = jax.device_get(out)  # ONE fetch for the whole fleet output
        return dict(
            tick=tick,
            exact_pose=np.round(o.exact_pose.astype(np.float64),
                                6).tolist(),
            # ExactPose.thetaQuaternion analog per robot (msg/ExactPose.msg;
            # the reference declares but never assigns it,
            # monte_carlo.cpp:995-1004).
            theta_quaternion=np.round(
                np.sin(0.5 * o.exact_pose.astype(np.float64)[..., 2]),
                6).tolist(),
            cell_pose=np.asarray(o.cell_pose).tolist(),
            confidence=np.round(o.confidence.astype(np.float64),
                                6).tolist(),
            song=np.asarray(o.song).tolist(),
            wanderer_cmd=np.asarray(o.wanderer_cmd).tolist(),
            n_injected=np.asarray(o.n_injected).tolist(),
        )

    # -- stream loop ---------------------------------------------------------

    def serve(self, lines: Iterable[str],
              out_stream: Optional[IO[str]] = None) -> int:
        """Drain a JSONL stream; returns the number of fleet ticks run."""
        out_stream = out_stream or sys.stdout

        def reply(obj):
            print(json.dumps(obj), file=out_stream, flush=True)

        def reply_tick(out):
            # Pipelined mode: the first tick has no completed predecessor.
            if out is not None:
                reply(out)

        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError as e:
                reply(dict(error=f"bad json: {e}"))
                continue
            try:
                if "cmd" in msg:
                    # Drain the in-flight tick first so replies stay in
                    # dispatch order across command boundaries.
                    reply_tick(self.flush())
                    if self._handle_cmd(msg, reply):
                        return self.tick_count
                elif "raw_scans" in msg:
                    reply_tick(self.tick_raw(msg["encoder_left"],
                                             msg["encoder_right"],
                                             msg["raw_scans"]))
                else:
                    reply_tick(self.tick(msg["encoder_left"],
                                         msg["encoder_right"],
                                         msg["ranges"], msg.get("mask")))
            except Exception as e:  # noqa: BLE001 — long-lived server:
                # survive any bad line, reply with the error instead.
                reply(dict(error=f"{type(e).__name__}: {e}"))
        reply_tick(self.flush())
        return self.tick_count

    def _handle_cmd(self, msg: dict, reply) -> bool:
        cmd = msg["cmd"]
        if cmd == "reset":
            if "robot" in msg:
                self.reset_robot(int(msg["robot"]),
                                 int(msg.get("seed", 0)))
            else:
                self.reset(int(msg.get("seed", 0)))
        elif cmd == "checkpoint":
            self.checkpoint(msg["path"])
        elif cmd == "restore":
            self.restore(msg["path"])
        elif cmd == "stats":
            reply(dict(
                tick=self.tick_count,
                n_robots=self.n_robots,
                confidence=np.round(np.asarray(
                    self.state.confidence, np.float64), 6).tolist()))
            return False
        elif cmd == "shutdown":
            reply(dict(ok=True))
            return True
        else:
            reply(dict(error=f"unknown cmd {cmd!r}"))
            return False
        reply(dict(ok=True))
        return False


class SLAMFleetServer:
    """Many live SLAM robots in one batched device step + FUSED map export.

    The multi-robot mapping story (models/mapping's log-odds fusion, the
    `mapping` preset's 8-wanderer run) in its ONLINE serving form: R
    robots, each carrying a full RBPF SLAM posterior ([R, P, H, W]
    per-particle map stacks on device), advance as ONE vmapped
    `slam.slam_step` per fleet frame.  Robots share a WORLD frame via
    their known start poses (the same convention as the offline
    multi-robot mapper); `export_map` fuses each robot's best-particle
    grid by log-odds addition (mapping.fuse_maps) — the fleet's combined
    map, downloadable mid-stream.  No reference counterpart on either
    axis (one node per robot AND no mapping at all).

    Protocol: the MCLFleetServer fleet-frame shape, with SLAM outputs
    (pose/best_pose [R][3], ess [R], mapped [R]) and the extra
    `{"cmd": "export_map", "path": p}` -> fused PGM+YAML + wall lists.
    """

    def __init__(self, cfg, angles, start_poses, seed: int = 0):
        from ..models import slam as slam_mod

        self.cfg = cfg                      # SLAMConfig
        self._slam = slam_mod
        self.angles = np.asarray(angles, np.float32)
        self._angles_dev = jnp.asarray(self.angles)
        self.start_poses = np.asarray(start_poses, np.float32)
        if self.start_poses.ndim != 2 or self.start_poses.shape[1] != 3:
            raise ValueError("start_poses must be [R, 3] (x, y, theta)")
        self.n_robots = self.start_poses.shape[0]
        nb = len(self.angles)

        def one_step(state, frame):
            return slam_mod.slam_step(
                state, frame[0], frame[1], frame[2:2 + nb],
                self._angles_dev, frame[2 + nb:], cfg)

        self._step = jax.jit(jax.vmap(one_step))
        self._frame = np.zeros((self.n_robots, 2 + 2 * nb), np.float32)
        self.tick_count = 0
        self.reset(seed)

    def _init_one(self, key, start_pose):
        return self._slam.init_slam(key, start_pose, self.cfg)

    def reset(self, seed: int = 0) -> None:
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(seed),
            jnp.arange(self.n_robots, dtype=jnp.uint32))
        self.state = jax.vmap(self._init_one)(
            keys, jnp.asarray(self.start_poses))
        self.tick_count = 0

    def reset_robot(self, robot: int, seed: int = 0) -> None:
        """Redeploy ONE robot (fresh pose anchor + empty map); the other
        robots' posteriors are untouched."""
        if not 0 <= robot < self.n_robots:
            raise ValueError(f"robot {robot} out of range "
                             f"[0, {self.n_robots})")
        fresh = self._init_one(
            jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(robot)),
            jnp.asarray(self.start_poses[robot]))
        self.state = jax.tree_util.tree_map(
            lambda batch, one: batch.at[robot].set(one), self.state, fresh)

    def checkpoint(self, path: str) -> None:
        logs.save_pytree(path, self.state)

    def restore(self, path: str) -> None:
        self.state = logs.load_pytree(path, self.state)

    def tick(self, encoder_left, encoder_right, ranges, mask=None) -> dict:
        r, nb = self.n_robots, len(self.angles)
        ranges = np.asarray(ranges, np.float32)
        if ranges.shape != (r, nb):
            raise ValueError(
                f"ranges has shape {ranges.shape}; fleet expects "
                f"({r}, {nb})")
        f = self._frame
        f[:, 0] = np.asarray(encoder_left, np.float32)
        f[:, 1] = np.asarray(encoder_right, np.float32)
        f[:, 2:2 + nb] = ranges
        f[:, 2 + nb:] = (1.0 if mask is None
                         else np.asarray(mask, np.float32))
        self.state, info = self._step(self.state, jnp.asarray(f))
        self.tick_count += 1
        pose, best, ess, mapped = jax.device_get(
            (info["pose"], info["best_pose"], info["ess"],
             info["mapped"]))
        return dict(
            tick=self.tick_count,
            pose=[[round(float(v), 6) for v in p] for p in pose],
            best_pose=[[round(float(v), 6) for v in p] for p in best],
            ess=[round(float(e), 2) for e in ess],
            mapped=[bool(m) for m in mapped])

    def fused_logodds(self) -> np.ndarray:
        """Each robot's best-particle grid, fused by log-odds addition."""
        from ..models import mapping

        best = jax.vmap(self._slam.best_map)(self.state)        # [R, H, W]
        return np.asarray(mapping.fuse_maps(best))

    def export_map(self, path: str) -> dict:
        from ..models import mapping

        lo = self.fused_logodds()
        base = path[:-5] if path.endswith(".yaml") else path
        mapping.export_learned_map(lo, self.cfg.mapping, base + ".pgm",
                                   base + ".yaml")
        cell_px = int(round(0.8 / self.cfg.mapping.resolution))
        walls = mapping.fit_walls(lo, cell_px=cell_px)
        tensor = [[[e for e in range(4) if walls[r, c, e]]
                   for c in range(walls.shape[1])]
                  for r in range(walls.shape[0])]
        return dict(ok=True, yaml=base + ".yaml", walls=tensor)

    def serve(self, lines: Iterable[str], out_stream: IO[str] = sys.stdout
              ) -> int:
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError as e:
                print(json.dumps(dict(error=f"bad json: {e}")),
                      file=out_stream, flush=True)
                continue
            if "cmd" in msg:
                cmd = msg.get("cmd")
                if cmd == "reset":
                    if "robot" in msg:
                        self.reset_robot(int(msg["robot"]),
                                         int(msg.get("seed", 0)))
                    else:
                        self.reset(int(msg.get("seed", 0)))
                    print(json.dumps(dict(ok=True)), file=out_stream,
                          flush=True)
                elif cmd == "checkpoint":
                    self.checkpoint(msg["path"])
                    print(json.dumps(dict(ok=True)), file=out_stream,
                          flush=True)
                elif cmd == "restore":
                    self.restore(msg["path"])
                    print(json.dumps(dict(ok=True)), file=out_stream,
                          flush=True)
                elif cmd == "export_map":
                    print(json.dumps(self.export_map(msg["path"])),
                          file=out_stream, flush=True)
                elif cmd == "stats":
                    print(json.dumps(dict(tick=self.tick_count,
                                          robots=self.n_robots)),
                          file=out_stream, flush=True)
                elif cmd == "shutdown":
                    print(json.dumps(dict(ok=True)), file=out_stream,
                          flush=True)
                    return self.tick_count
                else:
                    print(json.dumps(dict(error=f"unknown cmd {cmd!r}")),
                          file=out_stream, flush=True)
                continue
            try:
                out = self.tick(msg["encoder_left"], msg["encoder_right"],
                                msg["ranges"], msg.get("mask"))
                print(json.dumps(out), file=out_stream, flush=True)
            except (KeyError, ValueError) as e:
                print(json.dumps(dict(error=str(e))), file=out_stream,
                      flush=True)
        return self.tick_count
