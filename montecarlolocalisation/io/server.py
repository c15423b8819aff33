"""Online serving: the reference's live filter loop as a JSONL stream.

The reference DEPLOYS as a long-lived ROS node (monte_carlo.cpp:1153-1214):
encoder/scan callbacks feed a 10 Hz timer that updates the filter and
publishes /pose, /exact_pose, songs and wanderer service calls until a
/shutdown_driver message arrives.  This module is the accelerator
deployment surface: one process pins `MCLState` on the device, runs the
compiled `mcl_step` per input line, and emits the `MCLOutput` fields per
tick — turning the episode/replay engine into an ONLINE localizer that a
user feeds real sensor frames over stdin, a pipe, or a socket.

Protocol — one JSON object per line, one JSON object back per line:

  Sensor tick, pre-filtered (ranges aligned to the server's beam table):
    {"encoder_left": rad, "encoder_right": rad, "ranges": [...],
     "mask": [...]?}
  Sensor tick, raw LaserScan (filterLaserReadings semantics host-side):
    {"encoder_left": rad, "encoder_right": rad,
     "raw_scan": {"ranges": [...], "angle_min": a, "angle_increment": d,
                  "range_min": lo, "range_max": hi}}
  -> {"tick": i, "exact_pose": [x, y, th], "cell_pose": [row, col, o],
      "confidence": c, "song": s, "wanderer_cmd": w, "n_injected": k}
     (exact_pose/cell_pose publish the PREVIOUS tick's estimate, matching
      the reference's publish-then-update tick order,
      monte_carlo.cpp:1082-1083.)

  Commands:
    {"cmd": "reset", "seed": n?}            -> {"ok": true}
    {"cmd": "checkpoint", "path": "..."}    -> {"ok": true}  (pytree save)
    {"cmd": "restore", "path": "..."}       -> {"ok": true}
    {"cmd": "stats"}                        -> {"tick": i, "confidence": c}
    {"cmd": "shutdown"}                     -> {"ok": true} + loop exits
      (the /shutdown_driver analog, monte_carlo.cpp:248-251)
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import IO, Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FilterConfig, KLDConfig
from ..maps.grid import MazeMap
from ..models import filter as mcl
from ..models import kld as kldmod
from ..models import resample, sensor
from . import logs


class MCLServer:
    """A live filter: device-resident state + one compiled step.

    The beam table is FIXED at construction (the jit signature needs a
    static beam count, exactly as the reference fixes its LIDAR): raw
    scans are filtered and padded host-side to `len(angles)` lanes.

    `adapt=(n_min, n_max)` enables the ELASTIC PARTICLE BUDGET (no
    reference counterpart — its N=1500 is a compile-time constant,
    monte_carlo.cpp:84): while confidently tracking, the budget halves
    every `adapt_patience` consecutive confident ticks down to n_min; the
    moment the filter goes lost (the hysteresis "lost" song fires, i.e.
    the kidnap detector) it jumps straight back to n_max for global
    re-localization.  Each size is one compiled step (sizes are halvings
    of n_max — at most log2(n_max/n_min) signatures, compiled lazily);
    the resize itself is a systematic redraw of the current posterior
    (models/resample.resize_particles), so no information is discarded
    beyond the sampling itself.

    `adapt_mode="kld"` replaces the confidence-patience shrink rule with
    Fox's KLD-sampling bound (models/kld.py; ROS AMCL's adaptive sizing):
    every tick the step also emits the statistically REQUIRED count for
    the posterior's current bin spread, and the policy snaps the budget to
    the smallest lattice size covering it — growing immediately, shrinking
    one halving after `adapt_patience` agreeing ticks.  The lost-song snap
    to n_max is kept as a backstop in both modes.
    """

    def __init__(self, m: MazeMap, cfg: FilterConfig, angles,
                 seed: int = 0, adapt=None, adapt_patience: int = 20,
                 adapt_mode: str = "patience",
                 kld: Optional[KLDConfig] = None):
        self.m = m
        self.cfg = cfg
        self.angles = np.asarray(angles, np.float32)
        self._angles_dev = jnp.asarray(self.angles)
        self.tick_count = 0
        self.adapt = None if adapt is None else (int(adapt[0]),
                                                 int(adapt[1]))
        self.adapt_patience = adapt_patience
        self._confident_run = 0
        if self.adapt is not None and self.adapt[0] > self.adapt[1]:
            raise ValueError("adapt=(n_min, n_max) needs n_min <= n_max")
        if adapt_mode not in ("patience", "kld"):
            raise ValueError(f"unknown adapt_mode {adapt_mode!r}")
        self.adapt_mode = adapt_mode
        self.kld = kld or KLDConfig()
        self._kld_on = self.adapt is not None and adapt_mode == "kld"

        nb = len(self.angles)

        def step(state, frame):
            # One packed [2 + 2B] f32 upload per tick: encoders, ranges,
            # mask.  Separate uploads would each pay a host->device
            # transfer.
            sc = sensor.Scan(angles=self._angles_dev,
                             ranges=frame[2:2 + nb],
                             mask=frame[2 + nb:] > 0.5)
            new_state, out = mcl.mcl_step(state, frame[0], frame[1], sc,
                                          m, cfg)
            # KLD mode: the required-count statistic rides the SAME step
            # program and the same output fetch (a separate jit would pay
            # an extra host<->device round trip per tick).
            tgt = (kldmod.particle_target(new_state.particles, m, self.kld)
                   if self._kld_on else jnp.float32(0.0))
            return new_state, out, tgt

        self._step = jax.jit(step)
        self._resize = jax.jit(
            resample.resize_particles, static_argnames="n_new")
        self._frame = np.zeros(2 + 2 * nb, np.float32)
        self.reset(seed)

    @property
    def num_particles(self) -> int:
        return int(self.state.particles.shape[0])

    def _set_particle_count(self, n_new: int) -> None:
        """Resize the live posterior to n_new particles (systematic
        redraw); jit caches one resize per (n_from, n_new) signature and
        one step per n_new."""
        if n_new == self.num_particles:
            return
        key, k_resize = jax.random.split(self.state.key)
        parts, w = self._resize(k_resize, self.state.particles,
                                self.state.weights, n_new=n_new)
        self.state = dataclasses.replace(
            self.state, particles=parts, weights=w, key=key)

    def _lattice_size(self, target: float) -> int:
        """Smallest halving of n_max covering `target` (clamped to adapt
        bounds) — sizes off the lattice would each compile a new step."""
        n_min, n_max = self.adapt
        t = min(max(target, float(n_min)), float(n_max))
        size = n_max
        while size // 2 >= t and size // 2 >= n_min:
            size //= 2
        return size

    def _maybe_adapt(self, out: dict, kld_target: float = 0.0) -> None:
        if self.adapt is None:
            return
        n_min, n_max = self.adapt
        n = self.num_particles
        if out["song"] == self.cfg.hysteresis.song_lost:
            # Kidnapped / lost: full budget for global re-localization.
            self._confident_run = 0
            if n < n_max:
                self._set_particle_count(n_max)
            return
        if self.adapt_mode == "kld":
            want = self._lattice_size(kld_target)
            if want > n:
                # Under-sampled for the posterior's spread: grow NOW
                # (delay here is lost robustness; AMCL grows within the
                # resampling pass for the same reason).
                self._confident_run = 0
                self._set_particle_count(want)
            elif want < n:
                # Shrink one halving at a time after `adapt_patience`
                # consecutive agreeing ticks — hysteresis against
                # bin-count noise flapping between jit signatures.
                self._confident_run += 1
                if self._confident_run >= self.adapt_patience:
                    self._set_particle_count(n // 2)
                    self._confident_run = 0
            else:
                self._confident_run = 0
            return
        confident = (out["confidence"]
                     >= self.cfg.hysteresis.conf_confident_threshold)
        self._confident_run = self._confident_run + 1 if confident else 0
        if self._confident_run >= self.adapt_patience and n > n_min:
            self._set_particle_count(max(n // 2, n_min))
            self._confident_run = 0

    # -- lifecycle ---------------------------------------------------------

    def reset(self, seed: int = 0) -> None:
        self.state = mcl.init_state(jax.random.PRNGKey(seed), self.m,
                                    self.cfg)
        self.tick_count = 0
        self._confident_run = 0
        if self.adapt is not None:
            # Global localization starts at the full budget.
            self._set_particle_count(self.adapt[1])

    def checkpoint(self, path: str) -> None:
        logs.save_pytree(path, self.state)

    def restore(self, path: str) -> None:
        self.state = logs.load_pytree(path, self.state)

    # -- ticks -------------------------------------------------------------

    def tick(self, encoder_left: float, encoder_right: float, ranges,
             mask=None) -> dict:
        """One filter update from a PRE-FILTERED scan on the beam table."""
        ranges = np.asarray(ranges, np.float32)
        if ranges.shape != self.angles.shape:
            raise ValueError(
                f"ranges has shape {ranges.shape}, beam table has "
                f"{self.angles.shape} — pass a raw_scan or match "
                "the table")
        nb = len(self.angles)
        f = self._frame
        f[0], f[1] = encoder_left, encoder_right
        f[2:2 + nb] = ranges
        f[2 + nb:] = 1.0 if mask is None else np.asarray(mask, np.float32)
        n_used = self.num_particles
        self.state, out, tgt = self._step(self.state, f)
        self.tick_count += 1
        # ONE fetch for output + KLD scalar (each extra device_get pays a
        # full host<->device round trip).
        o, tgt = jax.device_get((out, tgt))
        d = self._out_dict(o)
        if self.adapt is not None:
            d["particles"] = n_used
        if self._kld_on:
            d["kld_target"] = round(float(tgt), 1)
        self._maybe_adapt(d, kld_target=float(tgt))
        return d

    def tick_raw(self, encoder_left: float, encoder_right: float,
                 raw: dict) -> dict:
        """One filter update from a raw LaserScan message dict."""
        angles, radii, mask = sensor.filter_scan(
            np.asarray(raw["ranges"], np.float64),
            float(raw["angle_min"]), float(raw["angle_increment"]),
            float(raw.get("range_min", 0.0)),
            float(raw.get("range_max", self.cfg.sensor.max_range)),
            self.cfg.sensor, pad_to=len(self.angles))
        # The dropped-shifts-comb quirk means the surviving beam angles can
        # drift from the server table; the filter evaluates AT the served
        # table, so re-use the table and feed the filtered radii + mask.
        del angles
        return self.tick(encoder_left, encoder_right, radii, mask)

    def _out_dict(self, o: mcl.MCLOutput) -> dict:
        # `o` is HOST data: tick() fetches the whole (output, kld) pytree
        # in one device_get — per-field fetches would each pay a full
        # host<->device round trip.
        return dict(
            tick=self.tick_count,
            exact_pose=[round(float(v), 6) for v in o.exact_pose],
            # ExactPose.thetaQuaternion analog (msg/ExactPose.msg) —
            # populated here; the reference declares but never assigns it
            # (monte_carlo.cpp:995-1004).  utils/angles.yaw_to_quaternion_z.
            theta_quaternion=round(
                float(np.sin(0.5 * float(o.exact_pose[2]))), 6),
            cell_pose=[int(v) for v in o.cell_pose],
            confidence=round(float(o.confidence), 6),
            song=int(o.song),
            wanderer_cmd=int(o.wanderer_cmd),
            n_injected=int(o.n_injected),
        )

    # -- stream loop -------------------------------------------------------

    def serve(self, lines: Iterable[str],
              out_stream: Optional[IO[str]] = None) -> int:
        """Drain a JSONL stream; returns the number of sensor ticks run."""
        out_stream = out_stream or sys.stdout
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
            try:
                if "cmd" in msg:
                    stop = self._handle_cmd(msg, out_stream)
                    if stop:
                        break
                elif "raw_scan" in msg:
                    print(json.dumps(self.tick_raw(
                        msg["encoder_left"], msg["encoder_right"],
                        msg["raw_scan"])), file=out_stream, flush=True)
                else:
                    print(json.dumps(self.tick(
                        msg["encoder_left"], msg["encoder_right"],
                        msg["ranges"], msg.get("mask"))),
                        file=out_stream, flush=True)
            except Exception as e:  # noqa: BLE001 — a long-lived server
                # must survive any bad line (missing keys, shape errors,
                # unreadable checkpoint paths, corrupt .npz, ...): reply
                # with the error instead of dropping the filter session.
                print(json.dumps(dict(
                    error=f"{type(e).__name__}: {e}")), file=out_stream,
                    flush=True)
        return self.tick_count

    def _handle_cmd(self, msg: dict, out_stream: IO[str]) -> bool:
        cmd = msg["cmd"]
        if cmd == "reset":
            self.reset(int(msg.get("seed", 0)))
        elif cmd == "checkpoint":
            self.checkpoint(msg["path"])
        elif cmd == "restore":
            self.restore(msg["path"])
        elif cmd == "stats":
            print(json.dumps(dict(
                tick=self.tick_count,
                confidence=round(float(self.state.confidence), 6))),
                file=out_stream, flush=True)
            return False
        elif cmd == "shutdown":
            print(json.dumps(dict(ok=True)), file=out_stream, flush=True)
            return True
        else:
            print(json.dumps(dict(error=f"unknown cmd {cmd!r}")),
                  file=out_stream, flush=True)
            return False
        print(json.dumps(dict(ok=True)), file=out_stream, flush=True)
        return False


class SLAMServer:
    """Live SLAM: the serve surface for robots WITHOUT a map.

    Same JSONL tick protocol as MCLServer (the beam table fixed at
    construction), but the device-resident state is a `slam.SLAMState` —
    joint (pose, per-particle map) posterior; each input frame runs one
    compiled `slam.slam_step`.  No reference counterpart at all: the
    reference's live node REQUIRES the hand-written map at startup
    (monte_carlo.cpp:82-84,1187-1196); this is the deployment form of
    the slam preset's offline loop.

    Extra commands beyond the MCLServer set:

      {"cmd": "export_map", "path": "out"}   -> {"ok": true, "yaml": ...}
        writes the current best-particle map as ROS map_server PGM+YAML
        (mapping.export_learned_map) and the fitted wall tensor as
        map.txt-format JSON rows in the reply.
    """

    def __init__(self, cfg, angles, start_pose=(1.25, 1.25, 0.0),
                 seed: int = 0, replicas: int = 1):
        from ..models import slam as slam_mod

        self.cfg = cfg                     # SLAMConfig
        self.angles = np.asarray(angles, np.float32)
        self._angles_dev = jnp.asarray(self.angles)
        self.start_pose = tuple(float(v) for v in start_pose)
        self.tick_count = 0
        self._slam = slam_mod
        # `replicas` > 1: K independent RNG replicas advance on every
        # frame (one vmapped step) and the outputs report the replica
        # with the highest accumulated log evidence — the live form of
        # slam.run_slam_replicas (seed-mislock insurance while serving).
        self.replicas = int(replicas)
        nb = len(self.angles)

        def one_step(state, frame):
            return slam_mod.slam_step(
                state, frame[0], frame[1], frame[2:2 + nb],
                self._angles_dev, frame[2 + nb:], cfg)

        self._step = jax.jit(
            one_step if self.replicas == 1
            else jax.vmap(one_step, in_axes=(0, None)))
        self._frame = np.zeros(2 + 2 * nb, np.float32)
        self.reset(seed)

    def reset(self, seed: int = 0) -> None:
        if self.replicas == 1:
            self.state = self._slam.init_slam(
                jax.random.PRNGKey(seed), self.start_pose, self.cfg)
        else:
            keys = jax.vmap(jax.random.fold_in, (None, 0))(
                jax.random.PRNGKey(seed),
                jnp.arange(self.replicas, dtype=jnp.uint32))
            self.state = jax.vmap(
                lambda k: self._slam.init_slam(k, self.start_pose,
                                               self.cfg))(keys)
        self.tick_count = 0

    def checkpoint(self, path: str) -> None:
        logs.save_pytree(path, self.state)

    def restore(self, path: str) -> None:
        self.state = logs.load_pytree(path, self.state)

    def tick(self, encoder_left: float, encoder_right: float, ranges,
             mask=None) -> dict:
        ranges = np.asarray(ranges, np.float32)
        if ranges.shape != self.angles.shape:
            raise ValueError(
                f"ranges has shape {ranges.shape}, beam table has "
                f"{self.angles.shape}")
        nb = len(self.angles)
        f = self._frame
        f[0], f[1] = encoder_left, encoder_right
        f[2:2 + nb] = ranges
        f[2 + nb:] = 1.0 if mask is None else np.asarray(mask, np.float32)
        self.state, info = self._step(self.state, f)
        self.tick_count += 1
        pose, best, ess, mapped, ev = jax.device_get(
            (info["pose"], info["best_pose"], info["ess"],
             info["mapped"], self.state.log_evidence))
        if self.replicas > 1:
            pick = int(np.argmax(ev))
            out = dict(
                tick=self.tick_count,
                pose=[round(float(v), 6) for v in pose[pick]],
                best_pose=[round(float(v), 6) for v in best[pick]],
                ess=round(float(ess[pick]), 2),
                mapped=bool(mapped[pick]),
                replica=pick,
                log_evidence=[round(float(e), 2) for e in ev])
            return out
        return dict(
            tick=self.tick_count,
            pose=[round(float(v), 6) for v in pose],
            best_pose=[round(float(v), 6) for v in best],
            ess=round(float(ess), 2),
            mapped=bool(mapped))

    def tick_raw(self, encoder_left: float, encoder_right: float,
                 raw: dict) -> dict:
        _, radii, mask = sensor.filter_scan(
            np.asarray(raw["ranges"], np.float64),
            float(raw["angle_min"]), float(raw["angle_increment"]),
            float(raw.get("range_min", 0.0)),
            float(raw.get("range_max", self.cfg.sensor.max_range)),
            self.cfg.sensor, pad_to=len(self.angles))
        return self.tick(encoder_left, encoder_right, radii, mask)

    def export_map(self, path: str) -> dict:
        """Write the best-particle map as map_server PGM+YAML; return the
        fitted wall tensor (row lists of per-cell wall-index lists)."""
        from ..models import mapping

        st = self.state
        if self.replicas > 1:
            pick = int(np.argmax(np.asarray(st.log_evidence)))
            st = jax.tree_util.tree_map(lambda x: x[pick], st)
        lo = np.asarray(self._slam.best_map(st))
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
              ) -> None:
        """JSONL loop (same shape as MCLServer.serve)."""
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
                if not self._handle_cmd(msg, out_stream):
                    return
                continue
            try:
                if "raw_scan" in msg:
                    out = self.tick_raw(msg["encoder_left"],
                                        msg["encoder_right"],
                                        msg["raw_scan"])
                else:
                    out = self.tick(msg["encoder_left"],
                                    msg["encoder_right"], msg["ranges"],
                                    msg.get("mask"))
                print(json.dumps(out), file=out_stream, flush=True)
            except (KeyError, ValueError) as e:
                print(json.dumps(dict(error=str(e))), file=out_stream,
                      flush=True)

    def _handle_cmd(self, msg: dict, out_stream: IO[str]) -> bool:
        cmd = msg.get("cmd")
        if cmd == "reset":
            self.reset(int(msg.get("seed", 0)))
            print(json.dumps(dict(ok=True)), file=out_stream, flush=True)
        elif cmd == "checkpoint":
            self.checkpoint(msg["path"])
            print(json.dumps(dict(ok=True)), file=out_stream, flush=True)
        elif cmd == "restore":
            self.restore(msg["path"])
            print(json.dumps(dict(ok=True)), file=out_stream, flush=True)
        elif cmd == "export_map":
            print(json.dumps(self.export_map(msg["path"])),
                  file=out_stream, flush=True)
        elif cmd == "stats":
            print(json.dumps(dict(tick=self.tick_count,
                                  particles=int(
                                      self.state.poses.shape[0]))),
                  file=out_stream, flush=True)
        elif cmd == "shutdown":
            print(json.dumps(dict(ok=True)), file=out_stream, flush=True)
            return False
        else:
            print(json.dumps(dict(error=f"unknown cmd {cmd!r}")),
                  file=out_stream, flush=True)
        return True
