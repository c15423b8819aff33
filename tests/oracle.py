"""C++-faithful NumPy oracle of the reference MCL math (SURVEY.md §4).

Sequential, loop-by-loop transcription of the reference SEMANTICS (not
code): Gaussian LUT with linear interpolation (monte_carlo.cpp:139-177),
worldToMap truncation, 9-point validity stencil, 0.1 m fixed ray march,
beam-angle negation, likelihood mixture, and the rot1-trans-rot2 odometry
decomposition.  Used by test_parity to verify the vectorized JAX filter
reproduces the reference numerics on identical inputs.
"""
from __future__ import annotations

import math

import numpy as np


class GaussianLUT:
    """monte_carlo.cpp:139-177: N(0, sigma) pdf table, 1e-4 resolution,
    support [0, 1.1], linear interpolation, 0 outside."""

    def __init__(self, sigma=0.1, resolution=1e-4, max_diff=1.1):
        self.resolution = resolution
        self.max_diff = max_diff
        n = int(max_diff / resolution) + 1
        diffs = np.arange(n) * resolution
        denom = sigma * math.sqrt(2.0 * math.pi)
        self.table = np.exp(-(diffs**2) / (2 * sigma * sigma)) / denom

    def get(self, diff):
        if diff < 0.0 or diff > self.max_diff:
            return 0.0
        f = diff / self.resolution
        i = int(f)
        if i + 1 < len(self.table):
            w = f - i
            return (1.0 - w) * self.table[i] + w * self.table[i + 1]
        return self.table[i]


class Oracle:
    def __init__(self, occ: np.ndarray, resolution=0.1, origin=(0.0, 0.0),
                 sigma=0.1, w_hit=0.8, w_rand=0.2, max_range=1.0,
                 laser_offset=0.1):
        self.occ = np.asarray(occ, dtype=bool)
        self.res = resolution
        self.ox, self.oy = origin
        self.lut = GaussianLUT(sigma)
        self.w_hit, self.w_rand = w_hit, w_rand
        self.max_range = max_range
        self.laser_offset = laser_offset
        self.h, self.w = occ.shape

    # -- map access (monte_carlo.cpp:298-349) --
    def world_to_map(self, wx, wy):
        mx = int((wx - self.ox) / self.res)   # static_cast<int> truncation
        my = int((wy - self.oy) / self.res)
        ok = 0 <= mx < self.w and 0 <= my < self.h
        return mx, my, ok

    def is_occupied(self, wx, wy):
        mx, my, ok = self.world_to_map(wx, wy)
        return ok and bool(self.occ[my, mx])

    def is_inside(self, wx, wy):
        return (self.ox <= wx < self.ox + self.w * self.res
                and self.oy <= wy < self.oy + self.h * self.res)

    def is_valid_pos(self, wx, wy, off=0.1):
        if not self.is_inside(wx, wy):
            return False
        for dx, dy in ((0, 0), (off, 0), (0, off), (-off, 0), (0, -off),
                       (off, off), (off, -off), (-off, off), (-off, -off)):
            if self.is_occupied(wx + dx, wy + dy):
                return False
        return True

    # -- ray march (monte_carlo.cpp:350-390) --
    def raycast(self, x, y, angle_rad, max_range=None):
        max_range = self.max_range if max_range is None else max_range
        dx, dy = math.cos(angle_rad), math.sin(angle_rad)
        r = 0.0
        while r < max_range:
            mx, my, ok = self.world_to_map(x + r * dx, y + r * dy)
            if not ok:
                break
            if self.occ[my, mx]:
                return r
            r += 0.1
        return max_range

    def raycast_exact(self, x, y, angle_rad, max_range=None):
        """Vectorized float64 Amanatides-Woo traversal: distance to the
        face of the first occupied cell along each ray (max_range when
        none is entered before max_range; 0 in an occupied origin cell;
        max_range from an out-of-map origin).  The geometry the exact
        casters (models/raycast "dda"/"analytic") compute in float32."""
        max_range = self.max_range if max_range is None else max_range
        x, y, a = np.broadcast_arrays(*(np.asarray(v, np.float64)
                                        for v in (x, y, angle_rad)))
        dx, dy = np.cos(a), np.sin(a)
        gx, gy = (x - self.ox) / self.res, (y - self.oy) / self.res
        ix, iy = np.floor(gx).astype(np.int64), np.floor(gy).astype(np.int64)
        sx, sy = np.where(dx >= 0, 1, -1), np.where(dy >= 0, 1, -1)
        with np.errstate(divide="ignore", invalid="ignore"):
            tdx = np.where(dx != 0, self.res / np.abs(dx), np.inf)
            tdy = np.where(dy != 0, self.res / np.abs(dy), np.inf)
            tx = np.where(dx != 0, np.where(dx >= 0, ix + 1 - gx, gx - ix)
                          * tdx, np.inf)
            ty = np.where(dy != 0, np.where(dy >= 0, iy + 1 - gy, gy - iy)
                          * tdy, np.inf)

        def inb(i, j):
            return (i >= 0) & (j >= 0) & (i < self.w) & (j < self.h)

        def occ(i, j):
            return inb(i, j) & self.occ[np.clip(j, 0, self.h - 1),
                                        np.clip(i, 0, self.w - 1)]

        dist = np.full(x.shape, float(max_range))
        done = ~inb(ix, iy)
        start = occ(ix, iy) & ~done
        dist[start] = 0.0
        done |= start
        for _ in range(int(math.ceil(max_range / self.res)) * 2 + 2):
            take_x = tx < ty
            t = np.where(take_x, tx, ty)
            ix = np.where(take_x, ix + sx, ix)
            iy = np.where(take_x, iy, iy + sy)
            tx = np.where(take_x, tx + tdx, tx)
            ty = np.where(take_x, ty, ty + tdy)
            out = ~inb(ix, iy) | (t >= max_range)
            hit = ~done & ~out & occ(ix, iy)
            dist = np.where(hit, t, dist)
            done |= hit | out
        return dist

    # -- computeWeight (monte_carlo.cpp:623-682) --
    def compute_weight(self, particle, beam_angles, beam_ranges):
        x, y, th = particle
        if not self.is_valid_pos(x, y):
            return 0.0
        ox = x + self.laser_offset * math.cos(th)
        oy = y + self.laser_offset * math.sin(th)
        prob = 0.0
        for a, obs in zip(beam_angles, beam_ranges):
            # angle = -(beam angle in deg); absolute = yaw + offset (:653).
            ray = th - a
            expected = self.raycast(ox, oy, ray)
            diff = abs(obs - expected)
            prob += self.w_hit * self.lut.get(diff)
            prob += self.w_rand * (1.0 if abs(obs - self.max_range) < 0.01
                                   else 0.0)
        return prob

    def compute_weights(self, particles, beam_angles, beam_ranges):
        return np.array([
            self.compute_weight(p, beam_angles, beam_ranges)
            for p in particles])


def diff_drive_decompose(prev, enc_prev, enc_cur, wheel_size=0.062,
                         wheel_space=0.265):
    """diffDriveModel + decomposition (monte_carlo.cpp:695-739), noise-free.

    prev: (x, y, theta); enc_*: (left, right) radians.
    Returns (new_pose, rot1, trans, rot2).
    """
    x, y, th = prev
    d_left = (enc_cur[0] - enc_prev[0]) * wheel_size * 0.5
    d_right = (enc_cur[1] - enc_prev[1]) * wheel_size * 0.5
    d_center = 0.5 * (d_left + d_right)
    dth = (d_left - d_right) / wheel_space
    nth = th + dth
    nx = x + d_center * math.cos(th + 0.5 * dth)
    ny = y + d_center * math.sin(th + 0.5 * dth)
    nth = math.atan2(math.sin(nth), math.cos(nth))
    rot1 = math.atan2(ny - y, nx - x) - th
    trans = math.hypot(nx - x, ny - y)
    rot2 = nth - th - rot1
    return (nx, ny, nth), rot1, trans, rot2


def _lower_bound(cdf, r):
    """std::lower_bound on the weight CDF (monte_carlo.cpp:513-516)."""
    i = int(np.searchsorted(cdf, r, side="left"))
    return min(i, len(cdf) - 1)


class OracleFilter:
    """Full-tick sequential reference filter: executeParticleFilter
    (monte_carlo.cpp:1025-1098) transcribed loop-by-loop on top of the
    per-stage Oracle above.

    Tick order (the reference's): hysteresis on the previous confidence
    (:1030-1081), publish previous best pose (:1083), diff-drive odometry
    + ONE shared noisy (rot1, trans, rot2) triple (:695-755 — the
    shared-noise quirk), propagation, per-tick beam weights + multinomial
    resampling with adaptive injection (:457-561), k-means confidence
    with the post-hysteresis threshold (:802-949).

    RNG draws are independent of the JAX filter's (threefry vs PCG64) —
    test_parity's episode-level check compares POSTERIOR STATISTICS
    (cloud mean / spread / confidence trajectories) under matched noise
    regimes, which is exactly what survives a change of RNG stream.
    """

    # Reference constants (same citations as config.py's defaults).
    ALPHAS = (0.001, 0.001, 0.0001, 0.0001)       # monte_carlo.cpp:1198
    LOST = dict(max_injection=200, alpha_slow=0.05, alpha_fast=0.5,
                jitter_xy=0.05, jitter_theta=math.pi / 12.0)   # :474-476,537-539
    CONF = dict(max_injection=50, alpha_slow=0.02, alpha_fast=2.0,
                jitter_xy=0.01, jitter_theta=0.0)              # :479-481,545-547
    NEAR_RADIUS = 0.4                              # :931

    def __init__(self, oracle: Oracle, n: int, seed: int, n_rows=6,
                 n_cols=6, cell_meters=0.8, start_pose=None,
                 sigma_xy=0.03, sigma_theta=0.05):
        self.o = oracle
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.n_rows, self.n_cols, self.cell = n_rows, n_cols, cell_meters
        self.odom = (0.0, 0.0, 0.0)
        self.enc = (0.0, 0.0)
        self.w_slow = self.w_fast = 0.0
        self.confidence = 0.0
        self.was_lost = False
        self.cluster_thr, self.conf_thr = 0.1, 0.80        # :78,:80
        self.best = np.array([-1.0, -1.0, -1.0])
        if start_pose is None:
            self.particles = self.sample_uniform(n)
        else:
            # Tracking start (mirrors filter.init_tracking_state).
            x, y, th = start_pose
            self.particles = np.stack([
                x + sigma_xy * self.rng.standard_normal(n),
                y + sigma_xy * self.rng.standard_normal(n),
                th + sigma_theta * self.rng.standard_normal(n)], axis=-1)
            self.confidence = 1.0
            self.cluster_thr, self.conf_thr = 0.4, 0.5     # :1048,:1051
            self.best = np.array([x, y, th])

    # -- sampleParticles (monte_carlo.cpp:415-450) --
    def sample_uniform(self, n):
        rows = self.rng.integers(0, self.n_rows, n)
        cols = self.rng.integers(0, self.n_cols, n)
        cx = cols * self.cell + 0.5 * self.cell
        cy = rows * self.cell + 0.5 * self.cell
        x = cx + self.rng.uniform(-0.2, 0.2, n) + 0.05     # :434,:444
        y = cy + self.rng.uniform(-0.2, 0.2, n) + 0.05
        yaw = self.rng.uniform(-math.pi, math.pi, n)
        return np.stack([x, y, yaw], axis=-1)

    def _hysteresis(self):
        """monte_carlo.cpp:1030-1081 on the PREVIOUS tick's confidence."""
        conf = self.confidence
        lost_cond = conf < self.conf_thr
        conf_cond = conf > self.conf_thr
        to_lost = lost_cond and not self.was_lost
        recovered = conf_cond and self.was_lost
        if to_lost:
            self.cluster_thr, self.conf_thr = 0.1, 0.8     # :1036-1037
            self.was_lost = True
        elif conf_cond:
            self.cluster_thr, self.conf_thr = 0.4, 0.5     # :1048,:1051
            if recovered:
                self.was_lost = False

    def tick(self, enc_l, enc_r, beam_angles, beam_ranges):
        """One 10 Hz tick; returns dict(mean, spread, confidence, best)."""
        self._hysteresis()
        published = self.best.copy()

        # Odometry + ONE shared noise triple (:695-755).
        new_odom, rot1, trans, rot2 = diff_drive_decompose(
            self.odom, self.enc, (enc_l, enc_r))
        a1, a2, a3, a4 = self.ALPHAS
        var_r1 = a1 * abs(rot1) + a2 * trans
        var_tr = a3 * trans + a4 * (abs(rot1) + abs(rot2))
        var_r2 = a1 * abs(rot2) + a2 * trans
        n_rot1 = rot1 + math.sqrt(var_r1) * self.rng.standard_normal()
        n_trans = trans + math.sqrt(var_tr) * self.rng.standard_normal()
        n_rot2 = rot2 + math.sqrt(var_r2) * self.rng.standard_normal()
        self.odom, self.enc = new_odom, (enc_l, enc_r)
        p = self.particles
        moved = p[:, 2] + n_rot1
        self.particles = np.stack([
            p[:, 0] + n_trans * np.cos(moved),
            p[:, 1] + n_trans * np.sin(moved),
            p[:, 2] + n_rot1 + n_rot2], axis=-1)

        # Weights + resample every tick (:457-561).
        w = self.o.compute_weights(self.particles, beam_angles, beam_ranges)
        n_injected = self._resample(w)

        # k-means confidence with the post-hysteresis threshold (:802-949).
        self.confidence, self.best = self._cluster_confidence()
        xy = self.particles[:, :2]
        mean = xy.mean(axis=0)
        spread = float(np.sqrt(((xy - mean) ** 2).sum(axis=1).mean()))
        return dict(mean=mean, spread=spread, confidence=self.confidence,
                    best=self.best.copy(), published=published,
                    n_injected=n_injected)

    def _resample(self, w):
        reg = self.LOST if self.was_lost else self.CONF
        n = self.n
        total = float(np.sum(w))
        w_avg = total / n
        self.w_slow += reg["alpha_slow"] * (w_avg - self.w_slow)
        self.w_fast += reg["alpha_fast"] * (w_avg - self.w_fast)
        p_inject = (max(0.0, 1.0 - self.w_fast / self.w_slow)
                    if self.w_slow > 0.0 else 0.0)
        norm = w / total if total > 0.0 else np.full(n, 1.0 / n)
        cdf = np.cumsum(norm)
        out = np.empty_like(self.particles)
        injected = 0
        jxy, jth = reg["jitter_xy"], reg["jitter_theta"]
        for k in range(n):
            r = self.rng.random()     # ONE r decides both (:513-528)
            if r < p_inject and injected < reg["max_injection"]:
                out[k] = self.sample_uniform(1)[0]
                injected += 1
            else:
                src = self.particles[_lower_bound(cdf, r)]
                th = src[2] + self.rng.uniform(-jth, jth)
                out[k] = (src[0] + self.rng.uniform(-jxy, jxy),
                          src[1] + self.rng.uniform(-jxy, jxy),
                          math.atan2(math.sin(th), math.cos(th)))  # :549
        self.particles = out
        return injected

    def _cluster_confidence(self, k=3, max_iters=20):
        """kMeansClustering + countParticlesNearCluster (:802-949)."""
        xy = self.particles[:, :2]
        n = self.n
        centers = xy[self.rng.integers(0, n, k)].copy()
        assign = np.zeros(n, np.int64)
        for _ in range(max_iters):
            d = ((xy[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            new_assign = np.argmin(d, axis=1)
            if np.array_equal(new_assign, assign):
                break                  # exit BEFORE the update (:841-844)
            assign = new_assign
            for i in range(k):
                m = assign == i
                if m.any():
                    centers[i] = xy[m].mean(axis=0)
                else:                                       # :861-864
                    centers[i] = xy[self.rng.integers(0, n)]
        counts = np.bincount(assign, minlength=k)
        best = int(np.argmax(counts))   # uniform post-resample weights
        member = assign == best
        cx, cy = centers[best]
        theta = math.atan2(np.sin(self.particles[member, 2]).sum(),
                           np.cos(self.particles[member, 2]).sum())
        d2 = ((xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2)
        ratio = float((d2 <= self.NEAR_RADIUS ** 2).mean())
        if ratio > self.conf_thr:
            return ratio, np.array([cx, cy, theta])
        return ratio, np.array([-1.0, -1.0, -1.0])
