"""Typed configuration for the JAX Monte Carlo localization engine.

Every constant that is hard-coded somewhere in the reference stack
(Bright8787/MonteCarloLocalisation, mounted at /root/reference) is captured
here as a frozen dataclass field whose default is the reference value, with a
file:line citation so parity can be audited.  Configs are hashable and are
closed over by jit-compiled functions (they are static, never traced).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# --------------------------------------------------------------------------
# Wall / direction conventions (reference: msg/Cell.msg, msg/Pose.msg)
# --------------------------------------------------------------------------
WALL_RIGHT, WALL_TOP, WALL_LEFT, WALL_BOTTOM = 0, 1, 2, 3
DIR_RIGHT, DIR_UP, DIR_LEFT, DIR_DOWN = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Maze raster geometry (reference: src/publish_map_rviz.cpp:272-276)."""

    cell_px: int = 8              # CELL_SIZE: pixels per maze cell side
    cell_meters: float = 0.8      # CELL_METERS: maze cell side in meters
    wall_occupied: int = 100      # WALL_OCCUPIED
    free_space: int = 0           # FREE_SPACE
    occupied_threshold: int = 50  # isOccupied: cell value > 50 (monte_carlo.cpp:348)
    origin_x: float = 0.0         # OccupancyGrid origin (publish_map_rviz.cpp:429)
    origin_y: float = 0.0

    @property
    def resolution(self) -> float:
        """Meters per pixel (0.8 / 8 = 0.1)."""
        return self.cell_meters / self.cell_px


@dataclasses.dataclass(frozen=True)
class SensorModelConfig:
    """Beam likelihood model (reference: src/monte_carlo.cpp:623-682,139-181)."""

    w_hit: float = 0.8            # monte_carlo.cpp:180
    w_rand: float = 0.2           # monte_carlo.cpp:181
    sigma: float = 0.1            # Gaussian sensor noise (monte_carlo.cpp:628, LUT :176)
    max_range: float = 1.0        # max_laser_range (monte_carlo.cpp:629)
    rand_window: float = 0.01     # |obs - max_range| < 0.01 -> random hit (:672)
    gauss_max_diff: float = 1.1   # LUT support [0, 1.1]; 0 outside (:142,155)
    laser_offset: float = 0.1     # LIDAR mount offset along heading (:631,644-645)
    invalid_beam_range: float = 1.05  # NaN/Inf replacement radius (:263)
    angle_crop_deg: float = 120.0 # filterAngles(-120, 120) (:635)
    beam_skip: int = 20           # every 20th filtered beam (:650)
    ray_step: float = 0.1         # fixed ray-march step (:370)
    negate_beam_angle: bool = True  # angle = -(beam angle) (:653)
    # "fixed" = reference 0.1 m stepping; "dda" = exact grid traversal.
    ray_mode: str = "fixed"
    # Map-lookup implementation: "gather" (XLA gather), "bits" (packed
    # select chains over the static raster, ops/bitlookup), "onehot"
    # (one-hot contraction, for traced maps), or "auto"
    # (sensor.resolve_lookup_mode: the same choice on every platform).
    lookup_mode: str = "auto"
    # Beam combination: "sum" (the reference ADDS per-beam probabilities,
    # monte_carlo.cpp:665-672) or "log" (product of per-beam likelihoods via
    # summed logs — the textbook beam model; non-parity opt-in).  Measured
    # tradeoff on 128-episode sweeps: log commits much faster (87% vs 63%
    # confident) but overcommits to symmetric aliases (higher RMSE); raise
    # log_temperature (divides the log-sum, ~geometric-mean tempering) to
    # soften it and keep multimodality alive longer.
    beam_combine: str = "sum"
    log_temperature: float = 1.0
    # The reference quantizes ray directions to ~1 degree via an int-keyed
    # memo (monte_carlo.cpp:355-363).  We default to exact angles; set True
    # to reproduce the 1-degree quantization.
    quantize_ray_deg: bool = False
    # Unknown-space beam credit on PARTIAL (learned) maps, as a fraction of
    # the peak hit probability w_hit * gauss_pdf(0).  Only read by the
    # frontier-aware scorer (sensor.beam_weights_partial, activated by
    # passing a known-walls-only map to the filter): a beam that crosses
    # into UNMAPPED territory before any evidenced wall and measures a
    # range at/behind that frontier is uninformative — it gets this flat
    # credit instead of being scored against fit_walls' phantom
    # unexplored-is-wall raster (which is what made relocalization on
    # partial maps fail outright rather than degrade).  No reference
    # counterpart (the reference never localizes on a learned map).
    unknown_credit: float = 0.3
    # How the credit is computed (sensor.beam_weights_partial):
    #   "flat"     — unknown_credit * peak for every frontier beam (the
    #                round-4 behavior).
    #   "interval" — frontier-DISTANCE-aware: the marginal density of the
    #                observation under "a wall sits uniformly somewhere in
    #                the unknown stretch beyond the frontier",
    #                w_hit * min(1 / (max_range - d_frontier + sigma),
    #                gauss_pdf(0)).  A beam GRAZING the frontier (almost
    #                no unknown left) is nearly as informative as a mapped
    #                beam and scores near peak; a beam that travels far
    #                through unknown space carries little information and
    #                scores low — so particles are no longer uniformly
    #                subsidized for looking outward (`unknown_credit` is
    #                ignored in this mode; the geometry sets the credit).
    # Default "interval": measured over SIX 16-episode seed sets on
    # half-explored maps (T=300): flat 30/96 relocalized -> interval
    # 46/96 (BENCH_DETAILS round-5 reloc table); "flat" restores the
    # round-4 behavior.
    unknown_credit_mode: str = "interval"

    @property
    def num_ray_steps(self) -> int:
        """Steps r = 0, step, ..., < max_range (monte_carlo.cpp:370-372)."""
        return int(math.ceil(self.max_range / self.ray_step))


@dataclasses.dataclass(frozen=True)
class MotionModelConfig:
    """Odometry / motion noise (reference: monte_carlo.cpp:695-739,1198)."""

    wheel_space: float = 0.265    # PID_lib.hpp:19
    wheel_size: float = 0.062     # PID_lib.hpp:20 (encoder rad -> m factor is *0.5)
    alpha_1: float = 0.001        # rot noise from rot      (monte_carlo.cpp:1198)
    alpha_2: float = 0.001        # rot noise from trans
    alpha_3: float = 0.0001       # trans noise from trans
    alpha_4: float = 0.0001       # trans noise from rot
    # The reference samples ONE shared (rot1, trans, rot2) noise triple per
    # step for all particles (monte_carlo.cpp:695-715, updateParticlePos
    # :740-755).  per-particle noise is the statistically correct option.
    shared_noise: bool = True


@dataclasses.dataclass(frozen=True)
class ResampleConfig:
    """Resampling + AMCL-style adaptive injection (monte_carlo.cpp:457-561)."""

    # Lost regime (jitterState=true)
    lost_max_injection: int = 200     # :474
    lost_alpha_slow: float = 0.05     # :475
    lost_alpha_fast: float = 0.5      # :476
    lost_jitter_xy: float = 0.05      # uniformJitter(-0.05, 0.05) (:537-538)
    lost_jitter_theta: float = math.pi / 12.0   # :539
    # Confident regime (jitterState=false)
    conf_max_injection: int = 50      # :479
    conf_alpha_slow: float = 0.02     # :480
    conf_alpha_fast: float = 2.0      # :481 (>1: deliberate reference quirk)
    conf_jitter_xy: float = 0.01      # :545-546
    conf_jitter_theta: float = 0.0    # theta unchanged when confident (:547)
    # "multinomial" matches the reference CDF + lower_bound draw (:513-555);
    # "systematic" is the low-variance production path.
    method: str = "multinomial"
    # Multinomial draw backend.  "exact": per-slot searchsorted, the
    # bit-faithful reference semantics incl. the draw↔injection coupling
    # (the SAME uniform decides both, monte_carlo.cpp:513-528) — but
    # searchsorted is N binary-search gather chains.
    # "sorted": order-statistics draw (resample.multinomial_indices_sorted)
    # — the identical multinomial MULTISET via one merged-sort cross-rank,
    # no gathers; injection uses an independent uniform (QUIRKS.md
    # fast-path row).
    multinomial_impl: str = "exact"
    # ESS-gated resampling (opt-in; None = reference behavior, resample
    # every tick, monte_carlo.cpp:457).  When set (e.g. 0.5), the filter
    # carries cumulative importance weights (w_t ∝ w_{t-1}·likelihood) and
    # runs the full resampling pass only when the effective sample size
    # 1/Σŵ² drops below ess_threshold·N — the standard production SIR
    # schedule; skipped ticks cost neither sampling noise nor jitter and
    # skip the whole resample stage under lax.cond.
    ess_threshold: Optional[float] = None
    # Multi-chip offspring exchange (parallel/distributed.resample_sharded).
    # "ring": O(N/P) per-chip memory and expansion compute — source blocks
    # rotate around a device ring (ppermute) and each shard assembles only
    # its own output block; no [N_global, 3] intermediate ever exists.
    # Systematic draws are bit-identical to the gathered form; multinomial
    # uses distributed order statistics (the sorted multiset draw — same
    # distribution, no searchsorted).  "allgather": the legacy form that
    # replicates the full cloud per shard (O(N_global) memory) and keeps
    # the reference's per-slot searchsorted for multinomial — only useful
    # for A/B parity checks.
    sharded_exchange: str = "ring"


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Occupancy-grid mapping (models/mapping.py).

    No reference counterpart — the reference consumes a hand-written
    map.txt and has no way to produce one from sensors.  Defaults match
    the reference raster geometry (publish_map_rviz.cpp:272-274: 49 px @
    0.1 m/px, +0.05 m origin via pixel centering) so a map learned on the
    default maze is pixel-comparable to the published one.
    """

    height: int = 49               # raster rows (pixels)
    width: int = 49                # raster cols
    resolution: float = 0.1        # m / pixel
    origin_x: float = 0.0
    origin_y: float = 0.0
    l_occ: float = 0.9             # log-odds per hit observation
    l_free: float = 0.35           # log-odds per free-space crossing
    clamp: float = 8.0             # saturation (keeps cells revisable)
    half_width: float = 0.055      # beam half-width, m (~pixel half-diag)
    hit_margin: float = 0.04       # near-side hit slack, m (2x range noise)
    hit_depth: float = 0.07        # far-side hit depth, m (~0.7 * res)
    max_trusted_range: float = 1.02  # drop beams beyond: excludes the
    # 1.05 NaN-replacement sentinel (monte_carlo.cpp:254-278) but keeps
    # at-max_range no-return beams, which carve free space without a hit


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Gradient-guided particle refinement (models/refine; opt-in).

    No reference counterpart — jax.grad through the exact ray casters
    nudges particles up the beam likelihood before weighting (scan
    matching as autodiff).  iters=0 (default) preserves exact reference
    behavior; see models/refine.py for semantics and the bias caveat.
    """

    iters: int = 0                # gradient-ascent rounds per tick (0 = off)
    step_xy: float = 0.02         # meters per round along the xy gradient
    step_theta: float = 0.01      # radians per round along sign(dL/dθ)
    # Differentiable caster for the gradient pass ("dda" or "analytic";
    # the reference's "fixed" march is piecewise constant — zero gradient).
    ray_mode: str = "dda"
    eps: float = 1e-9             # log-likelihood floor (invalid poses)


@dataclasses.dataclass(frozen=True)
class KLDConfig:
    """KLD-sampling statistic (Fox 2001; ROS AMCL's kld_err/kld_z knobs).

    No reference counterpart — its N=1500 is compile-time
    (monte_carlo.cpp:84).  Consumed by the serving layer's
    `adapt_mode="kld"` (io/server.py) via models/kld.py; defaults follow
    AMCL conventions except epsilon (AMCL's 0.01 targets building-scale
    maps; 0.05 suits maze-scale bin counts — override per deployment).
    """

    epsilon: float = 0.05          # K-L error bound ε (AMCL kld_err)
    z: float = 2.326               # normal upper quantile for 1-δ = 0.99
    bin_xy: float = 0.5            # histogram bin, meters (AMCL kd-tree res)
    bin_theta: float = math.pi / 18.0   # 10° heading bins
    subsample: int = 8192          # particles counted (strided subsample)


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Rao-Blackwellized particle-filter SLAM (models/slam.py; opt-in).

    No reference counterpart — the reference localizes against a
    hand-written map.txt and cannot build one online.  Each particle
    carries a pose hypothesis AND its own occupancy grid; weights come
    from scan-to-OWN-map endpoint consistency (a likelihood-field model
    over the particle's learned log-odds grid), so pose and map converge
    together from nothing but encoders + scans.
    """

    num_particles: int = 128
    mapping: MappingConfig = MappingConfig()
    sensor: SensorModelConfig = SensorModelConfig()
    motion: MotionModelConfig = MotionModelConfig()
    # AMCL-style likelihood field: per returned beam,
    # l = z_hit * field(endpoint) + z_rand, where field is the particle's
    # confident-wall mass Gaussian-widened by field_sigma_px (unit center
    # weight, banded-matmul blur — models/slam.hit_field).
    z_hit: float = 0.85
    z_rand: float = 0.15
    # sigma 1.0 px: tuned on 4-seed x {3%, 8%} slip wander sweeps (1000
    # ticks, P=64) — the 1.5 px field was soft enough to let the filter
    # wander off its own walls (tail drift 0.61 m mean at 3% slip vs
    # 0.25 m at sigma 1.0); the sharper basin locks revisits without
    # losing the pull radius (field_radius_px unchanged).
    field_sigma_px: float = 1.0
    field_radius_px: int = 4
    # Free-space consistency: `free_samples` interior stations per beam,
    # each confident-wall crossing multiplies the beam likelihood by
    # (1 - z_short * field).  The heading-drift signal the endpoint term
    # cannot see (models/slam.scan_log_likelihood).
    z_short: float = 0.5
    free_samples: int = 6
    free_margin: float = 0.18
    # Motion-noise inflation over the localization alphas.  1.0 measured
    # best across {3%, 8%} wheel-slip sweeps: the per-particle draw (the
    # shared-noise quirk is dropped here, see QUIRKS.md) already supplies
    # the proposal diversity, and inflating it further just adds random
    # walk the likelihood field must fight (2.0 doubled the 3%-slip tail
    # drift).  Raise for platforms whose odometry faults exceed what the
    # localization alphas model.
    alpha_scale: float = 1.0
    ess_threshold: float = 0.7    # resample when ESS < threshold * P
    # Gradient scan matching (experimental, default OFF): ascend the
    # differentiable endpoint likelihood on each particle's OWN map for
    # `refine_iters` steps before weighting.  Measured to HURT at maze
    # scale — deterministic uphill moves before weighting bias the
    # importance weights (no proposal correction) and accelerate lock-in
    # to the map's own drift; kept opt-in for larger/richer worlds.
    refine_iters: int = 0
    refine_step_xy: float = 0.01
    refine_step_theta: float = 0.01
    # Monte-Carlo optimal proposal (the UNBIASED scan-matched proposal —
    # what refine_iters could not deliver): draw K motion-model candidates
    # per particle, keep ONE with probability ∝ its scan likelihood
    # (Gumbel-max categorical), and multiply the particle's weight by the
    # candidate MEAN likelihood — an unbiased estimate of p(z | x_prev),
    # the optimal-proposal normalizer, so the importance weights stay
    # exact for any K (K → ∞ recovers p(x | x_prev, z); K = 1 is exactly
    # the plain SIR step).  K folds into the beam axis of the
    # per-particle bilinear field contractions (slam.scan_loglik_multi) —
    # no extra field/window computation, the einsums just get a K×
    # longer sample axis.
    proposal_candidates: int = 1
    # Keyframe-gated map updates (GMapping's linearUpdate/angularUpdate):
    # fold the scan into the particle maps only when the posterior-mean
    # pose has moved ≥ keyframe_trans meters or turned ≥ keyframe_rot
    # radians since the last map update (criteria with value 0 are
    # disabled; both 0 = update every tick, the legacy behavior).  Ticks
    # spent stationary or turning in place re-paint the same walls from
    # slightly different noisy poses — the dominant long-horizon map
    # smear source; gated ticks still weight and resample normally.
    keyframe_trans: float = 0.0
    keyframe_rot: float = 0.0
    # Consensus-anchored correlative correction ("loop closure lite",
    # models/slam.closure_correction; opt-in).  On map-update (keyframe)
    # ticks, the current scan is matched against the CONSENSUS map — the
    # importance-weighted mean of all particle log-odds grids, i.e. the
    # accumulated keyframe evidence, not any single particle's noisy map
    # (matching per-particle maps was measured to chase early-map noise:
    # refine_iters and proposal_candidates both hurt, QUIRKS.md) — over a
    # small exhaustive (dx, dy, dtheta) grid, and the best rigid offset is
    # applied to the WHOLE cloud (relative spread preserved: translation +
    # rotation about the posterior mean).  The cloud re-anchors onto the
    # map it already painted before painting more — the drift-compounding
    # cut that pure RBPF diversity cannot provide at high wheel slip.
    # Gated: the offset applies only when it improves the consensus scan
    # log-likelihood by ≥ closure_margin nats (an unexplored region has a
    # flat surface and never crosses the margin).  Steps must be odd (the
    # zero offset must be a candidate).
    closure: bool = False
    closure_xy_range: float = 0.15     # m, per-axis search half-width
    closure_xy_steps: int = 7
    closure_theta_range: float = 0.10  # rad
    closure_theta_steps: int = 7
    closure_margin: float = 2.0        # nats of required improvement
    # Fraction of the winning offset actually applied (a servo, not a
    # jump): damping keeps the grid-quantized argmax from injecting its
    # own step noise when it fires on a marginal gain.
    closure_gain: float = 1.0
    # Minimum matched (returned + painted-wall) beams for a correction to
    # fire — a couple of surviving beams cannot rigidly re-anchor a cloud.
    closure_min_beams: int = 8
    # No firing on ticks whose odometry rotation exceeds this (rad):
    # mid-turn scans are the least reliable anchors.
    closure_max_turn: float = 0.05
    # Keyframes a fired correction blocks further firings for.
    closure_cooldown: int = 2
    # Extra nats the best dtheta must buy over dtheta=0 (same dx, dy) to
    # be applied — rotation is weakly observable in corridors and the
    # raw argmax otherwise carries spurious grid-edge theta kicks.
    closure_theta_margin: float = 1.0


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """k-means pose clustering / confidence (monte_carlo.cpp:802-949)."""

    k: int = 3                    # :889
    max_iters: int = 20           # :890
    near_radius: float = 0.4      # countParticlesNearCluster radius (:931)


@dataclasses.dataclass(frozen=True)
class HysteresisConfig:
    """Lost/recovered state machine (monte_carlo.cpp:78-81,1030-1081)."""

    init_cluster_threshold: float = 0.1       # :78
    init_confident_threshold: float = 0.80    # confident_level_threshhold :80
    lost_cluster_threshold: float = 0.1       # :1036
    lost_confident_threshold: float = 0.8     # :1037
    conf_cluster_threshold: float = 0.4       # :1048
    conf_confident_threshold: float = 0.5     # :1051
    song_lost: int = 1                        # :1039 (songs_lib.cpp)
    song_recovered: int = 2                   # :1058


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Uniform particle sampler (monte_carlo.cpp:415-450,394-407)."""

    cell_offset: float = 0.2      # uniform in-cell offset +-0.2 m (:434)
    global_offset: float = 0.05   # +0.05 m map offset on x and y (:444-445)
    init_weight: float = 1.0      # :446
    # Fresh-draw RNG backend for the HOT path (resample injection):
    # "reference" = 5 threefry sweeps (randint x2 + uniform x3);
    # "packed" = the same distribution from one 2-word bits() call
    # (resample.sample_uniform_particles_packed — 16-bit offset/yaw
    # granularity, modulo-idiom cells; QUIRKS fast-path table).
    # init_state always uses the reference sampler (one-time cost).
    sampler: str = "reference"
    # Fresh-draw cell support on PARTIAL learned maps (known_map runs):
    # "explored" draws injected AND initial particles only from cells
    # whose fitted edges are not all walls; "init-only" restricts just
    # the initial cloud; "uniform" (default) keeps the reference's
    # all-cells draw.  MEASURED HARMFUL as a default on half-explored
    # maps (reloc 10/24 uniform -> 4/24 explored -> 3/24 init-only over
    # 3 seed batches): the "wasted" low-scoring draws in unexplored
    # cells hold w_avg and the cluster confidence DOWN, which keeps the
    # adaptive-injection search phase alive until the right alias wins;
    # concentrating the cloud in explored space makes the filter commit
    # early to in-coverage aliases.  Kept as an opt-in knob because the
    # dynamic is population-level and may invert on large worlds where
    # explored space is a small fraction of the map.
    partial_map_cells: str = "uniform"


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Full MCL configuration; defaults reproduce the reference filter."""

    num_particles: int = 1500     # Particle_number (monte_carlo.cpp:84)
    tick_dt: float = 0.1          # 10 Hz timer (monte_carlo.cpp:1210)
    grid: GridConfig = GridConfig()
    sensor: SensorModelConfig = SensorModelConfig()
    motion: MotionModelConfig = MotionModelConfig()
    resample: ResampleConfig = ResampleConfig()
    refine: RefineConfig = RefineConfig()
    cluster: ClusterConfig = ClusterConfig()
    hysteresis: HysteresisConfig = HysteresisConfig()
    init: InitConfig = InitConfig()
    # isValidPos 9-point stencil offset (monte_carlo.cpp:331-349)
    valid_pos_offset: float = 0.1
    dtype: str = "float32"

    def replace(self, **kw) -> "FilterConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Controller configs
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PIDConfig:
    """Two-phase PID point-to-point drive (src/PID_drive.cpp)."""

    heading_gain: float = 8.0         # PID_drive.cpp:128,169
    rotate_exit_rad: float = 0.05     # phase-1 exit |err| < 0.05 (:234)
    dist_exit_m: float = 0.05         # phase-2 exit dist < 0.05 (:253)
    max_wheel_speed: float = 100.0    # drive_motor clamp (:66-90)
    rate_hz: float = 10.0             # control loop (:226)
    max_phase_ticks: int = 600        # fixed bound for lax.while (60 s @ 10 Hz)


@dataclasses.dataclass(frozen=True)
class APFConfig:
    """Artificial-potential-field drive.  Presets for each reference node."""

    attract_gain: float = 90.0
    repel_gain: float = 0.0
    influence_radius: float = 0.2
    heading_gain: float = 8.0
    fade_exponent: float = 1.0
    repel_half: bool = True           # the *0.5 factor (avf.cpp:265)
    repel_sign: float = 1.0           # avf.cpp uses +u (toward point!); pf.cpp -u
    min_obstacle_dist: float = 0.005
    dist_exit_m: float = 0.1
    attract_mag_exit: float = 40.0    # avf.cpp exit needs attract_mag < 40 (:363)
    use_attract_exit: bool = True
    mix_sign: float = 1.0             # motor mixing: +1 avf.cpp, -1 potential_field
    subtract_theta: bool = True       # avf.cpp: err = heading - theta; pf.cpp: heading
    near_goal_dist: float = 0.2       # repel_gain -> 0 within this (avf.cpp:368)
    near_goal_repel: float = 0.0
    near_goal_radius: float = 0.2
    rate_hz: float = 10.0
    max_ticks: int = 600

    @staticmethod
    def avf() -> "APFConfig":
        """src/avf.cpp:73-79 gains (service Potential_drive)."""
        return APFConfig()

    @staticmethod
    def potential_field() -> "APFConfig":
        """src/potential_field.cpp:70-74 (service Potential_drive_1)."""
        return APFConfig(
            attract_gain=100.0, repel_gain=0.05, influence_radius=0.5,
            heading_gain=1.0, repel_half=False, repel_sign=-1.0,
            mix_sign=-1.0, subtract_theta=False, use_attract_exit=False,
            near_goal_dist=0.3, near_goal_repel=0.01, near_goal_radius=0.2,
            fade_exponent=0.0,
        )

    @staticmethod
    def global_apf() -> "APFConfig":
        """src/moveToPosition_server.cpp:54-56 global-frame APF."""
        return APFConfig(attract_gain=50.0, repel_gain=0.0,
                         influence_radius=0.6, heading_gain=4.0,
                         subtract_theta=False)


@dataclasses.dataclass(frozen=True)
class WandererConfig:
    """Reactive obstacle-avoidance (src/wanderer_try_final.cpp)."""

    threshold: float = 0.20       # min-range stop threshold (:219,226)
    forward_speed: float = 8.0    # :222-223
    turn_speed: float = 5.0       # :184-187
    turn_angle: float = 3.14 / 3  # rotate pi/3 (:184-187)
    wheel_space: float = 0.265
    wheel_size: float = 0.062


@dataclasses.dataclass(frozen=True)
class AVFWandererConfig:
    """Pure-repulsion wanderer (src/avf_wanderer.cpp:173-248)."""

    repel_gain: float = 0.001
    influence_radius: float = 0.4
    heading_gain: float = 5.0
    base_speed: float = 8.0


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """RANSAC wall alignment (src/align_server.cpp)."""

    distance_threshold: float = 0.05  # inlier distance (:805)
    max_iterations: int = 100         # :805
    min_inliers: int = 50             # :805
    max_lines: int = 2                # :361
    wall_standoff: float = 0.40       # drive to 0.40 m from wall (:712-755)


DEFAULT_CONFIG = FilterConfig()
