"""Static configuration for the stereo SVO engine.

Mirrors the reference's ``CameraSettings`` struct (reference:
src/lib/stereo_slam_types.hpp [UNVERIFIED — empty mount, see SURVEY.md §0]):
intrinsics, baseline, grid bucketing, epipolar search ranges, patch window
sizes and pyramid depth — plus the fixed capacities that replace the
reference's dynamic ``std::vector`` world (SURVEY.md §7.0.1).

Everything here is *static* w.r.t. tracing: a config instance is hashable and
is closed over by the jitted ``step`` — changing a value triggers a retrace,
which is the intended semantics (these are compile-time shape/schedule knobs).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole + baseline stereo camera model (rectified).

    Reference parity: CameraSettings{fx,fy,cx,cy,baseline,...}
    (src/lib/stereo_slam_types.hpp [UNVERIFIED]). Distortion is handled at
    ingest (host-side rectification); the device-side model is rectified
    pinhole, as in the reference's core pipeline.
    """

    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    baseline: float = 0.11  # meters
    width: int = 752
    height: int = 480

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass(frozen=True)
class SvoConfig:
    """Algorithm + capacity configuration (all static / trace-shaping)."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)

    # --- pyramid ---
    num_levels: int = 4            # intensity pyramid levels (ref: max_pyramid_levels)
    # --- detector / grid bucketing (ref: grid_width x grid_height) ---
    grid_rows: int = 12
    grid_cols: int = 16
    detect_levels: int = 4         # pyramid levels scanned for corners
                                   # (clipped to num_levels). Coarse levels
                                   # are what keep detection alive when
                                   # scene texture goes low-frequency in
                                   # pixel terms (close range / defocus):
                                   # a 30 px/cycle texture has no FAST
                                   # corners at level 0 but plenty at 2.
    fast_threshold: float = 12.0   # intensity contrast for FAST arc test (u8 scale)
    edgelet_threshold: float = 16.0  # gradient-magnitude threshold for edgelets
    min_score: float = 1.0         # minimum cell score to activate a feature
    border_margin: int = 16        # keep features away from image border

    # --- capacities (fixed; liveness via masks) ---
    max_features: int = 192        # == grid_rows * grid_cols cells by default
                                   # (also the seed + BA-landmark capacity:
                                   # one unified fixed-capacity feature
                                   # array, SURVEY.md §7.0.1)
    max_keyframes: int = 10        # sliding window size (ref/north-star: 10)

    # --- stereo matching (ref: DepthCalculator, search_x) ---
    stereo_max_disp: int = 96      # disparity search range in px at level 0
    stereo_patch: int = 8          # ZNCC window for stereo matching

    # --- sparse direct alignment (ref: PoseEstimator) ---
    align_patch: int = 4           # photometric patch (ref SVO uses 4x4)
    align_max_iters: int = 10      # GN iterations per level (when no
                                   # per-level schedule is set)
    align_iters_per_level: tuple | None = (2, 3, 4, 8)
                                   # per-level GN iteration schedule,
                                   # coarse→fine; longer schedules align
                                   # to the finest levels, None = flat
                                   # align_max_iters. Coarse levels
                                   # converge in 2-3 steps under the
                                   # constant-velocity prior; each saved
                                   # pass is a sampling pass + a
                                   # serial 6x6 solve. Measured (r3,
                                   # EuRoC-geometry bench): (2,3,4,8)
                                   # ATE 0.0103 vs flat-10 0.0106 —
                                   # parity at fewer dependent stages
    align_levels: int = 4          # coarse-to-fine levels used for alignment
    align_min_level: int = 0       # finest level in alignment. At stress
                                   # scale min_level=0 is less accurate
                                   # than 1 (ATE 0.0181 vs 0.0124,
                                   # 9778a94:BASELINE.md r3), so
                                   # stress_config keeps 1. Default
                                   # stays 0 for the 192-feature config.
    align_huber: float = 8.0       # Huber k on intensity residuals (u8 scale)
    align_irls_chunks: int = 3     # Huber-weight/Hessian refreshes per
                                   # level; each refresh takes an exact GN
                                   # step, iterations in between reuse H⁻¹
                                   # as one matvec (the exact 6x6 Cholesky
                                   # + exp + compose chain is a serial,
                                   # latency-bound stage). Measured: ATE
                                   # 0.0169 vs 0.0167 exact — parity.
                                   # align_max_iters → exact classic IRLS.

    align_tmpl_stereo: bool = False  # template depths from the CURRENT
                                   # frame's measured stereo disparity
                                   # (where valid) instead of the map.
                                   # Motivation: template depth IS the
                                   # align stage's translation gain
                                   # (forward flow ∝ t/z), so a +b% map
                                   # depth bias makes every aligned
                                   # forward step +b% hot. MEASURED MUCH
                                   # WORSE at driving scale (road_long
                                   # 400f ATE 7.2 → 47.3, r5): raw
                                   # disparity noise at far range (1 px
                                   # on a 6 px disparity = 17% depth
                                   # error, per feature, per frame)
                                   # swamps the ~5% smooth map bias it
                                   # removes — the depth filter exists
                                   # precisely to average that noise.
                                   # Off; recorded as a negative result.
    illum_affine: bool = True      # photometric affine compensation:
                                   # the aligner estimates a global gain/
                                   # bias (closed form, per Huber refresh)
                                   # and KLT removes a per-feature affine
                                   # fit — robustness to auto-exposure,
                                   # vignetting, and lighting drift, which
                                   # raw brightness-constancy residuals
                                   # cannot absorb (DSO-style; the
                                   # reference's plain SSD residuals lose
                                   # tracking under exposure steps)

    # --- KLT feature alignment (ref: OpticalFlow) ---
    klt_patch: int = 8             # inverse-compositional LK window
    klt_max_iters: int = 6
    klt_levels: int = 3
    klt_conv_eps: float = 0.03     # px; squared-step convergence threshold
    klt_affine_warp: bool = False  # resample templates through the pose-
                                   # predicted affine warp (SVO's
                                   # getWarpMatrixAffine) — for low-KF-rate
                                   # operation; the default KF rate keeps
                                   # templates fresh without it

    # --- pose refinement (ref: PoseRefiner) ---
    refine_max_iters: int = 10
    refine_huber_px: float = 2.0   # Huber k on reprojection residuals (px)
    refine_outlier_px: float = 4.0 # reprojection error to kill a feature
    refine_irls_chunks: int = 3    # Jacobian/weight refreshes (see
                                   # align_irls_chunks; same rationale)
    refine_prior_t_sig: float = 0.05  # constant-velocity motion prior in
                                   # the refiner (m, rad; 0 disables):
                                   # loose enough to be invisible against
                                   # healthy feature sets, caps the
                                   # single-frame forward excursions a
                                   # far-dominated set cannot observe —
                                   # which the distance-triggered KF
                                   # policy would otherwise anchor a
                                   # keyframe at (9778a94:BASELINE.md r3
                                   # KITTI-geometry root cause)
    refine_prior_r_sig: float = 0.02
    refine_whiten_depth: bool = False  # fold the depth posterior's
                                   # uncertainty into the refiner's row
                                   # noise (σ_reproj² += (fx·‖t_ck‖·σ_μ)²,
                                   # σ_disp² += (fx·B·σ_μ)²). Principled
                                   # (estimated depth is not exact) but
                                   # MEASURED WORSE at driving scale
                                   # (road_long 400f ATE 7.2 → 26.2, r5):
                                   # downweighting fresh seeds removes
                                   # real metric information faster than
                                   # it removes noise coupling — like
                                   # seed_sigma_floor, left off with the
                                   # result recorded.
    refine_stereo_weight: float = 1.0  # weight of the per-frame stereo
                                   # disparity residual rows in the pose
                                   # refiner (0 disables). Mono
                                   # reprojection leaves forward
                                   # translation nearly unobserved on
                                   # far-dominated scenes: measured on
                                   # road_long (r4), per-frame steps ran
                                   # +4..+32% hot and compounded into
                                   # collapse; the disparity rows are a
                                   # direct per-frame measurement of
                                   # each feature's camera depth and pin
                                   # the scale. Reuses the depth
                                   # filter's stereo_refresh measurement
                                   # — no extra search.

    # --- depth filter (ref: DepthFilter) ---
    seed_sigma_ratio: float = 0.05  # convergence: sigma < ratio * depth_range
    seed_sigma_floor: float = 0.0  # posterior σ floor as a ratio of μ
                                   # (inverse depth; 0 disables —
                                   # MEASURED HARMFUL at driving scale
                                   # and left off). Rationale tried
                                   # (r5): motion-triangulation
                                   # measurements share the pose error,
                                   # so σ² collapses toward a correlated
                                   # consensus and the per-frame stereo
                                   # refresh loses traction. But the
                                   # refresh is pose-free only in the
                                   # CURRENT camera frame — mapping it
                                   # onto the anchor ray goes through
                                   # the drifted relative pose, so
                                   # highly-responsive landmarks track
                                   # the pose bias FASTER: road_long
                                   # 400f ATE went 7.2 m (floor 0) →
                                   # 42.5 m (floor 0.02) with tracking
                                   # intact — smooth scale runaway.
                                   # Keep 0 unless the anchor transport
                                   # is made drift-proof.
    seed_max_updates: int = 60
    px_noise: float = 1.0          # 1-px measurement noise assumption
    stereo_refresh_window: int = 10  # per-frame stereo reobservation:
                                   # disparity search (pred ± window px)
                                   # in the CURRENT stereo pair, feeding
                                   # (a) the depth posterior and (b) the
                                   # pose refiner's disparity rows. The
                                   # scale anchor: motion triangulation
                                   # follows the pose estimate, so
                                   # pose-scale drift is self-reinforcing;
                                   # the disparity measurement is
                                   # pose-free (measured: KITTI-geom
                                   # landmark depth bias +0.8%→+9.6%
                                   # without it — 9778a94:BASELINE.md r3).
                                   # Window sizing (r4): the search
                                   # centers on the POSE-predicted
                                   # disparity, which a scale drift of s
                                   # shifts by ≈ s·disp — at the old ±4
                                   # a 7% drift pushed near features
                                   # (disp≈60, the only scale-informative
                                   # ones) off-window, and the interior
                                   # gate then dropped exactly them
                                   # (adverse selection; road_long
                                   # collapse root-cause). ±10 tolerates
                                   # ~16% drift on 60 px features.
                                   # 0 disables.
    stereo_refresh_landmarks: bool = True  # include converged LANDMARKS
                                   # in the per-frame stereo refresh (not
                                   # just seeds). The refresh's anchor
                                   # transport rides the current relative
                                   # pose, so at long horizon it can leak
                                   # pose drift into landmark depths;
                                   # False restricts the refresh to
                                   # seeds (landmarks then update only
                                   # through window BA). Measured r3:
                                   # True helped (+2-3% landmark bias
                                   # without it, pre-gauge-fix BA); r5
                                   # re-raced post-gauge-fix — see
                                   # 9778a94:BASELINE.md r5 road table.
    # per-seed epipolar search for KLT-lost seeds (ref DepthFilter's 1-D
    # search along the epipolar line; SURVEY.md §3.5)
    epi_samples: int = 0           # ZNCC probes along the μ±3σ segment
                                   # (0 disables the epipolar path —
                                   # the MEASURED default, r5 e2e
                                   # trade-off battery,
                                   # bench_results/diag_epi_tradeoff.py:
                                   # weak-texture stretch ATE 0.440 /
                                   # tracking 0.44 with the search ON vs
                                   # 0.171 / 0.98 OFF — recoveries feed
                                   # corrupted measurements through the
                                   # very stretch they were meant to
                                   # survive, while letting seeds die
                                   # and re-seeding stays on track;
                                   # blur ON 0.0108 vs OFF 0.0118
                                   # (noise-level win); perturb ON
                                   # 0.0134 vs OFF 0.0126. The r3
                                   # starvation-protection rationale is
                                   # INVERTED end-to-end. Path remains
                                   # available and parity-tested for
                                   # >0 opt-in.
    epi_min_zncc: float = 0.7      # acceptance threshold on the peak
    epi_level: int = 1             # pyramid level searched (cheaper coarse)

    # --- keyframe policy (ref: KeyframeInserter) ---
    kf_min_tracked: int = 60       # insert KF if tracked features drop below
    kf_dist_ratio: float = 0.12    # or translation / median scene depth above
    kf_every: int = 1              # regular-KF cadence quantization: > 1
                                   # restricts non-urgent insertions to
                                   # every kf_every-th frame so batched
                                   # sequences' insertions coincide and the
                                   # batch-level any(need_kf) cond stays
                                   # cold (engine/step.make_batched_step);
                                   # a collapsing track overrides it

    # --- stereo observation consistency gate (keyframe snapshots) ---
    stereo_consist_px: float = 2.0   # accept a stereo re-match into the BA
                                     # observation graph only if it agrees
                                     # with the feature's predicted
                                     # disparity within max(px, rel·disp):
                                     # absolute floor for near features
                                     # (occlusion/repeated-texture guard)…
    stereo_consist_rel: float = 0.15  # …relative window for far ones — a
                                     # 2 px absolute gate at 25 px
                                     # disparity rejects the very
                                     # measurements that re-anchor scale
                                     # once inverse-depth drift exceeds
                                     # ~8% (measured: the KITTI-geometry
                                     # forward-scale runaway,
                                     # 9778a94:BASELINE.md r3 root-cause)

    # --- bundle adjustment (backend) ---
    use_ba: bool = True            # run window BA at each KF insertion
    ba_iters: int = 5              # GN/LM outer iterations
    ba_huber_px: float = 2.0
    ba_trust_t: float = 0.10       # divergence guard: max translation /
    ba_trust_r: float = 0.05       # rotation the BA may move the newest
                                   # keyframe (reject the step beyond it).
                                   # Scale with scene depth: a 0.10 m cap
                                   # sized for EuRoC-scale scenes blocks
                                   # BA from repairing a mis-anchored
                                   # keyframe on driving-scale scenes
    ba_trust_clamp: bool = False   # True: apply an out-of-trust proposal
                                   # as a geodesic partial step scaled to
                                   # the trust radius instead of
                                   # rejecting it wholesale (binary
                                   # rejection discards exactly the large
                                   # legitimate recovery pulls at driving
                                   # scale — r5 road forensics)

    # --- place recognition / loop closure (backend/loop_closure.py) ---
    # The reference has no loop closure (SVO is pure odometry); the pose
    # graph [SPEC] accepts loop edges, so detection + measurement are
    # provided here: a tiny-thumbnail ZNCC global descriptor per keyframe
    # (also the relocalization index) and coarse direct alignment on stored
    # keyframe thumbnails to measure accepted edges.
    loop_desc_rows: int = 6        # descriptor pooling grid (rows x cols)
    loop_desc_cols: int = 8
    loop_thumb_level: int = 2      # pyramid level stored as KF thumbnail
    loop_patch: int = 4            # photometric patch for edge measurement
    loop_align_iters: int = 20     # GN iterations for edge measurement
    loop_min_score: float = 0.60   # descriptor ZNCC to propose an edge —
                                   # a cheap prefilter only (capacity is
                                   # loop_max_edges either way); the
                                   # photometric gate on the measured edge
                                   # is the correctness filter. Measured:
                                   # a true revisit with ~10° view change
                                   # scores ~0.68, unrelated views <0.4.
    loop_min_gap: int = 20         # min |frame stamp| separation (same seq)
    pr_rot_variants: int = 2       # rotated query variants per side for
                                   # place recognition (relocalization +
                                   # loop proposals): matching maxes over
                                   # ±k·pr_rot_step_rad rolls, k=1..n —
                                   # in-plane-rotation tolerance the plain
                                   # pooled grid lacks (0 disables)
    pr_rot_step_rad: float = 0.15
    reloc_min_score: float = 0.3   # descriptor-score floor for accepting
                                   # the appearance-nearest keyframe as the
                                   # relocalization seed; below it (e.g. a
                                   # textureless/blackout query, whose
                                   # descriptor degenerates to ~zero and
                                   # scores every bank entry ~0) fall back
                                   # to the most recent keyframe
    loop_max_edges: int = 8        # fixed loop-edge capacity (masked)
    loop_accept_frac: float = 0.6  # min photometric inlier frac to accept
    loop_rt_max_t: float = 0.30    # round-trip consistency gate: reject an
    loop_rt_max_r: float = 0.15    # edge whose forward and reverse
                                   # measurements (independent templates)
                                   # disagree beyond this (m, rad) — an
                                   # ambiguous alignment, however
                                   # photometrically confident
    online_loop_noise_k: float = 2.0  # adaptive significance floor: apply
                                   # an online correction only if it
                                   # exceeds k × the worst accepted
                                   # edge's round-trip error — the
                                   # edge-noise-scaled version of
                                   # online_loop_min_t (a static floor
                                   # cannot know the rig/scene's edge
                                   # accuracy; measured r5: 2 cm floor +
                                   # ~5 cm edge noise applied 6-9 phantom
                                   # corrections on a drift-free run and
                                   # compounded 0.3-0.5 m of error)
    # --- ONLINE loop closure (engine-integrated; VERDICT r3 next #5) ---
    # The offline path (refine_trajectory) repairs drift only after the
    # run; with online_loop_every > 0 the engine ALSO closes loops live:
    # every N-th keyframe insertion, the new keyframe's descriptor queries
    # the memory bank (incremental — one query row, not the full K² edge
    # matrix), accepted edges feed an on-device pose graph over the bank,
    # and the correction folds into the live state (kf_T_wk, mem_T_wk,
    # current/template poses) — a revisit repairs drift DURING the run.
    online_loop_every: int = 0     # run every N-th KF insertion (0 = off
                                   # — odometry parity with the
                                   # reference). The query +
                                   # bidirectional edge measurement +
                                   # pose graph run at each checked KF
                                   # insertion; for loop workloads
                                   # online_loop_every=4 is the
                                   # recommended setting (4× fewer
                                   # checks, ≤3-KF detection delay)
    online_loop_edges: int = 2     # top-k bank matches measured per query
    online_loop_iters: int = 8     # pose-graph GN iterations
    online_loop_max_t: float = 2.0  # trust guard: reject a correction
    online_loop_max_r: float = 1.0  # moving the newest KF further than
                                   # this (m, rad) — a false loop edge
                                   # must not teleport the live map
    online_loop_min_t: float = 0.02  # significance floor: corrections
    online_loop_min_r: float = 0.01  # below this are edge-measurement
                                   # noise, and applying them every KF
                                   # measurably destabilizes tracking
                                   # (each one kinks the pose history the
                                   # depth filters then absorb as biased
                                   # triangulations); a real loop event
                                   # fires once, cleanly
    online_loop_cooldown: int = 2  # KF insertions to wait after an
                                   # applied correction before running
                                   # again (lets BA/tracking re-settle)
    mem_keyframes: int = 48        # long-horizon place-recognition memory:
                                   # every keyframe's descriptor/thumbnail/
                                   # pose/stereo snapshot outlives the BA
                                   # window's eviction in a bank of this
                                   # capacity (loop closure and
                                   # relocalization search this bank, not
                                   # just the max_keyframes window)
    mem_retention: str = "coverage"  # bank eviction policy when full:
                                   # "coverage" evicts the slot whose
                                   # removal least widens the retained
                                   # temporal coverage (keeps ~uniformly
                                   # thinned history → revisits after
                                   # thousands of frames still find a
                                   # nearby retained keyframe, KITTI-00
                                   # scale loops with a fixed-size bank);
                                   # "fifo" is the plain ring (horizon =
                                   # mem_keyframes · KF-interval frames)

    def __post_init__(self):
        assert self.align_levels <= self.num_levels
        assert self.klt_levels <= self.num_levels
        assert self.max_features >= 1 and self.max_keyframes >= 2
        if self.epi_samples > 0 and self.epi_level > self.klt_levels - 1:
            # the epipolar search reuses the KLT template patches, which
            # exist only for levels < klt_levels — a silent clamp here
            # previously searched a different level than configured
            # (VERDICT r2 weak #8)
            raise ValueError(
                f"epi_level={self.epi_level} needs klt_levels >= "
                f"{self.epi_level + 1} (the search reuses KLT template "
                f"patches); got klt_levels={self.klt_levels}")

    @property
    def thumb_level(self) -> int:
        """Pyramid level stored as the keyframe thumbnail (clamped so tiny
        test configs with few levels stay valid)."""
        return min(self.loop_thumb_level, self.num_levels - 1)

    @property
    def thumb_shape(self) -> Tuple[int, int]:
        h, w = self.camera.height, self.camera.width
        for _ in range(self.thumb_level):
            h, w = h // 2, w // 2
        return (h, w)

    @property
    def desc_dim(self) -> int:
        return self.loop_desc_rows * self.loop_desc_cols

    @property
    def klt_big_patch(self) -> int:
        """Oversized KLT template size for affine warping (1 = disabled —
        the template tuple keeps a static dummy shape)."""
        return 2 * self.klt_patch if self.klt_affine_warp else 1


DEFAULT_CONFIG = SvoConfig()


def euroc_config() -> SvoConfig:
    """EuRoC MAV stereo (cam0) geometry, rectified."""
    return SvoConfig(camera=CameraConfig(
        fx=458.654, fy=457.296, cx=367.215, cy=248.375,
        baseline=0.110078, width=752, height=480))


def kitti_config() -> SvoConfig:
    """KITTI odometry grayscale stereo (seq 00 geometry)."""
    return SvoConfig(camera=CameraConfig(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        baseline=0.5371657, width=1241, height=376),
        grid_rows=10, grid_cols=24, max_features=240,
        stereo_max_disp=128,
        # driving-scale scenes (5-60 m): let BA move a mis-anchored
        # keyframe far enough to matter
        ba_trust_t=0.40, ba_trust_r=0.05,
        # the epipolar-recovery trade is SCENE-DEPENDENT (r5 battery):
        # on EuRoC-style scenes a degraded stretch poisons recovered
        # seeds (default now 0), but in the deep road corridor far
        # seeds are KLT-marginal and the recoveries keep them measured —
        # road-100 gate: 0.230 m (1.9%) with the search vs 0.318 m
        # (FAIL) without
        epi_samples=16)


def stress_config() -> SvoConfig:
    """North-star config #3: aggressive-motion stress — 5-level pyramids,
    >2k active depth-filter seeds (grid 32x64 = 2048 cells)."""
    return SvoConfig(camera=CameraConfig(),
                     num_levels=5, align_levels=4, align_min_level=1,
                     grid_rows=32, grid_cols=64, max_features=2048,
                     kf_min_tracked=600, klt_levels=3)
