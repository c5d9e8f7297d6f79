"""SlamState: the whole SLAM system as one fixed-capacity pytree.

SURVEY.md §7.0.2: one pytree = whole state. ``step: (SlamState, img_l,
img_r) -> (SlamState, FrameOut)`` is a pure function; checkpoint/resume is
``np.savez``/orbax of this pytree for free (SURVEY.md §5.4); ``vmap`` over a
leading axis gives multi-sequence batching (config #4).

Fixed capacities (N = max_features, K = max_keyframes) with status masks
replace the reference's dynamic keypoint/keyframe vectors
(StereoSlam's members, src/lib/stereo_slam.* [UNVERIFIED — SURVEY.md §0]).

Feature status codes: 0 = dead slot, 1 = depth-filter seed,
2 = converged landmark.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import SvoConfig
from ..geometry import se3
from ..ops import align as align_ops
from ..ops import klt as klt_ops

STATUS_DEAD = 0
STATUS_SEED = 1
STATUS_LANDMARK = 2


class SlamState(NamedTuple):
    # --- pose & motion ---
    T_cw: jnp.ndarray        # (3,4) world→current-camera
    T_pw: jnp.ndarray        # (3,4) world→previous-frame camera (template anchor)
    vel: jnp.ndarray         # (6,) twist of last cur←prev motion (const-velocity prior)
    frame_idx: jnp.ndarray   # () int32
    tracking_ok: jnp.ndarray  # () bool

    # --- features (N,) ---
    status: jnp.ndarray      # int32
    feat_uv: jnp.ndarray     # (N,2) current-frame level-0 position
    feat_level: jnp.ndarray  # (N,) detection pyramid level
    feat_corner: jnp.ndarray  # (N,) bool — corner (True) vs edgelet
    feat_dir: jnp.ndarray    # (N,2) unit gradient dir (edgelet normal)
    kf_id: jnp.ndarray       # (N,) owner keyframe slot
    kf_uv: jnp.ndarray       # (N,2) anchor pixel in owner keyframe
    mu: jnp.ndarray          # (N,) inverse-depth posterior mean (owner KF frame)
    sigma2: jnp.ndarray      # (N,) inverse-depth posterior variance
    a_beta: jnp.ndarray      # (N,) Beta inlier count
    b_beta: jnp.ndarray      # (N,) Beta outlier count
    z_range: jnp.ndarray     # (N,) inverse-depth range (outlier model)
    n_upd: jnp.ndarray       # (N,) int32 filter update count

    # --- templates ---
    tmpl: align_ops.Template     # frame-to-frame alignment template (prev frame)
    klt_tmpl: klt_ops.KltTemplate  # per-feature KF-anchored KLT template

    # --- keyframes (K,) ---
    kf_T_wk: jnp.ndarray     # (K,3,4) keyframe→world poses
    kf_valid: jnp.ndarray    # (K,) bool
    kf_next: jnp.ndarray     # () int32 ring pointer
    last_kf: jnp.ndarray     # () int32 slot of the most recent keyframe
    kf_stamp: jnp.ndarray    # (K,) int32 frame index at KF creation
    kf_desc: jnp.ndarray     # (K,D) place-recognition descriptors
    kf_thumb: jnp.ndarray    # (K,Ht,Wt) coarse thumbnails (loop measurement)
    kf_mem: jnp.ndarray      # (K,) int32 memory-bank slot of each window KF

    # --- long-horizon keyframe memory (M = mem_keyframes,) ---
    # Place-recognition bank that outlives the BA window's eviction: FIFO
    # ring of every keyframe's pose, stamp, descriptor, thumbnail, and
    # stereo-observation snapshot. Loop closure (backend/loop_closure.py)
    # and relocalization search this, not the K-slot window.
    mem_T_wk: jnp.ndarray    # (M,3,4) pose at creation (BA-refreshed while
                             # the keyframe is still in the window)
    mem_valid: jnp.ndarray   # (M,)
    mem_stamp: jnp.ndarray   # (M,) int32
    mem_desc: jnp.ndarray    # (M,D)
    mem_thumb: jnp.ndarray   # (M,Ht,Wt)
    mem_uv: jnp.ndarray      # (M,N,2) feature snapshot (loop measurement)
    mem_mask: jnp.ndarray    # (M,N)
    mem_disp: jnp.ndarray    # (M,N) stereo disparity snapshot
    mem_dmask: jnp.ndarray   # (M,N)
    mem_next: jnp.ndarray    # () int32 FIFO pointer (total KFs created)
    n_loop_closures: jnp.ndarray  # () int32 cumulative accepted+applied
                             # ONLINE loop edges (engine/step.
                             # run_online_loop; 0 unless
                             # cfg.online_loop_every > 0)
    last_loop_mem: jnp.ndarray  # () int32 mem_next at the last APPLIED
                             # online correction (cooldown anchor)

    # --- BA observation graph (K,N) ---
    obs_uv: jnp.ndarray      # (K,N,2) feature position snapshot at KF creation
    obs_mask: jnp.ndarray    # (K,N) bool
    obs_disp: jnp.ndarray    # (K,N) stereo disparity at snapshot (BA row 3)
    obs_dmask: jnp.ndarray   # (K,N) bool — disparity measured & trusted
    obs_sig: jnp.ndarray     # (K,N) observation px noise (2^detection level)

    # --- diagnostics ---
    ba_diag: jnp.ndarray     # (7,) last window-BA call: [proposed |dt|,
                             # proposed |dr|, signed forward move of the
                             # newest KF (its camera z), cost_initial,
                             # cost_final, accepted, n_obs] — surfaced
                             # per-frame in FrameOut (scan-safe
                             # instrumentation: no host callback inside
                             # the scanned step)


class FrameOut(NamedTuple):
    """Per-frame output + structured metrics (SURVEY.md §5.5)."""
    T_wc: jnp.ndarray            # (3,4) camera→world (trajectory entry)
    tracking_ok: jnp.ndarray     # () bool
    kf_inserted: jnp.ndarray     # () bool
    n_tracked: jnp.ndarray       # () int32 inlier features this frame
    n_seeds: jnp.ndarray         # () int32
    n_landmarks: jnp.ndarray     # () int32
    align_cost: jnp.ndarray      # () mean robust photometric cost
    align_inlier_frac: jnp.ndarray
    refine_rms_px: jnp.ndarray
    median_depth: jnp.ndarray
    n_seed_deaths: jnp.ndarray   # () int32 seeds killed this frame
                                 # (geometric outlier / filter divergence —
                                 # NOT keyframe-eviction kills)
    n_epi_recovered: jnp.ndarray  # () int32 KLT-lost seeds measured via
                                 # the epipolar search instead (the
                                 # reference DepthFilter's 1-D search;
                                 # VERDICT r1 #4 done-criterion metric)
    ba_diag: jnp.ndarray         # (7,) state.ba_diag snapshot (last BA
                                 # call's proposed move/cost/acceptance)


def init_state(cfg: SvoConfig) -> SlamState:
    N = cfg.max_features
    K = cfg.max_keyframes
    L_align = cfg.align_levels - cfg.align_min_level
    P2a = cfg.align_patch ** 2
    Lk = cfg.klt_levels
    P2k = cfg.klt_patch ** 2
    f32 = jnp.float32
    return SlamState(
        T_cw=se3.identity(),
        T_pw=se3.identity(),
        vel=jnp.zeros(6, f32),
        frame_idx=jnp.asarray(0, jnp.int32),
        tracking_ok=jnp.asarray(True),
        status=jnp.zeros(N, jnp.int32),
        feat_uv=jnp.zeros((N, 2), f32),
        feat_level=jnp.zeros(N, jnp.int32),
        feat_corner=jnp.ones(N, bool),
        feat_dir=jnp.zeros((N, 2), f32),
        kf_id=jnp.zeros(N, jnp.int32),
        kf_uv=jnp.zeros((N, 2), f32),
        mu=jnp.ones(N, f32) * 0.25,
        sigma2=jnp.ones(N, f32),
        a_beta=jnp.ones(N, f32) * 10.0,
        b_beta=jnp.ones(N, f32) * 10.0,
        z_range=jnp.ones(N, f32),
        n_upd=jnp.zeros(N, jnp.int32),
        tmpl=align_ops.Template(
            p_ref=jnp.zeros((N, 3), f32),
            patches=jnp.zeros((L_align, N, P2a), f32),
            jac=jnp.zeros((L_align, N, P2a, 6), f32),
            mask=jnp.zeros(N, bool)),
        klt_tmpl=klt_ops.KltTemplate(
            patches=jnp.zeros((Lk, N, P2k), f32),
            jac=jnp.zeros((Lk, N, P2k, 2), f32),
            hinv=jnp.zeros((Lk, N, 2, 2), f32),
            mask=jnp.zeros(N, bool),
            big=jnp.zeros((Lk, N, cfg.klt_big_patch ** 2), f32),
            big_ok=jnp.zeros((Lk, N), bool)),
        kf_T_wk=jnp.tile(se3.identity()[None], (K, 1, 1)),
        kf_valid=jnp.zeros(K, bool),
        kf_next=jnp.asarray(0, jnp.int32),
        last_kf=jnp.asarray(0, jnp.int32),
        kf_stamp=jnp.zeros(K, jnp.int32),
        kf_desc=jnp.zeros((K, cfg.desc_dim), f32),
        kf_thumb=jnp.zeros((K,) + cfg.thumb_shape, f32),
        kf_mem=jnp.zeros(K, jnp.int32),
        mem_T_wk=jnp.tile(se3.identity()[None], (cfg.mem_keyframes, 1, 1)),
        mem_valid=jnp.zeros(cfg.mem_keyframes, bool),
        mem_stamp=jnp.zeros(cfg.mem_keyframes, jnp.int32),
        mem_desc=jnp.zeros((cfg.mem_keyframes, cfg.desc_dim), f32),
        mem_thumb=jnp.zeros((cfg.mem_keyframes,) + cfg.thumb_shape, f32),
        mem_uv=jnp.zeros((cfg.mem_keyframes, N, 2), f32),
        mem_mask=jnp.zeros((cfg.mem_keyframes, N), bool),
        mem_disp=jnp.zeros((cfg.mem_keyframes, N), f32),
        mem_dmask=jnp.zeros((cfg.mem_keyframes, N), bool),
        mem_next=jnp.asarray(0, jnp.int32),
        n_loop_closures=jnp.asarray(0, jnp.int32),
        last_loop_mem=jnp.asarray(-(2 ** 20), jnp.int32),
        obs_uv=jnp.zeros((K, N, 2), f32),
        obs_mask=jnp.zeros((K, N), bool),
        obs_disp=jnp.zeros((K, N), f32),
        obs_dmask=jnp.zeros((K, N), bool),
        obs_sig=jnp.ones((K, N), f32),
        ba_diag=jnp.zeros(7, f32),
    )
