"""Keyframe insertion: detection, stereo depth bootstrap, slot assignment.

Reference parity: StereoSlam::new_keyframe — detect FAST/edgelet features in
grid cells not already occupied by tracked keypoints, stereo-match them,
triangulate depth, spawn depth-filter seeds, store the keyframe
(SURVEY.md §3.2; src/lib/ [UNVERIFIED — SURVEY.md §0]).

The dynamic parts of the reference (erase/push_back on keypoint vectors)
become a sort-based stream compaction: valid new detections are paired with
free feature slots via two argsorts and committed with a single masked
scatter — fully static shapes, jit/vmap-safe (SURVEY.md §7.3.1).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..backend import loop_closure
from ..config import SvoConfig
from ..engine.state import (STATUS_DEAD, STATUS_SEED, SlamState)
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import align as align_ops
from ..ops import depth_filter, klt as klt_ops, stereo_match
from . import detector


def cell_index(cfg: SvoConfig, uv: jnp.ndarray) -> jnp.ndarray:
    """Grid cell id of level-0 positions (N,2) → (N,) int32."""
    H, W = cfg.camera.height, cfg.camera.width
    ch = H // cfg.grid_rows
    cw = W // cfg.grid_cols
    cy = jnp.clip(uv[:, 1].astype(jnp.int32) // ch, 0, cfg.grid_rows - 1)
    cx = jnp.clip(uv[:, 0].astype(jnp.int32) // cw, 0, cfg.grid_cols - 1)
    return cy * cfg.grid_cols + cx


def mem_coverage_slot(mem_valid: jnp.ndarray, mem_stamp: jnp.ndarray,
                      protected: jnp.ndarray) -> jnp.ndarray:
    """Temporal-coverage retention: which memory-bank slot to (over)write.

    Empty slots are used first. Once the bank is full, evict the slot whose
    removal least widens the retained temporal coverage — the slot in the
    densest stamp neighborhood (gap = next_stamp − prev_stamp). The oldest
    and newest retained keyframes are never evicted (map origin / recency
    anchor), nor is anything in ``protected`` (current-window ownership).

    The retained stamps converge to a ~uniform thinning of the whole
    history, so a revisit after thousands of frames still finds a nearby
    retained keyframe — a fixed-size bank with an unbounded loop horizon,
    vs. the FIFO ring's mem_keyframes·KF-interval horizon (VERDICT r1
    weak #4: KITTI 00 closes loops after thousands of frames).
    """
    M = mem_valid.shape[0]
    big = jnp.asarray(2 ** 30, mem_stamp.dtype)
    first_free = jnp.argmin(mem_valid).astype(jnp.int32)  # first False
    all_full = jnp.all(mem_valid)
    order = jnp.argsort(jnp.where(mem_valid, mem_stamp, big))
    s = mem_stamp[order]
    nxt = jnp.concatenate([s[1:], s[-1:]])
    prv = jnp.concatenate([s[:1], s[:-1]])
    loss_sorted = (nxt - prv).astype(jnp.float32)
    idx = jnp.arange(M)
    loss_sorted = jnp.where((idx == 0) | (idx == M - 1), jnp.inf,
                            loss_sorted)
    loss = jnp.zeros(M, jnp.float32).at[order].set(loss_sorted)
    loss = jnp.where(protected, jnp.inf, loss)
    # Degenerate bank (protected slots + the two temporal anchors cover
    # everything, possible when mem_keyframes <= max_keyframes + 2): every
    # loss is +inf and argmin would silently evict slot 0 — possibly a
    # protected slot, breaking the BA write-back ownership invariant
    # (advisor r2 finding #2). Fall back to the oldest NON-protected slot
    # (sacrificing an anchor is safe; stomping window ownership is not).
    fallback = jnp.where(protected, jnp.inf, mem_stamp.astype(jnp.float32))
    loss = jnp.where(jnp.all(jnp.isinf(loss)), fallback, loss)
    evict = jnp.argmin(loss).astype(jnp.int32)
    return jnp.where(all_full, evict, first_free)


def insert(cfg: SvoConfig, state: SlamState, pyr_l, gxs, gys,
           img_r: jnp.ndarray, T_cw: jnp.ndarray) -> SlamState:
    """Create a keyframe at pose T_cw from the current stereo pair."""
    cam = cfg.camera
    N = cfg.max_features
    K = cfg.max_keyframes
    n_cells = cfg.grid_rows * cfg.grid_cols

    # --- slot choice: empty slots first, else evict the valid keyframe
    # owning the fewest active features (never the newest). A plain FIFO
    # ring evicts feature-rich keyframes during high-KF-rate stretches and
    # cascades feature loss (each eviction kills its owned features).
    owned = jnp.zeros(K, jnp.float32).at[
        jnp.where(state.status > 0, state.kf_id, K)].add(1.0, mode="drop")
    cost = jnp.where(state.kf_valid, owned, -1.0)        # empty slots win
    cost = jnp.where(jnp.arange(K) == state.last_kf, 1e9, cost)
    slot = jnp.argmin(cost).astype(jnp.int32)

    # Features owned by the evicted keyframe slot lose their anchor → dead.
    status = jnp.where((state.kf_id == slot) & (state.status > 0),
                       STATUS_DEAD, state.status)
    active = status > 0

    # --- spatially free cells (no currently tracked feature) ---
    cells = cell_index(cfg, state.feat_uv)
    cells = jnp.where(active, cells, n_cells)  # OOB → dropped by scatter
    occupied = jnp.zeros(n_cells, bool).at[cells].set(True, mode="drop")
    free_cells = ~occupied

    # --- detect & stereo-bootstrap new candidates ---
    det = detector.detect(pyr_l, gxs[0], gys[0], cfg, free_cells)
    disp, zncc, st_ok = stereo_match.match(
        pyr_l[0], img_r, det.uv, cfg.stereo_max_disp, cfg.stereo_patch)
    z0 = cam_mod.disparity_to_depth(cam, disp)
    cand = det.valid & st_ok & (z0 > 0.3) & (z0 < 80.0)

    # --- pair valid candidates with free slots (sort-based compaction) ---
    # stable argsort: free slots first, in index order
    free_order = jnp.argsort(jnp.where(status == STATUS_DEAD, 0, 1),
                             stable=True)
    cand_order = jnp.argsort(jnp.where(cand, 0, 1), stable=True)
    n_free = jnp.sum(status == STATUS_DEAD)
    n_cand = jnp.sum(cand)
    j = jnp.arange(N)
    assign = (j < jnp.minimum(n_free, n_cand))
    dst = jnp.where(assign, free_order, N)            # OOB drop when unused
    src = cand_order

    mu0, s20, a0, b0 = depth_filter.seed_from_stereo(
        cam, cfg, z0, px_scale=jnp.exp2(det.level.astype(jnp.float32)))

    def put(arr, vals):
        return arr.at[dst].set(vals[src], mode="drop")

    status = put(status, jnp.full(N, STATUS_SEED, jnp.int32))
    feat_uv = put(state.feat_uv, det.uv)
    feat_level = put(state.feat_level, det.level)
    feat_corner = put(state.feat_corner, det.is_corner)
    feat_dir = put(state.feat_dir, det.grad_dir)
    kf_id = put(state.kf_id, jnp.full(N, slot, jnp.int32))
    kf_uv = put(state.kf_uv, det.uv)
    mu = put(state.mu, mu0)
    sigma2 = put(state.sigma2, s20)
    a_beta = put(state.a_beta, a0)
    b_beta = put(state.b_beta, b0)
    z_range = put(state.z_range, jnp.clip(2.0 * mu0, 0.5, 4.0))
    n_upd = put(state.n_upd, jnp.zeros(N, jnp.int32))

    new_rows = jnp.zeros(N, bool).at[dst].set(assign, mode="drop")

    # --- KLT templates: new rows from this keyframe's pyramid ---
    fresh = klt_ops.make_template(pyr_l, gxs, gys, cfg, feat_uv,
                                  status > 0)
    blend = lambda old, new: jnp.where(
        new_rows.reshape((1, N) + (1,) * (new.ndim - 2)), new, old)
    klt_tmpl = klt_ops.KltTemplate(
        patches=blend(state.klt_tmpl.patches, fresh.patches),
        jac=blend(state.klt_tmpl.jac, fresh.jac),
        hinv=blend(state.klt_tmpl.hinv, fresh.hinv),
        mask=jnp.where(new_rows, True, state.klt_tmpl.mask & (status > 0)),
        big=blend(state.klt_tmpl.big, fresh.big),
        big_ok=jnp.where(new_rows[None, :], fresh.big_ok,
                         state.klt_tmpl.big_ok))

    # --- keyframe ring buffer ---
    T_wk = se3.inverse(T_cw)
    kf_T_wk = state.kf_T_wk.at[slot].set(T_wk)
    kf_valid = state.kf_valid.at[slot].set(True)

    # --- place-recognition record: descriptor + coarse thumbnail ---
    # (backend/loop_closure.py; also the relocalization index — step()
    # seeds re-tracking from the appearance-nearest keyframe.)
    desc = loop_closure.descriptor(pyr_l[cfg.num_levels - 1],
                                   cfg.loop_desc_rows, cfg.loop_desc_cols)
    kf_stamp = state.kf_stamp.at[slot].set(state.frame_idx)
    kf_desc = state.kf_desc.at[slot].set(desc)
    kf_thumb = state.kf_thumb.at[slot].set(pyr_l[cfg.thumb_level])

    # --- observation snapshot for BA (every tracked feature, incl. new) ---
    # Re-match stereo at ALL tracked features' current positions so each
    # keyframe observation carries a disparity: the stereo residual row is
    # what pins scale in the window BA (backend/ba.py). A raw epipolar
    # match can lock onto occlusions/repeated texture with confident but
    # wrong disparity, so each measurement is gated against the disparity
    # predicted by the feature's own depth estimate (the recursive filter's
    # posterior) — the BA only ever sees consistent stereo rows.
    disp_all, _, disp_ok = stereo_match.match(
        pyr_l[0], img_r, feat_uv, cfg.stereo_max_disp, cfg.stereo_patch,
        min_zncc=0.7)
    p_kf = cam_mod.backproject(cam, kf_uv, 1.0 / jnp.maximum(mu, 1e-4))
    # world → current-camera depth of each feature (anchors already updated)
    T_wk_per = kf_T_wk[kf_id]                               # (N,3,4)
    X_w = se3.transform(T_wk_per, p_kf)
    z_cur = se3.transform(T_cw, X_w)[..., 2]
    disp_pred = cam.fx * cam.baseline / jnp.maximum(z_cur, 1e-3)
    window = jnp.maximum(cfg.stereo_consist_px,
                         cfg.stereo_consist_rel * disp_all)
    consistent = jnp.abs(disp_all - disp_pred) < window
    # Slot-reuse hygiene: a feature slot newly assigned THIS insert holds a
    # brand-new landmark — observation columns of that slot in OLDER
    # keyframes belong to the dead previous occupant. Leaving them masked-
    # in associates the new landmark with the old feature's pixels and the
    # window BA drags poses to fit the mismatch while its cost still
    # decreases (measured: the dominant error source of the KITTI-geometry
    # road run — BA moved each new keyframe up to 338 mm forward;
    # 9778a94:BASELINE.md r3 root-cause #3).
    obs_mask_clean = state.obs_mask & ~new_rows[None, :]
    obs_dmask_clean = state.obs_dmask & ~new_rows[None, :]
    obs_uv = state.obs_uv.at[slot].set(feat_uv)
    obs_mask = obs_mask_clean.at[slot].set(status > 0)
    obs_disp = state.obs_disp.at[slot].set(disp_all)
    obs_dmask = obs_dmask_clean.at[slot].set(
        disp_ok & consistent & (status > 0))
    obs_sig = state.obs_sig.at[slot].set(
        jnp.exp2(feat_level.astype(jnp.float32)))

    # --- long-horizon memory bank (survives window eviction) ---
    if cfg.mem_retention == "fifo":
        m = state.mem_next % cfg.mem_keyframes
    else:
        # coverage retention: never evict slots the current window still
        # owns (BA write-back + relocalization anchors point there)
        M = cfg.mem_keyframes
        owned = jnp.zeros(M, bool).at[jnp.where(
            state.kf_valid
            & (state.mem_stamp[state.kf_mem] == state.kf_stamp),
            state.kf_mem, M)].set(True, mode="drop")
        m = mem_coverage_slot(state.mem_valid, state.mem_stamp, owned)
    mem = dict(
        mem_T_wk=state.mem_T_wk.at[m].set(T_wk),
        mem_valid=state.mem_valid.at[m].set(True),
        mem_stamp=state.mem_stamp.at[m].set(state.frame_idx),
        mem_desc=state.mem_desc.at[m].set(desc),
        mem_thumb=state.mem_thumb.at[m].set(pyr_l[cfg.thumb_level]),
        mem_uv=state.mem_uv.at[m].set(feat_uv),
        mem_mask=state.mem_mask.at[m].set(status > 0),
        mem_disp=state.mem_disp.at[m].set(disp_all),
        mem_dmask=state.mem_dmask.at[m].set(disp_ok & (status > 0)),
        mem_next=state.mem_next + 1,
        kf_mem=state.kf_mem.at[slot].set(m))

    return state._replace(
        status=status, feat_uv=feat_uv, feat_level=feat_level,
        feat_corner=feat_corner, feat_dir=feat_dir, kf_id=kf_id,
        kf_uv=kf_uv, mu=mu, sigma2=sigma2, a_beta=a_beta, b_beta=b_beta,
        z_range=z_range, n_upd=n_upd, klt_tmpl=klt_tmpl,
        kf_T_wk=kf_T_wk, kf_valid=kf_valid,
        kf_next=state.kf_next + 1, last_kf=slot,
        kf_stamp=kf_stamp, kf_desc=kf_desc, kf_thumb=kf_thumb,
        obs_uv=obs_uv, obs_mask=obs_mask,
        obs_disp=obs_disp, obs_dmask=obs_dmask, obs_sig=obs_sig, **mem)
