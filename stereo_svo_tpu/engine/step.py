"""The per-frame SVO state machine as one jitted function.

Reference parity: StereoSlam::new_image — the per-frame entry point and the
only load-bearing API of the reference (SURVEY.md §1, §3.1):

    pyramid → sparse align → KLT feature alignment → pose refinement →
    depth-filter updates → keyframe decision → (maybe) keyframe insertion

Every data-dependent branch of the reference (KF insertion, seed
promote/cull, track loss) stays **on device**: `lax.cond` for the keyframe
branch, masked arithmetic for everything else — no host round-trips in
steady state (SURVEY.md §7.0.2, §7.3.1). ``vmap(step)`` batches whole
sequences (north-star config #4).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..backend import loop_closure
from ..config import SvoConfig
from ..frontend import detector, keyframe, pose_refine
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import align as align_ops
from ..ops import depth_filter, klt as klt_ops, pyramid, solve, stereo_match
from .state import (STATUS_DEAD, STATUS_LANDMARK, STATUS_SEED, FrameOut,
                    SlamState, init_state)


def world_points(cfg: SvoConfig, state: SlamState) -> jnp.ndarray:
    """(N,3) world positions from owner-KF anchor + inverse-depth mean."""
    z = 1.0 / jnp.maximum(state.mu, 1e-4)
    p_kf = cam_mod.backproject(cfg.camera, state.kf_uv, z)
    T_wk = state.kf_T_wk[state.kf_id]                  # (N,3,4)
    return se3.transform(T_wk, p_kf)


def _masked_median(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    big = jnp.where(mask, x, jnp.inf)
    s = jnp.sort(big)
    n = jnp.sum(mask)
    idx = jnp.clip((n - 1) // 2, 0, x.shape[0] - 1)
    # all-false mask (fully lost frame): s[idx] would be inf and flow into
    # the keyframe-distance gating — return a benign positive depth instead
    return jnp.where(n > 0, s[idx], jnp.asarray(1.0, s.dtype))


def run_window_ba(cfg: SvoConfig, st: SlamState) -> SlamState:
    """Window stereo BA over the keyframe ring + converged landmarks,
    writing refined geometry back into the anchor parameterization
    (SURVEY.md §7.1 stage 6). Seeds keep their recursive filters."""
    from ..backend import ba as ba_mod  # local import: engine↔backend cycle

    cam = cfg.camera
    X = world_points(cfg, st)
    X_mask = st.status == STATUS_LANDMARK
    kf_T_wk, X_new, stats = ba_mod.bundle_adjust(
        cam, cfg, st.kf_T_wk, st.kf_valid, X, X_mask,
        st.obs_uv, st.obs_mask, st.obs_disp, st.obs_dmask,
        obs_sig=st.obs_sig, kf_stamp=st.kf_stamp)

    # Divergence guards: a GN step on adversarial data (gross outliers past
    # the gates) must never corrupt the map. Accept only if (a) cost
    # dropped AND (b) the correction is trust-region plausible — window BA
    # refines by millimeters; a large jump of the newest keyframe means the
    # solver latched onto outliers, and committing it would corrupt the
    # alignment template chain irrecoverably (observed failure mode).
    dr, dt = se3.distance(kf_T_wk[st.last_kf], st.kf_T_wk[st.last_kf])
    if cfg.ba_trust_clamp:
        # Damped acceptance: a proposal beyond the trust region applies
        # as a geodesic PARTIAL step scaled to the trust radius instead
        # of being discarded. Binary rejection threw away exactly the
        # large legitimate recovery pulls (road_long r5: 0.4-0.8 m
        # proposals with 3-4x cost drops rejected at trust 0.40 while
        # drift compounded).
        s = jnp.minimum(1.0, jnp.minimum(
            cfg.ba_trust_t / jnp.maximum(dt, 1e-9),
            cfg.ba_trust_r / jnp.maximum(dr, 1e-9)))
        kf_T_wk = jax.vmap(lambda Tp, To: se3.compose(
            se3.exp(s * se3.log(se3.compose(Tp, se3.inverse(To)))), To))(
            kf_T_wk, st.kf_T_wk)
        X_new = X + s * (X_new - X)
        ok = stats.cost_final < stats.cost_initial
    else:
        ok = ((stats.cost_final < stats.cost_initial)
              & (dt < cfg.ba_trust_t) & (dr < cfg.ba_trust_r))
    # signed forward component of the newest keyframe's proposed move,
    # in its own camera frame (z > 0 = BA pushed it forward)
    delta_c = se3.transform(se3.inverse(st.kf_T_wk[st.last_kf]),
                            se3.translation(kf_T_wk[st.last_kf])[None])[0]
    ba_diag = jnp.stack([dt, dr, delta_c[2], stats.cost_initial,
                         stats.cost_final, ok.astype(jnp.float32),
                         stats.n_obs.astype(jnp.float32)])
    kf_T_wk = jnp.where(ok, kf_T_wk, st.kf_T_wk)
    X_new = jnp.where(ok, X_new, X)

    # Fold the refined world point back into the anchor parameterization.
    # The anchor pixel kf_uv stays put — it is the feature's *photometric*
    # identity (KLT/align templates were sampled there); BA's refinement is
    # absorbed along the anchor bearing as an inverse-depth update only.
    T_kw = se3.inverse(kf_T_wk)
    x_k = se3.transform(T_kw[st.kf_id], X_new)         # (N,3)
    z = x_k[..., 2]
    good = X_mask & (z > 0.1)
    mu = jnp.where(good, 1.0 / jnp.maximum(z, 1e-3), st.mu)
    # refresh the memory-bank poses of keyframes still in the window, so
    # loop closure / relocalization see the BA-refined estimates. Ownership
    # gate: a window keyframe can outlive its FIFO memory slot (the bank
    # recycles after mem_keyframes insertions while least-owned eviction
    # keeps feature-rich window slots alive); writing through a stale
    # kf_mem pointer would stomp a NEWER keyframe's pose while that slot's
    # descriptor/thumbnail/stamp belong to the newer keyframe — corrupting
    # relocalization anchors and loop-closure node poses. The slot is ours
    # only while its stamp still matches the keyframe's creation stamp.
    owns = st.kf_valid & (st.mem_stamp[st.kf_mem] == st.kf_stamp)
    mem_T = st.mem_T_wk.at[jnp.where(owns, st.kf_mem,
                                     st.mem_T_wk.shape[0])].set(
        kf_T_wk, mode="drop")
    return st._replace(kf_T_wk=kf_T_wk, mu=mu, mem_T_wk=mem_T,
                       ba_diag=ba_diag)


def run_online_loop(cfg: SvoConfig, st: SlamState) -> SlamState:
    """Online loop closure at keyframe insertion (VERDICT r3 next #5).

    The offline path (backend/loop_closure.refine_trajectory) repairs
    drift only after the run ends; here a revisit repairs drift DURING
    the run, fully on device (jit/scan/vmap-safe):

      1. incremental proposal: the newest keyframe's descriptor variants
         query the memory bank (one row — not the offline K² matrix);
      2. accepted proposals are measured by thumbnail alignment
         (loop_closure.measure_edges, photometric acceptance gate);
      3. a pose graph over the bank (odometry chain from stamps + the
         measured loop edges) is optimized with the OLDEST retained
         keyframe as gauge, so corrections land on the drifted recent
         poses;
      4. the correction folds into the live state: mem poses take the
         optimum, window keyframes move by their own mem slot's delta,
         and the current/template poses ride the newest keyframe's delta
         (landmarks are anchor-parameterized in keyframe frames, so they
         move consistently for free; velocity is relative and invariant).

    A trust guard rejects corrections that would move the newest keyframe
    further than online_loop_max_t/r — a false loop edge must never
    teleport the live map (the online analog of the BA divergence guard).
    """
    from ..backend import pose_graph  # local import: engine↔backend cycle

    m_new = st.kf_mem[st.last_kf]
    props = loop_closure.propose_online(
        cfg, st.mem_desc, st.mem_valid, st.mem_stamp, m_new,
        st.mem_thumb[m_new])
    meas = loop_closure.measure_edges(
        cfg, props, st.mem_T_wk, st.mem_thumb,
        st.mem_uv, st.mem_mask, st.mem_disp, st.mem_dmask)
    weight = meas.accept.astype(jnp.float32)
    n_edges = jnp.sum(meas.accept).astype(jnp.int32)

    def apply(st: SlamState) -> SlamState:
        chain = pose_graph.chain_graph_stamped(
            st.mem_T_wk, st.mem_valid, st.mem_stamp)
        full = pose_graph.PoseGraph(
            edges_ij=jnp.concatenate([chain.edges_ij, props.edges_ij]),
            Z=jnp.concatenate([chain.Z, meas.Z]),
            weight=jnp.concatenate([chain.weight, weight]))
        # Gauge: the oldest bank slot NOT owned by the active window. The
        # fold below moves owned slots rigidly with the window — pinning
        # one of them would mean the optimizer's anchor itself moves each
        # application, a feedback that measurably ran away (corrections
        # growing 0.01 → 0.39 m within three keyframes).
        owns = st.kf_valid & (st.mem_stamp[st.kf_mem] == st.kf_stamp)
        owned_mem = jnp.zeros(st.mem_valid.shape[0], bool).at[
            jnp.where(owns, st.kf_mem, st.mem_valid.shape[0])
        ].set(True, mode="drop")
        elig = st.mem_valid & ~owned_mem
        big = jnp.iinfo(jnp.int32).max
        oldest = jnp.argmin(
            jnp.where(elig, st.mem_stamp, big)).astype(jnp.int32)
        T_opt, _ = pose_graph.optimize(
            st.mem_T_wk, st.mem_valid, full,
            n_iters=cfg.online_loop_iters, fixed=oldest)

        # trust guard (teleport protection) + significance floor (don't
        # kink the pose history for edge-noise-sized corrections — the
        # depth filters absorb each kink as biased triangulations) + a
        # gauge must exist outside the window. The guard bounds EVERY
        # valid bank slot's correction, not just the newest keyframe's
        # (ADVICE r4): non-owned slots take T_opt wholesale below, so a
        # false loop edge that barely moves m_new could still teleport
        # mid-bank poses used for relocalization and future loop queries.
        dr, dt = se3.distance(T_opt[m_new], st.mem_T_wk[m_new])
        dr_all, dt_all = jax.vmap(se3.distance)(T_opt, st.mem_T_wk)
        # owned slots move rigidly by delta_last (magnitude == dt), so the
        # bank-wide bound applies T_opt's delta to non-owned slots only
        nonowned = st.mem_valid & ~owned_mem
        dt_max = jnp.maximum(jnp.max(jnp.where(nonowned, dt_all, 0.0)), dt)
        dr_max = jnp.maximum(jnp.max(jnp.where(nonowned, dr_all, 0.0)), dr)
        # adaptive significance floor: the worst accepted edge's
        # round-trip error is that edge's own noise estimate — a
        # correction smaller than k× it is indistinguishable from edge
        # noise and must not kink the pose history (static floors
        # under-gate crisp rigs and over-gate blurry ones; see
        # config.online_loop_noise_k)
        noise_t = jnp.max(jnp.where(meas.accept, meas.rt_t, 0.0))
        noise_r = jnp.max(jnp.where(meas.accept, meas.rt_r, 0.0))
        floor_t = jnp.maximum(cfg.online_loop_min_t,
                              cfg.online_loop_noise_k * noise_t)
        floor_r = jnp.maximum(cfg.online_loop_min_r,
                              cfg.online_loop_noise_k * noise_r)
        ok = ((dt_max < cfg.online_loop_max_t)
              & (dr_max < cfg.online_loop_max_r)
              & ((dt > floor_t) | (dr > floor_r))
              & jnp.any(elig)
              & jnp.all(jnp.isfinite(T_opt)))

        # Fold the correction in TWO regimes (the live-map consistency
        # rule; first attempt applied each window keyframe's own graph
        # delta and collapsed tracking within ~5 frames — the graph
        # distributes different deltas along the chain, landmarks anchored
        # in different window KFs became mutually inconsistent, pose
        # refinement tugged the camera between them, and the template
        # chain corrupted):
        #   * the ACTIVE WINDOW (keyframes + landmarks they anchor +
        #     current/template poses) moves RIGIDLY by the newest
        #     keyframe's delta — internal geometry untouched, tracking
        #     continues as if nothing happened, in corrected world frame;
        #   * the long-horizon bank outside the window takes the full
        #     graph optimum (it anchors relocalization and future loop
        #     queries, not live tracking).
        # Owned mem slots mirror their window keyframe (the BA write-back
        # invariant), NOT T_opt, so window and bank never disagree.
        delta_last = se3.compose(T_opt[m_new],
                                 se3.inverse(st.mem_T_wk[m_new]))
        kf_T_new = jax.vmap(lambda t: se3.compose(delta_last, t))(
            st.kf_T_wk)
        kf_T_new = jnp.where(st.kf_valid[:, None, None], kf_T_new,
                             st.kf_T_wk)
        mem_rigid = jax.vmap(lambda t: se3.compose(delta_last, t))(
            st.mem_T_wk)
        mem_T_new = jnp.where(
            owned_mem[:, None, None], mem_rigid,
            jnp.where(st.mem_valid[:, None, None], T_opt, st.mem_T_wk))
        # current + template anchor poses (world→cam): T_cw ∘ delta⁻¹
        inv_d = se3.inverse(delta_last)
        T_cw_new = se3.compose(st.T_cw, inv_d)
        T_pw_new = se3.compose(st.T_pw, inv_d)

        new = st._replace(kf_T_wk=kf_T_new, mem_T_wk=mem_T_new,
                          T_cw=T_cw_new, T_pw=T_pw_new,
                          n_loop_closures=st.n_loop_closures + n_edges,
                          last_loop_mem=st.mem_next)
        return jax.tree.map(lambda a, b: jnp.where(ok, a, b), new, st)

    return jax.lax.cond(n_edges > 0, apply, lambda s: s, st)


def _rebuild_template(cfg: SvoConfig, state: SlamState, pyr_l, gxs, gys,
                      T_cw: jnp.ndarray,
                      z_obs=None, z_obs_ok=None) -> SlamState:
    """Anchor the next frame's alignment template at the current frame.

    z_obs/z_obs_ok: optional (N,) per-feature depths measured in THIS
    frame's stereo pair (and validity). Template depth sets the align
    stage's translation gain directly — forward flow ∝ t/z, so a map
    depth bias of +b% makes every aligned forward step +b% hot (the r5
    road_long forensic signature: sustained +4..+17% per-frame overshoot
    tracking a far-biased map). The measured disparity is pose- and
    map-free; where available it replaces the map depth here, severing
    the map-bias → align-gain coupling.
    """
    X_w = world_points(cfg, state)
    x_c = se3.transform(T_cw, X_w)
    z_cur = x_c[..., 2]
    if z_obs is not None:
        z_cur = jnp.where(z_obs_ok & (z_obs > 0.1), z_obs, z_cur)
    mask = ((state.status > 0) & (z_cur > 0.1)
            & cam_mod.in_bounds(cfg.camera, state.feat_uv,
                                margin=cfg.align_patch))
    tmpl = align_ops.make_template(pyr_l, gxs, gys, cfg.camera, cfg,
                                   state.feat_uv, z_cur, mask)
    return state._replace(tmpl=tmpl)


class TrackCtx(NamedTuple):
    """Per-frame tracking context threaded between the step phases."""
    T_cw: jnp.ndarray          # (3,4) refined pose (pre-KF-BA correction)
    ok: jnp.ndarray            # () tracking success
    need_kf: jnp.ndarray       # () keyframe decision
    n_inl: jnp.ndarray         # () inlier count
    med_depth: jnp.ndarray     # () median scene depth
    align_cost: jnp.ndarray
    align_inlier_frac: jnp.ndarray
    refine_rms_px: jnp.ndarray
    n_seed_deaths: jnp.ndarray   # () int32 (see FrameOut)
    n_epi_recovered: jnp.ndarray  # () int32
    tmpl_z_obs: jnp.ndarray    # (N,) this frame's stereo-measured depths
    tmpl_z_ok: jnp.ndarray     # (N,) …validity (template depth override)


def make_phases(cfg: SvoConfig):
    """The per-frame state machine split into composable phases.

    ``make_step`` chains them with a per-sequence ``lax.cond`` around the
    keyframe phase (single-sequence scan runner); ``make_batched_step``
    vmaps each phase and gates the keyframe phase with ONE cond on
    ``jnp.any(need_kf)`` across the batch — under plain ``vmap(step)`` the
    cond decays to a select and every sequence pays detection+stereo+BA
    every frame, which is exactly what capped config #4's throughput
    (VERDICT r1 item 2).
    """
    cam = cfg.camera

    def boot(st: SlamState, pyr_l, gxs, gys, img_r):
        """First frame: create the bootstrap keyframe (SURVEY.md §3.2)."""
        T_cw = st.T_cw  # initial pose (identity unless caller seeded it)
        st = keyframe.insert(cfg, st, pyr_l, gxs, gys, img_r, T_cw)
        st = _rebuild_template(cfg, st, pyr_l, gxs, gys, T_cw)
        st = st._replace(T_pw=T_cw, vel=jnp.zeros(6, jnp.float32),
                         frame_idx=st.frame_idx + 1,
                         tracking_ok=jnp.asarray(True))
        z = jnp.zeros((), jnp.float32)
        out = FrameOut(
            T_wc=se3.inverse(T_cw), tracking_ok=jnp.asarray(True),
            kf_inserted=jnp.asarray(True),
            n_tracked=jnp.sum(st.status > 0),
            n_seeds=jnp.sum(st.status == STATUS_SEED),
            n_landmarks=jnp.sum(st.status == STATUS_LANDMARK),
            align_cost=z, align_inlier_frac=z + 1.0,
            refine_rms_px=z,
            median_depth=_masked_median(
                1.0 / jnp.maximum(st.mu, 1e-4), st.status > 0),
            n_seed_deaths=jnp.asarray(0, jnp.int32),
            n_epi_recovered=jnp.asarray(0, jnp.int32),
            ba_diag=st.ba_diag)
        return st, out

    def track_phase(st: SlamState, pyr_l, gxs, gys, img_r
                    ) -> Tuple[SlamState, TrackCtx]:
            # --- 1. sparse direct alignment vs previous frame ---
            # Relocalization seed (SURVEY.md §5.3): after a failed frame the
            # constant-velocity prior is meaningless — restart from the
            # appearance-nearest stored keyframe (descriptor search over the
            # whole bank, backend/loop_closure.relocalize), not blindly from
            # the most recent one.
            T_init_vel = se3.exp(st.vel)
            reloc, reloc_score = loop_closure.relocalize(
                st.mem_desc, st.mem_valid, pyr_l[cfg.num_levels - 1],
                cfg.loop_desc_rows, cfg.loop_desc_cols,
                n_rot=cfg.pr_rot_variants, rot_step=cfg.pr_rot_step_rad,
                rot_gate=~st.tracking_ok)
            # On a textureless/blackout frame the query descriptor
            # degenerates to ~zero: every bank entry scores ~0 and argmax
            # returns an arbitrary (possibly distant) keyframe. Below the
            # score floor, fall back to the most RECENT keyframe — the
            # best prior when appearance carries no information.
            latest = jnp.argmax(
                jnp.where(st.mem_valid, st.mem_stamp, -1)).astype(jnp.int32)
            reloc = jnp.where(reloc_score >= cfg.reloc_min_score,
                              reloc, latest)
            T_kf_rel = se3.compose(se3.inverse(st.mem_T_wk[reloc]),
                                   se3.inverse(st.T_pw))
            T_init = jax.tree.map(
                lambda a, b: jnp.where(st.tracking_ok, a, b),
                T_init_vel, T_kf_rel)
            T_cp, align_stats = align_ops.align(pyr_l, st.tmpl, cam, cfg,
                                                T_init)
            T_cw_pred = se3.compose(T_cp, st.T_pw)

            # --- 2. KLT feature alignment vs keyframe templates ---
            active = st.status > 0
            X_w = world_points(cfg, st)
            x_c = se3.transform(T_cw_pred, X_w)
            uv_pred, front = cam_mod.project(cam, x_c)
            in_img = front & cam_mod.in_bounds(
                cam, uv_pred, margin=cfg.klt_patch + 2)
            klt_mask = active & in_img
            if cfg.klt_affine_warp:
                # pose-predicted affine template warp (SVO's
                # getWarpMatrixAffine); degenerate/shrinking warps fall
                # back to the identity (fronto-parallel template)
                z_ref = 1.0 / jnp.maximum(st.mu, 1e-4)
                T_ck_pred = se3.compose(T_cw_pred[None],
                                        st.kf_T_wk[st.kf_id])
                A = cam_mod.affine_warp_matrix(cam, st.kf_uv, z_ref,
                                               T_ck_pred)
                # det guard at 0.2 (not 0.05): strongly shrinking warps
                # alias the oversized template grid; below this the
                # fronto-parallel fallback tracks better anyway
                det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
                A = jnp.where((det > 0.2)[:, None, None], A,
                              jnp.eye(2, dtype=A.dtype))
                A_inv = solve.inv2x2(A)
            else:
                A_inv = None
            uv_ref, klt_ok, _ = klt_ops.track(
                pyr_l, st.klt_tmpl._replace(mask=st.klt_tmpl.mask & klt_mask),
                cfg, uv_pred, edge_dir=st.feat_dir,
                is_edgelet=~st.feat_corner, A_inv=A_inv)
            tracked = klt_mask & klt_ok

            # --- 3. per-frame stereo disparity at the tracked positions
            # (measured BEFORE refinement: the rows feed the pose refiner
            # as direct depth observations AND the depth filter below —
            # one search, two consumers) ---
            disp_m = ok_m = None
            if cfg.stereo_refresh_window > 0:
                z_pred = jnp.maximum(x_c[..., 2], 0.2)
                disp_pred = cam.fx * cam.baseline / z_pred
                disp_m, _, ok_m = stereo_match.refine_disparity(
                    pyr_l[0], img_r, uv_ref, disp_pred,
                    cfg.stereo_refresh_window, cfg.stereo_patch)

            # --- 4. motion-only pose refinement: reprojection rows plus
            # (when measured) stereo disparity rows — the forward-scale
            # anchor on far-dominated scenes (see pose_refine.refine) ---
            # per-feature noise: a feature detected at pyramid level L
            # localizes to ~2^L px (SURVEY.md §2.1 detector row)
            obs_sigma = jnp.exp2(st.feat_level.astype(jnp.float32))
            sig_reproj = obs_sigma
            sig_disp = obs_sigma
            if cfg.refine_whiten_depth:
                # fold each feature's MAP uncertainty into the row noise:
                # a depth error σ_z displaces the reprojection by
                # ≈ fx·‖t_ck‖·σ_z/z² = fx·‖t_ck‖·σ_μ px (σ_μ = posterior
                # inverse-depth σ) and the predicted disparity by
                # ≈ fx·B·σ_μ px. Without this the refiner treats
                # estimated depth as EXACT, so fresh seeds' pose-
                # correlated depth noise couples straight back into the
                # pose (r5 road_long forward-overshoot forensics).
                sd_mu = jnp.sqrt(jnp.maximum(st.sigma2, 0.0))
                t_ck_n = jnp.linalg.norm(se3.translation(
                    se3.compose(T_cw_pred[None], st.kf_T_wk[st.kf_id])),
                    axis=-1)
                sig_reproj = jnp.sqrt(obs_sigma ** 2
                                      + (cam.fx * t_ck_n * sd_mu) ** 2)
                sig_disp = jnp.sqrt(obs_sigma ** 2
                                    + (cam.fx * cam.baseline * sd_mu) ** 2)
            # motion prior target: the same prediction that seeded the
            # align (constant velocity, or the relocalization pose after
            # a failure) composed to a world→camera pose
            T_prior = se3.compose(T_init, st.T_pw)
            T_cw, inliers, refine_stats = pose_refine.refine(
                cam, cfg, T_cw_pred, X_w, uv_ref, tracked,
                obs_sigma=sig_reproj, T_prior=T_prior,
                disp_obs=disp_m,
                disp_mask=None if ok_m is None else (tracked & ok_m),
                obs_sigma_d=sig_disp)
            n_inl = refine_stats["refine_inliers"]
            ok = (n_inl >= 10) & jnp.all(jnp.isfinite(T_cw))
            # Failed frame: do NOT commit the diverging estimate — anchor
            # at the relocalization keyframe instead, so the next frame's
            # restart composes from a sane, finite pose. Without this the
            # pose compounds garbage across consecutive failures until it
            # reaches inf/NaN and poisons the whole state permanently
            # (observed: poserr 15 → 54 → 8e3 → 1e9 → NaN).
            T_cw = jax.tree.map(
                lambda a, b: jnp.where(ok, a, b),
                T_cw, se3.inverse(st.mem_T_wk[reloc]))

            # --- 4. feature bookkeeping ---
            # On a failed frame nothing is trusted: keep features alive so
            # the relocalization attempt next frame still has its map.
            # A KLT non-convergence alone is NOT a kill (weak texture this
            # frame can recover next frame); only geometric evidence kills:
            # leaving the image, or being a reprojection outlier.
            lost = ok & active & (~in_img | (tracked & ~inliers))
            status = jnp.where(lost, STATUS_DEAD, st.status)
            feat_uv = jnp.where((ok & tracked & inliers)[:, None],
                                uv_ref, uv_pred)

            # --- 5. recursive depth-filter updates (seeds only) ---
            T_wk_per = st.kf_T_wk[st.kf_id]
            T_ck = se3.compose(T_cw[None], T_wk_per)       # (N,3,4)
            seeds_klt = ok & (status == STATUS_SEED) & inliers
            # Seeds KLT failed on this frame still get measured: 1-D ZNCC
            # search along the seed's epipolar segment (the reference's
            # DepthFilter epipolar search, SURVEY.md §3.5) — without it a
            # briefly-untrackable seed collects zero observations and dies
            # by update budget instead of converging.
            status_in = st.status         # for the seed-death counter
            obs_uv_df = feat_uv
            px_scale = obs_sigma
            seeds = seeds_klt
            n_epi = jnp.asarray(0, jnp.int32)
            if cfg.epi_samples > 0:
                lv_e = cfg.epi_level   # validated ≤ klt_levels-1 in config
                lost_seed = (ok & (status == STATUS_SEED)
                             & ~(tracked & inliers) & st.klt_tmpl.mask)
                uv_epi, epi_ok, _ = depth_filter.epipolar_search(
                    cam, cfg, T_ck, st.kf_uv, st.mu, st.sigma2,
                    st.klt_tmpl.patches[lv_e], pyr_l[lv_e], lost_seed,
                    level=lv_e)
                recovered = lost_seed & epi_ok
                n_epi = jnp.sum(recovered).astype(jnp.int32)
                seeds = seeds_klt | recovered
                # The epipolar hit feeds the DEPTH FILTER ONLY — never the
                # feature's tracked position (a broad ZNCC peak on smooth
                # texture localizes worse than KLT; letting it overwrite
                # feat_uv measurably corrupted templates/observations).
                obs_uv_df = jnp.where(recovered[:, None], uv_epi, feat_uv)
                px_scale = jnp.where(
                    recovered, jnp.maximum(obs_sigma, float(2 ** lv_e)),
                    obs_sigma)
            upd = depth_filter.observe_and_update(
                cam, cfg, T_ck, st.kf_uv, obs_uv_df,
                st.mu, st.sigma2, st.a_beta, st.b_beta, st.z_range, seeds,
                px_scale=px_scale)
            n_upd = st.n_upd + upd.updated.astype(jnp.int32)
            if cfg.stereo_refresh_window > 0:
                # per-frame stereo reobservation — the metric-scale anchor.
                # Motion triangulation (above) follows the pose estimate,
                # so pose-scale drift is self-reinforcing; the disparity
                # measurement is pose-free (ops/depth_filter.
                # stereo_observe_and_update). The measurement itself was
                # taken in phase 3 (at uv_ref, which equals feat_uv on
                # every feature the mask below admits).
                # KLT-verified positions only: an untracked feature's
                # feat_uv is the pose prediction, whose left patch may not
                # be the feature — measuring disparity there would fold a
                # wrong ray's depth into the posterior. LANDMARKS included:
                # their depth is otherwise frozen between BA calls, and the
                # residual +2-3% landmark bias was the tail of the road
                # scale drift (the posterior's tiny converged σ² makes each
                # stereo observation a gentle correction, not a jump).
                refresh_status = (status > 0) if cfg.stereo_refresh_landmarks \
                    else (status == STATUS_SEED)
                stereo_seeds = ok & refresh_status & tracked & inliers
                upd2 = depth_filter.stereo_observe_and_update(
                    cam, cfg, se3.inverse(T_ck), feat_uv, disp_m, ok_m,
                    upd.mu, upd.sigma2, upd.a, upd.b, st.z_range,
                    stereo_seeds, px_scale=obs_sigma)
                upd = upd._replace(mu=upd2.mu, sigma2=upd2.sigma2,
                                   a=upd2.a, b=upd2.b)
            conv = depth_filter.converged(cfg, upd.mu, upd.sigma2)
            div = depth_filter.diverged(cfg, upd.a, upd.b, n_upd)
            status = jnp.where((status == STATUS_SEED) & conv,
                               STATUS_LANDMARK, status)
            status = jnp.where((status == STATUS_SEED) & div,
                               STATUS_DEAD, status)
            n_seed_deaths = jnp.sum((status_in == STATUS_SEED)
                                    & (status == STATUS_DEAD)
                                    ).astype(jnp.int32)

            st = st._replace(status=status, feat_uv=feat_uv, mu=upd.mu,
                             sigma2=upd.sigma2, a_beta=upd.a,
                             b_beta=upd.b, n_upd=n_upd)

            # --- 6. keyframe decision (SURVEY.md §3.1 policy) ---
            z_cur = se3.transform(T_cw, world_points(cfg, st))[..., 2]
            med_depth = _masked_median(z_cur, st.status > 0)
            # Distance trigger from the PREDICTED (constant-velocity)
            # center, not the per-frame estimate: the estimate's noise is
            # largest along weakly-observed axes, and triggering on it
            # preferentially fires the keyframe on exactly the frames
            # whose pose excursed the most — anchoring the new keyframe
            # (and all its seeds) at the excursion (measured: +70 mm of
            # immortalized forward error per distance-KF on the
            # KITTI-geometry road run; 9778a94:BASELINE.md r3). The
            # prediction is smooth, so trigger timing decorrelates from
            # estimate noise.
            c_cur = se3.translation(se3.inverse(T_prior))
            c_kf = se3.translation(st.kf_T_wk[st.last_kf])
            kf_dist = jnp.linalg.norm(c_cur - c_kf)
            # Probation after a tracking failure: the first recovered frame
            # may sit on a relocalized-but-imprecise pose; inserting a
            # keyframe there anchors new seeds at a wrong pose and corrupts
            # the map irrecoverably (observed: reloc pose 0.5 m off →
            # cascade of bad keyframes → permanent loss). Require the
            # PREVIOUS frame tracked too.
            regular = ((n_inl < cfg.kf_min_tracked)
                       | (kf_dist > cfg.kf_dist_ratio * med_depth))
            if cfg.kf_every > 1:
                # cadence quantization (batched mode): regular insertions
                # only on every kf_every-th frame, so the batch's single
                # any(need_kf) cond stays cold most frames. A collapsing
                # track (half the feature budget) overrides the cadence.
                urgent = n_inl < max(10, cfg.kf_min_tracked // 2)
                eligible = (st.frame_idx % cfg.kf_every) == 0
                regular = urgent | (regular & eligible)
            need_kf = ok & st.tracking_ok & regular

            if cfg.align_tmpl_stereo and disp_m is not None:
                tmpl_z_obs = cam.fx * cam.baseline / jnp.maximum(disp_m,
                                                                 0.25)
                tmpl_z_ok = tracked & inliers & ok_m
            else:
                tmpl_z_obs = jnp.zeros_like(st.mu)
                tmpl_z_ok = jnp.zeros_like(st.status, bool)
            ctx = TrackCtx(
                T_cw=T_cw, ok=ok, need_kf=need_kf, n_inl=n_inl,
                med_depth=med_depth,
                align_cost=align_stats["align_cost"],
                align_inlier_frac=align_stats["align_inlier_frac"],
                refine_rms_px=refine_stats["refine_rms_px"],
                n_seed_deaths=n_seed_deaths, n_epi_recovered=n_epi,
                tmpl_z_obs=tmpl_z_obs, tmpl_z_ok=tmpl_z_ok)
            return st, ctx

    def kf_phase(st: SlamState, pyr_l, gxs, gys, img_r,
                 T_cw: jnp.ndarray) -> SlamState:
        st = keyframe.insert(cfg, st, pyr_l, gxs, gys, img_r, T_cw)
        if cfg.use_ba:
            st = run_window_ba(cfg, st)
        if cfg.online_loop_every > 0:
            # cadence on total KFs created; BA first, so the loop query
            # and the chain graph see BA-refined poses. Cooldown: after
            # an applied correction, wait online_loop_cooldown further
            # keyframes before querying again (tracking/BA re-settle).
            do = (((st.mem_next % cfg.online_loop_every) == 0)
                  & (st.mem_next - st.last_loop_mem
                     > cfg.online_loop_cooldown))
            st = jax.lax.cond(
                do, lambda s: run_online_loop(cfg, s), lambda s: s, st)
        return st

    def post_phase(st: SlamState, pyr_l, gxs, gys, ctx: TrackCtx
                   ) -> Tuple[SlamState, FrameOut]:
        # BA may have moved the newest keyframe (== this frame).
        T_cw_kf = se3.inverse(st.kf_T_wk[st.last_kf])
        T_cw = jax.tree.map(
            lambda a, b: jnp.where(ctx.need_kf, a, b), T_cw_kf, ctx.T_cw)

        # --- 7. re-anchor next frame's alignment template ---
        # stereo-measured depth override is only valid on non-KF frames:
        # a keyframe insertion recycles feature slots, so ctx's per-slot
        # measurements may belong to dead predecessors (fresh seeds carry
        # exact stereo depths anyway)
        st = _rebuild_template(cfg, st, pyr_l, gxs, gys, T_cw,
                               z_obs=ctx.tmpl_z_obs,
                               z_obs_ok=ctx.tmpl_z_ok & ~ctx.need_kf)
        vel = se3.log(se3.compose(T_cw, se3.inverse(st.T_pw)))
        # damp the constant-velocity prior after a tracking failure
        vel = jnp.where(ctx.ok, vel, 0.5 * st.vel)
        st = st._replace(T_cw=T_cw, T_pw=T_cw, vel=vel,
                         frame_idx=st.frame_idx + 1, tracking_ok=ctx.ok)

        out = FrameOut(
            T_wc=se3.inverse(T_cw), tracking_ok=ctx.ok,
            kf_inserted=ctx.need_kf,
            n_tracked=ctx.n_inl.astype(jnp.int32),
            n_seeds=jnp.sum(st.status == STATUS_SEED),
            n_landmarks=jnp.sum(st.status == STATUS_LANDMARK),
            align_cost=ctx.align_cost,
            align_inlier_frac=ctx.align_inlier_frac,
            refine_rms_px=ctx.refine_rms_px,
            median_depth=ctx.med_depth,
            n_seed_deaths=ctx.n_seed_deaths,
            n_epi_recovered=ctx.n_epi_recovered,
            ba_diag=st.ba_diag)
        return st, out

    return boot, track_phase, kf_phase, post_phase


def make_step(cfg: SvoConfig):
    """Build the jittable per-frame step closure for a static config."""
    boot, track_phase, kf_phase, post_phase = make_phases(cfg)

    def step(state: SlamState, img_l: jnp.ndarray, img_r: jnp.ndarray
             ) -> Tuple[SlamState, FrameOut]:
        pyr_l, gxs, gys = pyramid.build_with_gradients(img_l, cfg.num_levels)

        def do_boot(st):
            return boot(st, pyr_l, gxs, gys, img_r)

        def do_track(st):
            st, ctx = track_phase(st, pyr_l, gxs, gys, img_r)
            st = jax.lax.cond(
                ctx.need_kf,
                lambda s: kf_phase(s, pyr_l, gxs, gys, img_r, ctx.T_cw),
                lambda s: s, st)
            return post_phase(st, pyr_l, gxs, gys, ctx)

        return jax.lax.cond(jnp.any(state.kf_valid), do_track, do_boot,
                            state)

    return step


def make_batched_step(cfg: SvoConfig):
    """Per-frame step over a batch of sequences (north-star config #4).

    Unlike ``vmap(make_step(cfg))`` — where the keyframe ``lax.cond``
    decays to a ``select`` and all sequences pay detection+stereo+BA every
    frame — the keyframe phase here sits under ONE batch-level cond on
    ``jnp.any(need_kf)``: frames where no sequence wants a keyframe skip
    that work entirely. Combine with ``cfg.kf_every > 1`` to keep the cond
    cold on most frames (per-sequence insertions quantize to a shared
    cadence, so they coincide instead of scattering across frames).
    """
    boot, track_phase, kf_phase, post_phase = make_phases(cfg)

    def bcast(m, like):
        return m.reshape(m.shape + (1,) * (like.ndim - 1))

    def bstep(states: SlamState, img_l: jnp.ndarray, img_r: jnp.ndarray
              ) -> Tuple[SlamState, FrameOut]:
        pyr_l, gxs, gys = jax.vmap(
            lambda im: pyramid.build_with_gradients(im, cfg.num_levels)
        )(img_l)

        sts, ctx = jax.vmap(track_phase)(states, pyr_l, gxs, gys, img_r)

        def do_kf(sts):
            sts_i = jax.vmap(kf_phase)(sts, pyr_l, gxs, gys, img_r,
                                       ctx.T_cw)
            return jax.tree.map(
                lambda a, b: jnp.where(bcast(ctx.need_kf, a), a, b),
                sts_i, sts)

        sts = jax.lax.cond(jnp.any(ctx.need_kf), do_kf, lambda s: s, sts)
        sts, outs = jax.vmap(post_phase)(sts, pyr_l, gxs, gys, ctx)

        # Bootstrap (first frame of a sequence) under its own rare cond.
        is_boot = ~jnp.any(states.kf_valid, axis=-1)

        def do_boot(args):
            sts_t, outs_t = args
            sts_b, outs_b = jax.vmap(boot)(states, pyr_l, gxs, gys, img_r)
            pick = lambda a, b: jnp.where(bcast(is_boot, a), a, b)
            return (jax.tree.map(pick, sts_b, sts_t),
                    jax.tree.map(pick, outs_b, outs_t))

        return jax.lax.cond(jnp.any(is_boot), do_boot, lambda a: a,
                            (sts, outs))

    return bstep


def make_jitted_step(cfg: SvoConfig):
    return jax.jit(make_step(cfg), donate_argnums=(0,))


__all__ = ["make_step", "make_batched_step", "make_jitted_step",
           "init_state", "world_points", "SlamState", "FrameOut"]
