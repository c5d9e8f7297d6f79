"""Appearance-based place recognition + loop-closure edge measurement.

The reference is pure odometry — no loop closure exists upstream (SVO-family
systems drift; SURVEY.md §5.3 lists relocalization as absent/stretch). The
pose-graph layer [SPEC] accepts loop edges, so this module supplies the two
missing pieces as batched, fixed-shape device code:

1. **Global descriptor** (``descriptor``): the keyframe's coarsest pyramid
   level average-pooled onto a tiny fixed grid, zero-mean / unit-norm — a
   "tiny thumbnail" place-recognition signature (the classic small-image
   ZNCC matcher of SeqSLAM / LSD-SLAM-style relocalization). Similarity of
   two descriptors is their dot product == ZNCC of the pooled thumbnails,
   invariant to affine lighting. Descriptor compare against a keyframe bank
   is one matvec — no trees or vocabularies.

2. **Edge proposal** (``propose_edges``): dense descriptor similarity
   matrix over the keyframe bank, masked by validity, temporal separation
   (same-sequence pairs must be ``loop_min_gap`` frames apart; cross-
   sequence pairs always eligible), thresholded, top-k → a fixed-capacity
   ``(E,2)`` edge list with scores. Static shapes throughout (the bank is
   the fixed keyframe ring / global-map concatenation).

3. **Edge measurement** (``measure_edges``): for a proposed pair (i, j),
   coarse sparse direct alignment of keyframe j's stored thumbnail against
   keyframe i's stereo-observed feature points (obs_uv + disparity →
   depth), reusing the production alignment kernel (ops/align.py) on a
   thumbnail-scaled camera model. Edges whose photometric inlier fraction
   stays below ``loop_accept_frac`` are rejected (weight 0). Accepted
   edges carry the measured relative pose Z = T_i←j for
   backend/pose_graph.optimize.

All three are jit/vmap-safe; ``measure_edges`` vmaps the GN alignment over
the edge list.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig, SvoConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import align as align_ops
from ..ops import pyramid
from ..precision import MATCHING
from . import pose_graph


def descriptor(img: jnp.ndarray, rows: int, cols: int) -> jnp.ndarray:
    """Tiny-thumbnail global descriptor of a (coarse) image level.

    Average-pools onto a (rows, cols) cell grid (the centered sub-grid of
    a (rows+2, cols+2) pooling — see ``shifted_descriptors``), removes
    mean, L2-normalizes. Returns (rows*cols,) f32 with ||d|| = 1;
    dot(d_a, d_b) == ZNCC of the pooled thumbnails (affine-lighting
    invariant). Matching against a bank takes the max over the query's
    shifted variants for cell-sized viewpoint tolerance.

    Equals ``shifted_descriptors(img, rows, cols)[4]`` exactly, computed
    directly (the insert path needs only the center variant; building all
    nine would be 9x the normalization work — advisor r2 finding #5).
    """
    H, W = img.shape
    R, C = rows + 2, cols + 2
    ch, cw = H // R, W // C
    x = img[: R * ch, : C * cw].astype(jnp.float32)
    grid = x.reshape(R, ch, C, cw).mean(axis=(1, 3))
    sub = grid[1:1 + rows, 1:1 + cols].reshape(-1)
    sub = sub - jnp.mean(sub)
    return sub / jnp.maximum(jnp.linalg.norm(sub), 1e-6)


def _sim(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(K, D) x (M, D) unit descriptors → (K, M) ZNCC scores."""
    return jnp.einsum("kd,md->km", a, b, precision=MATCHING)


def similarity(desc: jnp.ndarray, bank: jnp.ndarray) -> jnp.ndarray:
    """(D,) query vs (K, D) bank → (K,) ZNCC scores in [-1, 1]."""
    return jnp.matmul(bank, desc, precision=MATCHING)


def shifted_descriptors(img: jnp.ndarray, rows: int, cols: int
                        ) -> jnp.ndarray:
    """(9, rows·cols) descriptors of ±1-cell-shifted pooling grids.

    Viewpoint tolerance (ROADMAP r1 #6): a lateral/vertical camera offset
    at revisit translates the thumbnail, which plain pooled-ZNCC punishes.
    Pooling a (rows+2, cols+2) grid and extracting the 9 aligned
    (rows, cols) sub-grids gives cell-sized shift variants (~1/cols of
    the image width each); matching takes the max score over shifts —
    one matmul per shift, still vocabulary-free.

    Index 4 (center) equals ``descriptor(img, rows, cols)`` up to the
    cell-size rounding of the cropped pooling region.
    """
    H, W = img.shape
    R, C = rows + 2, cols + 2
    ch, cw = H // R, W // C
    x = img[: R * ch, : C * cw].astype(jnp.float32)
    grid = x.reshape(R, ch, C, cw).mean(axis=(1, 3))        # (R, C)
    outs = []
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            sub = grid[dy:dy + rows, dx:dx + cols].reshape(-1)
            sub = sub - jnp.mean(sub)
            outs.append(sub / jnp.maximum(jnp.linalg.norm(sub), 1e-6))
    return jnp.stack(outs)


def _bilinear_grid(grid: jnp.ndarray, sy: jnp.ndarray, sx: jnp.ndarray
                   ) -> jnp.ndarray:
    """Bilinear sample of a small (R,C) grid at float coords, clamped."""
    R, C = grid.shape
    sy = jnp.clip(sy, 0.0, R - 1.0)
    sx = jnp.clip(sx, 0.0, C - 1.0)
    y0 = jnp.clip(jnp.floor(sy).astype(jnp.int32), 0, R - 2)
    x0 = jnp.clip(jnp.floor(sx).astype(jnp.int32), 0, C - 2)
    fy = sy - y0
    fx = sx - x0
    g00 = grid[y0, x0]
    g01 = grid[y0, x0 + 1]
    g10 = grid[y0 + 1, x0]
    g11 = grid[y0 + 1, x0 + 1]
    return ((1 - fy) * (1 - fx) * g00 + (1 - fy) * fx * g01
            + fy * (1 - fx) * g10 + fy * fx * g11)


def _rotate_image(img: jnp.ndarray, angle: float) -> jnp.ndarray:
    """Bilinear in-plane rotation about the image center (border clamped).

    Applied only to the tiny coarse pyramid level (a few thousand pixels),
    so rotating the image outright is cheaper AND loss-free compared to
    resampling the pooled grid (pooling first, rotating second decorrelates
    the descriptor — measured 0.62 vs 0.70 shift-only on a 0.25 rad roll).
    """
    import math as _math

    H, W = img.shape
    ca, sa = _math.cos(float(angle)), _math.sin(float(angle))
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    dx = xx - cx
    dy = yy - cy
    sx = ca * dx - sa * dy + cx
    sy = sa * dx + ca * dy + cy
    return _bilinear_grid(img.astype(jnp.float32), sy, sx)


def rotated_descriptors(img: jnp.ndarray, rows: int, cols: int,
                        angles) -> jnp.ndarray:
    """(len(angles), rows·cols) descriptors of in-plane-rotated views.

    In-plane camera roll rotates the thumbnail about its center, which
    plain pooled-ZNCC punishes (VERDICT r2 missing #5). Each variant
    rotates the (coarse) image by θ and applies the standard center
    pooling, so an angle matching the query's roll reproduces the bank
    descriptor almost exactly. Matching takes the max over variants —
    same trick as ``shifted_descriptors``, composing with it.
    """
    return jnp.stack([descriptor(_rotate_image(img, a), rows, cols)
                      for a in angles])


def query_descriptors(img: jnp.ndarray, rows: int, cols: int,
                      n_rot: int = 0, rot_step: float = 0.15
                      ) -> jnp.ndarray:
    """All query-side matching variants: 9 shifts + 2·n_rot rotations.

    Returns (9 + 2·n_rot, rows·cols). Bank entries store only the center
    descriptor; viewpoint tolerance (translation AND in-plane rotation)
    lives entirely on the query side via max-over-variants.

    **Recall envelope** (documented limitation, VERDICT r2 missing #5):
    tolerance covers ±1 pooling cell of translation and ±n_rot·rot_step
    rad of roll. Reverse-heading revisits (out-and-back along the same
    path, camera facing the OPPOSITE direction) image disjoint parts of
    the scene and are unmatchable by ANY appearance descriptor over the
    forward view — they are out of scope by construction, asserted by
    ``tests/test_loop_closure.py::test_reverse_heading_revisit_is_
    documented_miss``. Systems that need them carry a second, backward-
    facing camera or match 3-D structure instead.
    """
    ds = [shifted_descriptors(img, rows, cols)]
    if n_rot > 0:
        angles = [k * rot_step for k in range(-n_rot, n_rot + 1) if k != 0]
        ds.append(rotated_descriptors(img, rows, cols, angles))
    return jnp.concatenate(ds, axis=0)


def relocalize(kf_desc: jnp.ndarray, kf_valid: jnp.ndarray,
               coarse_img: jnp.ndarray, rows: int, cols: int,
               n_rot: int = 0, rot_step: float = 0.15,
               rot_gate: jnp.ndarray | None = None
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Appearance-nearest keyframe for a query frame.

    Relocalization breadth (SURVEY.md §5.3): after tracking failure the
    restart pose is seeded from the keyframe whose descriptor best matches
    the current image — a search over ALL stored keyframes, not just the
    most recent one. Returns (slot, score); invalid slots score -2 (below
    the ZNCC floor of -1). Matching is shift- and (with n_rot > 0)
    roll-tolerant via query-side variants.

    rot_gate: optional scalar bool — compute the rotated variants only
    when True (under ``lax.cond``). The engine calls relocalize every
    frame but only consumes it after a tracking failure; the 2·n_rot
    coarse-image rotations are gather-bound work that healthy frames
    skip.
    """
    ds = shifted_descriptors(coarse_img, rows, cols)          # (9, D)
    scores = jnp.max(_sim(kf_desc, ds), axis=-1)
    if n_rot > 0:
        angles = [k * rot_step for k in range(-n_rot, n_rot + 1) if k != 0]

        def rot_scores(_):
            dr = rotated_descriptors(coarse_img, rows, cols, angles)
            return jnp.max(_sim(kf_desc, dr), axis=-1)

        if rot_gate is None:
            s_rot = rot_scores(None)
        else:
            s_rot = jax.lax.cond(
                rot_gate, rot_scores,
                lambda _: jnp.full(kf_desc.shape[0], -2.0), None)
        scores = jnp.maximum(scores, s_rot)
    scores = jnp.where(kf_valid, scores, -2.0)
    return jnp.argmax(scores).astype(jnp.int32), jnp.max(scores)


class LoopProposals(NamedTuple):
    edges_ij: jnp.ndarray   # (E,2) int32 — keyframe indices (i, j), i "older"
    score: jnp.ndarray      # (E,) descriptor ZNCC
    valid: jnp.ndarray      # (E,) bool


def propose_edges(desc: jnp.ndarray, valid: jnp.ndarray,
                  stamp: jnp.ndarray, seq: jnp.ndarray,
                  min_score: float, min_gap: int, max_edges: int,
                  desc_shift: jnp.ndarray | None = None
                  ) -> LoopProposals:
    """Top-``max_edges`` loop candidates from the descriptor bank.

    Args:
      desc: (K, D) keyframe descriptors.
      valid: (K,) keyframe validity.
      stamp: (K,) int32 frame index at keyframe creation (temporal order).
      seq: (K,) int32 sequence id (global map); pass zeros for one sequence.
      desc_shift: optional (K, 9, D) shifted descriptor variants
        (``shifted_descriptors`` of each keyframe's thumbnail); pairwise
        similarity becomes max over shifts — cell-sized viewpoint
        tolerance (shifting one side covers both directions).
    """
    K = desc.shape[0]
    if desc_shift is not None:
        S = jnp.max(jnp.einsum("kd,msd->kms", desc, desc_shift,
                               precision=MATCHING), axis=-1)
        S = jnp.maximum(S, S.T)                          # symmetrize
    else:
        S = _sim(desc, desc)                             # (K, K)
    i = jnp.arange(K)
    pair_ok = (valid[:, None] & valid[None, :]
               & (i[:, None] < i[None, :]))              # upper triangle
    same = seq[:, None] == seq[None, :]
    gap = jnp.abs(stamp[:, None] - stamp[None, :])
    pair_ok &= jnp.where(same, gap >= min_gap, True)
    S = jnp.where(pair_ok, S, -2.0)

    flat = S.reshape(-1)
    top, idx = jax.lax.top_k(flat, max_edges)
    ei = idx // K
    ej = idx % K
    return LoopProposals(
        edges_ij=jnp.stack([ei, ej], -1).astype(jnp.int32),
        score=top,
        valid=top >= min_score)


def propose_online(cfg: SvoConfig, mem_desc: jnp.ndarray,
                   mem_valid: jnp.ndarray, mem_stamp: jnp.ndarray,
                   m_new: jnp.ndarray, thumb_new: jnp.ndarray
                   ) -> LoopProposals:
    """Incremental loop proposals: the NEWEST keyframe vs the memory bank.

    The online engine path (engine/step.run_online_loop) only needs loops
    that close at the camera's current position, so instead of the full
    K×K similarity matrix (``propose_edges``, offline) this computes one
    query row: the new keyframe's shift+roll descriptor variants against
    every bank entry — the same cost class as per-frame relocalization.
    Returns edges (i = matched older slot, j = m_new); the temporal-gap
    mask also excludes m_new itself (gap 0 < loop_min_gap).
    """
    q = query_descriptors(thumb_new, cfg.loop_desc_rows, cfg.loop_desc_cols,
                          cfg.pr_rot_variants, cfg.pr_rot_step_rad)  # (V,D)
    scores = jnp.max(_sim(mem_desc, q), axis=-1)                      # (M,)
    gap = jnp.abs(mem_stamp - mem_stamp[m_new]) >= cfg.loop_min_gap
    scores = jnp.where(mem_valid & gap, scores, -2.0)
    top, idx = jax.lax.top_k(scores, cfg.online_loop_edges)
    edges = jnp.stack([idx.astype(jnp.int32),
                       jnp.full((cfg.online_loop_edges,), m_new,
                                jnp.int32)], -1)
    return LoopProposals(edges_ij=edges, score=top,
                         valid=top >= cfg.loop_min_score)


def _thumb_cfg(cfg: SvoConfig) -> Tuple[CameraConfig, SvoConfig]:
    """Camera + align config operating directly at thumbnail resolution."""
    s = 1.0 / (2 ** cfg.thumb_level)
    cam = cfg.camera
    th, tw = cfg.thumb_shape
    cam_t = dataclasses.replace(
        cam, fx=cam.fx * s, fy=cam.fy * s, cx=cam.cx * s, cy=cam.cy * s,
        width=tw, height=th)
    cfg_t = dataclasses.replace(
        cfg, camera=cam_t, num_levels=1, align_levels=1, align_min_level=0,
        klt_levels=1, align_patch=cfg.loop_patch,
        align_max_iters=cfg.loop_align_iters,
        epi_samples=0,   # no depth filter at thumbnail scale (and the
                         # epi/klt level validation would reject level 1)
        # the thumbnail aligner is single-level: a per-level iteration
        # schedule sized for the main config would fail align()'s length
        # check (advisor r2 finding #1)
        align_iters_per_level=None)
    return cam_t, cfg_t


class LoopMeasurement(NamedTuple):
    Z: jnp.ndarray            # (E,3,4) measured T_i←j
    inlier_frac: jnp.ndarray  # (E,)
    cost: jnp.ndarray         # (E,) final mean robust photometric cost
    accept: jnp.ndarray       # (E,) bool
    rt_t: jnp.ndarray         # (E,) round-trip translation error (m) —
    rt_r: jnp.ndarray         # (E,) …and rotation (rad): ‖Z_ij ∘ Z_ji‖.
                              # The edge's own empirical noise estimate:
                              # the forward and reverse alignments use
                              # INDEPENDENT templates (i's vs j's stereo
                              # snapshot), so measurement bias decorrelates
                              # between them, while true drift enters both
                              # consistently and cancels in the round trip.


def measure_edges(cfg: SvoConfig, props: LoopProposals,
                  kf_T_wk: jnp.ndarray, kf_thumb: jnp.ndarray,
                  obs_uv: jnp.ndarray, obs_mask: jnp.ndarray,
                  obs_disp: jnp.ndarray, obs_dmask: jnp.ndarray
                  ) -> LoopMeasurement:
    """Measure relative poses for proposed edges by thumbnail alignment.

    For edge (i, j): keyframe i contributes 3-D points (its stereo-observed
    features: obs_uv[i] + obs_disp[i] → depth) and reference patches from
    its thumbnail; keyframe j contributes the target thumbnail. Coarse IC
    Gauss-Newton (ops/align.align, single level) estimates T_j←i starting
    from the current pose estimates — the loop-closure situation is exactly
    "current estimates drifted"; the coarse level's wide convergence basin
    is what absorbs that drift.

    Returns Z = T_i←j (the pose-graph measurement convention,
    backend/pose_graph._residual) and a photometric acceptance gate.
    """
    cam_t, cfg_t = _thumb_cfg(cfg)
    s = 1.0 / (2 ** cfg.thumb_level)

    def one(edge, score_valid):
        i, j = edge[0], edge[1]
        thumb_i = kf_thumb[i]
        thumb_j = kf_thumb[j]
        gx, gy = pyramid.gradients(thumb_i)
        cam_full = cfg.camera
        z_i = cam_mod.disparity_to_depth(cam_full, obs_disp[i])
        m = (obs_mask[i] & obs_dmask[i] & (z_i > 0.1)
             & jnp.asarray(score_valid))
        uv_t = obs_uv[i] * s
        tmpl = align_ops.make_template(
            (thumb_i,), (gx,), (gy,), cam_t, cfg_t, uv_t,
            jnp.where(m, z_i, 1.0), m)
        T_init = se3.compose(se3.inverse(kf_T_wk[j]), kf_T_wk[i])  # T_j←i
        T_ji, stats = align_ops.align((thumb_j,), tmpl, cam_t, cfg_t,
                                      T_init)
        return se3.inverse(T_ji), stats["align_inlier_frac"], \
            stats["align_cost"]

    Z, frac, cost = jax.vmap(one)(props.edges_ij, props.valid)
    # Reverse measurement (j's template onto i's thumbnail) → round-trip
    # error = per-edge empirical noise (see LoopMeasurement.rt_t). Also a
    # hard consistency gate: an edge whose two directions disagree beyond
    # loop_rt_max_t/r is ambiguous (repeated structure, blur, bad depth
    # snapshot) regardless of its photometric inlier fraction — measured:
    # on a drift-free out-and-back run such edges injected 3-8 cm
    # phantom corrections that compounded to 0.3-0.5 m of error once
    # applied (r5 organic-drift probes).
    Z_rev, frac_r, _ = jax.vmap(one)(props.edges_ij[:, ::-1], props.valid)
    rt = jax.vmap(lambda a, b: se3.distance(se3.compose(a, b),
                                            se3.identity()))(Z, Z_rev)
    rt_r, rt_t = rt
    accept = (props.valid & (frac >= cfg.loop_accept_frac)
              & (frac_r >= cfg.loop_accept_frac)
              & (rt_t < cfg.loop_rt_max_t) & (rt_r < cfg.loop_rt_max_r))
    return LoopMeasurement(Z=Z, inlier_frac=frac, cost=cost, accept=accept,
                           rt_t=rt_t, rt_r=rt_r)


def close_loops(cfg: SvoConfig, kf_T_wk: jnp.ndarray, kf_valid: jnp.ndarray,
                kf_desc: jnp.ndarray, kf_thumb: jnp.ndarray,
                kf_stamp: jnp.ndarray, kf_seq: jnp.ndarray,
                obs_uv: jnp.ndarray, obs_mask: jnp.ndarray,
                obs_disp: jnp.ndarray, obs_dmask: jnp.ndarray
                ) -> Tuple[pose_graph.PoseGraph, LoopMeasurement]:
    """Detect, measure, and gate loop edges over a keyframe bank.

    Returns a fixed-capacity PoseGraph of loop edges (rejected proposals
    carry weight 0 — safe to concatenate with the odometry chain graph) and
    the raw measurements for diagnostics. Proposal similarity is max over
    per-keyframe shift (+roll, if cfg.pr_rot_variants > 0) variants built
    from the stored thumbnails — translation- and rotation-tolerant
    matching (VERDICT r2 missing #5).
    """
    variants = jax.vmap(
        lambda th: query_descriptors(th, cfg.loop_desc_rows,
                                     cfg.loop_desc_cols,
                                     cfg.pr_rot_variants,
                                     cfg.pr_rot_step_rad))(kf_thumb)
    props = propose_edges(kf_desc, kf_valid, kf_stamp, kf_seq,
                          cfg.loop_min_score, cfg.loop_min_gap,
                          cfg.loop_max_edges, desc_shift=variants)
    meas = measure_edges(cfg, props, kf_T_wk, kf_thumb,
                         obs_uv, obs_mask, obs_disp, obs_dmask)
    graph = pose_graph.PoseGraph(
        edges_ij=props.edges_ij, Z=meas.Z,
        weight=meas.accept.astype(jnp.float32))
    return graph, meas


def refine_trajectory(cfg: SvoConfig, state, traj_T_wc,
                      chain_weight: float = 1.0):
    """Offline single-sequence loop closing over a finished run.

    Detects loop edges in the engine's **long-horizon memory bank**
    (``mem_*`` in SlamState — every keyframe ever created, not just the
    BA window), optimizes the stamp-ordered odometry chain + loop edges
    as a pose graph, and propagates each keyframe's correction to the
    frames of its segment (every frame between its stamp and the next
    keyframe's stamp) — the standard pose-graph trajectory correction.

    Args:
      state: final engine SlamState.
      traj_T_wc: (T,3,4) per-frame camera→world poses from the run.
    Returns:
      (traj_refined (T,3,4), mem_T_wk_refined (M,3,4), n_edges accepted).
    """
    import numpy as np

    graph_loop, meas = close_loops(
        cfg, state.mem_T_wk, state.mem_valid, state.mem_desc,
        state.mem_thumb, state.mem_stamp, jnp.zeros_like(state.mem_stamp),
        state.mem_uv, state.mem_mask, state.mem_disp, state.mem_dmask)
    n_edges = int(np.asarray(graph_loop.weight.sum()))
    if n_edges == 0:
        return np.asarray(traj_T_wc), np.asarray(state.mem_T_wk), 0

    chain = pose_graph.chain_graph_stamped(state.mem_T_wk, state.mem_valid,
                                           state.mem_stamp)
    full = pose_graph.PoseGraph(
        edges_ij=jnp.concatenate([chain.edges_ij, graph_loop.edges_ij]),
        Z=jnp.concatenate([chain.Z, graph_loop.Z]),
        weight=jnp.concatenate([chain.weight * chain_weight,
                                graph_loop.weight]))
    # gauge: pin the oldest valid keyframe
    stamp_np = np.asarray(state.mem_stamp)
    valid_np = np.asarray(state.mem_valid)
    oldest = int(np.argmin(np.where(valid_np, stamp_np, np.iinfo(np.int32).max)))
    T_opt, _ = pose_graph.optimize(state.mem_T_wk, state.mem_valid, full,
                                   n_iters=10, fixed=oldest)

    # propagate: frame t gets the correction of the latest KF with
    # stamp <= t (world-frame delta ∘ old pose)
    T_opt_np = np.asarray(T_opt)
    T_old_np = np.asarray(state.mem_T_wk)
    traj = np.asarray(traj_T_wc)
    slots = np.where(valid_np)[0]
    slots = slots[np.argsort(stamp_np[slots])]
    out = traj.copy()
    for s in slots:
        delta = np.asarray(se3.compose(jnp.asarray(T_opt_np[s]),
                                       se3.inverse(jnp.asarray(T_old_np[s]))))
        sel = np.arange(traj.shape[0]) >= stamp_np[s]
        R, t = delta[:, :3], delta[:, 3]
        out[sel, :, :3] = np.einsum("ij,njk->nik", R, traj[sel, :, :3])
        out[sel, :, 3] = np.einsum("ij,nj->ni", R, traj[sel, :, 3]) + t
    return out, T_opt_np, n_edges
