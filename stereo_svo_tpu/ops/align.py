"""Sparse direct image alignment — the #1 hot loop (SURVEY.md §3.3).

Reference parity: PoseEstimator's coarse-to-fine Gauss-Newton on photometric
patch residuals (src/lib/pose_estimator.* [UNVERIFIED — SURVEY.md §0]).
The reference's triple loop (level → iteration → keypoint → patch pixel)
becomes, per level:

  * a one-time template build (``make_template``): gather reference patches
    and their inverse-compositional Jacobians J = ∇I_ref · ∂π/∂ξ for every
    (feature, patch-pixel) — fixed for all iterations;
  * per GN iteration: one batched bilinear gather of the current image at
    the warped points, Huber weights, and H = Jᵀ W J / b = Jᵀ W e reduced
    with a single einsum → 6x6 solve.

Inverse-compositional formulation (SVO's own trick, here chosen because it
moves all gradient gathers out of the iteration loop — each iteration
is one sampling pass and one reduction): minimize
||I_ref(π(exp(δ)·p)) - I_cur(π(T·p))||², update T ← T ∘ exp(δ)⁻¹.

Everything is fixed-capacity and masked: dead features simply carry zero
weights (SURVEY.md §7.0.1).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig, SvoConfig
from ..geometry import camera, se3
from ..precision import SOLVER
from . import interp, solve


class Template(NamedTuple):
    """Per-reference-frame alignment template (one entry per align level).

    Shapes: L = number of align levels, N = max_features, P2 = patch².
    """
    p_ref: jnp.ndarray      # (N, 3) feature 3-D points in ref camera frame
    patches: jnp.ndarray    # (L, N, P2) reference intensities
    jac: jnp.ndarray        # (L, N, P2, 6) IC Jacobians d(intensity)/d(twist)
    mask: jnp.ndarray       # (N,) feature validity


def _level_list(cfg: SvoConfig):
    """Align levels, coarse→fine."""
    top = cfg.align_levels - 1
    return list(range(top, cfg.align_min_level - 1, -1))


def make_template(levels: Sequence[jnp.ndarray],
                  gxs: Sequence[jnp.ndarray], gys: Sequence[jnp.ndarray],
                  cam: CameraConfig, cfg: SvoConfig,
                  uv: jnp.ndarray, z: jnp.ndarray,
                  mask: jnp.ndarray) -> Template:
    """Build the IC template from a reference frame.

    uv: (N,2) level-0 feature positions; z: (N,) feature depths (ref frame).
    Patch-pixel 3-D points share the center depth (the standard SVO
    small-patch approximation).
    """
    P = cfg.align_patch
    offs = interp.patch_coords(P)                    # (P2, 2)
    p_ref = camera.backproject(cam, uv, z)           # (N, 3)

    patches, jacs = [], []
    for lv in _level_list(cfg):
        scale = 1.0 / (2 ** lv)
        uv_l = uv * scale
        pts = uv_l[:, None, :] + offs[None]          # (N, P2, 2)
        patch = interp.sample_patch(levels[lv], uv_l, P)   # (N, P2)
        gu = interp.sample_patch(gxs[lv], uv_l, P)
        gv = interp.sample_patch(gys[lv], uv_l, P)
        # 3-D point of each patch pixel at the center's depth
        p_pix = camera.backproject(cam, pts * (2 ** lv),
                                   jnp.broadcast_to(z[:, None], pts.shape[:2]))
        Jpose = camera.proj_pose_jacobian(cam, p_pix, level=lv)  # (N,P2,2,6)
        J = gu[..., None] * Jpose[..., 0, :] + gv[..., None] * Jpose[..., 1, :]
        # invalidate templates whose patch leaves the level image
        ok = camera.in_bounds(cam, pts, level=lv, margin=1.0)    # (N, P2)
        J = jnp.where(ok[..., None], J, 0.0)
        patches.append(patch)
        jacs.append(J)

    return Template(p_ref=p_ref,
                    patches=jnp.stack(patches),
                    jac=jnp.stack(jacs),
                    mask=mask & (z > 1e-2))


def _huber_weight(e: jnp.ndarray, k: float) -> jnp.ndarray:
    a = jnp.abs(e)
    return jnp.where(a <= k, 1.0, k / jnp.maximum(a, 1e-6))


def align(levels_cur: Sequence[jnp.ndarray], tmpl: Template,
          cam: CameraConfig, cfg: SvoConfig,
          T_init: jnp.ndarray) -> Tuple[jnp.ndarray, dict]:
    """Estimate T_cr (ref→cur) by coarse-to-fine IC Gauss-Newton.

    Returns (T_cr, stats) with per-frame diagnostics (SURVEY.md §5.5).
    """
    P = cfg.align_patch
    offs = interp.patch_coords(P)
    lam = 1e-4  # Levenberg damping floor keeps the 6x6 solve well-posed

    T = T_init
    last_cost = jnp.asarray(0.0, jnp.float32)
    inlier_frac = jnp.asarray(0.0, jnp.float32)

    lvl_list = _level_list(cfg)
    schedule = cfg.align_iters_per_level
    if schedule is not None:
        if len(schedule) < len(lvl_list):
            raise ValueError("align_iters_per_level shorter than the "
                             "number of align levels")
        # longer schedules align to the FINEST levels (coarse→fine order;
        # extra coarse entries dropped) so one default schedule serves
        # configs with fewer align levels
        schedule = schedule[len(schedule) - len(lvl_list):]

    for li, lv in enumerate(lvl_list):
        img = levels_cur[lv]
        ref_patch = tmpl.patches[li]                 # (N, P2)
        J = tmpl.jac[li]                             # (N, P2, 6)
        iters_l = schedule[li] if schedule is not None \
            else cfg.align_max_iters

        def sample_cur(T):
            p_cur = se3.transform(T, tmpl.p_ref)     # (N, 3)
            uv_c, front = camera.project(cam, p_cur, level=lv)
            pts = uv_c[:, None, :] + offs[None]      # (N, P2, 2)
            cur = interp.sample_patch(img, uv_c, P)  # (N, P2)
            ok = (camera.in_bounds(cam, pts, level=lv, margin=1.0)
                  & front[:, None] & tmpl.mask[:, None])
            return cur, ok

        # --- chunked IRLS: refresh Huber weights + H a few times per
        # level, run cheap quasi-Newton iterations in between. The IC
        # formulation's Hessian JᵀWJ depends on the pose only through W;
        # each exact GN iteration is latency-bound on its serial
        # 6x6-Cholesky + exp + compose chain (longer than the whole
        # sampling pass), so H is inverted once per chunk and
        # inner iterations reduce to a 6x6 matvec. Short per-level
        # schedules get proportionally fewer refreshes (a 3-iteration
        # coarse level with 3 refreshes would be all solve latency).
        chunks = max(1, min(cfg.align_irls_chunks, iters_l // 2,
                            iters_l))
        inner = max(iters_l // chunks - 1, 0)
        for ci in range(chunks):
            # refresh pass: weights + H⁻¹ AND an exact GN step from the
            # same samples (7 simultaneous unrolled-Cholesky solves:
            # columns of I plus b — LAPACK-free, ops/solve.py)
            cur, ok = sample_cur(T)
            if cfg.illum_affine:
                # Global affine illumination I_cur ≈ a·I_ref + b, closed
                # form over the masked samples. Exposure gain/bias between
                # consecutive frames otherwise violates brightness
                # constancy and collapses the inlier set. The effective
                # template becomes a·ref+b, whose IC Jacobian is a·J — the
                # exact GN step is the nominal one scaled by 1/a.
                sw = jnp.maximum(jnp.sum(ok), 1.0)
                m_ref = jnp.sum(ref_patch * ok) / sw
                m_cur = jnp.sum(cur * ok) / sw
                cov = jnp.sum((cur - m_cur) * (ref_patch - m_ref) * ok) / sw
                var = jnp.sum((ref_patch - m_ref) ** 2 * ok) / sw
                a_il = jnp.clip(cov / jnp.maximum(var, 1e-3), 0.5, 2.0)
                b_il = m_cur - a_il * m_ref
            else:
                a_il = jnp.asarray(1.0, jnp.float32)
                b_il = jnp.asarray(0.0, jnp.float32)
            e = cur - (a_il * ref_patch + b_il)
            w = _huber_weight(e, cfg.align_huber) * ok
            # Stats are byproducts of this sample pass. They must be
            # computed here, not only in the inner loop: with small
            # align_max_iters (<= 2*chunks) the inner fori_loop runs zero
            # times and the stats would otherwise keep their 0.0 init —
            # failing every loop_accept_frac gate despite convergence.
            n_ok0 = jnp.maximum(jnp.sum(ok), 1.0)
            last_cost = jnp.sum(w * e * e) / n_ok0
            inlier_frac = (jnp.sum((jnp.abs(e) < cfg.align_huber) & ok)
                           / n_ok0)
            H = jnp.einsum("npi,np,npj->ij", J, w, J, precision=SOLVER)
            b = jnp.einsum("npi,np,np->i", J, w, e, precision=SOLVER)
            H = H + lam * jnp.trace(H) / 6.0 * jnp.eye(6, dtype=H.dtype) \
                + 1e-8 * jnp.eye(6, dtype=H.dtype)
            rhs = jnp.concatenate([jnp.eye(6, dtype=H.dtype), b[None]])
            sol = solve.chol_solve_small(
                jnp.broadcast_to(H, (7, 6, 6)), rhs)
            Hinv = sol[:6]
            T = se3.compose(T, se3.exp(-sol[6] / a_il))
            n_ok = jnp.maximum(jnp.sum(ok), 1.0)

            def body(it, carry):
                T, cost, infrac = carry
                cur_i, ok_i = sample_cur(T)
                e = cur_i - (a_il * ref_patch + b_il)
                b = jnp.einsum("npi,np,np->i", J, w, e, precision=SOLVER)
                delta = jnp.matmul(Hinv, b, precision=SOLVER) / a_il
                T_new = se3.compose(T, se3.exp(-delta))
                cost = jnp.sum(w * e * e) / n_ok
                infrac = (jnp.sum((jnp.abs(e) < cfg.align_huber) & ok_i)
                          / jnp.maximum(jnp.sum(ok_i), 1.0))
                return T_new, cost, infrac

            T, last_cost, inlier_frac = jax.lax.fori_loop(
                0, inner, body, (T, last_cost, inlier_frac))

    stats = {"align_cost": last_cost, "align_inlier_frac": inlier_frac}
    return T, stats
