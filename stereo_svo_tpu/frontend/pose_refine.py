"""Motion-only pose refinement: Gauss-Newton on reprojection residuals.

Reference parity: PoseRefiner — second GN pass over the KLT-refined 2-D
positions, optimizing the 6-DoF pose only (src/lib/pose_refinement.*
[UNVERIFIED — SURVEY.md §0]; SURVEY.md §3.1). Batched over all features,
fixed iteration count, Huber-weighted; outliers are reported as a mask for
the caller to kill (the reference erases them from its vectors).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig, SvoConfig
from ..geometry import camera, se3
from ..ops import solve
from ..precision import SOLVER


def refine(cam: CameraConfig, cfg: SvoConfig, T_cw: jnp.ndarray,
           X_world: jnp.ndarray, uv_obs: jnp.ndarray,
           mask: jnp.ndarray, obs_sigma: jnp.ndarray | None = None,
           T_prior: jnp.ndarray | None = None,
           disp_obs: jnp.ndarray | None = None,
           disp_mask: jnp.ndarray | None = None,
           obs_sigma_d: jnp.ndarray | None = None
           ) -> Tuple[jnp.ndarray, jnp.ndarray, dict]:
    """Refine T_cw so that projected landmarks match observed positions.

    Args:
      X_world: (N, 3) landmark positions; uv_obs: (N, 2) observations.
      mask: (N,) features participating.
      obs_sigma: optional (N,) per-feature measurement noise in px — a
        feature detected/tracked at pyramid level L carries ~2^L px noise
        (the reference keeps features at their detection level; SURVEY.md
        §2.1 detector row). Residuals are whitened by it: the Huber
        threshold, the information weight (1/σ²), and the outlier gate
        all scale with σ.
      T_prior: optional (3,4) motion-prior pose (the constant-velocity
        prediction). Adds a Gaussian prior ½‖log(T∘T_prior⁻¹)‖²_Λ with
        Λ = diag(1/σ_t², 1/σ_r²) from cfg.refine_prior_t_sig/_r_sig.
        Purpose (9778a94:BASELINE.md r3 KITTI-geometry root-cause): when
        the tracked feature set goes far-dominated, the forward axis is
        weakly observed and single frames can excurse 100-400 mm — the
        distance-triggered keyframe policy then anchors a keyframe AT the
        excursion, immortalizing it. A loose prior (default 50 mm) is
        invisible against healthy data and caps exactly those
        excursions. Disabled when cfg.refine_prior_t_sig == 0.
      disp_obs/disp_mask: optional (N,) per-frame stereo disparity
        measurements at the tracked positions (and their validity). Adds
        a third residual row fx·B/z_c(T) − d_obs per feature — a DIRECT
        observation of each feature's current camera-frame depth, i.e.
        of forward translation. Mono reprojection rows leave the forward
        axis nearly unobserved on far-dominated scenes: measured on the
        700-frame road_long run, per-frame translation ran +4…+32% hot
        and compounded into tracking collapse (r4 root-cause); with the
        disparity rows the near features pin it. Gated by
        cfg.refine_stereo_weight (0 disables).
      obs_sigma_d: optional (N,) separate noise for the disparity rows
        (px). The caller can fold each feature's MAP uncertainty into
        both sigmas (engine/step: σ_reproj² += (fx·‖t_ck‖·σ_μ)²,
        σ_disp² += (fx·B·σ_μ)²) so uncertain-depth features — fresh
        seeds above all — cannot bias the pose: treating estimated depth
        as exact couples the seeds' pose-correlated depth noise straight
        back into the pose (the r5 road_long forward-overshoot
        forensics). Defaults to obs_sigma.
    Returns: (T_cw, inlier_mask, stats).
    """
    sig = jnp.ones(X_world.shape[0], jnp.float32) if obs_sigma is None \
        else obs_sigma
    inv_s2 = 1.0 / (sig * sig)
    sig_d = sig if obs_sigma_d is None else obs_sigma_d
    inv_s2_d = 1.0 / (sig_d * sig_d)
    use_prior = T_prior is not None and cfg.refine_prior_t_sig > 0.0
    use_disp = (disp_obs is not None and disp_mask is not None
                and cfg.refine_stereo_weight > 0.0)
    if use_prior:
        lam = jnp.concatenate([
            jnp.full(3, 1.0 / cfg.refine_prior_t_sig ** 2),
            jnp.full(3, 1.0 / max(cfg.refine_prior_r_sig, 1e-6) ** 2)])
        T_prior_inv = se3.inverse(T_prior)
    fxB = cam.fx * cam.baseline

    def residual(T):
        x_c = se3.transform(T, X_world)                     # (N,3)
        uv_p, front = camera.project(cam, x_c)
        r = uv_p - uv_obs                                   # (N,2)
        rn = jnp.linalg.norm(r, axis=-1) / sig              # whitened
        w = jnp.where(rn <= cfg.refine_huber_px, 1.0,
                      cfg.refine_huber_px / jnp.maximum(rn, 1e-6))
        w = w * inv_s2 * (mask & front)
        if use_disp:
            z = jnp.maximum(x_c[..., 2], 0.2)
            r_d = fxB / z - disp_obs                        # (N,) px
            rdn = jnp.abs(r_d) / sig_d
            w_d = jnp.where(rdn <= cfg.refine_huber_px, 1.0,
                            cfg.refine_huber_px / jnp.maximum(rdn, 1e-6))
            w_d = (w_d * inv_s2_d * cfg.refine_stereo_weight
                   * (mask & front & disp_mask))
        else:
            r_d = w_d = None
        return x_c, r, w, r_d, w_d

    def disp_jacobian(x_c):
        """d(fx·B/z)/dξ for left-multiplied twists: dz/dδ = [0,0,1,y,−x,0]
        scaled by −fx·B/z²."""
        z = jnp.maximum(x_c[..., 2], 0.2)
        s = -fxB / (z * z)
        zero = jnp.zeros_like(z)
        return s[:, None] * jnp.stack(
            [zero, zero, jnp.ones_like(z),
             x_c[..., 1], -x_c[..., 0], zero], axis=-1)     # (N,6)

    # Chunked IRLS (same latency rationale as ops/align.py): the exact
    # per-iteration 6x6 Cholesky + exp chain is what the iteration's wall
    # time is made of, not the (N,)-sized vector work. Refresh J/W/H⁻¹ a
    # few times (taking an exact GN step each time); between refreshes the
    # update is a Jacobian-frozen quasi-Newton matvec.
    T = T_cw
    chunks = max(1, min(cfg.refine_irls_chunks, cfg.refine_max_iters))
    inner = max(cfg.refine_max_iters // chunks - 1, 0)
    for ci in range(chunks):
        x_c, r, w, r_d, w_d = residual(T)
        J = camera.proj_pose_jacobian(cam, x_c)             # (N,2,6)
        H = jnp.einsum("nri,n,nrj->ij", J, w, J, precision=SOLVER)
        g = jnp.einsum("nri,n,nr->i", J, w, r, precision=SOLVER)
        if use_disp:
            Jd = disp_jacobian(x_c)                         # (N,6)
            H = H + jnp.einsum("ni,n,nj->ij", Jd, w_d, Jd,
                               precision=SOLVER)
            g = g + jnp.einsum("ni,n,n->i", Jd, w_d, r_d, precision=SOLVER)
        if use_prior:
            xi = se3.log(se3.compose(T, T_prior_inv))
            H = H + jnp.diag(lam)
            g = g + lam * xi
        H = H + 1e-8 * jnp.eye(6, dtype=H.dtype) \
            + 1e-4 * jnp.trace(H) / 6.0 * jnp.eye(6, dtype=H.dtype)
        rhs = jnp.concatenate([jnp.eye(6, dtype=H.dtype), g[None]])
        sol = solve.chol_solve_small(jnp.broadcast_to(H, (7, 6, 6)), rhs)
        Hinv = sol[:6]
        T = se3.compose(se3.exp(-sol[6]), T)

        def body(it, T):
            _, r, w_i, r_d_i, w_d_i = residual(T)
            g = jnp.einsum("nri,n,nr->i", J, w_i, r, precision=SOLVER)
            if use_disp:
                g = g + jnp.einsum("ni,n,n->i", Jd, w_d_i, r_d_i,
                                   precision=SOLVER)
            step = jnp.matmul(Hinv, g, precision=SOLVER)
            return se3.compose(se3.exp(-step), T)

        T = jax.lax.fori_loop(0, inner, body, T)

    x_c = se3.transform(T, X_world)
    uv_p, front = camera.project(cam, x_c)
    err = jnp.linalg.norm(uv_p - uv_obs, axis=-1)
    inliers = mask & front & (err < cfg.refine_outlier_px * sig)
    stats = {
        "refine_rms_px": jnp.sqrt(
            jnp.sum(jnp.where(inliers, err * err, 0.0))
            / jnp.maximum(jnp.sum(inliers), 1.0)),
        "refine_inliers": jnp.sum(inliers),
    }
    return T, inliers, stats
