"""Pyramidal inverse-compositional Lucas-Kanade feature alignment, batched.

Reference parity: OpticalFlow — per-feature KLT refinement of each projected
keypoint against its keyframe patch, breaking frame-to-keyframe drift
(src/lib/optical_flow.* [UNVERIFIED — SURVEY.md §0]; SURVEY.md §3.1).

The reference iterates feature-by-feature with early exits; here all N
features advance together through a fixed iteration schedule with
convergence masking (a converged feature's update is zeroed, not branched).
Template gradients/Hessians are precomputed at keyframe creation — per
iteration only one batched bilinear gather of the current image runs.

Affine-warped templates (``cfg.klt_affine_warp``, SVO's
getWarpMatrixAffine): for large viewpoint change between the owner keyframe
and the current frame, a stored oversized template patch is resampled once
per frame through the pose-predicted local affine warp A = ∂uv_cur/∂uv_ref
(geometry/camera.affine_warp_matrix); the warped patch, its gradients and
IC Hessian replace the stored fronto-parallel ones. Off by default — the
engine's keyframe rate keeps templates fresh; enable for low-KF-rate
operation.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig, SvoConfig
from ..precision import GEOMETRY, SOLVER
from . import interp, solve


class KltTemplate(NamedTuple):
    """IC-LK template per feature per KLT level.

    L = klt_levels, N = max_features, P2 = klt_patch².
    """
    patches: jnp.ndarray   # (L, N, P2) template intensities
    jac: jnp.ndarray       # (L, N, P2, 2) template gradients (du, dv)
    hinv: jnp.ndarray      # (L, N, 2, 2) inverse IC Hessians
    mask: jnp.ndarray      # (N,)
    big: jnp.ndarray       # (L, N, B2) oversized patches for affine warping
                           # (B = 2·klt_patch when enabled, else B2 == 1)
    big_ok: jnp.ndarray    # (L, N) oversized patch fully inside the level
                           # image when stored (border-clamped samples would
                           # otherwise corrupt the warped template)


def make_template(levels: Sequence[jnp.ndarray],
                  gxs: Sequence[jnp.ndarray], gys: Sequence[jnp.ndarray],
                  cfg: SvoConfig, uv: jnp.ndarray,
                  mask: jnp.ndarray) -> KltTemplate:
    """Extract KLT templates at level-0 positions ``uv`` from a keyframe."""
    P = cfg.klt_patch
    B = cfg.klt_big_patch
    N = uv.shape[0]
    patches, jacs, hinvs, bigs, big_oks = [], [], [], [], []
    for lv in range(cfg.klt_levels):
        scale = 1.0 / (2 ** lv)
        t = interp.sample_patch(levels[lv], uv * scale, P)
        gu = interp.sample_patch(gxs[lv], uv * scale, P)
        gv = interp.sample_patch(gys[lv], uv * scale, P)
        J = jnp.stack([gu, gv], axis=-1)                    # (N, P2, 2)
        H = jnp.einsum("npi,npj->nij", J, J, precision=SOLVER)
        # Regularize: textureless templates get ~identity (their updates
        # will be tiny since Jᵀe ≈ 0) instead of a singular solve.
        H = H + 1e-3 * jnp.eye(2, dtype=H.dtype)
        hinvs.append(solve.inv2x2(H))
        patches.append(t)
        jacs.append(J)
        if B > 1:
            bigs.append(interp.sample_patch(levels[lv], uv * scale, B))
            Hh, Ww = levels[lv].shape
            half = (B - 1) / 2.0 + 1.0   # +1: bilinear right/bottom tap
            uv_l = uv * scale
            big_oks.append((uv_l[:, 0] >= half) & (uv_l[:, 0] < Ww - half)
                           & (uv_l[:, 1] >= half) & (uv_l[:, 1] < Hh - half))
        else:
            bigs.append(jnp.zeros((N, 1), t.dtype))
            big_oks.append(jnp.zeros(N, bool))
    return KltTemplate(patches=jnp.stack(patches), jac=jnp.stack(jacs),
                       hinv=jnp.stack(hinvs), mask=mask,
                       big=jnp.stack(bigs), big_ok=jnp.stack(big_oks))


def warp_template_level(big: jnp.ndarray, A_inv: jnp.ndarray, patch: int
                        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                                   jnp.ndarray]:
    """Resample stored oversized patches through per-feature affine warps.

    big: (N, B²) oversized template patches (ref-frame pixel grid).
    A_inv: (N, 2, 2) maps current-frame patch offsets → ref-frame offsets.
    Returns (patches (N,P²), jac (N,P²,2), hinv (N,2,2), contained (N,)) —
    the warped template, its gradients in *current-frame* pixel coordinates
    (chain rule through A⁻¹), the inverse IC Hessian, and whether every
    warped sample landed inside the stored BxB grid (a strongly shrinking
    warp, |A_inv·offs| > (B-1)/2, would index outside it and silently
    produce border-clamped garbage — callers must fall back to the
    fronto-parallel template for those features).
    """
    N, B2 = big.shape
    B = int(round(B2 ** 0.5))
    imgs = big.reshape(N, B, B)
    offs = interp.patch_coords(patch, big.dtype)          # (P2, 2) cur px
    r_ref = jnp.einsum("nij,pj->npi", A_inv, offs,
                       precision=GEOMETRY)             # (N, P2, 2) ref px
    contained = jnp.all(jnp.abs(r_ref) <= (B - 1) / 2.0, axis=(-2, -1))
    # big-patch index coords: grid spans offsets [-(B-1)/2, (B-1)/2]
    pts = r_ref + (B - 1) / 2.0
    val, gu, gv = jax.vmap(interp.bilinear_with_grad)(imgs, pts)
    g_ref = jnp.stack([gu, gv], axis=-1)                  # (N, P2, 2)
    J = jnp.einsum("npj,nji->npi", g_ref, A_inv,
                   precision=GEOMETRY)                    # cur-frame coords
    H = jnp.einsum("npi,npj->nij", J, J, precision=SOLVER)
    H = H + 1e-3 * jnp.eye(2, dtype=H.dtype)
    return val, J, solve.inv2x2(H), contained


def track(levels_cur: Sequence[jnp.ndarray], tmpl: KltTemplate,
          cfg: SvoConfig, uv_init: jnp.ndarray,
          edge_dir: jnp.ndarray | None = None,
          is_edgelet: jnp.ndarray | None = None,
          A_inv: jnp.ndarray | None = None,
          ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Refine feature positions in the current frame.

    Args:
      uv_init: (N, 2) predicted level-0 positions (from the aligned pose).
      edge_dir: optional (N,2) unit gradient directions; with
        ``is_edgelet`` (N,) bool, edgelet features update only along their
        gradient normal (1-DoF — the reference's edgelet treatment: the
        position along the edge is unobservable, src/lib/corner_detector.*
        [UNVERIFIED]).
      A_inv: optional (N,2,2) inverse affine warps (cur→ref patch offsets);
        with ``cfg.klt_affine_warp`` templates, resamples the oversized
        stored patches once per level instead of using the fronto-parallel
        ones.
    Returns:
      uv: (N, 2) refined positions.
      converged: (N,) bool — final update below threshold and in-bounds.
      residual: (N,) mean absolute photometric residual (diagnostic).
    """
    P = cfg.klt_patch
    uv = uv_init
    use_warp = A_inv is not None and tmpl.big.shape[-1] > 1

    converged = jnp.zeros(uv.shape[0], dtype=bool)
    res = jnp.zeros(uv.shape[0], dtype=levels_cur[0].dtype)

    for lv in range(cfg.klt_levels - 1, -1, -1):
        img = levels_cur[lv]
        H, W = img.shape
        if use_warp:
            t_w, J_w, Hinv_w, contained = warp_template_level(
                tmpl.big[lv], A_inv, P)
            # fall back to the stored fronto-parallel template when the
            # warped samples leave the stored grid or the stored big patch
            # was border-clamped at template build
            w_ok = contained & tmpl.big_ok[lv]
            t = jnp.where(w_ok[:, None], t_w, tmpl.patches[lv])
            J = jnp.where(w_ok[:, None, None], J_w, tmpl.jac[lv])
            Hinv = jnp.where(w_ok[:, None, None], Hinv_w, tmpl.hinv[lv])
        else:
            t = tmpl.patches[lv]
            J = tmpl.jac[lv]
            Hinv = tmpl.hinv[lv]
        scale = 1.0 / (2 ** lv)

        def body(it, carry):
            uv, conv, res = carry
            cur = interp.sample_patch(img, uv * scale, P)
            if cfg.illum_affine:
                # Per-feature affine fit cur ≈ a·t + b (closed form over
                # the patch): absorbs exposure change AND the spatially-
                # varying vignette/shading drift between the owner
                # keyframe and the current frame. Effective template
                # a·(t-mean) has Jacobian a·J → exact step = nominal / a.
                # CORNERS ONLY: on 1-D structure (edgelets) the fit is
                # degenerate — a sub-pixel edge shift is photometrically
                # near-indistinguishable from a gain/bias change over the
                # patch, so compensation absorbs real displacement signal
                # and KLT stalls short of the true position (measured:
                # 1.7 px short on a 3 px sigmoid-edge shift). Edgelets
                # keep the raw brightness-constancy residual.
                mc = jnp.mean(cur, -1, keepdims=True)
                mt = jnp.mean(t, -1, keepdims=True)
                cov = jnp.mean((cur - mc) * (t - mt), -1, keepdims=True)
                var = jnp.mean((t - mt) ** 2, -1, keepdims=True)
                a_fit = jnp.clip(cov / jnp.maximum(var, 1e-3), 0.6, 1.6)
                e_fit = (cur - mc) - a_fit * (t - mt)        # (N, P2)
                if is_edgelet is not None:
                    edge = is_edgelet[:, None]
                    a_il = jnp.where(edge, 1.0, a_fit)
                    e = jnp.where(edge, cur - t, e_fit)
                else:
                    a_il, e = a_fit, e_fit
            else:
                a_il = jnp.ones((uv.shape[0], 1), jnp.float32)
                e = cur - t                                  # (N, P2)
            g = jnp.einsum("npi,np->ni", J, e, precision=SOLVER)
            delta = jnp.einsum("nij,nj->ni", Hinv, g,
                               precision=SOLVER) / a_il      # level-lv px
            if edge_dir is not None and is_edgelet is not None:
                # 1-DoF constraint: project the update onto the gradient
                # normal for edgelet features
                along = jnp.sum(delta * edge_dir, axis=-1, keepdims=True)
                delta = jnp.where(is_edgelet[:, None],
                                  along * edge_dir, delta)
            step = delta * (2 ** lv)                         # level-0 px
            in_b = ((uv[:, 0] * scale > P) & (uv[:, 0] * scale < W - P)
                    & (uv[:, 1] * scale > P) & (uv[:, 1] * scale < H - P))
            active = tmpl.mask & in_b & ~conv
            uv_new = jnp.where(active[:, None], uv - step, uv)
            conv_new = conv | (active &
                               (jnp.sum(delta * delta, -1) < cfg.klt_conv_eps ** 2))
            res_new = jnp.where(active, jnp.mean(jnp.abs(e), axis=-1), res)
            return uv_new, conv_new, res_new

        # reset convergence flags at each level (finer level re-refines)
        converged = jnp.zeros_like(converged)
        uv, converged, res = jax.lax.fori_loop(
            0, cfg.klt_max_iters, body, (uv, converged, res))

    moved2 = jnp.sum((uv - uv_init) ** 2, axis=-1)
    ok = tmpl.mask & (moved2 < (4.0 * cfg.klt_patch) ** 2)
    return uv, ok & converged, res
