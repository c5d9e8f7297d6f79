"""Bilinear image sampling, batched, pure XLA gathers.

The workhorse behind patch warping, KLT and epipolar search — the reference
does this per-pixel with cv::getRectSubPix-style loops
(src/lib/image_comparison.* [UNVERIFIED — SURVEY.md §0]); here it is one
vectorized 4-tap gather over arbitrarily-shaped batches of sample points,
fused by XLA into the surrounding kernels. Exact f32, no matmul.

The one sampler: on an H100 it beat the tent-kernel matmul formulation
(bilinear as one-hot einsums, built for a systolic array) at every measured
shape — per call and across the whole scan — and was the exact one; see
PERF.md (Findings) for the numbers.
"""

from __future__ import annotations

import jax.numpy as jnp


def bilinear(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Sample ``img`` (H,W) at ``uv`` (...,2) [u=x=col, v=y=row], bilinear.

    Out-of-bounds coordinates clamp to the border (callers mask validity
    separately via geometry.camera.in_bounds).
    """
    H, W = img.shape
    u = jnp.clip(uv[..., 0], 0.0, W - 1.000001)
    v = jnp.clip(uv[..., 1], 0.0, H - 1.000001)
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    du = u - u0
    dv = v - v0
    iu0 = u0.astype(jnp.int32)
    iv0 = v0.astype(jnp.int32)
    iu1 = jnp.minimum(iu0 + 1, W - 1)
    iv1 = jnp.minimum(iv0 + 1, H - 1)
    p00 = img[iv0, iu0]
    p01 = img[iv0, iu1]
    p10 = img[iv1, iu0]
    p11 = img[iv1, iu1]
    top = p00 + du * (p01 - p00)
    bot = p10 + du * (p11 - p10)
    return top + dv * (bot - top)


def bilinear_with_grad(img: jnp.ndarray, uv: jnp.ndarray):
    """Sample value and its image-space gradient (dI/du, dI/dv) at uv.

    The gradient is the analytic derivative of the bilinear interpolant —
    consistent with the sampled value (what inverse-compositional LK wants),
    not a finite difference of neighboring samples.
    """
    H, W = img.shape
    u = jnp.clip(uv[..., 0], 0.0, W - 1.000001)
    v = jnp.clip(uv[..., 1], 0.0, H - 1.000001)
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    du = u - u0
    dv = v - v0
    iu0 = u0.astype(jnp.int32)
    iv0 = v0.astype(jnp.int32)
    iu1 = jnp.minimum(iu0 + 1, W - 1)
    iv1 = jnp.minimum(iv0 + 1, H - 1)
    p00 = img[iv0, iu0]
    p01 = img[iv0, iu1]
    p10 = img[iv1, iu0]
    p11 = img[iv1, iu1]
    val = (p00 * (1 - du) * (1 - dv) + p01 * du * (1 - dv)
           + p10 * (1 - du) * dv + p11 * du * dv)
    gu = (p01 - p00) * (1 - dv) + (p11 - p10) * dv
    gv = (p10 - p00) * (1 - du) + (p11 - p01) * du
    return val, gu, gv


def patch_coords(patch: int, dtype=jnp.float32) -> jnp.ndarray:
    """Centered patch offset grid: (patch*patch, 2) of (du, dv).

    For even ``patch`` the grid is centered between pixels (offset -.5), so a
    feature's patch is symmetric around its sub-pixel location.
    """
    r = (jnp.arange(patch, dtype=dtype) - (patch - 1) / 2.0)
    dv, du = jnp.meshgrid(r, r, indexing="ij")
    return jnp.stack([du.reshape(-1), dv.reshape(-1)], axis=-1)


def sample_patch(img: jnp.ndarray, center_uv: jnp.ndarray, patch: int):
    """Sample (…,patch*patch) intensity patches centered at (…,2) points."""
    offs = patch_coords(patch, img.dtype)              # (P2, 2)
    pts = center_uv[..., None, :] + offs               # (…, P2, 2)
    return bilinear(img, pts)


def sample_rect(img: jnp.ndarray, center_uv: jnp.ndarray,
                row_offs: jnp.ndarray, col_offs: jnp.ndarray):
    """(N,2) centers + (P,)/(Q,) offsets → (N,P,Q) bilinear samples."""
    su = center_uv[:, None, None, 0] + col_offs[None, None, :]
    sv = center_uv[:, None, None, 1] + row_offs[None, :, None]
    N = center_uv.shape[0]
    P, Q = row_offs.shape[0], col_offs.shape[0]
    return bilinear(img, jnp.stack(
        [jnp.broadcast_to(su, (N, P, Q)), jnp.broadcast_to(sv, (N, P, Q))],
        axis=-1))


def sample_patch_with_grad(img: jnp.ndarray, center_uv: jnp.ndarray, patch: int):
    offs = patch_coords(patch, img.dtype)
    pts = center_uv[..., None, :] + offs
    return bilinear_with_grad(img, pts)
