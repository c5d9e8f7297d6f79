"""Rectified pinhole camera model + projection Jacobians, pure JAX.

Reference parity: projection/back-projection helpers used throughout the
reference's pose estimator and depth calculator
(src/lib/ [UNVERIFIED — SURVEY.md §0]). Batched over leading dims.

The analytic Jacobians here feed the sparse-direct-alignment and
pose-refinement Gauss-Newton solvers (SURVEY.md §3.3). Twist layout (v, w):
translation first — must match geometry/se3.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import CameraConfig
from ..precision import GEOMETRY
from . import se3


def intrinsics(cam: CameraConfig, level: int = 0, dtype=jnp.float32):
    """(fx, fy, cx, cy) at a pyramid level (each level halves resolution).

    Level-l pixel (u_l, v_l) corresponds to level-0 pixel (u*2^l, v*2^l);
    equivalently intrinsics scale by 1/2^l.
    """
    s = 1.0 / (2 ** level)
    return (jnp.asarray(cam.fx * s, dtype), jnp.asarray(cam.fy * s, dtype),
            jnp.asarray(cam.cx * s, dtype), jnp.asarray(cam.cy * s, dtype))


def project(cam: CameraConfig, x_cam: jnp.ndarray, level: int = 0):
    """Camera-frame points (…,3) -> pixel coords (…,2) at pyramid level.

    Returns (uv, valid) where valid masks points with z > min depth.
    """
    fx, fy, cx, cy = intrinsics(cam, level, x_cam.dtype)
    z = x_cam[..., 2]
    valid = z > 1e-3
    zs = jnp.where(valid, z, 1.0)
    u = fx * x_cam[..., 0] / zs + cx
    v = fy * x_cam[..., 1] / zs + cy
    return jnp.stack([u, v], axis=-1), valid


def backproject(cam: CameraConfig, uv: jnp.ndarray, depth: jnp.ndarray,
                level: int = 0) -> jnp.ndarray:
    """Pixels (…,2) + depth (…) -> camera-frame points (…,3)."""
    fx, fy, cx, cy = intrinsics(cam, level, uv.dtype)
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def disparity_to_depth(cam: CameraConfig, disp: jnp.ndarray) -> jnp.ndarray:
    """Rectified stereo: z = fx * baseline / d (ref: DepthCalculator)."""
    d = jnp.maximum(disp, 1e-3)
    return cam.fx * cam.baseline / d


def depth_to_disparity(cam: CameraConfig, depth: jnp.ndarray) -> jnp.ndarray:
    return cam.fx * cam.baseline / jnp.maximum(depth, 1e-3)


def proj_jacobian(cam: CameraConfig, x_cam: jnp.ndarray, level: int = 0):
    """d(u,v)/d(x_cam): (…,2,3) for camera-frame point (…,3)."""
    fx, fy, _, _ = intrinsics(cam, level, x_cam.dtype)
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    iz = 1.0 / jnp.maximum(z, 1e-3)
    iz2 = iz * iz
    zeros = jnp.zeros_like(x)
    row_u = jnp.stack([fx * iz, zeros, -fx * x * iz2], axis=-1)
    row_v = jnp.stack([zeros, fy * iz, -fy * y * iz2], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)


def proj_pose_jacobian(cam: CameraConfig, x_cam: jnp.ndarray, level: int = 0):
    """d(u,v)/d(xi) for left-multiplied twist on T_cw: (…,2,6), (v,w) layout.

    With x_cam = exp(xi) ∘ T_cw applied to world point:
    d x_cam / d v = I, d x_cam / d w = -hat(x_cam).
    """
    Jp = proj_jacobian(cam, x_cam, level)          # (…,2,3)
    J_v = Jp
    J_w = -jnp.einsum("...ij,...jk->...ik", Jp, se3.hat(x_cam),
                      precision=GEOMETRY)
    return jnp.concatenate([J_v, J_w], axis=-1)    # (…,2,6)


def affine_warp_matrix(cam: CameraConfig, uv_ref: jnp.ndarray,
                       z_ref: jnp.ndarray, T_cr: jnp.ndarray) -> jnp.ndarray:
    """First-order pixel warp A = ∂uv_cur/∂uv_ref around a feature (…,2,2).

    Reference parity: SVO's getWarpMatrixAffine — predicts how a patch
    around (uv_ref, z_ref) in the reference view deforms in the current
    view under relative pose T_cr (ref→cur), assuming locally constant
    depth. Analytic chain: A = J_proj(x_cur) · R_cr · J_backproj(z_ref);
    pure-scale for forward motion, rotation for roll. Scale-invariant
    across pyramid levels (the fx factors cancel between the two
    Jacobians' level scalings).

    uv_ref: (…,2) level-0 pixels; z_ref: (…) depths; T_cr: (…,3,4).
    """
    x_ref = backproject(cam, uv_ref, z_ref)              # (…,3)
    x_cur = se3.transform(T_cr, x_ref)
    Jp = proj_jacobian(cam, x_cur)                       # (…,2,3)
    R = T_cr[..., :3, :3]
    fx, fy, _, _ = intrinsics(cam, 0, uv_ref.dtype)
    # d backproject / d uv at fixed depth: z · diag(1/fx, 1/fy), third row 0
    zb = z_ref[..., None, None]
    Jb_cols = jnp.stack(
        [jnp.stack([1.0 / fx * jnp.ones_like(z_ref),
                    jnp.zeros_like(z_ref), jnp.zeros_like(z_ref)], -1),
         jnp.stack([jnp.zeros_like(z_ref),
                    1.0 / fy * jnp.ones_like(z_ref),
                    jnp.zeros_like(z_ref)], -1)], -1) * zb  # (…,3,2)
    return jnp.einsum("...ij,...jk,...kl->...il", Jp, R, Jb_cols,
                      precision=GEOMETRY)


def in_bounds(cam: CameraConfig, uv: jnp.ndarray, level: int = 0,
              margin: float = 0.0) -> jnp.ndarray:
    """Mask of pixels inside the level-l image with a margin."""
    h = cam.height // (2 ** level)
    w = cam.width // (2 ** level)
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= margin) & (u <= w - 1 - margin) &
            (v >= margin) & (v <= h - 1 - margin))
