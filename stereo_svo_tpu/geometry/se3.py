"""SE(3) Lie-group operations, tangent-space parameterized, pure JAX.

Reference parity: the reference keeps poses as OpenCV Rodrigues vectors +
translation and composes them with cv::Rodrigues round-trips
(src/lib/ transform helpers [UNVERIFIED — SURVEY.md §0]). Here poses are
(R: 3x3, t: 3) pairs packed as a single (3,4) matrix; updates live in the
se(3) tangent space via exp/log maps with closed-form Rodrigues formulas.
All functions are batched-friendly (leading dims broadcast / vmap-able) and
safe at the theta→0 singularity (Taylor fallbacks), so they can sit inside
jitted Gauss-Newton loops.

Convention: T = [R|t] maps points from the *local* frame to the *parent*
frame: x_parent = R @ x_local + t. ``T_cw`` denotes world→camera.
Twist layout: xi = (v, w) — translation first, rotation last (matches the
Jacobians in frontend/alignment and backend/ba).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..precision import GEOMETRY

_EPS = 1e-8


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=GEOMETRY)


def identity(dtype=jnp.float32) -> jnp.ndarray:
    """Identity pose as a (3,4) matrix."""
    return jnp.concatenate(
        [jnp.eye(3, dtype=dtype), jnp.zeros((3, 1), dtype=dtype)], axis=-1)


def make(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Pack rotation (…,3,3) and translation (…,3) into a (…,3,4) pose."""
    return jnp.concatenate([R, t[..., None]], axis=-1)


def rotation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :, :3]


def translation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :, 3]


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (…,3) -> (…,3,3) skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], axis=-1),
        jnp.stack([wz, z, -wx], axis=-1),
        jnp.stack([-wy, wx, z], axis=-1),
    ], axis=-2)


def exp_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: so(3) (…,3) -> SO(3) (…,3,3), stable near 0."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(x)/x and (1-cos x)/x^2 with Taylor fallback near 0
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = hat(w)
    WW = _mm(W, W)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * WW


def log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """SO(3) (…,3,3) -> so(3) (…,3). Stable for theta in [0, pi).

    Autodiff-safe at theta→0: arccos'(1) = -inf, so the small-angle branch
    is a polynomial in cos(theta) and the arccos input is substituted with
    a dummy value where unused (the standard double-where trick — a plain
    `where` would still propagate NaN through the dead branch's tangent).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = jnp.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1)
    small = cos_t > 1.0 - 1e-5
    cos_safe = jnp.where(small, 0.0, cos_t)
    theta = jnp.arccos(cos_safe)
    sin_safe = jnp.sqrt(jnp.maximum(1.0 - cos_safe * cos_safe, 1e-12))
    scale_big = theta / (2.0 * sin_safe)
    # theta/(2 sin theta) = 1/2 + theta²/12 + …, with theta² ≈ 2(1-cos)
    one_m_c = 1.0 - cos_t
    scale_small = 0.5 + one_m_c / 6.0 + one_m_c * one_m_c * 7.0 / 90.0
    scale = jnp.where(small, scale_small, scale_big)
    # Near theta == pi the vee formula degenerates; SLAM increments never
    # reach pi in one GN step, but clamp for safety via the diagonal method.
    return scale[..., None] * vee


def _V(w: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian of SO(3): V s.t. exp_se3 translation = V @ v."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / (theta2 * theta))
    W = hat(w)
    WW = _mm(W, W)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + B[..., None, None] * W + C[..., None, None] * WW


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) twist (…,6) = (v,w) -> SE(3) pose (…,3,4)."""
    v, w = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    t = _mm(_V(w), v[..., None])[..., 0]
    return make(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) (…,3,4) -> twist (…,6) = (v,w). Inverse of exp."""
    R = rotation(T)
    t = translation(T)
    w = log_so3(R)
    Vinv = jnp.linalg.inv(_V(w))
    v = _mm(Vinv, t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """A ∘ B: apply B first, then A. (…,3,4) x (…,3,4) -> (…,3,4)."""
    Ra, ta = rotation(A), translation(A)
    Rb, tb = rotation(B), translation(B)
    return make(_mm(Ra, Rb), _mm(Ra, tb[..., None])[..., 0] + ta)


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    R = rotation(T)
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return make(Rt, -_mm(Rt, t[..., None])[..., 0])


def transform(T: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Apply pose to points: (…,3,4) x (…,3) -> (…,3)."""
    R = rotation(T)
    t = translation(T)
    return jnp.einsum("...ij,...j->...i", R, x, precision=GEOMETRY) + t


def retract(T: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative retraction: exp(xi) ∘ T (GN update convention)."""
    return compose(exp(xi), T)


def adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """Adjoint of SE(3) for twist frame changes: (…,6,6), (v,w) layout."""
    R = rotation(T)
    t = translation(T)
    tR = _mm(hat(t), R)
    top = jnp.concatenate([R, tR], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def distance(A: jnp.ndarray, B: jnp.ndarray):
    """(rotation angle, translation norm) between two poses."""
    rel = compose(inverse(A), B)
    w = log_so3(rotation(rel))
    return jnp.linalg.norm(w, axis=-1), jnp.linalg.norm(translation(rel), axis=-1)
