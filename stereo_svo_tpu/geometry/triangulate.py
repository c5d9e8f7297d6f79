"""Triangulation: stereo (rectified) and general two-view midpoint, pure JAX.

Reference parity: DepthCalculator's disparity→depth bootstrap and the depth
filter's per-observation triangulation (src/lib/depth_calculator.*,
src/lib/depth_filter.* [UNVERIFIED — SURVEY.md §0]).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import CameraConfig
from ..precision import GEOMETRY
from . import camera as cam_mod
from . import se3


def stereo_point(cam: CameraConfig, uv: jnp.ndarray, disp: jnp.ndarray):
    """Rectified stereo triangulation: left pixel (…,2) + disparity (…) ->
    camera-frame 3D point (…,3) and validity mask."""
    valid = disp > 0.25
    z = cam_mod.disparity_to_depth(cam, disp)
    return cam_mod.backproject(cam, uv, z), valid


def two_view_depth(T_cr: jnp.ndarray, f_ref: jnp.ndarray, f_cur: jnp.ndarray):
    """Depth along the *reference* bearing from a two-view correspondence.

    T_cr: (…,3,4) pose mapping reference-frame points into the current frame.
    f_ref, f_cur: (…,3) unit (or unnormalized) bearing vectors in their frames.
    Solves min || [f_ref, -R^T f_cur] [d1, d2]^T - (-R^T t) || in closed form
    (standard mid-point / linear triangulation, as used by SVO's depth filter).
    Returns (depth_ref, valid) — valid requires positive depths and a
    well-conditioned 2x2 system.
    """
    R = se3.rotation(T_cr)
    t = se3.translation(T_cr)
    Rt_f_cur = jnp.einsum("...ji,...j->...i", R, f_cur,
                          precision=GEOMETRY)          # R^T f_cur
    Rt_t = jnp.einsum("...ji,...j->...i", R, t,
                      precision=GEOMETRY)              # R^T t
    A00 = jnp.sum(f_ref * f_ref, axis=-1)
    A01 = -jnp.sum(f_ref * Rt_f_cur, axis=-1)
    A11 = jnp.sum(Rt_f_cur * Rt_f_cur, axis=-1)
    b0 = -jnp.sum(f_ref * Rt_t, axis=-1)
    b1 = jnp.sum(Rt_f_cur * Rt_t, axis=-1)
    det = A00 * A11 - A01 * A01
    ok = jnp.abs(det) > 1e-10
    det_s = jnp.where(ok, det, 1.0)
    d_ref = (A11 * b0 - A01 * b1) / det_s
    d_cur = (A00 * b1 - A01 * b0) / det_s
    valid = ok & (d_ref > 1e-3) & (d_cur > 1e-3)
    return jnp.where(valid, d_ref, 1.0), valid
