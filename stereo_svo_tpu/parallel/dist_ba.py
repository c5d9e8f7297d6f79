"""Distributed Schur-complement bundle adjustment over a device mesh.

SURVEY.md §5.7 / north-star config #5: the map's landmark blocks shard
across hosts/devices on the ``kf`` mesh axis. Each shard linearizes its own
landmarks' observation blocks and eliminates its landmark 3x3 blocks
locally (the landmark Hessian is block-diagonal, so elimination is
embarrassingly parallel); the reduced camera system's pose blocks are
summed across shards with ``psum`` (NVLink all-reduce between the GPUs of
one host) and solved replicated (6K x 6K,
tiny); landmark back-substitution is again shard-local. One ``psum`` per GN
iteration is the entire communication volume: O(K²·36) floats, independent
of the number of landmarks.

The math is the same masked-dense formulation as backend/ba.py — the
single-device and distributed solvers share the same ``ba_iteration`` code
path (reduce_fn injection), so parity is testable bit-for-bit up to
reduction order (SURVEY.md §7.3.4).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..backend import ba
from ..config import CameraConfig, SvoConfig
from ..geometry import se3
from . import mesh as mesh_mod


def bundle_adjust_sharded(mesh, cam: CameraConfig, cfg: SvoConfig,
                          kf_T_wk: jnp.ndarray, kf_valid: jnp.ndarray,
                          X: jnp.ndarray, X_mask: jnp.ndarray,
                          obs_uv: jnp.ndarray, obs_mask: jnp.ndarray,
                          obs_disp: jnp.ndarray | None = None,
                          obs_dmask: jnp.ndarray | None = None,
                          axis: str = "kf",
                          fixed_mask: jnp.ndarray | None = None
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Window stereo BA with landmarks sharded over ``axis``.

    Shapes as backend/ba.bundle_adjust; N must divide the mesh axis size.
    ``fixed_mask`` (K,) optionally overrides the gauge (callers with
    multiple disconnected pose blocks — e.g. multi-sequence maps — must
    pin one keyframe PER block or the reduced system is singular).
    Returns (kf_T_wk', X') with X' sharded the same way as X.
    """
    K = kf_T_wk.shape[0]
    if obs_disp is None:
        obs_disp = jnp.zeros(obs_mask.shape, jnp.float32)
        obs_dmask = jnp.zeros(obs_mask.shape, bool)

    if fixed_mask is None:
        first_valid = jnp.argmax(kf_valid)
        fixed_mask = ((jnp.arange(K) == first_valid)
                      | ~kf_valid).astype(jnp.float32)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(None, axis), P(None, axis),
                  P(None, axis), P(None, axis), P()),
        out_specs=(P(), P(axis)))
    def run(T_wk_all, valid, X_s, Xm_s, obs_s, obsm_s, disp_s, dmask_s,
            fixed):
        T_kw = se3.inverse(T_wk_all)
        w_rows = ba.obs_weights(valid, Xm_s, obsm_s, dmask_s)
        obs_ur = obs_s[..., 0] - disp_s
        psum = functools.partial(jax.lax.psum, axis_name=axis)

        def body(carry, _):
            T_kw, X_s = carry
            # solver pinned explicitly (ADVICE r4): the reduced system
            # S/rhs is fully psum-reduced above, so every device holds the
            # complete 6K x 6K system and the replicated direct Cholesky
            # is valid (and faster) here too; "cg" remains the fallback
            # for window sizes where a dense factorization won't fit.
            T_kw, X_s, cost = ba.ba_iteration(
                cam, cfg, T_kw, X_s, obs_s, obs_ur, w_rows, fixed,
                reduce_fn=psum, solver="direct")
            return (T_kw, X_s), cost

        (T_kw, X_s), _ = jax.lax.scan(body, (T_kw, X_s), None,
                                      length=cfg.ba_iters)
        return se3.inverse(T_kw), X_s

    return run(kf_T_wk, kf_valid, X, X_mask, obs_uv, obs_mask,
               obs_disp, obs_dmask, fixed_mask)


def dryrun(n_devices: int) -> None:
    """Compile + execute one distributed BA on tiny synthetic geometry."""
    import numpy as np

    from ..config import CameraConfig, SvoConfig
    from ..geometry import camera as cam_mod

    cam = CameraConfig(fx=100.0, fy=100.0, cx=64.0, cy=48.0,
                       baseline=0.1, width=128, height=96)
    cfg = SvoConfig(camera=cam, ba_iters=2, max_keyframes=4)
    K, N = 4, 8 * n_devices
    rng = np.random.default_rng(0)

    # ground-truth geometry: landmarks in front of a slowly moving camera
    z = rng.uniform(2, 6, N)
    uv0 = np.stack([rng.uniform(20, 108, N), rng.uniform(20, 76, N)], -1)
    X = np.asarray(cam_mod.backproject(cam, jnp.asarray(uv0, jnp.float32),
                                       jnp.asarray(z, jnp.float32)))
    T_wk = []
    for k in range(K):
        T_wk.append(np.asarray(se3.exp(jnp.asarray(
            [0.05 * k, 0.0, 0.02 * k, 0.0, 0.01 * k, 0.0], jnp.float32))))
    T_wk = jnp.asarray(np.stack(T_wk))
    obs = []
    for k in range(K):
        x_c = se3.transform(se3.inverse(T_wk[k]), jnp.asarray(X, jnp.float32))
        uv, _ = cam_mod.project(cam, x_c)
        obs.append(uv)
    obs_uv = jnp.stack(obs)                                  # (K,N,2)
    obs_mask = jnp.ones((K, N), bool)

    mesh = mesh_mod.make(n_devices, axis_name="kf")
    T_out, X_out = bundle_adjust_sharded(
        mesh, cam, cfg, T_wk, jnp.ones(K, bool),
        jnp.asarray(X, jnp.float32) + 0.01, jnp.ones(N, bool),
        obs_uv, obs_mask)
    jax.block_until_ready((T_out, X_out))
