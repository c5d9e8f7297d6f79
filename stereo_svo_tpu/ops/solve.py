"""Small linear-algebra kernels, LAPACK-free, batched, XLA-fusable.

`jnp.linalg.solve/inv` on a batch of tiny matrices lower to library
factorization calls (cuSOLVER on the GPU) with their own launch and
workspace; the SVO hot loops only ever need 2x2/3x3 closed forms, a 6x6
SPD solve, and a small-SPD CG — all of which fuse into the surrounding GN
graphs as plain elementwise arithmetic. Used by alignment, KLT, pose
refinement and the BA Schur solver.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..precision import SOLVER


def inv2x2(A: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Batched closed-form 2x2 inverse: (…,2,2) → (…,2,2)."""
    a = A[..., 0, 0]
    b = A[..., 0, 1]
    c = A[..., 1, 0]
    d = A[..., 1, 1]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) > eps, det, jnp.sign(det) * eps + eps)
    inv = jnp.stack([
        jnp.stack([d, -b], -1),
        jnp.stack([-c, a], -1),
    ], -2)
    return inv / det[..., None, None]


def inv3x3(A: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Batched adjugate 3x3 inverse: (…,3,3) → (…,3,3)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    det = jnp.where(jnp.abs(det) > eps, det, jnp.sign(det) * eps + eps)
    adj = jnp.stack([
        jnp.stack([c00, c01, c02], -1),
        jnp.stack([c10, c11, c12], -1),
        jnp.stack([c20, c21, c22], -1),
    ], -2)
    return adj / det[..., None, None]


def chol_solve_small(A: jnp.ndarray, b: jnp.ndarray,
                     jitter: float = 0.0) -> jnp.ndarray:
    """SPD solve via statically-unrolled Cholesky; n is a static small
    dimension (6 for pose systems). Batched over leading dims.

    A: (…,n,n) SPD, b: (…,n) → x with A x = b.
    """
    n = A.shape[-1]
    if jitter:
        A = A + jitter * jnp.eye(n, dtype=A.dtype)
    # unrolled Cholesky A = L Lᵀ (row-major scalar recurrences; each
    # "scalar" is a batched vector over the leading dims)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution Lᵀ x = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def cg_solve(A: jnp.ndarray, b: jnp.ndarray, iters: int = 25,
             x0: jnp.ndarray | None = None) -> jnp.ndarray:
    """Fixed-iteration conjugate gradient for SPD A (…,n,n), b (…,n).

    Jacobi-preconditioned; fixed ``iters`` keeps control flow static.
    This is the reduced-camera-system fallback of window BA — matvecs
    are batched matmuls, and under shard_map the A blocks are already psum-reduced so no per-iteration collectives
    are needed.
    """
    diag = jnp.diagonal(A, axis1=-2, axis2=-1)
    Minv = 1.0 / jnp.maximum(jnp.abs(diag), 1e-12)

    def mv(v):
        # true-f32 matvec: TF32 inputs are too coarse for CG on normal
        # equations (see backend/ba.py note)
        return jnp.einsum("...ij,...j->...i", A, v, precision=SOLVER)

    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - mv(x)
    z = Minv * r
    p = z
    rz = jnp.sum(r * z, axis=-1, keepdims=True)

    def body(_, carry):
        x, r, p, rz = carry
        Ap = mv(p)
        denom = jnp.sum(p * Ap, axis=-1, keepdims=True)
        alpha = rz / jnp.where(jnp.abs(denom) > 1e-20, denom, 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv * r
        rz_new = jnp.sum(r * z, axis=-1, keepdims=True)
        beta = rz_new / jnp.where(jnp.abs(rz) > 1e-20, rz, 1e-20)
        p = z + beta * p
        return x, r, p, rz_new

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, p, rz))
    return x
