"""Pose-graph optimization over keyframe chains, batched Gauss-Newton.

Reference parity: pose-graph optimization over the keyframe chain
(SURVEY.md §2.1 "Local BA + pose graph", [SPEC]). Edges carry measured
relative poses (odometry and, when available, loop closures); the solver
refines absolute keyframe poses T_wk minimizing

    Σ_e || log( Z_e⁻¹ ∘ T_{i(e)}w ∘ T_w{j(e)} ) ||²_Λ

Fixed-capacity edge list with a validity mask (same masked-dense design as
the BA solver). Jacobian blocks use the standard right/left-Jacobian ≈ I
approximation (exact at convergence), giving J_i = Ad(Z_e⁻¹)·(stuff) — we
instead build them by forward-mode autodiff of the residual at ξ=0, which
is exact, shape-static, and free of hand-derivation errors; the problem
size (≤ max_keyframes·6 parameters) keeps this cheap.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..precision import SOLVER


class PoseGraph(NamedTuple):
    edges_ij: jnp.ndarray   # (E,2) int32 — indices (i, j) into the pose array
    Z: jnp.ndarray          # (E,3,4) measured T_i←j (j expressed in i frame)
    weight: jnp.ndarray     # (E,) edge weights (0 = inactive)


def chain_graph(T_wk: jnp.ndarray, valid: jnp.ndarray,
                noise: float = 0.0) -> PoseGraph:
    """Odometry chain edges (k, k+1) from current pose estimates."""
    K = T_wk.shape[0]
    i = jnp.arange(K - 1)
    j = i + 1
    Z = jax.vmap(lambda a, b: se3.compose(se3.inverse(a), b))(
        T_wk[:-1], T_wk[1:])
    w = (valid[:-1] & valid[1:]).astype(jnp.float32)
    return PoseGraph(edges_ij=jnp.stack([i, j], -1), Z=Z, weight=w)


def chain_graph_stamped(T_wk: jnp.ndarray, valid: jnp.ndarray,
                        stamp: jnp.ndarray) -> PoseGraph:
    """Odometry chain edges between *temporally* consecutive keyframes.

    The keyframe store is a ring with least-owned eviction
    (frontend/keyframe.py), so slot order is not temporal order once a
    slot has been reused; edges here follow ``stamp`` (frame index at
    creation) instead. Fixed capacity K-1 edges, invalid tail masked.
    """
    K = T_wk.shape[0]
    order = jnp.argsort(jnp.where(valid, stamp, jnp.iinfo(jnp.int32).max))
    n = jnp.sum(valid)
    i = order[:-1]
    j = order[1:]
    Z = jax.vmap(lambda a, b: se3.compose(se3.inverse(a), b))(
        T_wk[i], T_wk[j])
    w = (jnp.arange(K - 1) < n - 1).astype(jnp.float32)
    return PoseGraph(edges_ij=jnp.stack([i, j], -1).astype(jnp.int32),
                     Z=Z, weight=w)


def _residual(T_wk: jnp.ndarray, graph: PoseGraph) -> jnp.ndarray:
    """(E,6) residuals of all edges."""
    Ti = T_wk[graph.edges_ij[:, 0]]
    Tj = T_wk[graph.edges_ij[:, 1]]
    rel = jax.vmap(lambda a, b: se3.compose(se3.inverse(a), b))(Ti, Tj)
    err = jax.vmap(lambda z, m: se3.log(se3.compose(se3.inverse(z), m)))(
        graph.Z, rel)
    return err


def optimize(T_wk: jnp.ndarray, valid: jnp.ndarray, graph: PoseGraph,
             n_iters: int = 10, fixed: int = 0, lam: float = 1e-6
             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """GN over absolute poses; pose ``fixed`` pins the gauge.

    Returns (T_wk_optimized, final_cost).
    """
    K = T_wk.shape[0]

    def perturbed_residual(xi_flat, T_cur):
        xi = xi_flat.reshape(K, 6)
        T_pert = jax.vmap(lambda d, t: se3.compose(se3.exp(d), t))(xi, T_cur)
        return (_residual(T_pert, graph)
                * jnp.sqrt(graph.weight)[:, None]).reshape(-1)

    def body(T_cur, _):
        zero = jnp.zeros(K * 6, T_cur.dtype)
        J = jax.jacfwd(perturbed_residual)(zero, T_cur)     # (6E, 6K)
        r = perturbed_residual(zero, T_cur)                 # (6E,)
        H = (jnp.matmul(J.T, J, precision=SOLVER)
             + lam * jnp.eye(K * 6, dtype=T_cur.dtype))
        g = jnp.matmul(J.T, r, precision=SOLVER)
        # gauge + invalid poses pinned
        pin = ((jnp.arange(K) == fixed) | ~valid)
        big = 1e12
        H = H + jnp.diag(jnp.repeat(pin.astype(T_cur.dtype) * big, 6))
        dx = -jnp.linalg.solve(H, g).reshape(K, 6)
        T_new = jax.vmap(lambda d, t: se3.compose(se3.exp(d), t))(dx, T_cur)
        cost = jnp.sum(r * r)
        return T_new, cost

    T_out, costs = jax.lax.scan(body, T_wk, None, length=n_iters)
    final = jnp.sum(_residual(T_out, graph) ** 2 * graph.weight[:, None])
    return T_out, final
