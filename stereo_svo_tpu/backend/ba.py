"""Keyframe-window bundle adjustment: batched Schur-complement Gauss-Newton.

Reference parity: sliding-window local BA jointly refining keyframe poses +
landmarks, Schur-style (SURVEY.md §2.1 "Local BA + pose graph"; in the
BASELINE north star: "sparse Ceres-style BA becomes a distributed
Schur-complement CG solver over the keyframe mesh").

The reference's sparse per-observation loops become dense *masked block
tensors*: with K ≤ max_keyframes poses and N ≤ max_features landmarks, all
(K,N) observation blocks are built in one shot by einsum — the landmark
block Hll is block-diagonal (3x3 per landmark) and eliminated in closed
form; the reduced camera system (6K x 6K, tiny) is solved densely. Masks
make absent observations exact zeros, so the masked dense formulation is
algebraically identical to the sparse solver while running as a few
large batched contractions instead of per-observation loops.

The same functions run under ``shard_map`` with landmarks sharded across a
mesh axis — partial Schur blocks then ``psum`` into the replicated reduced
system (parallel/dist_ba.py; SURVEY.md §5.7).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig, SvoConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import solve as solve_ops
# The BA normal equations need true f32 matmuls: with reduced-precision
# matmul inputs (TF32 keeps a 10-bit mantissa; preferred_element_type
# only sets the accumulator dtype) GN diverges on driving-scale geometry —
# identical inputs converged 628 -> 92 at f32 and diverged 737 -> 4383
# with reduced-precision inputs when this solver was built (commit
# 9778a94 history). BA is keyframe-rate work; the cost of true f32 is
# negligible.
from ..precision import SOLVER


class BAStats(NamedTuple):
    cost_initial: jnp.ndarray
    cost_final: jnp.ndarray
    n_obs: jnp.ndarray


def _linearize(cam: CameraConfig, cfg: SvoConfig,
               T_kw: jnp.ndarray, X: jnp.ndarray,
               obs_uv: jnp.ndarray, obs_ur: jnp.ndarray,
               w_rows: jnp.ndarray, obs_sig: jnp.ndarray | None = None):
    """Residuals + weighted normal-equation blocks for all (K,N) pairs.

    *Stereo* BA (as the reference is a stereo system): each observation
    contributes up to three residual rows — left (u, v) plus the right
    camera's u-coordinate u_r = fx·(x−baseline)/z + cx. The u_r row is what
    makes scale observable inside the window (monocular BA has a 7-DoF
    gauge; fixing one KF leaves scale free and noise slides the whole
    window along it).

    T_kw: (K,3,4) world→KF. X: (N,3). obs_uv: (K,N,2). obs_ur: (K,N).
    w_rows: (K,N,3) per-row weight masks (row 2 = stereo row; 0 when the
    disparity was not measured).
    obs_sig: optional (K,N) per-observation pixel noise (features detected
    at pyramid level L localize to ~2^L px); residuals are whitened by it
    (Huber radius and information weight both scale).
    Returns (Hpp, Hll, Hpl, gp, gl, cost).
    """
    x_c = se3.transform(T_kw[:, None], X[None])          # (K,N,3)
    uv, front = cam_mod.project(cam, x_c)
    # Near-plane gate: as the estimate drifts, a landmark can slide to
    # tiny positive depth in SOME window camera. Its Jacobian energy
    # (∝ fx²/z⁴) then floods the f32 reduced system — entries ~1e18 next
    # to the 1e-3 damping floor — and the Cholesky NaNs (measured: the
    # road_long BA died with cost_final=NaN at the first eviction and
    # never recovered, r5 forensics). A sub-25 cm observation row carries
    # no usable constraint for these rigs; zero its weight.
    front = front & (x_c[..., 2] > 0.25)
    z = jnp.maximum(x_c[..., 2], 1e-3)
    u_r = cam.fx * (x_c[..., 0] - cam.baseline) / z + cam.cx
    r = jnp.concatenate([uv - obs_uv, (u_r - obs_ur)[..., None]],
                        axis=-1)                          # (K,N,3)

    sig = jnp.ones(r.shape[:2], r.dtype) if obs_sig is None else obs_sig
    rn = jnp.sqrt(jnp.sum(r * r * (w_rows > 0), axis=-1) + 1e-12) / sig
    huber = jnp.where(rn <= cfg.ba_huber_px, 1.0,
                      cfg.ba_huber_px / jnp.maximum(rn, 1e-6))
    w = w_rows * (huber * front / (sig * sig))[..., None]  # (K,N,3)

    # Jacobians w.r.t. camera-frame point: left rows + right-u row.
    Jproj = cam_mod.proj_jacobian(cam, x_c)               # (K,N,2,3)
    iz = 1.0 / z
    Jr3 = jnp.stack([cam.fx * iz, jnp.zeros_like(iz),
                     -cam.fx * (x_c[..., 0] - cam.baseline) * iz * iz],
                    axis=-1)                              # (K,N,3)
    Jc = jnp.concatenate([Jproj, Jr3[..., None, :]], axis=-2)  # (K,N,3,3)

    # pose rows: d x_c/d(v,w) = [I | -hat(x_c)] for left-multiplied twists
    J_w = -jnp.einsum("knri,knij->knrj", Jc, se3.hat(x_c),
                      precision=SOLVER)
    Jp = jnp.concatenate([Jc, J_w], axis=-1)              # (K,N,3,6)
    R_kw = se3.rotation(T_kw)                             # (K,3,3)
    Jl = jnp.einsum("knri,kij->knrj", Jc, R_kw,
                    precision=SOLVER)                        # (K,N,3,3)

    Hpp = jnp.einsum("knri,knr,knrj->kij", Jp, w, Jp,
                     precision=SOLVER, preferred_element_type=jnp.float32)  # (K,6,6)
    Hll = jnp.einsum("knri,knr,knrj->nij", Jl, w, Jl,
                     precision=SOLVER, preferred_element_type=jnp.float32)  # (N,3,3)
    Hpl = jnp.einsum("knri,knr,knrj->knij", Jp, w, Jl,
                     precision=SOLVER, preferred_element_type=jnp.float32)  # (K,N,6,3)
    gp = jnp.einsum("knri,knr,knr->ki", Jp, w, r,
                    precision=SOLVER, preferred_element_type=jnp.float32)   # (K,6)
    gl = jnp.einsum("knri,knr,knr->ni", Jl, w, r,
                    precision=SOLVER, preferred_element_type=jnp.float32)   # (N,3)
    cost = jnp.sum(w * r * r)
    return Hpp, Hll, Hpl, gp, gl, cost


def _schur_reduce(Hpp, Hll, Hpl, gp, gl, lam, fixed_mask, reduce_fn=None):
    """Eliminate landmarks; return (S (6K,6K), rhs (6K,), Hll_inv, W).

    ``reduce_fn`` sums partial pose-side blocks across landmark shards
    (identity on a single device; ``lax.psum`` over the 'kf' mesh axis in
    the distributed solver — SURVEY.md §5.7). Landmark-side blocks
    (Hll, W) stay shard-local.
    """
    K = Hpp.shape[0]
    if reduce_fn is None:
        reduce_fn = lambda x: x
    I3 = jnp.eye(3, dtype=Hll.dtype)
    # Damped, mask-safe landmark blocks (dead landmarks → identity).
    Hll_d = Hll + (lam + 1e-6) * I3[None]
    deg = jnp.einsum("nii->n", Hll)  # trace as activity proxy
    Hll_d = jnp.where((deg > 1e-8)[:, None, None], Hll_d, I3[None])
    Hll_inv = solve_ops.inv3x3(Hll_d)                      # (N,3,3)

    # S_{k,k'} = δ·Hpp_k − Σ_j Hpl_kj Hll_j^{-1} Hpl_k'j^T
    W = jnp.einsum("knij,njl->knil", Hpl, Hll_inv,
                   precision=SOLVER)                          # (K,N,6,3)
    S_off = jnp.einsum("knil,mnjl->kmij", W, Hpl,
                       precision=SOLVER, preferred_element_type=jnp.float32)  # (K,K,6,6)
    rhs_l = jnp.einsum("knil,nl->ki", W, gl, precision=SOLVER)  # (K,6)

    # cross-shard reduction of everything that sums over landmarks
    Hpp = reduce_fn(Hpp)
    gp = reduce_fn(gp)
    S_off = reduce_fn(S_off)
    rhs_l = reduce_fn(rhs_l)

    S = -S_off
    diag = Hpp + lam * jnp.eye(6, dtype=Hpp.dtype)[None]
    S = S.at[jnp.arange(K), jnp.arange(K)].add(diag)
    rhs = -(gp - rhs_l)                                    # (K,6)

    # Gauge fixing by EXACT elimination: zero the fixed poses' rows,
    # columns, and rhs; identity on their diagonal → their delta solves
    # to exactly 0 and the free block keeps its natural conditioning.
    # (The previous 1e12 diagonal prior made the f32 reduced system's
    # condition number gauge-dominated — the fixed-iteration Jacobi CG
    # returned garbage steps on driving-scale data: measured cost
    # 890 → 332k, a 57 m pose step, silently absorbed by the divergence
    # guard; commit 9778a94 history.)
    free = (1.0 - fixed_mask)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S = S.at[jnp.arange(K), jnp.arange(K)].add(
        fixed_mask[:, None, None] * jnp.eye(6, dtype=S.dtype)[None])
    rhs = rhs * free[:, None]

    S_flat = S.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
    rhs_flat = rhs.reshape(6 * K)
    return S_flat, rhs_flat, Hll_inv, W


def ba_iteration(cam: CameraConfig, cfg: SvoConfig,
                 T_kw: jnp.ndarray, X: jnp.ndarray,
                 obs_uv: jnp.ndarray, obs_ur: jnp.ndarray,
                 w_rows: jnp.ndarray,
                 fixed_mask: jnp.ndarray, lam: float = 1e-3,
                 reduce_fn=None, obs_sig: jnp.ndarray | None = None,
                 solver: str = "direct"):
    """One damped GN step. Returns (T_kw', X', cost_before).

    With ``reduce_fn = partial(lax.psum, axis_name='kf')`` and
    landmark-sharded inputs this same function is the distributed
    Schur-complement BA step (parallel/dist_ba.py).

    solver: "direct" (default) solves the reduced camera system (6K x 6K,
    K <= 10 → 60x60) with one dense Cholesky. The distributed path
    (parallel/dist_ba.py) also uses "direct": its reduce_fn psum fully
    reduces S/rhs, so every device holds the complete reduced system and
    the replicated factorization is valid (equivalence vs single-device:
    tests/test_parallel.py). "cg" is the fixed-iteration Jacobi-CG
    fallback for window sizes where a dense factorization won't fit. At
    the default window size CG-40 is pure serial latency: 40 dependent
    tiny matvec/axpy steps against one 60x60 factorization.
    """
    K = T_kw.shape[0]
    Hpp, Hll, Hpl, gp, gl, cost = _linearize(
        cam, cfg, T_kw, X, obs_uv, obs_ur, w_rows, obs_sig)
    S, rhs, Hll_inv, W = _schur_reduce(Hpp, Hll, Hpl, gp, gl, lam,
                                       fixed_mask, reduce_fn)
    if solver == "direct":
        # Jacobi (symmetric diagonal) preconditioning before the f32
        # Cholesky: driving-scale windows mix O(1e6+) constrained
        # directions with O(1e-3) damped-only ones in S — condition
        # numbers far past f32's factorization range produce negative
        # pivots → NaN. Scaling by D^-1/2 S D^-1/2 bounds the diagonal at
        # 1 and costs two (6K,) multiplies.
        d = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(S), 1e-12))
        S_hat = S * d[:, None] * d[None, :]
        y = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(S_hat), rhs * d)
        dp = (y * d).reshape(K, 6)
    else:
        # Jacobi-preconditioned CG, fixed iteration count (static graph)
        dp = solve_ops.cg_solve(S, rhs, iters=40).reshape(K, 6)
    # Back-substitute landmarks: δl = -Hll⁻¹ (gl + Hlpᵀ·δp)
    Hlp_dp = jnp.einsum("knij,ki->nj", Hpl, dp,
                        precision=SOLVER)                     # (N,3)
    dl = -jnp.einsum("nij,nj->ni", Hll_inv, gl + Hlp_dp,
                     precision=SOLVER)
    # clamp pathological steps (masked/degenerate landmarks)
    dl = jnp.clip(dl, -1.0, 1.0)
    dp = dp * (1.0 - fixed_mask)[:, None]
    # Finite-step guard: one non-finite solve (adversarial geometry past
    # every gate) must cost that ITERATION, not poison the GN carry — a
    # NaN step would propagate through T_kw/X into every later iteration
    # and disable BA for the rest of the run (the pre-r5 road_long
    # failure mode; the divergence guard in engine/step.run_window_ba
    # only rejects the final result). Poses are guarded on pose data only
    # (replicated/shard-invariant under shard_map); landmarks per-row
    # (shard-local) — mixing dl into the pose guard would make the pose
    # carry shard-varying.
    dp = jnp.where(jnp.all(jnp.isfinite(dp)), dp, 0.0)
    dl = jnp.where(jnp.all(jnp.isfinite(dl), axis=-1, keepdims=True),
                   dl, 0.0)

    T_kw_new = jax.vmap(lambda t, d: se3.compose(se3.exp(d), t))(T_kw, dp)
    X_new = X + dl
    return T_kw_new, X_new, cost


def obs_weights(kf_valid: jnp.ndarray, X_mask: jnp.ndarray,
                obs_mask: jnp.ndarray, obs_dmask: jnp.ndarray
                ) -> jnp.ndarray:
    """(K,N,3) per-row weights: rows 0-1 = left (u,v), row 2 = stereo u_r."""
    base = obs_mask & kf_valid[:, None] & X_mask[None]
    w_lr = base.astype(jnp.float32)
    w_st = (base & obs_dmask).astype(jnp.float32)
    return jnp.stack([w_lr, w_lr, w_st], axis=-1)


def bundle_adjust(cam: CameraConfig, cfg: SvoConfig,
                  kf_T_wk: jnp.ndarray, kf_valid: jnp.ndarray,
                  X: jnp.ndarray, X_mask: jnp.ndarray,
                  obs_uv: jnp.ndarray, obs_mask: jnp.ndarray,
                  obs_disp: jnp.ndarray | None = None,
                  obs_dmask: jnp.ndarray | None = None,
                  obs_sig: jnp.ndarray | None = None,
                  kf_stamp: jnp.ndarray | None = None,
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, BAStats]:
    """Window BA over the keyframe ring buffer + landmark set.

    obs_disp: (K,N) measured stereo disparity at each observation (the
    right-camera u is obs_uv[...,0] − disp). When omitted the solve is
    monocular (legacy / testing only — scale then rides the gauge).

    Gauge: the oldest valid keyframe (by kf_stamp when given — slot order
    does NOT follow age under least-owned eviction) is held fixed. Dead
    keyframes / landmarks participate with zero weights (masked dense
    formulation).
    """
    K = kf_T_wk.shape[0]
    T_kw = se3.inverse(kf_T_wk)
    if obs_disp is None:
        obs_disp = jnp.zeros(obs_mask.shape, jnp.float32)
        obs_dmask = jnp.zeros(obs_mask.shape, bool)
    obs_ur = obs_uv[..., 0] - obs_disp
    w_rows = obs_weights(kf_valid, X_mask, obs_mask, obs_dmask)

    # A keyframe only participates as a FREE pose if it still observes
    # enough live landmarks. Feature-slot recycling erodes old keyframes'
    # observation rows (a new feature in a reused slot clears the slot's
    # column in every older row — keyframe.insert hygiene); once the
    # oldest keyframe's row empties, pinning it as gauge constrains
    # nothing and the remaining window is a disconnected component with
    # full 6-DoF gauge freedom — the solver then slides the whole free
    # window along exact null directions (measured on road_long r5:
    # +0.40-0.46 m pure-forward proposals with bitwise-equal
    # cost_initial == cost_final at every post-eviction call, BA
    # effectively dead). Freeze under-constrained keyframes and choose
    # the gauge among constrained ones.
    n_obs_k = jnp.sum(w_rows[..., 0] > 0, axis=1)          # (K,)
    constrained = kf_valid & (n_obs_k >= 4)
    if kf_stamp is not None:
        big = jnp.asarray(2 ** 30, kf_stamp.dtype)
        first_valid = jnp.argmin(jnp.where(constrained, kf_stamp, big))
    else:
        first_valid = jnp.argmax(constrained)  # first True (legacy)
    fixed_mask = (jnp.arange(K) == first_valid).astype(jnp.float32)
    fixed_mask = jnp.clip(
        fixed_mask + (1.0 - constrained.astype(jnp.float32)), 0.0, 1.0)

    def body(carry, _):
        T_kw, X = carry
        T_kw, X, cost = ba_iteration(cam, cfg, T_kw, X, obs_uv, obs_ur,
                                     w_rows, fixed_mask, obs_sig=obs_sig)
        return (T_kw, X), cost

    (T_kw, X), costs = jax.lax.scan(body, (T_kw, X), None,
                                    length=cfg.ba_iters)
    *_, cost_final = _linearize(cam, cfg, T_kw, X, obs_uv, obs_ur, w_rows,
                                obs_sig)
    stats = BAStats(cost_initial=costs[0], cost_final=cost_final,
                    n_obs=jnp.sum(w_rows[..., 0] > 0))
    return se3.inverse(T_kw), X, stats
