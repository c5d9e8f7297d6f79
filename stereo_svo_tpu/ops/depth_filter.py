"""Batched recursive depth filters (Gaussian × Beta inverse-depth model).

Reference parity: DepthFilter::update — per-seed Bayesian depth estimation
with the Vogiatzis-Hernández Gaussian×Beta posterior as used by the SVO
family, seeded by stereo triangulation (src/lib/depth_filter.*
[UNVERIFIED — SURVEY.md §0]; SURVEY.md §3.5; BASELINE north star: "the
per-feature depth-filter update becomes a batched fused kernel over all
active seeds").

The reference's sequential per-seed loop becomes one masked update over the
whole (N,) seed array: every op below is elementwise — XLA fuses the entire
update (triangulation → tau → posterior) into a single elementwise pass.

Seed state (all (N,) float32, inverse-depth parameterization):
  mu      — posterior mean inverse depth (in the owner keyframe)
  sigma2  — posterior variance of inverse depth
  a, b    — Beta inlier/outlier pseudo-counts
  z_range — scene inverse-depth range (fixed at seeding; uniform outlier model)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..config import CameraConfig, SvoConfig
from ..geometry import camera as cam_mod
from ..geometry import se3, triangulate
from ..precision import MATCHING
from . import interp


class SeedUpdate(NamedTuple):
    mu: jnp.ndarray
    sigma2: jnp.ndarray
    a: jnp.ndarray
    b: jnp.ndarray
    updated: jnp.ndarray   # (N,) bool — observation accepted and applied


def seed_from_stereo(cam: CameraConfig, cfg: SvoConfig, z0: jnp.ndarray,
                     px_scale: jnp.ndarray | None = None):
    """Initialize (mu, sigma2, a, b) from stereo-triangulated depth z0.

    Inverse-depth measurement noise from 1-px disparity noise:
    d(1/z)/d(disp) = 1/(fx·baseline). px_scale: optional per-seed noise
    multiplier (2^detection_level).
    """
    mu = 1.0 / jnp.maximum(z0, 1e-3)
    noise = cfg.px_noise if px_scale is None else cfg.px_noise * px_scale
    tau_inv = noise / (cam.fx * cam.baseline)
    sigma2 = (3.0 * tau_inv) ** 2 * jnp.ones_like(mu)
    a = 10.0 * jnp.ones_like(mu)
    b = 10.0 * jnp.ones_like(mu)
    return mu, sigma2, a, b


def compute_tau(T_rc: jnp.ndarray, f_ref: jnp.ndarray, z: jnp.ndarray,
                px_error_angle: jnp.ndarray) -> jnp.ndarray:
    """Depth std-dev of a triangulated observation (SVO's computeTau).

    T_rc: (…,3,4) pose of current camera in the reference (seed) frame —
    its translation is the baseline vector t. f_ref: (…,3) unit bearing.
    """
    t = se3.translation(T_rc)
    t_norm = jnp.linalg.norm(t, axis=-1)
    a_vec = f_ref * z[..., None] - t
    a_norm = jnp.linalg.norm(a_vec, axis=-1)
    tn = jnp.maximum(t_norm, 1e-9)
    an = jnp.maximum(a_norm, 1e-9)
    alpha = jnp.arccos(jnp.clip(jnp.sum(f_ref * t, -1) / tn, -1.0, 1.0))
    beta = jnp.arccos(jnp.clip(-jnp.sum(a_vec * t, -1) / (an * tn), -1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma = jnp.pi - alpha - beta_plus
    sin_g = jnp.maximum(jnp.sin(gamma), 1e-6)
    z_plus = t_norm * jnp.sin(beta_plus) / sin_g
    return jnp.abs(z_plus - z)


def update(mu: jnp.ndarray, sigma2: jnp.ndarray, a: jnp.ndarray,
           b: jnp.ndarray, x: jnp.ndarray, tau2: jnp.ndarray,
           z_range: jnp.ndarray, apply_mask: jnp.ndarray) -> SeedUpdate:
    """One Vogiatzis-Hernández posterior update with measurement x ~ N(μ,τ²).

    All inputs (N,); ``apply_mask`` gates which seeds commit the update.
    """
    sigma2 = jnp.maximum(sigma2, 1e-12)
    tau2 = jnp.maximum(tau2, 1e-12)
    norm_scale = jnp.sqrt(sigma2 + tau2)

    s2 = 1.0 / (1.0 / sigma2 + 1.0 / tau2)
    m = s2 * (mu / sigma2 + x / tau2)

    # Gaussian pdf of x under N(mu, sigma2 + tau2)
    gauss = jnp.exp(-0.5 * (x - mu) ** 2 / (norm_scale ** 2)) / (
        jnp.sqrt(2.0 * jnp.pi) * norm_scale)
    C1 = a / (a + b) * gauss
    C2 = b / (a + b) * (1.0 / jnp.maximum(z_range, 1e-6))
    norm = jnp.maximum(C1 + C2, 1e-12)
    C1 = C1 / norm
    C2 = C2 / norm

    f = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e = (C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0))
         + C2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0)))

    mu_new = C1 * m + C2 * mu
    sigma2_new = C1 * (s2 + m * m) + C2 * (sigma2 + mu * mu) - mu_new * mu_new
    # Beta moment matching: a' = (e-f)/(f-e/f). Note e<f and e>f² for a
    # proper posterior, so numerator and denominator are both negative —
    # guard only against |denom|≈0, preserving sign.
    denom = f - e / jnp.maximum(f, 1e-12)
    denom = jnp.where(jnp.abs(denom) > 1e-12, denom, -1e-12)
    a_new = (e - f) / denom
    b_new = a_new * (1.0 - f) / jnp.maximum(f, 1e-12)

    finite = (jnp.isfinite(mu_new) & jnp.isfinite(sigma2_new)
              & jnp.isfinite(a_new) & jnp.isfinite(b_new)
              & (sigma2_new > 0) & (a_new > 0) & (b_new > 0))
    ok = apply_mask & finite
    return SeedUpdate(
        mu=jnp.where(ok, mu_new, mu),
        sigma2=jnp.where(ok, sigma2_new, sigma2),
        a=jnp.where(ok, a_new, a),
        b=jnp.where(ok, b_new, b),
        updated=ok)


def _floor_sigma(cfg: SvoConfig, upd: SeedUpdate) -> SeedUpdate:
    """Posterior σ floor (cfg.seed_sigma_floor · μ, inverse depth).

    The recursive filter assumes independent measurements, but motion
    triangulation shares the pose estimate's error — σ² collapses toward
    a correlated consensus and the truly independent per-frame stereo
    refresh loses traction. Measured on road_long (r5): the landmark map
    went persistently far-biased, per-frame translation ran +4..+17% hot
    against it (the scale-feedback loop), and window BA clawed back
    0.1-0.4 m at every keyframe until collapse. The floor keeps every
    seed/landmark permanently responsive to pose-free stereo evidence.
    """
    if cfg.seed_sigma_floor <= 0.0:
        return upd
    s_min = (cfg.seed_sigma_floor * upd.mu) ** 2
    return upd._replace(sigma2=jnp.maximum(upd.sigma2, s_min))


def observe_and_update(cam: CameraConfig, cfg: SvoConfig,
                       T_ck: jnp.ndarray,
                       kf_uv: jnp.ndarray, cur_uv: jnp.ndarray,
                       mu: jnp.ndarray, sigma2: jnp.ndarray,
                       a: jnp.ndarray, b: jnp.ndarray,
                       z_range: jnp.ndarray,
                       active: jnp.ndarray,
                       px_scale: jnp.ndarray | None = None) -> SeedUpdate:
    """Full per-frame seed update: triangulate the tracked observation
    against the owner keyframe, derive tau, update the posterior.

    T_ck: (N,3,4) per-seed pose mapping owner-KF points → current camera.
    kf_uv: (N,2) anchor pixel in owner KF; cur_uv: (N,2) tracked position.
    px_scale: optional (N,) multiplier on cfg.px_noise — a seed detected at
    pyramid level L carries ~2^L px measurement noise.
    """
    f_ref = jnp.concatenate([
        (kf_uv[:, 0:1] - cam.cx) / cam.fx,
        (kf_uv[:, 1:2] - cam.cy) / cam.fy,
        jnp.ones_like(kf_uv[:, 0:1])], axis=-1)          # (N,3), z=1
    f_cur = jnp.concatenate([
        (cur_uv[:, 0:1] - cam.cx) / cam.fx,
        (cur_uv[:, 1:2] - cam.cy) / cam.fy,
        jnp.ones_like(cur_uv[:, 0:1])], axis=-1)

    z_obs, tri_ok = triangulate.two_view_depth(T_ck, f_ref, f_cur)

    # tau in depth, then converted to inverse depth (SVO's recipe)
    T_kc = se3.inverse(T_ck)
    f_unit = f_ref / jnp.linalg.norm(f_ref, axis=-1, keepdims=True)
    z_unit = z_obs * jnp.linalg.norm(f_ref, axis=-1)      # depth along unit ray
    noise_px = cfg.px_noise if px_scale is None else cfg.px_noise * px_scale
    px_error_angle = jnp.arctan(noise_px / (2.0 * cam.fx)) * 2.0
    tau = compute_tau(T_kc, f_unit, z_unit, px_error_angle)
    tau = jnp.maximum(tau, 1e-6)
    z_lo = jnp.maximum(z_unit - tau, 1e-3)
    z_hi = z_unit + tau
    tau_inv = 0.5 * (1.0 / z_lo - 1.0 / z_hi)

    x_obs = 1.0 / jnp.maximum(z_obs, 1e-3)
    apply_mask = active & tri_ok & (z_obs > 0.05)
    upd = update(mu, sigma2, a, b, x_obs, tau_inv ** 2, z_range, apply_mask)
    return _floor_sigma(cfg, upd)


def stereo_observe_and_update(cam: CameraConfig, cfg: SvoConfig,
                              T_kc: jnp.ndarray,
                              cur_uv: jnp.ndarray,
                              disp: jnp.ndarray, disp_ok: jnp.ndarray,
                              mu: jnp.ndarray, sigma2: jnp.ndarray,
                              a: jnp.ndarray, b: jnp.ndarray,
                              z_range: jnp.ndarray,
                              active: jnp.ndarray,
                              px_scale: jnp.ndarray | None = None
                              ) -> SeedUpdate:
    """Per-frame STEREO depth observation folded into the seed posterior.

    Reference parity-plus: the reference seeds its filters from stereo and
    then updates them only with motion triangulation (SURVEY.md §3.5) —
    but a stereo rig measures metric depth every frame. Motion
    triangulation follows the pose estimate, so any pose-scale drift is
    reinforced, not corrected (measured: the KITTI-geometry forward-scale
    runaway — landmark depth bias compounding to +9.6%). The per-frame
    disparity measurement is pose-scale-free; folding it in pins the
    map's metric scale continuously.

    The measurement z_c = fx·baseline/disp lives in the CURRENT camera;
    the posterior is inverse depth along the ANCHOR ray: transform the
    measured point into the anchor frame and take its z. tau: propagate
    ±px_noise disparity bounds through the same transform (the z
    component of T_kc shifts by ~cosθ·Δz_c — exact enough at these
    angles).
    """
    z_c = cam_mod.disparity_to_depth(cam, disp)
    X_c = cam_mod.backproject(cam, cur_uv, z_c)
    z_k = se3.transform(T_kc, X_c)[..., 2]
    x_obs = 1.0 / jnp.maximum(z_k, 1e-3)

    noise = cfg.px_noise if px_scale is None else cfg.px_noise * px_scale
    dlo = jnp.maximum(disp - noise, 0.25)
    dhi = disp + noise
    z_c_hi = cam_mod.disparity_to_depth(cam, dlo)   # low disp → far
    z_c_lo = cam_mod.disparity_to_depth(cam, dhi)
    # anchor-frame depth moves (to first order) by the same Δz scaled by
    # the rotation's z-row alignment; bound it by the full Δ to stay safe
    dz_k_hi = z_k + (z_c_hi - z_c)
    dz_k_lo = jnp.maximum(z_k + (z_c_lo - z_c), 1e-3)
    tau_inv = 0.5 * (1.0 / dz_k_lo - 1.0 / jnp.maximum(dz_k_hi, 1e-3))
    tau_inv = jnp.maximum(jnp.abs(tau_inv), 1e-8)

    apply_mask = active & disp_ok & (z_c > 0.1) & (z_k > 0.05)
    upd = update(mu, sigma2, a, b, x_obs, tau_inv ** 2, z_range,
                 apply_mask)
    return _floor_sigma(cfg, upd)


def epipolar_search(cam: CameraConfig, cfg: SvoConfig,
                    T_ck: jnp.ndarray, kf_uv: jnp.ndarray,
                    mu: jnp.ndarray, sigma2: jnp.ndarray,
                    tmpl_patch: jnp.ndarray, img: jnp.ndarray,
                    active: jnp.ndarray, level: int = 0
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched 1-D epipolar search for seeds the tracker lost this frame.

    Reference parity: DepthFilter's per-seed epipolar-line search in the new
    frame (SURVEY.md §3.5: "epipolar search for the seed's patch in new
    frame (1-D along epipolar line)") — the path that keeps a seed observed
    when KLT fails on it, instead of letting it starve to death on its
    update budget. The reference scans pixel-by-pixel per seed; here the
    whole seed array is searched at once: the posterior μ±3σ inverse-depth
    interval projects to a segment in the current image, ``epi_samples``
    ZNCC probes cover it in one batched patch-sampling pass, and a
    parabola over the correlation peak gives the sub-sample position.

    Args:
      T_ck: (N,3,4) owner-KF → current-camera poses.
      kf_uv: (N,2) level-0 anchor pixels in the owner keyframe.
      mu, sigma2: inverse-depth posterior (defines the search interval).
      tmpl_patch: (N,P²) reference patches at ``level`` (the stored KLT
        template of the seed's anchor — its photometric identity).
      img: current image at ``level``.
      active: (N,) seeds to search.
      level: pyramid level to search at (coarser = cheaper; the returned
        position is level-0, measurement noise scales as 2^level).
    Returns:
      uv: (N,2) level-0 matched positions.
      ok: (N,) bool — peak found, interior, above cfg.epi_min_zncc, and
        probe spacing fine enough to not step over the peak.
      score: (N,) best ZNCC (diagnostic).
    """
    N = kf_uv.shape[0]
    S = cfg.epi_samples
    P = int(round(tmpl_patch.shape[-1] ** 0.5))
    scale = 1.0 / (2 ** level)

    sd = jnp.sqrt(jnp.maximum(sigma2, 1e-12))
    x_hi = mu + 3.0 * sd                       # nearest plausible (inv depth)
    x_lo = jnp.maximum(mu - 3.0 * sd, 1e-4)    # farthest plausible
    z_near = 1.0 / x_hi
    z_far = 1.0 / x_lo
    p_near = cam_mod.backproject(cam, kf_uv, z_near)
    p_far = cam_mod.backproject(cam, kf_uv, z_far)
    uv_a, front_a = cam_mod.project(cam, se3.transform(T_ck, p_near))
    uv_b, front_b = cam_mod.project(cam, se3.transform(T_ck, p_far))

    t = jnp.linspace(0.0, 1.0, S, dtype=jnp.float32)          # (S,)
    uv_s = uv_a[:, None] + t[None, :, None] * (uv_b - uv_a)[:, None]  # (N,S,2)
    cur = interp.sample_patch(img, uv_s.reshape(N * S, 2) * scale,
                              P).reshape(N, S, P * P)

    def znorm(p):
        p = p - jnp.mean(p, axis=-1, keepdims=True)
        return p / jnp.maximum(
            jnp.sqrt(jnp.sum(p * p, axis=-1, keepdims=True)), 1e-6)

    scores = jnp.einsum("np,nsp->ns", znorm(tmpl_patch), znorm(cur),
                        precision=MATCHING)
    best = jnp.argmax(scores, axis=1)
    s_best = jnp.take_along_axis(scores, best[:, None], 1)[:, 0]
    bm = jnp.clip(best - 1, 0, S - 1)
    bp = jnp.clip(best + 1, 0, S - 1)
    s0 = jnp.take_along_axis(scores, bm[:, None], 1)[:, 0]
    s2 = jnp.take_along_axis(scores, bp[:, None], 1)[:, 0]
    denom = s0 - 2.0 * s_best + s2
    off = jnp.where(jnp.abs(denom) > 1e-6,
                    0.5 * (s0 - s2) / jnp.where(jnp.abs(denom) > 1e-6,
                                                denom, 1.0), 0.0)
    off = jnp.clip(off, -0.5, 0.5)
    tt = (best.astype(jnp.float32) + off) / (S - 1)
    uv = uv_a + tt[:, None] * (uv_b - uv_a)

    seg = jnp.linalg.norm(uv_b - uv_a, axis=-1)
    spacing_ok = seg * scale / (S - 1) <= 0.75 * P  # probes overlap the peak
    interior = (best > 0) & (best < S - 1)
    in_img = cam_mod.in_bounds(cam, uv, margin=P * (2 ** level))
    # prominence gate: a flat correlation ridge (smooth texture along the
    # epipolar line) localizes arbitrarily — require a real peak
    prominent = s_best - 0.5 * (s0 + s2) > 0.01
    ok = (active & front_a & front_b & interior & in_img & spacing_ok
          & prominent & (s_best > cfg.epi_min_zncc))
    return uv, ok, s_best


def converged(cfg: SvoConfig, mu: jnp.ndarray, sigma2: jnp.ndarray
              ) -> jnp.ndarray:
    """Seed convergence: inverse-depth std below a fraction of the mean."""
    return jnp.sqrt(sigma2) < cfg.seed_sigma_ratio * jnp.maximum(mu, 1e-6)


def diverged(cfg: SvoConfig, a: jnp.ndarray, b: jnp.ndarray,
             n_updates: jnp.ndarray) -> jnp.ndarray:
    """Cull: posterior inlier probability collapsed, or update budget spent."""
    inlier_prob = a / jnp.maximum(a + b, 1e-6)
    return (inlier_prob < 0.1) | (n_updates > cfg.seed_max_updates)
