"""Ops-layer tests: interpolation, pyramid, FAST, stereo matching.

Kernel-parity strategy per SURVEY.md §4.2.1: each op is checked against a
straightforward numpy oracle or an analytic ground truth.
"""

import jax
import jax.numpy as jnp
import numpy as np

from stereo_svo_tpu.config import CameraConfig, SvoConfig
from stereo_svo_tpu.geometry import camera, se3
from stereo_svo_tpu.io import synthetic
from stereo_svo_tpu.ops import fast, interp, pyramid, stereo_match
from stereo_svo_tpu.frontend import detector

RNG = np.random.default_rng(3)


# ---------- interp ----------

def test_bilinear_matches_numpy_oracle():
    img = jnp.asarray(RNG.uniform(0, 255, size=(64, 80)), jnp.float32)
    pts = np.stack([RNG.uniform(0, 79, 200), RNG.uniform(0, 63, 200)], -1)
    out = interp.bilinear(img, jnp.asarray(pts, jnp.float32))

    im = np.asarray(img)
    u, v = pts[:, 0], pts[:, 1]
    u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
    u1, v1 = np.minimum(u0 + 1, 79), np.minimum(v0 + 1, 63)
    du, dv = u - u0, v - v0
    oracle = (im[v0, u0] * (1 - du) * (1 - dv) + im[v0, u1] * du * (1 - dv)
              + im[v1, u0] * (1 - du) * dv + im[v1, u1] * du * dv)
    np.testing.assert_allclose(out, oracle, rtol=1e-5, atol=1e-3)


def test_bilinear_grad_consistent_with_autodiff():
    img = jnp.asarray(RNG.uniform(0, 255, size=(32, 32)), jnp.float32)
    pts = jnp.asarray(np.stack([RNG.uniform(2, 29, 50),
                                RNG.uniform(2, 29, 50)], -1), jnp.float32)
    _, gu, gv = interp.bilinear_with_grad(img, pts)
    J = jax.vmap(jax.grad(lambda p: interp.bilinear(img, p)))(pts)
    np.testing.assert_allclose(gu, J[:, 0], atol=1e-3)
    np.testing.assert_allclose(gv, J[:, 1], atol=1e-3)


# ---------- pyramid ----------

def test_pyramid_shapes_and_mean():
    img = jnp.asarray(RNG.uniform(0, 255, size=(480, 752)), jnp.float32)
    lv = pyramid.build(img, 4)
    assert [l.shape for l in lv] == [(480, 752), (240, 376), (120, 188), (60, 94)]
    oracle = np.asarray(img).reshape(240, 2, 376, 2).mean(axis=(1, 3))
    np.testing.assert_allclose(lv[1], oracle, rtol=1e-6, atol=1e-3)
    # energy preserved
    np.testing.assert_allclose(float(jnp.mean(lv[3])), float(jnp.mean(img)),
                               rtol=0.05)


def test_gradients_central_difference():
    img = jnp.asarray(RNG.uniform(0, 255, size=(16, 16)), jnp.float32)
    gx, gy = pyramid.gradients(img)
    im = np.asarray(img)
    np.testing.assert_allclose(gx[:, 1:-1], 0.5 * (im[:, 2:] - im[:, :-2]),
                               atol=1e-4)
    np.testing.assert_allclose(gy[1:-1, :], 0.5 * (im[2:, :] - im[:-2, :]),
                               atol=1e-4)


# ---------- FAST ----------

def test_fast_detects_synthetic_corner():
    """A bright square on dark background: corners of the square must score
    high; flat regions and straight edges must score ~0."""
    img = np.zeros((64, 64), np.float32)
    img[20:40, 20:40] = 200.0
    s = np.asarray(fast.corner_score(jnp.asarray(img)))
    # corner pixels (just inside the square corners) are strong
    assert s[20, 20] > 100.0 and s[39, 39] > 100.0
    # flat interior & exterior are zero
    assert s[30, 30] == 0.0 and s[5, 5] == 0.0
    # middle of a straight edge must NOT be a FAST-9 corner
    assert s[20, 30] == 0.0 and s[30, 20] == 0.0


def test_fast_score_is_contrast():
    img = np.zeros((32, 32), np.float32)
    img[10:20, 10:20] = 80.0
    s80 = np.asarray(fast.corner_score(jnp.asarray(img)))[10, 10]
    img2 = img * 2.0
    s160 = np.asarray(fast.corner_score(jnp.asarray(img2)))[10, 10]
    np.testing.assert_allclose(s160, 2 * s80, rtol=1e-5)


# ---------- detector ----------

def test_detector_on_synthetic_scene():
    cfg = SvoConfig()
    cam = cfg.camera
    scene = synthetic.default_scene(0)
    img = synthetic.render_view(cam, se3.identity(), scene)
    lv, gxs, gys = pyramid.build_with_gradients(img, cfg.num_levels)
    det = jax.jit(lambda l, gx, gy: detector.detect(l, gx, gy, cfg))(
        lv, gxs[0], gys[0])
    n_valid = int(jnp.sum(det.valid))
    assert n_valid > 100, f"only {n_valid} features detected"
    # all valid features inside the border
    uv = np.asarray(det.uv)[np.asarray(det.valid)]
    assert uv[:, 0].min() >= 4 and uv[:, 0].max() < cam.width - 4
    assert uv[:, 1].min() >= 4 and uv[:, 1].max() < cam.height - 4
    # grid uniformity: features spread over most cells
    assert n_valid >= 0.55 * cfg.grid_rows * cfg.grid_cols


# ---------- stereo matching ----------

def test_stereo_match_recovers_gt_disparity():
    cfg = SvoConfig()
    cam = cfg.camera
    scene = synthetic.default_scene(0)
    T = se3.identity()
    left, right = synthetic.render_stereo(cam, T, scene)

    # ground-truth depth at feature points from the ray-cast planes
    lv, gxs, gys = pyramid.build_with_gradients(left, cfg.num_levels)
    det = detector.detect(lv, gxs[0], gys[0], cfg)
    disp, zncc, valid = stereo_match.match(
        left, right, det.uv, cfg.stereo_max_disp, cfg.stereo_patch)
    valid = valid & det.valid
    assert int(jnp.sum(valid)) > 80

    # analytic depth of plane A along each ray → expected disparity
    planes, _ = scene
    uv = np.asarray(det.uv)
    rays = np.stack([(uv[:, 0] - cam.cx) / cam.fx,
                     (uv[:, 1] - cam.cy) / cam.fy,
                     np.ones(len(uv))], -1)
    best_s = np.full(len(uv), np.inf)
    for p in planes:
        n = np.asarray(p.normal)
        denom = rays @ n
        s = np.where(np.abs(denom) > 1e-6, float(p.d) / denom, np.inf)
        s = np.where(s > 0.1, s, np.inf)
        best_s = np.minimum(best_s, s)
    z_gt = best_s * rays[:, 2] / np.linalg.norm(rays, axis=-1) * np.linalg.norm(rays, axis=-1)
    z_gt = best_s  # ray param times unit-z of pinhole ray: z = s (rays have z=1)
    d_gt = cam.fx * cam.baseline / z_gt

    m = np.asarray(valid)
    err = np.abs(np.asarray(disp)[m] - d_gt[m])
    # sub-pixel matching: median well under half a pixel
    assert np.median(err) < 0.3, f"median disparity error {np.median(err)}"
    assert np.mean(err < 1.0) > 0.9


def test_stereo_match_rejects_without_texture():
    cfg = SvoConfig()
    left = jnp.zeros((64, 256), jnp.float32)
    right = jnp.zeros((64, 256), jnp.float32)
    uv = jnp.asarray([[128.0, 32.0]], jnp.float32)
    _, _, valid = stereo_match.match(left, right, uv, 32, 8)
    assert not bool(valid[0])


def test_stereo_lr_check_rejects_occluded():
    """A feature visible only in the left image (texture pasted over the
    right) must fail the left-right round trip even when its ZNCC peak
    looks confident."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, (64, 256)).astype(np.float32)
    # smooth the noise so ZNCC peaks are broad enough to sub-pixel
    base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 0)) / 3.0
    d_true = 7.0
    right = np.roll(base, -int(d_true), axis=1)
    # occlude the right image around the feature with DIFFERENT texture
    right[24:40, 109:133] = rng.uniform(0, 255, (16, 24)).astype(np.float32)
    left = jnp.asarray(base)
    uv = jnp.asarray([[123.0, 32.0]], jnp.float32)
    _, _, v_occ = stereo_match.match(left, jnp.asarray(right), uv, 32, 8)
    assert not bool(v_occ[0]), "occluded match must fail the LR check"
    # sanity: the un-occluded pair matches fine at d_true
    right_ok = np.roll(base, -int(d_true), axis=1)
    disp, _, v_ok = stereo_match.match(left, jnp.asarray(right_ok), uv,
                                       32, 8)
    assert bool(v_ok[0]) and abs(float(disp[0]) - d_true) < 0.5


def test_refine_disparity_narrow_search():
    """refine_disparity recovers sub-pixel disparity from a prediction a
    few px off, and flags predictions off by more than the window."""
    cfg = SvoConfig()
    cam = cfg.camera
    scene = synthetic.default_scene(0)
    left, right = synthetic.render_stereo(cam, se3.identity(), scene)
    lv, gxs, gys = pyramid.build_with_gradients(left, cfg.num_levels)
    det = detector.detect(lv, gxs[0], gys[0], cfg)
    z_gt = synthetic.gt_depth(cam, se3.identity(), det.uv, scene)
    d_gt = cam.fx * cam.baseline / np.asarray(z_gt)
    sel = np.asarray(det.valid) & np.isfinite(d_gt) & (d_gt > 4) & (d_gt < 40)
    uv = det.uv[np.where(sel)[0][:64]]
    d_sel = d_gt[np.where(sel)[0][:64]]

    pred = jnp.asarray(d_sel + 2.0, jnp.float32)       # 2 px off
    disp, zncc, ok = stereo_match.refine_disparity(left, right, uv, pred,
                                                   window=4, patch=8)
    m = np.asarray(ok)
    assert m.mean() > 0.8
    err = np.abs(np.asarray(disp)[m] - d_sel[m])
    assert np.median(err) < 0.3, np.median(err)
    # prediction off by more than the window: the interior gate rejects
    # most (a peak pinned at the window edge = prediction was wrong), but
    # repetitive texture can still produce interior peaks — the Beta
    # outlier model absorbs those; only the RATE must drop sharply
    pred_far = jnp.asarray(d_sel + 9.0, jnp.float32)
    _, _, ok_far = stereo_match.refine_disparity(left, right, uv, pred_far,
                                                 window=4, patch=8)
    assert np.asarray(ok_far).mean() < m.mean() - 0.3


def test_stereo_observe_pulls_drifted_posterior_back():
    """The per-frame stereo observation must pull an inverse-depth
    posterior that drifted +10% back toward the (pose-free) stereo depth —
    the scale-anchor property (9778a94:BASELINE.md r3 root-cause)."""
    from stereo_svo_tpu.ops import depth_filter

    cfg = SvoConfig()
    cam = cfg.camera
    N = 8
    z_true = jnp.full((N,), 8.0)
    d_true = cam.fx * cam.baseline / z_true
    uv = jnp.tile(jnp.asarray([[300.0, 200.0]], jnp.float32), (N, 1))
    T_kc = jnp.tile(se3.identity()[None], (N, 1, 1))   # anchor == current
    mu_drift = (1.0 / z_true) * 0.9                    # depth +11% too far
    sigma2 = jnp.full((N,), (0.02 / 8.0) ** 2)
    a = jnp.full((N,), 10.0)
    b = jnp.full((N,), 10.0)
    out = depth_filter.stereo_observe_and_update(
        cam, cfg, T_kc, uv, d_true, jnp.ones(N, bool),
        mu_drift, sigma2, a, b, jnp.ones(N), jnp.ones(N, bool))
    assert bool(out.updated.all())
    z_post = 1.0 / np.asarray(out.mu)
    z0 = 1.0 / np.asarray(mu_drift)
    assert (np.abs(z_post - 8.0) < np.abs(z0 - 8.0) - 1e-3).all(), z_post
