#!/usr/bin/env python
"""Amortized per-op timings on the GPU: each op repeated R times inside
one jitted lax.scan, so per-call dispatch divides out and the op runs as
it does inside the scan-based pipeline.

Full-frame accounting (VERDICT r3 next #1a): beyond the individual op
rows, the script measures every per-frame cost the r3 table omitted
(relocalization descriptor pass, epipolar seed recovery, per-frame stereo
reobservation, template rebuild, depth-filter second update) plus the
KF-rate costs (keyframe insertion, window BA), times the REAL steady-state
step, and closes the budget:

    frame_ms ≈ step_nonkf_ms + kf_rate * (kf_insert_ms + window_ba_ms)

with ``accounting`` reporting per-op sum vs step_nonkf (intra-frame
fusion residual) and the model vs the measured full-scan frame time.

BENCH_AMORT_STRESS=1 runs the whole table at north-star config #3 shapes
(2048 features, 5 levels) — the binding-resource analysis input."""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from stereo_svo_tpu.config import SvoConfig, stress_config
from stereo_svo_tpu.frontend import detector, keyframe, pose_refine
from stereo_svo_tpu.geometry import camera as cam_mod, se3
from stereo_svo_tpu.io import synthetic
from stereo_svo_tpu.ops import align, depth_filter, klt, pyramid, stereo_match
from stereo_svo_tpu.utils.profiling import time_runs

# R repeats per timed call: host dispatch jitter divides by R.
R = int(os.environ.get("BENCH_AMORT_R", "200"))


def scanned(body_of_c):
    """Wrap op in a scan of R dependent iterations; returns jitted fn."""
    def outer(*args):
        def body(c, _):
            out = body_of_c(c, *args)
            return c + 1e-3, out
        return jax.lax.scan(body, 0.0, None, length=R)
    return jax.jit(outer)


def main():
    from stereo_svo_tpu import compile_cache
    from stereo_svo_tpu.utils import device

    dev = device.require_gpu()
    compile_cache.enable()
    stress = os.environ.get("BENCH_AMORT_STRESS") == "1"
    cfg = stress_config() if stress else SvoConfig()
    cam = cfg.camera
    scene = synthetic.default_scene(0)
    img_l, img_r = jax.jit(
        lambda: synthetic.render_stereo(cam, se3.identity(), scene))()
    pyr, gxs, gys = pyramid.build_with_gradients(img_l, cfg.num_levels)
    det = detector.detect(pyr, gxs[0], gys[0], cfg)
    z = synthetic.gt_depth(cam, se3.identity(), det.uv, scene)
    tmpl = align.make_template(pyr, gxs, gys, cam, cfg, det.uv, z, det.valid)
    ktmpl = klt.make_template(pyr, gxs, gys, cfg, det.uv, det.valid)
    X = cam_mod.backproject(cam, det.uv, z)

    results = {}

    def per_call_ms(fn, *args):
        _, times, out = time_runs(fn, *args)
        return float(np.median(times)) * 1e3 / R, out

    def amort(name, fn, *args):
        results[name] = per_call_ms(fn, *args)[0]

    twist = jnp.zeros(6).at[0].set(1e-4)
    amort("align_ms", scanned(
        lambda c, p, t: align.align(p, t, cam, cfg,
                                    se3.exp(twist * c))[0]), pyr, tmpl)
    amort("klt_ms", scanned(
        lambda c, p, t, uv: klt.track(p, t, cfg, uv + c)[0]),
        pyr, ktmpl, det.uv)
    amort("pyramid_ms", scanned(
        lambda c, i: pyramid.build_with_gradients(i + c, cfg.num_levels)[0][0]),
        img_l)
    amort("align_template_ms", scanned(
        lambda c, p, gx, gy, uv, zz, m: align.make_template(
            p, gx, gy, cam, cfg, uv + c, zz, m).patches),
        pyr, gxs, gys, det.uv, z, det.valid)
    amort("klt_template_ms", scanned(
        lambda c, p, gx, gy, uv, m: klt.make_template(
            p, gx, gy, cfg, uv + c, m).patches),
        pyr, gxs, gys, det.uv, det.valid)
    amort("stereo_match_ms", scanned(
        lambda c, l, r, uv: stereo_match.match(
            l, r, uv + c, cfg.stereo_max_disp, cfg.stereo_patch)[0]),
        img_l, img_r, det.uv)
    amort("pose_refine_ms", scanned(
        lambda c, x, uv, m: pose_refine.refine(
            cam, cfg, se3.exp(twist * c), x, uv, m)[0]),
        X, det.uv, det.valid)
    amort("detector_ms", scanned(
        lambda c, p, gx, gy: detector.detect(
            [l + c for l in p], gx, gy, cfg).uv), pyr, gxs[0], gys[0])

    n = cfg.max_features
    T_ck = jnp.broadcast_to(se3.exp(jnp.asarray([0.05, 0, 0, 0, 0, 0.0])),
                            (n, 3, 4))
    mu0 = 1.0 / jnp.maximum(z, 1e-3)
    amort("depth_filter_ms", scanned(
        lambda c, t, kuv, cuv, mu: depth_filter.observe_and_update(
            cam, cfg, t, kuv, cuv + c, mu, jnp.ones(n) * 1e-3,
            jnp.ones(n) * 10, jnp.ones(n) * 10, jnp.ones(n),
            jnp.ones(n, bool)).mu), T_ck, det.uv, det.uv, mu0)

    # ------------------------------------------------------------------
    # Full-frame accounting on a REAL evolved state (VERDICT r3 next #1a):
    # a table of the hot ops alone once summed to half the measured frame
    # time. The missing rows live below.
    # ------------------------------------------------------------------
    import bench as bench_mod
    from stereo_svo_tpu.backend import loop_closure
    from stereo_svo_tpu.engine import runner
    from stereo_svo_tpu.engine import step as step_mod

    lefts, rights, _ = bench_mod._render_sequence(cam, 100)
    run = jax.jit(lambda l, r: runner.run_sequence_scan(cfg, l, r))
    # measured full-scan frame time (median of 3 runs, as bench.py)
    _, scan_times, (st, outs) = time_runs(run, lefts, rights, runs=3)
    kf_rate = float(np.asarray(outs.kf_inserted).sum()) / lefts.shape[0]
    frame_ms = float(np.median(scan_times)) / lefts.shape[0] * 1e3

    img_l1, img_r1 = lefts[-1], rights[-1]
    pyr1, gxs1, gys1 = pyramid.build_with_gradients(img_l1, cfg.num_levels)

    # every-frame rows the r3 table omitted
    coarse = pyr1[cfg.num_levels - 1]
    amort("reloc_ms", scanned(
        lambda c, d, v, im: loop_closure.relocalize(
            d, v, im + c, cfg.loop_desc_rows, cfg.loop_desc_cols,
            n_rot=cfg.pr_rot_variants, rot_step=cfg.pr_rot_step_rad,
            rot_gate=jnp.asarray(False))[1]),
        st.mem_desc, st.mem_valid, coarse)

    T_ck = se3.compose(st.T_cw[None], st.kf_T_wk[st.kf_id])
    if cfg.epi_samples > 0:
        lv_e = cfg.epi_level
        # perturb the searched image by c: keeps the whole search inside
        # the scan (XLA hoists loop-invariant subgraphs out of while
        # loops — a `0*c` perturbation of an unused field measures zero)
        amort("epi_search_ms", scanned(
            lambda c, t, kuv, mu, s2, p, im, m: depth_filter.epipolar_search(
                cam, cfg, t, kuv, mu, s2, p, im + c, m,
                level=lv_e)[0]),
            T_ck, st.kf_uv, st.mu, st.sigma2,
            st.klt_tmpl.patches[lv_e], pyr1[lv_e], st.klt_tmpl.mask)

    if cfg.stereo_refresh_window > 0:
        def refresh(c, im_l, im_r, uv, t_ck, mu, s2, a, b, zr, m):
            z_pred = jnp.maximum(1.0 / jnp.maximum(mu, 1e-4), 0.2)
            disp_pred = cam.fx * cam.baseline / z_pred
            disp_m, _, ok_m = stereo_match.refine_disparity(
                im_l, im_r, uv + c, disp_pred,
                cfg.stereo_refresh_window, cfg.stereo_patch)
            return depth_filter.stereo_observe_and_update(
                cam, cfg, se3.inverse(t_ck), uv, disp_m, ok_m,
                mu, s2, a, b, zr, m).mu
        amort("stereo_refresh_ms", scanned(refresh),
              pyr1[0], img_r1, st.feat_uv, T_ck, st.mu, st.sigma2,
              st.a_beta, st.b_beta, st.z_range, st.klt_tmpl.mask)

    amort("rebuild_template_ms", scanned(
        lambda c, s, T: step_mod._rebuild_template(
            cfg, s, [p + c for p in pyr1], gxs1, gys1, T).tmpl.patches),
        st, st.T_cw)

    # KF-rate rows: keyframe insertion (detector+stereo+snapshot) and
    # window BA — each charged at kf_rate in the budget. Images (and for
    # BA the observation graph) are perturbed by the scan carry so XLA
    # cannot hoist the work out of the timing loop.
    def kf_insert_probe(c, s, T):
        # the returned value must depend on the image-derived outputs
        # (detection, stereo, snapshots) or XLA dead-code-eliminates the
        # entire insert (a probe returning kf_T_wk — T-only — timed an
        # empty loop)
        s2 = keyframe.insert(cfg, s, [p + c for p in pyr1], gxs1, gys1,
                             img_r1 + c, T)
        return (s2.obs_uv.sum() + s2.obs_disp.sum() + s2.kf_desc.sum()
                + s2.mu.sum() + s2.kf_thumb.sum())
    amort("kf_insert_ms", scanned(kf_insert_probe), st, st.T_cw)
    if cfg.use_ba:
        amort("window_ba_ms", scanned(
            lambda c, s: step_mod.run_window_ba(
                cfg, s._replace(obs_uv=s.obs_uv + 1e-6 * c)).kf_T_wk), st)

    # the REAL steady-state step (non-KF frames): scan the full step over
    # R repeats of one frame, carrying the state — this is the number the
    # per-op rows must sum to (minus what XLA fuses across op boundaries)
    step = step_mod.make_step(cfg)

    def step_scan(st0, l, r):
        def body(s, _):
            s, out = step(s, l, r)
            return s, out.kf_inserted
        stf, kfs = jax.lax.scan(body, st0, None, length=R)
        return stf.T_cw, jnp.sum(kfs)

    results["step_nonkf_ms"], (_, n_kf) = per_call_ms(
        jax.jit(step_scan), st, img_l1, img_r1)
    results["step_loop_kf_count"] = float(np.asarray(n_kf))   # should be 0
    results["scan_frame_ms"] = frame_ms
    results["kf_rate"] = kf_rate

    out = {k: round(v, 4) for k, v in results.items()}
    out["device"] = dev

    # budget closure
    every_frame = [k for k in ("align_ms", "klt_ms", "pyramid_ms",
                               "align_template_ms", "pose_refine_ms",
                               "depth_filter_ms", "reloc_ms",
                               "epi_search_ms", "stereo_refresh_ms",
                               "rebuild_template_ms") if k in out]
    # rebuild_template_ms supersedes align_template_ms in the per-frame
    # budget (it wraps it); count it once
    per_frame_sum = sum(out[k] for k in every_frame
                        if k != "align_template_ms")
    kf_cost = out.get("kf_insert_ms", 0.0) + out.get("window_ba_ms", 0.0)
    model_ms = out.get("step_nonkf_ms", per_frame_sum) \
        + out["kf_rate"] * kf_cost
    out["accounting"] = {
        "per_op_sum_ms": round(per_frame_sum, 4),
        "step_nonkf_ms": out.get("step_nonkf_ms"),
        "intra_frame_residual_ms": round(
            out.get("step_nonkf_ms", 0.0) - per_frame_sum, 4),
        "kf_phase_ms": round(kf_cost, 4),
        "kf_rate": out["kf_rate"],
        "model_frame_ms": round(model_ms, 4),
        "measured_frame_ms": out["scan_frame_ms"],
        "unaccounted_ms": round(out["scan_frame_ms"] - model_ms, 4),
        "kf_phase_share_of_frame": round(
            out["kf_rate"] * kf_cost / out["scan_frame_ms"], 4),
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
