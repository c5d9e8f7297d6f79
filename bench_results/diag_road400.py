#!/usr/bin/env python
"""road_long 400-frame forensics (VERDICT r4 next #2).

Judge's datum on r4 HEAD: 400 frames -> ATE 10.14 m (20.8% of travel),
tracking_ok 0.69, 36 KFs, max perr 46.8 m. This dumps the per-frame chain
to locate the break frame and mechanism. Renders the 700-frame road_long
sequence and slices its first N frames (DIAG_FRAMES, default 400), so
every N shares one trajectory.
"""
import os, sys, json
os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.getcwd())
import jax, numpy as np
import bench
from stereo_svo_tpu.config import kitti_config
from stereo_svo_tpu.engine import runner
from stereo_svo_tpu.eval import ate

N = int(os.environ.get("DIAG_FRAMES", "400"))
cfg = kitti_config()
lefts, rights, gts = bench._render_sequence(cfg.camera, 700, "road_long",
                                            "kitti", False)
lefts, rights, gts = lefts[:N], rights[:N], gts[:N]
run = jax.jit(lambda a, b: runner.run_sequence_scan(cfg, a, b))
st, outs = run(lefts, rights)
ok = np.asarray(outs.tracking_ok)
nt = np.asarray(outs.n_tracked); ns = np.asarray(outs.n_seeds)
nl = np.asarray(outs.n_landmarks); md = np.asarray(outs.median_depth)
kf = np.asarray(outs.kf_inserted); est = np.asarray(outs.T_wc)
ac = np.asarray(outs.align_cost); rr = np.asarray(outs.refine_rms_px)
sd = np.asarray(outs.n_seed_deaths)
perr = np.linalg.norm(est[:, :, 3] - gts[:, :, 3], axis=1)
# per-frame step length ratio (forward scale signal)
est_step = np.linalg.norm(np.diff(est[:, :, 3], axis=0), axis=1)
gt_step = np.linalg.norm(np.diff(gts[:, :, 3], axis=0), axis=1)
ratio = est_step / np.maximum(gt_step, 1e-9)
err = ate.ate_rmse(ate.positions(est), ate.positions(gts))
travel = float(np.sum(gt_step))
np.savez(os.path.join("bench_results", f"road{N}_dump.npz"),
         ok=ok, nt=nt, ns=ns, nl=nl, md=md, kf=kf, est=est, gts=gts,
         ac=ac, rr=rr, sd=sd)
print(json.dumps({"n": N, "ate": round(float(err), 3),
                  "travel": round(travel, 1),
                  "pct": round(100 * float(err) / travel, 2),
                  "ok": round(float(ok.mean()), 3),
                  "kfs": int(kf.sum()),
                  "max_perr": round(float(perr.max()), 2)}))
bad = np.where(~ok)[0]
print("first_bad:", bad[:15].tolist(), "n_bad:", len(bad))
kfl = np.where(kf)[0]
print("kf_frames:", kfl.tolist())
bd = np.asarray(outs.ba_diag)          # (T,7) last BA call at each frame
for f in kfl:
    if f == 0:
        continue
    dt_, dr_, dz, ci, cf, acc, nobs = bd[f]
    print(json.dumps({"kf_f": int(f), "ba_dt": round(float(dt_), 3),
                      "ba_dz_fwd": round(float(dz), 3),
                      "ba_dr": round(float(dr_), 4),
                      "cost": [round(float(ci), 1), round(float(cf), 1)],
                      "acc": int(acc), "nobs": int(nobs)}))
for f in range(0, N, 10):
    print(json.dumps({"f": f, "ok": int(ok[f]), "trk": int(nt[f]),
                      "seed": int(ns[f]), "lm": int(nl[f]),
                      "med_z": round(float(md[f]), 1),
                      "perr": round(float(perr[f]), 3),
                      "sratio": round(float(ratio[f - 1]), 3) if f else 1.0,
                      "acost": round(float(ac[f]), 1),
                      "rms": round(float(rr[f]), 2),
                      "sdeath": int(sd[f])}))
