#!/usr/bin/env python
"""Bring-up smoke test: the stereo SVO engine's main path on NVIDIA GPUs.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py           # one GPU: device, precision, sampler,
                                   # scan, live, batched, stress, kitti
    python chip_smoke.py --four    # four GPUs of one host: the sharded
                                   # paths against one GPU, nothing else

Frames are rendered from seeds (io/synthetic) with exact ground truth, so
nothing is downloaded. Each phase prints one JSON line; a failed check
raises and the script exits non-zero. No phase is caught and skipped. The
last line of a passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Without a GPU the device phase fails and no result is printed.

Tolerances are module constants below, each with its reason. The accuracy
gates are bench.py's (``eval/ate.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from stereo_svo_tpu import compile_cache
from stereo_svo_tpu.backend import ba
from stereo_svo_tpu.config import SvoConfig, kitti_config, stress_config
from stereo_svo_tpu.engine import runner
from stereo_svo_tpu.eval import ate
from stereo_svo_tpu.geometry import camera, se3
from stereo_svo_tpu.io import synthetic
from stereo_svo_tpu.ops import interp
from stereo_svo_tpu.parallel import dist_ba, mapping, mesh as mesh_mod
from stereo_svo_tpu.utils import device
from stereo_svo_tpu.utils.profiling import time_runs

DT = 0.08                 # frame interval of bench.py's sequences (s)

# --- tolerances -----------------------------------------------------------
# Each bound sits between two readings on an H100: the engine as built
# (true f32 dots) and a control run with every precision group at DEFAULT,
# where XLA may run the dots in TF32.
# 20 compose/exp steps land within 1.4e-7 of float64 either way: XLA
# does not put 3x3 dots on the tensor cores, so this bound guards the
# algebra, and the HLO test (tests/test_chip_smoke.py) guards the pin.
CHAIN_POSE_ATOL = 1e-5
CHAIN_PX_ATOL = 5e-3      # f32 1.2e-4 px, TF32 0.31 px at fx = 458
# GPU vs CPU render of one 752x480 pair, in intensity units (0..255). Both
# evaluate the same f32 ray cast; sin/cos and FMA contraction differ in
# the last bits, and the texture's sines take arguments up to ~1e4 rad.
RENDER_MEAN_ATOL = 3e-3   # f32 5.9e-5, TF32 0.144
RENDER_P999_ATOL = 3e-2   # f32 6.3e-4, TF32 1.73
# f32 bilinear of [0, 255] intensities: a few ulp of 255 (~1e-4); the
# retired tent-matmul sampler was held to 2e-3.
SAMPLER_ATOL = 1e-3
# Pose agreement of two runs of the same frames that differ only in
# floating-point order: GPU vs CPU device over the first 10 frames (f32
# 1.2e-6 m / 1.9e-7 rad, TF32 1.5e-3 m / 2.3e-4 rad) and new_image vs the
# scan (bitwise equal). A thresholded decision (KLT convergence, ZNCC
# gates) that flips on float noise moves a pose by mm, so this fails on a
# flip, not only on a precision loss.
POSE_AGREE_M = 5e-5
POSE_AGREE_RAD = 5e-6
# The data-sharded batched step (4 KITTI road sequences x 40 frames)
# against the same step at B=4 on one device. Each device of the sharded
# run executes the B=1 program; batch size changes XLA's fusion and
# reduction order, and thresholded decisions (KLT convergence, ZNCC gates)
# flip on that noise. On one H100, B=4 against each sequence at B=1 reads
# 1.4e-6 m at 3 frames, 1.6 mm at 10, 4.31 mm at 40 (the sharded run's
# reading, to its last digit) and 5.9 mm at 80: the bound holds for this
# fixed length only.
SHARD_AGREE_M = 5e-3
SHARD_AGREE_RAD = 5e-3
# Sharded window BA against one device: identical math up to the psum's
# reduction order (tests/test_backend.py holds the CPU mesh to the same).
BA_POSE_RTOL, BA_POSE_ATOL = 1e-4, 1e-5
BA_X_RTOL, BA_X_ATOL = 1e-3, 1e-4
# Global map after pose graph + sharded BA, driving scale (points 5-60 m).
MAP_POSE_ATOL = 1e-3
MAP_X_ATOL = 1e-2


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# --- helpers ----------------------------------------------------------------
def exp64(xi: np.ndarray) -> np.ndarray:
    """float64 se(3) exp, independent of geometry/se3.py."""
    v, w = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-9:
        A, B, C = 1.0, 0.5, 1.0 / 6.0
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th ** 2
        C = (th - np.sin(th)) / th ** 3
    R = np.eye(3) + A * W + B * W @ W
    V = np.eye(3) + B * W + C * W @ W
    return np.concatenate([R, (V @ v)[:, None]], 1)


def compose64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [a[:, :3] @ b[:, :3], (a[:, :3] @ b[:, 3] + a[:, 3])[:, None]], 1)


def bilinear64(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """float64 clamp-to-edge bilinear sample of img at uv (..., 2)."""
    H, W = img.shape
    u = np.clip(uv[..., 0], 0.0, W - 1.000001)
    v = np.clip(uv[..., 1], 0.0, H - 1.000001)
    u0, v0 = np.floor(u), np.floor(v)
    du, dv = u - u0, v - v0
    iu0, iv0 = u0.astype(int), v0.astype(int)
    iu1, iv1 = np.minimum(iu0 + 1, W - 1), np.minimum(iv0 + 1, H - 1)
    return (img[iv0, iu0] * (1 - du) * (1 - dv)
            + img[iv0, iu1] * du * (1 - dv)
            + img[iv1, iu0] * (1 - du) * dv + img[iv1, iu1] * du * dv)


def render(cam, n_frames, scene="planes", traj="arc", seed=0):
    """Device-staged (lefts, rights) and host ground truth (N,3,4)."""
    l, r, g = synthetic.make_sequence(cam, n_frames, dt=DT, kind=traj,
                                      seed=seed, scene_kind=scene)
    return jnp.asarray(l), jnp.asarray(r), g


def pose_gaps(A: np.ndarray, B: np.ndarray):
    """(max translation gap m, max rotation gap rad) of two (T,3,4) runs."""
    dt = np.linalg.norm(A[:, :, 3] - B[:, :, 3], axis=-1)
    R = np.einsum("tji,tjk->tik", A[:, :, :3], B[:, :, :3])
    # angle from the skew part (sin θ = |vee(R - Rᵀ)| / 2): well
    # conditioned at the small angles compared here, unlike arccos(trace)
    vee = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                    R[:, 1, 0] - R[:, 0, 1]], -1)
    dr = np.arcsin(np.clip(0.5 * np.linalg.norm(vee, axis=-1), 0.0, 1.0))
    return float(dt.max()), float(dr.max())


def gates(est_T, gt_T, tracking, ate_gate, what):
    err = ate.ate_rmse(ate.positions(est_T), ate.positions(gt_T))
    fails = ate.gate_failures(err, tracking, ate_gate)
    check(not fails, f"{what}: " + "; ".join(fails))
    return float(err)


def memory_fields(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {k: getattr(ma, k, None) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def compile_and_time(fn, *args, runs=3):
    """(compiled, compile s, warm s median, outputs) of jit(fn)(*args);
    compiled ahead of time so its memory analysis can be read."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    _, times, out = time_runs(compiled, *args, runs=runs)
    return compiled, compile_s, float(np.median(times)), out


# --- phases -----------------------------------------------------------------
def phase_device(count: int = 1) -> dict:
    """Refuse anything but a GPU; record the card and the build."""
    info = device.require_gpu()
    check(info["count"] >= count,
          f"needs {count} GPUs, JAX found {info['count']}")
    cache = compile_cache.enable()
    print(info["nvidia_smi"], flush=True)
    emit("device", platform=info["platform"], kind=info["kind"],
         count=info["count"], nvidia_smi=info["nvidia_smi"],
         jax=jax.__version__, xla_flags=os.environ.get("XLA_FLAGS"),
         compile_cache=cache or os.environ.get("JAX_COMPILATION_CACHE_DIR"))
    return info


def se3_chain_errors(cam, n_steps: int = 20, n_points: int = 192,
                     seed: int = 0) -> dict:
    """A compose∘exp chain, transform and project against float64."""
    rng = np.random.default_rng(seed)
    xis = np.concatenate([rng.uniform(-0.2, 0.2, (n_steps, 3)),
                          rng.uniform(-0.1, 0.1, (n_steps, 3))],
                         1).astype(np.float32)

    def chain(xis):
        T = se3.identity()
        for k in range(n_steps):
            T = se3.compose(T, se3.exp(xis[k]))
        return T

    T = np.asarray(jax.jit(chain)(jnp.asarray(xis)), np.float64)
    T64 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    for xi in xis.astype(np.float64):
        T64 = compose64(T64, exp64(xi))
    # points in front of the final camera, given in the world frame
    Xc = np.stack([rng.uniform(-3, 3, n_points), rng.uniform(-2, 2, n_points),
                   rng.uniform(2, 10, n_points)], -1)
    Xw = ((Xc - T64[:, 3]) @ T64[:, :3]).astype(np.float32)
    uv = np.asarray(jax.jit(
        lambda T, X: camera.project(cam, se3.transform(T, X))[0])(
            jnp.asarray(T, jnp.float32), jnp.asarray(Xw)), np.float64)
    xc64 = Xw.astype(np.float64) @ T64[:, :3].T + T64[:, 3]
    uv64 = np.stack([cam.fx * xc64[:, 0] / xc64[:, 2] + cam.cx,
                     cam.fy * xc64[:, 1] / xc64[:, 2] + cam.cy], -1)
    return {"pose_maxerr": float(np.abs(T - T64).max()),
            "px_maxerr": float(np.abs(uv - uv64).max())}


def render_errors(cam, ref_device, seed: int = 0) -> dict:
    """One stereo pair rendered on the default device vs ``ref_device``."""
    T = synthetic.trajectory_pose(jnp.float32(1.0), "arc")
    scene = synthetic.get_scene("planes", seed)
    out = jax.jit(lambda T: synthetic.render_stereo(cam, T, scene))(T)
    with jax.default_device(ref_device):
        scene_r = synthetic.get_scene("planes", seed)
        ref = jax.jit(lambda T: synthetic.render_stereo(cam, T, scene_r))(
            jax.device_put(T, ref_device))
    check(ref[0].devices() == {ref_device}, "reference render left its device")
    d = np.abs(np.concatenate([np.asarray(a, np.float64).ravel()
                               for a in out])
               - np.concatenate([np.asarray(b, np.float64).ravel()
                                 for b in ref]))
    return {"mean_absdiff": float(d.mean()),
            "p999_absdiff": float(np.percentile(d, 99.9)),
            "max_absdiff": float(d.max()),
            "frac_over_1": float(np.mean(d > 1.0))}


def phase_precision(cam) -> None:
    chain = se3_chain_errors(cam)
    check(chain["pose_maxerr"] <= CHAIN_POSE_ATOL,
          f"SE3 chain off f64 by {chain['pose_maxerr']:.3g}")
    check(chain["px_maxerr"] <= CHAIN_PX_ATOL,
          f"projection off f64 by {chain['px_maxerr']:.3g} px")
    rend = render_errors(cam, jax.devices("cpu")[0])
    check(rend["mean_absdiff"] <= RENDER_MEAN_ATOL,
          f"render GPU vs CPU mean |d| {rend['mean_absdiff']:.3g}")
    check(rend["p999_absdiff"] <= RENDER_P999_ATOL,
          f"render GPU vs CPU p99.9 |d| {rend['p999_absdiff']:.3g}")
    emit("precision", se3_chain=chain, render_vs_cpu=rend,
         tolerances={"pose": CHAIN_POSE_ATOL, "px": CHAIN_PX_ATOL,
                     "render_mean": RENDER_MEAN_ATOL,
                     "render_p999": RENDER_P999_ATOL})


def sampler_errors(img: jnp.ndarray, cases, seed: int = 0) -> list:
    """interp.sample_patch against a float64 bilinear, per (N, P) case."""
    H, W = img.shape
    img64 = np.asarray(img, np.float64)
    rng = np.random.default_rng(seed)
    rows = []
    for N, P in cases:
        uv = jnp.asarray(np.stack([rng.uniform(2, W - 2, N),
                                   rng.uniform(2, H - 2, N)], -1),
                         jnp.float32)
        got = np.asarray(jax.jit(
            lambda i, u: interp.sample_patch(i, u, P))(img, uv), np.float64)
        offs = np.asarray(interp.patch_coords(P), np.float64)
        want = bilinear64(img64, np.asarray(uv, np.float64)[:, None] + offs)
        rows.append({"N": N, "P": P,
                     "maxerr": float(np.abs(got - want).max())})
    return rows


def phase_sampler(img) -> None:
    rows = sampler_errors(img, ((192, 4), (192, 8), (2048, 8)))
    for r in rows:
        check(r["maxerr"] <= SAMPLER_ATOL,
              f"sampler N={r['N']} P={r['P']} off f64 by {r['maxerr']:.3g}")
    emit("sampler", cases=rows, atol=SAMPLER_ATOL)


def run_scan(cfg, lefts, rights, gt, what, ate_gate=ate.ATE_GATE_M):
    """Compile, time and gate ``run_sequence_scan``; returns outputs."""
    compiled, compile_s, warm_s, (_, outs) = compile_and_time(
        lambda l, r: runner.run_sequence_scan(cfg, l, r), lefts, rights)
    est = np.asarray(outs.T_wc)
    tracking = float(np.asarray(outs.tracking_ok).mean())
    err = gates(est, gt, tracking, ate_gate, what)
    n = lefts.shape[0]
    fields = {"frames": n, "ate_m": err, "ate_gate_m": ate_gate,
              "tracking": tracking,
              "keyframes": int(np.asarray(outs.kf_inserted).sum()),
              "compile_s": round(compile_s, 3), "warm_s": round(warm_s, 6),
              "fps": round(n / warm_s, 2), "memory": memory_fields(compiled)}
    return outs, fields


def phase_scan(cfg, lefts, rights, gt, n_cpu: int = 10):
    outs, fields = run_scan(cfg, lefts, rights, gt, "scan")
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        _, outs_c = jax.jit(lambda l, r: runner.run_sequence_scan(cfg, l, r))(
            jax.device_put(lefts[:n_cpu], cpu),
            jax.device_put(rights[:n_cpu], cpu))
        est_c = np.asarray(outs_c.T_wc, np.float64)
    dt, dr = pose_gaps(np.asarray(outs.T_wc[:n_cpu], np.float64), est_c)
    check(dt <= POSE_AGREE_M and dr <= POSE_AGREE_RAD,
          f"scan GPU vs CPU first {n_cpu} poses differ by {dt:.3g} m / "
          f"{dr:.3g} rad")
    fields["vs_cpu"] = {"frames": n_cpu, "max_dt_m": dt, "max_dr_rad": dr,
                        "cpu_s": round(time.perf_counter() - t0, 2)}
    emit("scan", **fields)
    return outs


def phase_live(cfg, lefts, rights, scan_T, n: int = 20) -> None:
    svo = runner.StereoSvo(cfg)
    t0 = time.perf_counter()
    svo.new_image(lefts[0], rights[0])
    first_s = time.perf_counter() - t0
    lat = []
    for i in range(1, n):
        t0 = time.perf_counter()
        out = svo.new_image(lefts[i], rights[i])
        jax.block_until_ready(out.T_wc)
        lat.append(time.perf_counter() - t0)
    dt, dr = pose_gaps(svo.trajectory().astype(np.float64),
                       np.asarray(scan_T[:n], np.float64))
    check(dt <= POSE_AGREE_M and dr <= POSE_AGREE_RAD,
          f"new_image vs scan poses differ by {dt:.3g} m / {dr:.3g} rad")
    emit("live", frames=n, max_dt_m=dt, max_dr_rad=dr,
         first_call_s=round(first_s, 3),
         latency_p50_ms=round(float(np.percentile(lat, 50)) * 1e3, 3))


def phase_batched(cfg, batch: int = 8, n_frames: int = 25) -> None:
    seqs = [render(cfg.camera, n_frames, seed=b) for b in range(batch)]
    lefts = jnp.stack([s[0] for s in seqs])
    rights = jnp.stack([s[1] for s in seqs])
    gt = seqs[0][2]                   # one trajectory, `batch` scenes
    compiled, compile_s, warm_s, (_, outs) = compile_and_time(
        lambda l, r: runner.run_sequence_batched(cfg, l, r), lefts, rights)
    est = np.asarray(outs.T_wc)
    trk = np.asarray(outs.tracking_ok).mean(axis=1)
    errs = [gates(est[b], gt, float(trk[b]), ate.ATE_GATE_M,
                  f"batched seq {b}")
            for b in range(batch)]
    emit("batched", batch=batch, frames=n_frames, ate_m=errs,
         tracking=[float(t) for t in trk], compile_s=round(compile_s, 3),
         warm_s=round(warm_s, 6),
         fps=round(batch * n_frames / warm_s, 2),
         memory=memory_fields(compiled))


def phase_config(name, cfg, lefts, rights, gt) -> None:
    travel = ate.travel(gt)
    gate = (ate.ATE_GATE_M if name == "stress"
            else ate.driving_ate_gate(travel))
    _, fields = run_scan(cfg, lefts, rights, gt, name, ate_gate=gate)
    emit(name, travel_m=round(travel, 3), **fields)


def main_one() -> dict:
    t_start = time.perf_counter()
    info = phase_device(1)
    cfg = SvoConfig()
    phase_precision(cfg.camera)
    lefts, rights, gt = render(cfg.camera, 100)
    phase_sampler(lefts[0])
    outs = phase_scan(cfg, lefts, rights, gt)
    phase_live(cfg, lefts, rights, np.asarray(outs.T_wc))
    phase_batched(cfg)
    phase_config("stress", stress_config(), lefts, rights, gt)
    kcfg = kitti_config()
    kl, kr, kg = render(kcfg.camera, 100, scene="road", traj="kitti")
    phase_config("kitti", kcfg, kl, kr, kg)
    emit("summary", total_s=round(time.perf_counter() - t_start, 1))
    return info


# --- four GPUs ----------------------------------------------------------------
def ba_problem(cam, K: int, N: int, seed: int = 0):
    """Stereo window-BA problem with exact observations and perturbed
    initial poses/points (the tests' construction at engine width)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2, 8, N)
    uv0 = np.stack([rng.uniform(30, cam.width - 30, N),
                    rng.uniform(30, cam.height - 30, N)], -1)
    X = np.asarray(camera.backproject(cam, jnp.asarray(uv0, jnp.float32),
                                      jnp.asarray(z, jnp.float32)))
    T_wk = np.stack([exp64(np.array([0.04 * k, 0.01 * k, 0.03 * k,
                                     0.0, 0.008 * k, 0.003 * k]))
                     for k in range(K)]).astype(np.float32)
    obs = np.zeros((K, N, 2), np.float32)
    disp = np.zeros((K, N), np.float32)
    mask = np.zeros((K, N), bool)
    for k in range(K):
        R, t = T_wk[k, :, :3].astype(np.float64), T_wk[k, :, 3]
        xc = (X - t) @ R
        uv = np.stack([cam.fx * xc[:, 0] / xc[:, 2] + cam.cx,
                       cam.fy * xc[:, 1] / xc[:, 2] + cam.cy], -1)
        obs[k] = uv
        disp[k] = cam.fx * cam.baseline / xc[:, 2]
        mask[k] = ((xc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < cam.width)
                   & (uv[:, 1] > 0) & (uv[:, 1] < cam.height))
    T_init = np.stack([T_wk[0]] + [
        compose64(exp64(rng.normal(0, 0.01, 6)), T_wk[k]).astype(np.float32)
        for k in range(1, K)])
    X_init = (X + rng.normal(0, 0.02, X.shape)).astype(np.float32)
    return tuple(jnp.asarray(a) for a in
                 (T_init, X_init, obs, mask, disp))


def four_ba(cam, n_dev: int, K: int, N: int) -> dict:
    cfg = SvoConfig(camera=cam, max_keyframes=K)
    T0, X0, obs, mask, disp = ba_problem(cam, K, N)
    ones_k, ones_n = jnp.ones(K, bool), jnp.ones(N, bool)
    T_ref, X_ref, _ = jax.jit(lambda *a: ba.bundle_adjust(cam, cfg, *a))(
        T0, ones_k, X0, ones_n, obs, mask, disp, mask)
    mesh = mesh_mod.make(n_dev, axis_name="kf")
    T_d, X_d = dist_ba.bundle_adjust_sharded(
        mesh, cam, cfg, T0, ones_k, X0, ones_n, obs, mask, disp, mask)
    T_ref, X_ref = np.asarray(T_ref), np.asarray(X_ref)
    T_d, X_d = np.asarray(T_d), np.asarray(X_d)
    check(np.allclose(T_d, T_ref, rtol=BA_POSE_RTOL, atol=BA_POSE_ATOL),
          f"sharded BA poses off by {np.abs(T_d - T_ref).max():.3g}")
    check(np.allclose(X_d, X_ref, rtol=BA_X_RTOL, atol=BA_X_ATOL),
          f"sharded BA points off by {np.abs(X_d - X_ref).max():.3g}")
    return {"K": K, "N": N, "pose_maxdiff": float(np.abs(T_d - T_ref).max()),
            "point_maxdiff": float(np.abs(X_d - X_ref).max())}


def four_batched(cfg, n_dev: int, n_frames: int, scene: str, traj: str):
    """The batched step sharded over ``data`` (one sequence per device)
    against the same step on one device; returns the sharded states."""
    import __graft_entry__ as graft

    seqs = [render(cfg.camera, n_frames, scene=scene, traj=traj, seed=b)
            for b in range(n_dev)]
    lefts = jnp.stack([s[0] for s in seqs])
    rights = jnp.stack([s[1] for s in seqs])
    t0 = time.perf_counter()
    states, outs = graft.dryrun_multichip(n_dev, cfg=cfg,
                                          frames=(lefts, rights))
    sharded_s = time.perf_counter() - t0
    dev0 = jax.devices()[0]
    _, outs_1 = graft.run_batched_steps(
        cfg, jax.device_put(lefts, dev0), jax.device_put(rights, dev0))
    dt, dr = pose_gaps(np.asarray(outs.T_wc, np.float64).reshape(-1, 3, 4),
                       np.asarray(outs_1.T_wc, np.float64).reshape(-1, 3, 4))
    check(dt <= SHARD_AGREE_M and dr <= SHARD_AGREE_RAD,
          f"data-sharded batched step vs one device: {dt:.3g} m / "
          f"{dr:.3g} rad")
    return states, {"batch": n_dev, "frames": n_frames, "max_dt_m": dt,
                    "max_dr_rad": dr, "sharded_s": round(sharded_s, 2)}


def four_mapping(cfg, states, n_dev: int) -> dict:
    gmap = mapping.build_global_map(cfg, states)
    out = {}
    for n in (n_dev, 1):
        mesh = mesh_mod.make(n, axis_name="kf")
        refined, pg_cost = mapping.optimize_global_map(
            mesh, cfg.camera, cfg, gmap)
        out[n] = (np.asarray(refined.kf_T_wk), np.asarray(refined.X),
                  float(pg_cost))
    valid = np.asarray(gmap.kf_valid)
    live = np.asarray(gmap.X_mask)
    dT = float(np.abs(out[n_dev][0] - out[1][0])[valid].max())
    dX = float(np.abs(out[n_dev][1] - out[1][1])[live].max()) \
        if live.any() else 0.0
    check(np.isfinite(out[n_dev][0]).all(), "sharded map poses not finite")
    check(dT <= MAP_POSE_ATOL, f"sharded map poses off by {dT:.3g}")
    check(dX <= MAP_X_ATOL, f"sharded map points off by {dX:.3g}")
    return {"sequences": len(states), "keyframes": int(valid.sum()),
            "landmarks": int(live.sum()), "pose_maxdiff": dT,
            "point_maxdiff": dX, "pg_cost": out[n_dev][2]}


def run_four(n_dev: int = 4, cfg=None, n_frames: int = 40,
             scene: str = "road", traj: str = "kitti") -> None:
    """The sharded paths on ``n_dev`` devices against one device."""
    cfg = kitti_config() if cfg is None else cfg
    emit("four_ba", **four_ba(cfg.camera, n_dev, K=10, N=48 * n_dev))
    states, fields = four_batched(cfg, n_dev, n_frames, scene, traj)
    emit("four_batched", **fields)
    # three road sequences' maps, uncommitted so either mesh can take them
    per_seq = [jax.tree.map(lambda x: jnp.asarray(np.asarray(x[b])), states)
               for b in range(3)]
    emit("four_mapping", **four_mapping(cfg, per_seq, n_dev))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU sharded paths")
    args = p.parse_args(argv)
    if args.four:
        t0 = time.perf_counter()
        info = phase_device(4)
        run_four(4)
        emit("summary", total_s=round(time.perf_counter() - t0, 1))
    else:
        info = main_one()
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
