"""End-to-end engine tests on synthetic sequences with exact ground truth
(SURVEY.md §4.2.2-3): the minimum end-to-end slice of §7.2."""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_svo_tpu.config import CameraConfig, SvoConfig
from stereo_svo_tpu.engine import runner, state as state_mod
from stereo_svo_tpu.eval import ate
from stereo_svo_tpu.geometry import se3
from stereo_svo_tpu.io import synthetic

pytestmark = pytest.mark.slow  # compile-heavy e2e tier

# Small image for CPU CI speed; bench uses full 752x480 on the GPU.
CFG = SvoConfig(
    camera=CameraConfig(fx=240.0, fy=240.0, cx=188.0, cy=120.0,
                        baseline=0.11, width=376, height=240),
    grid_rows=10, grid_cols=13, max_features=130,
    num_levels=3, align_levels=3, klt_levels=3,
    stereo_max_disp=64, kf_min_tracked=40,
    border_margin=10,
)


@pytest.fixture(scope="module")
def arc_sequence():
    return synthetic.make_sequence(CFG.camera, 30, dt=0.12, kind="arc",
                                   seed=0)


def test_bootstrap_creates_keyframe(arc_sequence):
    lefts, rights, _ = arc_sequence
    svo = runner.StereoSvo(CFG)
    out = svo.new_image(lefts[0], rights[0])
    assert bool(out.kf_inserted)
    assert int(out.n_seeds) > 60
    assert bool(jnp.any(svo.state.kf_valid))
    np.testing.assert_allclose(svo.pose, np.asarray(se3.identity()),
                               atol=1e-6)


def test_sequence_tracks_and_ate_low(arc_sequence):
    lefts, rights, gt = arc_sequence
    traj, metrics = runner.run_sequence(CFG, lefts, rights)
    assert metrics["tracking_ok"].all(), (
        f"tracking lost at frames {np.where(~metrics['tracking_ok'])[0]}")
    # every frame after bootstrap keeps a healthy tracked count
    assert metrics["n_tracked"][1:].min() > 30
    err = ate.ate_rmse(ate.positions(traj), ate.positions(gt))
    assert err < 0.02, f"ATE RMSE {err:.4f} m"
    # rotation drift sanity via RPE
    t_rpe, r_rpe = ate.rpe(traj, gt)
    assert t_rpe < 0.01 and r_rpe < 0.005


def test_keyframes_inserted_over_motion(arc_sequence):
    lefts, rights, _ = arc_sequence
    traj, metrics = runner.run_sequence(CFG, lefts, rights)
    # the arc trajectory moves ~0.9m through a ~4m scene → several KFs
    assert metrics["kf_inserted"].sum() >= 2
    # seeds converge into landmarks as the camera translates
    assert metrics["n_landmarks"][-1] > 20


def test_scan_runner_matches_python_loop(arc_sequence):
    lefts, rights, _ = arc_sequence
    lefts_j = jnp.asarray(lefts[:8])
    rights_j = jnp.asarray(rights[:8])
    traj_py, _ = runner.run_sequence(CFG, lefts[:8], rights[:8])
    _, outs = runner.run_sequence_scan(CFG, lefts_j, rights_j)
    np.testing.assert_allclose(np.asarray(outs.T_wc), traj_py,
                               rtol=1e-4, atol=1e-5)


def test_determinism(arc_sequence):
    """Same inputs → bit-identical trajectory (SURVEY.md §4.2.5)."""
    lefts, rights, _ = arc_sequence
    t1, _ = runner.run_sequence(CFG, lefts[:6], rights[:6])
    t2, _ = runner.run_sequence(CFG, lefts[:6], rights[:6])
    np.testing.assert_array_equal(t1, t2)


def test_loop_trajectory_returns_home():
    """Out-and-back trajectory: drift at return must stay small (long-run
    stability; the map is revisited with old keyframes evicted)."""
    lefts, rights, gt = synthetic.make_sequence(CFG.camera, 40, dt=0.25,
                                                kind="loop", seed=1)
    traj, metrics = runner.run_sequence(CFG, lefts, rights)
    assert metrics["tracking_ok"].mean() > 0.95
    err = ate.ate_rmse(ate.positions(traj), ate.positions(gt))
    assert err < 0.05, f"loop ATE {err:.3f} m"
    # end-point error (unaligned drift proxy)
    end_err = np.linalg.norm(traj[-1, :, 3] - gt[-1, :, 3])
    assert end_err < 0.1, f"endpoint drift {end_err:.3f} m"


def test_window_ba_guard_rejects_corrupted_observations():
    """run_window_ba must not move the map when fed garbage observations
    (the divergence guard is what keeps adversarial KF data from
    destroying tracking — regression for the observed failure mode)."""
    import jax
    from stereo_svo_tpu.engine import step as step_mod

    lefts, rights, _ = synthetic.make_sequence(CFG.camera, 8, dt=0.12,
                                               kind="arc", seed=0)
    svo = runner.StereoSvo(CFG)
    for l, r in zip(lefts, rights):
        svo.new_image(l, r)
    st = svo.state
    # corrupt every observation badly
    rng = np.random.default_rng(0)
    bad_uv = jnp.asarray(
        rng.uniform(0, CFG.camera.width, st.obs_uv.shape), jnp.float32)
    st_bad = st._replace(obs_uv=bad_uv)
    st_out = jax.jit(lambda s: step_mod.run_window_ba(CFG, s))(st_bad)
    np.testing.assert_allclose(np.asarray(st_out.kf_T_wk),
                               np.asarray(st.kf_T_wk), atol=1e-5)


def test_tracking_failure_detection_and_recovery(arc_sequence):
    """Blackout frames mid-sequence: the engine must flag failure (not
    silently emit garbage poses), keep its map, and recover once real
    frames return (SURVEY.md §5.3 failure detection / relocalization)."""
    lefts, rights, gt = arc_sequence
    svo = runner.StereoSvo(CFG)
    for i in range(6):
        svo.new_image(lefts[i], rights[i])
    assert bool(svo.state.tracking_ok)
    n_alive_before = int((np.asarray(svo.state.status) > 0).sum())

    black = np.zeros_like(lefts[0])
    for _ in range(2):
        out = svo.new_image(black, black)
    assert not bool(out.tracking_ok), "blackout must be detected"
    # the map must not be destroyed by the failed frames
    n_alive_after = int((np.asarray(svo.state.status) > 0).sum())
    assert n_alive_after >= 0.9 * n_alive_before

    # resume real frames near where tracking was lost → must re-lock
    recovered = False
    for i in range(6, 10):
        out = svo.new_image(lefts[i], rights[i])
        recovered = recovered or bool(out.tracking_ok)
    assert recovered, "tracking did not recover after blackout"


def test_blackout_poses_stay_finite_and_recovery_is_accurate():
    """Regression: a blackout late in a loop trajectory used to cascade —
    a keyframe inserted on the first (imprecisely relocalized) recovery
    frame corrupted the map, subsequent failures compounded the committed
    pose until inf/NaN poisoned the state permanently. Guards: keyframe
    probation after failure + failed-frame anchoring at the reloc
    keyframe + finite-pose check."""
    cfg = CFG
    lefts, rights, gt = synthetic.make_sequence(cfg.camera, 48, dt=0.25,
                                                kind="loop", seed=1)
    svo = runner.StereoSvo(cfg)
    black = np.zeros_like(lefts[0])
    oks = []
    for i, (l, r) in enumerate(zip(lefts, rights)):
        if 20 <= i < 23:
            l, r = black, black
        out = svo.new_image(l, r)
        oks.append(bool(out.tracking_ok))
    traj = svo.trajectory()
    assert np.isfinite(traj).all(), "poses must never go non-finite"
    assert not any(oks[20:23]), "blackout must be flagged"
    assert all(oks[24:]), f"must stay locked after recovery: {oks[23:]}"
    # accuracy after recovery: compare tail positions against GT with the
    # pre-blackout alignment (recovery must re-lock to the SAME map/frame)
    err_tail = np.linalg.norm(traj[30:, :, 3] - gt[30:, :, 3], axis=1)
    assert err_tail.max() < 0.1, err_tail.max()


def test_kf_every_quantizes_regular_insertions(arc_sequence):
    """kf_every=4: non-urgent keyframe insertions land only on frame
    indices ≡ 0 (mod 4) — the cadence that keeps the batched runner's
    any(need_kf) cond cold (VERDICT r2 weak #3: advertised, never
    exercised)."""
    import dataclasses

    lefts, rights, _ = arc_sequence
    cfg = dataclasses.replace(CFG, kf_every=4,
                              kf_dist_ratio=0.02)  # high regular pressure
    svo = runner.StereoSvo(cfg)
    for l, r in zip(lefts, rights):
        svo.new_image(l, r)
    m = svo.metrics()
    assert m["tracking_ok"].all()
    kf_frames = np.where(m["kf_inserted"])[0]
    regular = kf_frames[kf_frames > 0]          # frame 0 is the bootstrap
    assert len(regular) >= 2                    # cadence actually exercised
    assert (regular % 4 == 0).all(), kf_frames


def test_kf_every_urgent_override(arc_sequence):
    """A collapsing track must override the kf_every cadence: with
    kf_min_tracked impossibly high, every tracked frame is 'urgent' and
    keyframes appear on non-multiple frames too (engine/step.py urgent
    branch — the dead-unless-configured path VERDICT r2 weak #3 flagged)."""
    import dataclasses

    lefts, rights, _ = arc_sequence
    cfg = dataclasses.replace(CFG, kf_every=4, kf_min_tracked=1000)
    svo = runner.StereoSvo(cfg)
    for l, r in zip(lefts[:12], rights[:12]):
        svo.new_image(l, r)
    m = svo.metrics()
    kf_frames = np.where(m["kf_inserted"])[0]
    assert (kf_frames[1:] % 4 != 0).any(), kf_frames


def test_checkpoint_resume(arc_sequence, tmp_path):
    """State is one pytree: save/restore mid-sequence reproduces the run
    (SURVEY.md §5.4)."""
    from stereo_svo_tpu.utils import checkpoint

    lefts, rights, _ = arc_sequence
    svo = runner.StereoSvo(CFG)
    for i in range(4):
        svo.new_image(lefts[i], rights[i])
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, svo.state)

    # continue the original
    out_a = svo.new_image(lefts[4], rights[4])

    # resume from checkpoint in a fresh engine
    svo2 = runner.StereoSvo(CFG)
    svo2.state = checkpoint.load(path, state_mod.init_state(CFG))
    out_b = svo2.new_image(lefts[4], rights[4])

    np.testing.assert_array_equal(np.asarray(out_a.T_wc),
                                  np.asarray(out_b.T_wc))
