"""CPU checks of what chip_smoke.py and the GPU bring-up rely on: the
device refusal, the compile-cache helper, the matmul precision carried in
the lowered HLO, the smoke phases' reference comparisons at tiny size, the
stereo window extraction, and the --four comparisons on the CPU mesh.
The phases themselves run at full width on the card (``python
chip_smoke.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from stereo_svo_tpu import compile_cache
from stereo_svo_tpu.config import CameraConfig, SvoConfig
from stereo_svo_tpu.geometry import se3
from stereo_svo_tpu.io import synthetic
from stereo_svo_tpu.ops import align, stereo_match

CAM = CameraConfig(fx=160.0, fy=160.0, cx=94.0, cy=60.0, baseline=0.11,
                   width=188, height=120)


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.phase_device()


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_set_sets_nothing(monkeypatch, tmp_path,
                                            restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable(backend="gpu") is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".xla_cache")
    assert compile_cache.enable(backend="gpu") == want
    assert jax.config.jax_compilation_cache_dir == want


def test_compile_cache_off_on_cpu(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() is None        # the resolved backend
    assert jax.config.jax_compilation_cache_dir == before


def _dots(fn, *args):
    txt = jax.jit(fn).lower(*args).as_text()
    return [ln for ln in txt.splitlines() if "dot_general" in ln]


def _align_args():
    cfg = SvoConfig(camera=CAM, num_levels=3, align_levels=3,
                    align_iters_per_level=(2, 2, 3), max_features=24)
    L, N, P2 = 3, cfg.max_features, cfg.align_patch ** 2
    levels = [jnp.zeros((CAM.height >> k, CAM.width >> k), jnp.float32)
              for k in range(cfg.num_levels)]
    tmpl = align.Template(p_ref=jnp.ones((N, 3)),
                          patches=jnp.zeros((L, N, P2)),
                          jac=jnp.zeros((L, N, P2, 6)),
                          mask=jnp.ones(N, bool))
    return cfg, levels, tmpl


@pytest.mark.parametrize("which", ["se3_compose", "align_gn"])
def test_lowered_dots_carry_true_f32(which):
    """Every dot in these paths is pinned to HIGHEST (true f32), so the GPU
    backend cannot run it in TF32."""
    if which == "se3_compose":
        T = se3.exp(jnp.asarray([0.1, 0.0, 0.2, 0.01, 0.02, 0.03]))
        dots = _dots(se3.compose, T, T)
    else:
        cfg, levels, tmpl = _align_args()
        dots = _dots(lambda lv, t: align.align(lv, t, CAM, cfg,
                                               se3.identity())[0],
                     levels, tmpl)
    assert dots
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln


def test_se3_chain_phase_within_tolerance():
    err = chip_smoke.se3_chain_errors(CAM, n_steps=20, n_points=32)
    assert err["pose_maxerr"] <= chip_smoke.CHAIN_POSE_ATOL
    assert err["px_maxerr"] <= chip_smoke.CHAIN_PX_ATOL


def test_render_phase_same_device_is_exact():
    err = chip_smoke.render_errors(
        CameraConfig(fx=40.0, fy=40.0, cx=24.0, cy=16.0, baseline=0.11,
                     width=48, height=32), jax.devices("cpu")[0])
    assert err["max_absdiff"] == 0.0


def test_sampler_phase_within_tolerance():
    img = synthetic.render_view(CAM, se3.identity(),
                                synthetic.default_scene(0))
    rows = chip_smoke.sampler_errors(img, ((16, 4), (16, 8)))
    assert [(r["N"], r["P"]) for r in rows] == [(16, 4), (16, 8)]
    for r in rows:
        assert r["maxerr"] <= chip_smoke.SAMPLER_ATOL


def test_pose_gaps_small_rotation():
    """The rotation gap stays exact at the sub-mrad angles it compares."""
    A = np.stack([np.asarray(se3.exp(jnp.zeros(6)), np.float64)])
    B = np.stack([chip_smoke.exp64(np.array([0.002, 0, 0, 0, 0, 3e-4]))])
    dt, dr = chip_smoke.pose_gaps(A, B)
    assert abs(dt - 0.002) < 1e-9 and abs(dr - 3e-4) < 1e-7


@pytest.mark.parametrize("D,P", [(24, 8), (9, 4)])
def test_stereo_windows_match_onehot_reference(D, P):
    """Index-gather window extraction == the one-hot selector einsum it
    replaced (wins[n,d,p,q] = strip[n,p,start_d+q])."""
    rng = np.random.default_rng(D)
    N, C = 16, D + P - 1
    strip = jnp.asarray(rng.uniform(0, 255, (N, P, C)), jnp.float32)
    starts = jnp.arange(D - 1, -1, -1)
    cols = starts[:, None] + jnp.arange(P)[None, :]
    onehot = (jnp.arange(C)[None, None, :] == cols[..., None]
              ).astype(jnp.float32)
    want = jnp.einsum("npc,dqc->ndpq", strip, onehot,
                      precision=jax.lax.Precision.HIGHEST)
    got = jnp.moveaxis(strip[:, :, cols], 2, 1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # and the matcher built on it finds a pure horizontal shift (to the
    # integer: the sub-pixel parabola on white noise is asymmetric)
    L = jnp.asarray(rng.uniform(0, 255, (48, 96)), jnp.float32)
    R = jnp.roll(L, -5, axis=1)
    uv = jnp.asarray(np.stack([rng.uniform(40, 80, 8),
                               rng.uniform(10, 38, 8)], -1), jnp.float32)
    disp, _, valid = stereo_match.match(L, R, uv, D, P)
    assert bool(jnp.all(valid))
    np.testing.assert_array_equal(np.round(np.asarray(disp)), 5.0)


def test_four_ba_phase_on_cpu_mesh():
    """The --four BA comparison, on 4 of the 8 virtual CPU devices."""
    out = chip_smoke.four_ba(CAM, n_dev=4, K=4, N=32)
    assert out["pose_maxdiff"] <= 1e-4


def test_four_batched_phase_on_cpu_mesh():
    """The --four data-sharded comparison, on 4 of the 8 virtual CPU
    devices, before a decision can flip: float noise only."""
    import __graft_entry__ as graft

    _, out = chip_smoke.four_batched(graft._tiny_cfg(), n_dev=4, n_frames=3,
                                     scene="planes", traj="arc")
    assert (out["batch"], out["frames"]) == (4, 3)
    assert out["max_dt_m"] <= 1e-4 and out["max_dr_rad"] <= 1e-4


@pytest.mark.gpu
def test_precision_and_sampler_phases_on_gpu(gpu_device):
    """The card-side precision and sampler phases at full width."""
    cam = SvoConfig().camera
    with jax.default_device(gpu_device):
        chip_smoke.phase_precision(cam)
        img = synthetic.render_view(cam, se3.identity(),
                                    synthetic.default_scene(0))
        chip_smoke.phase_sampler(img)
