"""Scaled-capacity smoke test toward north-star config #3 (5-level
pyramid, large seed population) at CI scale; the full 2048-seed 752x480
variant runs on the GPU (bench.py BENCH_STRESS=1, chip_smoke.py)."""

import numpy as np

from stereo_svo_tpu.config import CameraConfig, SvoConfig, stress_config
from stereo_svo_tpu.engine import runner
from stereo_svo_tpu.io import synthetic
import pytest

pytestmark = pytest.mark.slow  # compile-heavy e2e tier


def test_stress_config_shape():
    cfg = stress_config()
    assert cfg.num_levels == 5
    assert cfg.max_features >= 2048
    assert cfg.grid_rows * cfg.grid_cols >= 2048


def test_many_seeds_five_levels_tracks():
    cfg = SvoConfig(
        camera=CameraConfig(fx=240.0, fy=240.0, cx=188.0, cy=120.0,
                            baseline=0.11, width=376, height=240),
        num_levels=5, align_levels=4, align_min_level=1,
        grid_rows=16, grid_cols=32, max_features=512,
        stereo_max_disp=48, kf_min_tracked=150, border_margin=10,
        klt_levels=3, max_keyframes=4)
    lefts, rights, gt = synthetic.make_sequence(cfg.camera, 6, dt=0.1,
                                                kind="arc", seed=2)
    traj, m = runner.run_sequence(cfg, lefts, rights)
    assert m["tracking_ok"].all()
    # large active population from the bootstrap keyframe
    assert int(m["n_seeds"][0] + m["n_landmarks"][0]) > 300
    assert m["n_tracked"][1:].min() > 150
