"""Batched rectified-stereo epipolar matching (left→right, 1-D ZNCC search).

Reference parity: DepthCalculator's per-keypoint SSD scan along the
epipolar line within ``search_x`` (src/lib/depth_calculator.*
[UNVERIFIED — SURVEY.md §0]; SURVEY.md §3.2). The reference loops per
keypoint per disparity; here the whole frame's matching is one batched
computation: per feature we bilinearly sample a single (P, D+P-1) strip of
the right image (all D candidate windows share fractional offsets, so one
strip covers every disparity), extract the D sliding windows from it, and
score all of them with ZNCC in one einsum — no per-feature control flow.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..precision import MATCHING
from . import interp


def _normalize(p: jnp.ndarray) -> jnp.ndarray:
    """Zero-mean, unit-norm over the last axis (ZNCC normalization)."""
    p = p - jnp.mean(p, axis=-1, keepdims=True)
    n = jnp.sqrt(jnp.sum(p * p, axis=-1, keepdims=True))
    return p / jnp.maximum(n, 1e-6)


def _search_1d(ref_n: jnp.ndarray, img: jnp.ndarray, uv0: jnp.ndarray,
               D: int, P: int, direction: float):
    """Core 1-D scanline search: score D windows starting at uv0 and
    stepping ``direction`` (−1 = leftward in the target image, +1 =
    rightward), sub-pixel peak. Returns (disp, best_score, s0, s2,
    interior)."""
    half = (P - 1) / 2.0
    C = D + P - 1
    if direction < 0:
        # columns u − (D−1) − half … u + half; window for disparity d
        # starts at column index (D−1−d)
        col_off = jnp.arange(C, dtype=img.dtype) - (D - 1) - half
        starts = jnp.arange(D - 1, -1, -1)
    else:
        # columns u − half … u + (D−1) + half; window d starts at d
        col_off = jnp.arange(C, dtype=img.dtype) - half
        starts = jnp.arange(D)
    row_off = jnp.arange(P, dtype=img.dtype) - half
    strip = interp.sample_rect(img, uv0, row_off, col_off)   # (N,P,C)
    N = uv0.shape[0]
    # All D sliding windows in ONE index gather —
    # wins[n,d,p,q] = strip[n,p,start_d+q]. One HLO op whatever D is
    # (stacking D static slices unrolled O(D) ops per search direction
    # and blew up compile time at D=128 with the LR check), and exact:
    # it moves intensities instead of multiplying them by one-hot
    # selectors, which at TF32 shifted disparities by up to 0.014 px.
    cols = starts[:, None] + jnp.arange(P)[None, :]          # (D,P)
    wins = jnp.moveaxis(strip[:, :, cols], 2, 1)             # (N,D,P,P)
    wins_n = _normalize(wins.reshape(N, D, P * P))
    scores = jnp.einsum("np,ndp->nd", ref_n, wins_n,
                        precision=MATCHING)                  # (N,D)

    best = jnp.argmax(scores, axis=1)
    best_score = jnp.take_along_axis(scores, best[:, None], axis=1)[:, 0]
    bm1 = jnp.clip(best - 1, 0, D - 1)
    bp1 = jnp.clip(best + 1, 0, D - 1)
    s0 = jnp.take_along_axis(scores, bm1[:, None], axis=1)[:, 0]
    s2 = jnp.take_along_axis(scores, bp1[:, None], axis=1)[:, 0]
    denom = s0 - 2.0 * best_score + s2
    offset = jnp.where(jnp.abs(denom) > 1e-6,
                       0.5 * (s0 - s2) / jnp.where(jnp.abs(denom) > 1e-6,
                                                   denom, 1.0),
                       0.0)
    offset = jnp.clip(offset, -0.5, 0.5)
    disp = best.astype(img.dtype) + offset
    interior = (best > 0) & (best < D - 1)
    return disp, best_score, s0, s2, interior


def match(left: jnp.ndarray, right: jnp.ndarray, uv: jnp.ndarray,
          max_disp: int, patch: int, min_zncc: float = 0.5,
          lr_check_px: float = 1.0, prominence: float = 0.005):
    """Match features left→right along rectified scanlines.

    Args:
      left, right: (H, W) rectified intensity images (same level).
      uv: (N, 2) feature positions in the left image.
      max_disp: disparity search range [0, max_disp).
      patch: ZNCC window size P.
      min_zncc: acceptance threshold on the best normalized correlation.
      lr_check_px: left-right consistency — re-match the winning right-
        image window back into the left image and require the round trip
        to land within this many px (0 disables). The classic gross-
        outlier killer: occlusions and repeated texture rarely round-trip
        (measured on the deep road scene: ZNCC-passing outliers with
        +11 px mean disparity error seeded the KITTI-geometry forward-
        scale runaway, 9778a94:BASELINE.md r3).
      prominence: reject flat correlation ridges (low-frequency texture
        along the scanline localizes arbitrarily): require
        best − (s₋+s₊)/2 above this.

    Returns:
      disp: (N,) sub-pixel disparity (garbage where invalid).
      zncc: (N,) best correlation score.
      valid: (N,) bool — all gates passed.
    """
    N = uv.shape[0]
    D = max_disp
    P = patch

    ref = interp.sample_patch(left, uv, P).reshape(N, P * P)
    ref_n = _normalize(ref)
    disp, best_score, s0, s2, interior = _search_1d(ref_n, right, uv, D, P,
                                                    direction=-1.0)
    valid = (best_score > min_zncc) & interior
    if prominence > 0.0:
        valid &= best_score - 0.5 * (s0 + s2) > prominence
    if lr_check_px > 0.0:
        uv_r = jnp.stack([uv[:, 0] - disp, uv[:, 1]], axis=-1)
        ref_r = interp.sample_patch(right, uv_r, P).reshape(N, P * P)
        disp_rl, score_rl, _, _, interior_rl = _search_1d(
            _normalize(ref_r), left, uv_r, D, P, direction=+1.0)
        valid &= interior_rl & (jnp.abs(disp_rl - disp) <= lr_check_px)
    return disp, best_score, valid


def refine_disparity(left: jnp.ndarray, right: jnp.ndarray,
                     uv: jnp.ndarray, disp_pred: jnp.ndarray,
                     window: int, patch: int, min_zncc: float = 0.6):
    """Narrow stereo re-measurement around a predicted disparity.

    The scale anchor of the per-frame seed update (engine/step.py): a
    stereo rig measures depth EVERY frame, not only at keyframe creation —
    searching only disp_pred ± window (typically ±4 px, vs the full
    max_disp range) makes the per-frame cost a small constant. Measured
    need: without per-frame stereo reobservation the depth filter's
    motion-triangulation observations follow pose-scale drift and outvote
    the accurate stereo seed (KITTI-geometry road run: landmark depth bias
    +0.8% → +9.6% over 100 frames, 9778a94:BASELINE.md r3 root-cause).

    Returns (disp, zncc, ok) like ``match``; ok includes an interior check
    (peak strictly inside the window — a edge hit means the prediction was
    off by more than the window, not a measurement).
    """
    N = uv.shape[0]
    D = 2 * window + 1
    P = patch
    base = disp_pred - float(window)          # (N,) leftmost disparity
    ref = interp.sample_patch(left, uv, P).reshape(N, P * P)
    uv0 = jnp.stack([uv[:, 0] - base, uv[:, 1]], axis=-1)
    d_rel, score, s0, s2, interior = _search_1d(_normalize(ref), right,
                                                uv0, D, P, direction=-1.0)
    disp = base + d_rel
    prominent = score - 0.5 * (s0 + s2) > 0.005
    ok = (score > min_zncc) & interior & prominent & (disp > 0.5)
    return disp, score, ok
