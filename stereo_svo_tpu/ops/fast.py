"""FAST-9/16 corner scores + edgelet (gradient) scores as dense maps.

Reference parity: the corner detector with FAST corners plus edgelet
features (src/lib/corner_detector.* [UNVERIFIED — SURVEY.md §0];
SURVEY.md §2.1). The reference runs cv::FAST + a scalar edgelet scan; here
both are *dense score maps* computed by pure elementwise math
over 16 shifted copies of the image — no data-dependent branches, so the
whole detector jits and vmaps.

Score definition (matches the classic FAST corner score): the largest
threshold t for which a contiguous 9-of-16 arc is uniformly brighter
(or darker) than the center, i.e. max over the 16 arcs of the minimum
absolute contrast within the arc.
"""

from __future__ import annotations

import jax.numpy as jnp

# Bresenham circle of radius 3: (dx, dy), clockwise from 12 o'clock.
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_ARC = 9  # contiguous run length for FAST-9


def _shift(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """I_shift[y, x] = I[y+dy, x+dx] with circular wrap; the <=3px wrapped
    border is invalidated by the caller's border margin."""
    return jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))


def corner_score(img: jnp.ndarray) -> jnp.ndarray:
    """Dense FAST-9/16 score map (H, W), float. 0 where not a corner at
    threshold 0; callers threshold with config.fast_threshold."""
    diffs = jnp.stack([_shift(img, dx, dy) for dx, dy in _CIRCLE]) - img[None]
    # circular extension so every arc start has 9 consecutive entries
    ext = jnp.concatenate([diffs, diffs[: _ARC - 1]], axis=0)  # (24, H, W)
    # arc_min_bright[s] = min over the 9-arc of (I_off - I); positive when
    # the whole arc is brighter. Same for dark with negated diffs.
    bright = []
    dark = []
    for s in range(len(_CIRCLE)):
        window = ext[s: s + _ARC]
        bright.append(jnp.min(window, axis=0))
        dark.append(jnp.min(-window, axis=0))
    score_b = jnp.max(jnp.stack(bright), axis=0)
    score_d = jnp.max(jnp.stack(dark), axis=0)
    return jnp.maximum(jnp.maximum(score_b, score_d), 0.0)


def edgelet_score(gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    """Gradient-magnitude map used to score edgelet features."""
    return jnp.sqrt(gx * gx + gy * gy)


def edgelet_direction(gx: jnp.ndarray, gy: jnp.ndarray):
    """Unit gradient direction per pixel (the edgelet normal)."""
    mag = jnp.sqrt(gx * gx + gy * gy)
    m = jnp.maximum(mag, 1e-6)
    return gx / m, gy / m
