"""Synthetic stereo sequence generator with exact ground truth.

The sandbox has no EuRoC/KITTI data and no network (SURVEY.md §0), so the
end-to-end metric tests and the benchmark run on procedurally rendered
stereo sequences: textured 3-D planes ray-cast in closed form, a known
camera trajectory, and therefore exact ground-truth poses/depths. This is
the "synthetic scenes with known motion" tier of the test strategy
(SURVEY.md §4.2.2) and also serves as the ``ImageInput`` analog of the
reference's dataset readers for environments without datasets.

Rendering is pure JAX (jittable) so frames can be produced on-device at
benchmark time without a host round-trip.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CameraConfig
from ..geometry import se3
from ..precision import RENDER

# Procedural texture: multi-octave sum of plane waves. Low octaves give the
# smooth shading direct alignment needs; high octaves give FAST corners.
_N_WAVES = 24


def _texture_params(seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    freqs = []
    amps = []
    phases = []
    for octave in range(4):
        f0 = 0.7 * (2.2 ** octave)
        for _ in range(_N_WAVES // 4):
            ang = rng.uniform(0, 2 * math.pi)
            f = f0 * rng.uniform(0.7, 1.4)
            freqs.append([f * math.cos(ang), f * math.sin(ang)])
            amps.append(rng.uniform(0.5, 1.0) / (1.35 ** octave))
            phases.append(rng.uniform(0, 2 * math.pi))
    return (np.asarray(freqs, np.float32), np.asarray(amps, np.float32),
            np.asarray(phases, np.float32))


def _texture(p1: jnp.ndarray, p2: jnp.ndarray, params) -> jnp.ndarray:
    freqs, amps, phases = params
    acc = jnp.zeros_like(p1)
    for k in range(freqs.shape[0]):
        acc = acc + amps[k] * jnp.sin(
            2 * math.pi * (freqs[k, 0] * p1 + freqs[k, 1] * p2) + phases[k])
    # map to [10, 245] u8-like intensity range
    lo, hi = -float(np.sum(np.abs(amps))), float(np.sum(np.abs(amps)))
    return 10.0 + (acc - lo) / (hi - lo) * 235.0


class Plane(NamedTuple):
    normal: jnp.ndarray   # (3,) world-frame unit normal
    d: jnp.ndarray        # scalar: plane is n·x = d
    e1: jnp.ndarray       # (3,) in-plane texture basis
    e2: jnp.ndarray       # (3,)


class Sphere(NamedTuple):
    center: jnp.ndarray   # (3,) world-frame center
    radius: jnp.ndarray   # scalar
    e1: jnp.ndarray       # (3,) texture projection basis
    e2: jnp.ndarray       # (3,)


def _intersect(prim, o: jnp.ndarray, rays_w: jnp.ndarray):
    """Ray-primitive intersection for x = o + s·rays_w.

    rays_w are camera rays with unit z in the camera frame, so the ray
    parameter s *is* the camera-frame z-depth for every primitive type.
    Returns (s, hit, p1, p2): depth, hit mask, and texture coordinates.
    """
    if isinstance(prim, Plane):
        n, d = prim.normal, prim.d
        denom = jnp.einsum("...i,i->...", rays_w, n, precision=RENDER)
        denom = jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
        s = (d - jnp.dot(n, o, precision=RENDER)) / denom
        hit = s > 0.1
    elif isinstance(prim, Sphere):
        oc = o - prim.center
        a = jnp.einsum("...i,...i->...", rays_w, rays_w, precision=RENDER)
        b = 2.0 * jnp.einsum("...i,i->...", rays_w, oc, precision=RENDER)
        c0 = jnp.dot(oc, oc, precision=RENDER) - prim.radius ** 2
        disc = b * b - 4.0 * a * c0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        s = (-b - sq) / (2.0 * a)            # near intersection
        hit = (disc > 0.0) & (s > 0.1)
        s = jnp.where(hit, s, 1e9)
    else:
        raise TypeError(type(prim))
    x = o + s[..., None] * rays_w
    p1 = jnp.einsum("...i,i->...", x, prim.e1, precision=RENDER)
    p2 = jnp.einsum("...i,i->...", x, prim.e2, precision=RENDER)
    return s, hit, p1, p2


def default_scene(seed: int = 0):
    """Two tilted textured planes in front of the camera (z forward).

    Plane A fills the view at ~2.5–7 m; plane B is a far backdrop so rays
    missing A still hit texture.
    """
    def unit(v):
        v = np.asarray(v, np.float32)
        return v / np.linalg.norm(v)

    nA = unit([0.25, -0.15, -1.0])
    pA = Plane(jnp.asarray(nA), jnp.asarray(np.dot(nA, [0, 0, 4.0]), np.float32),
               jnp.asarray(unit(np.cross(nA, [0, 1, 0]))),
               jnp.asarray(unit(np.cross(nA, np.cross(nA, [0, 1, 0])))))
    nB = unit([0.0, 0.0, -1.0])
    pB = Plane(jnp.asarray(nB), jnp.asarray(np.dot(nB, [0, 0, 14.0]), np.float32),
               jnp.asarray([1.0, 0.0, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    return (pA, pB), (_texture_params(seed), _texture_params(seed + 1))


def cluttered_scene(seed: int = 0, n_spheres: int = 6):
    """Non-planar scene: backdrop + ground plane + textured spheres.

    Spheres at mixed depths create real parallax layers and, critically,
    **occlusion**: features on a near sphere's silhouette see the backdrop
    appear/disappear behind them as the camera moves — the geometry class
    the planar `default_scene` cannot produce (VERDICT r1 missing #1;
    SURVEY.md §4.2.2 "rendered planes/point clouds").
    """
    def unit(v):
        v = np.asarray(v, np.float32)
        return v / np.linalg.norm(v)

    rng = np.random.default_rng(1000 + seed)
    prims = []
    # far backdrop so every ray hits texture
    nB = unit([0.0, 0.0, -1.0])
    prims.append(Plane(jnp.asarray(nB),
                       jnp.asarray(np.dot(nB, [0, 0, 16.0]), np.float32),
                       jnp.asarray([1.0, 0.0, 0.0]),
                       jnp.asarray([0.0, 1.0, 0.0])))
    # ground plane below the camera (y is down in the camera frame)
    nG = unit([0.02, -1.0, -0.05])
    prims.append(Plane(jnp.asarray(nG),
                       jnp.asarray(np.dot(nG, [0, 1.8, 0]), np.float32),
                       jnp.asarray(unit(np.cross(nG, [0, 0, 1.0]))),
                       jnp.asarray(unit(np.cross(nG,
                                                 np.cross(nG, [0, 0, 1.0]))))))
    # spheres: z past the trajectory's forward reach (camera advances ~2 m)
    for k in range(n_spheres):
        c = np.asarray([rng.uniform(-2.2, 2.2), rng.uniform(-1.0, 1.2),
                        rng.uniform(4.5, 9.0)], np.float32)
        r = np.float32(rng.uniform(0.45, 1.0))
        ang = rng.uniform(0, 2 * math.pi)
        e1 = unit([math.cos(ang), math.sin(ang), 0.3])
        e2 = unit(np.cross(e1, [0.2, 1.0, 0.1]))
        prims.append(Sphere(jnp.asarray(c), jnp.asarray(r),
                            jnp.asarray(e1), jnp.asarray(e2)))
    texs = tuple(_texture_params(seed + 10 * k) for k in range(len(prims)))
    return tuple(prims), texs


def road_scene(seed: int = 0, length: float = 60.0, wall_tilt: float = 0.06):
    """KITTI-like deep scene: road plane + two building walls + backdrop.

    Depth spans ~4–`length` m (vs the EuRoC-ish default_scene's 2.5–14 m),
    so a wide-baseline camera (KITTI: 0.537 m) sees disparities well inside
    its search range and forward motion has structure to track all the way
    out — the geometry class the arc-over-close-planes bench never
    exercises (VERDICT r2 weak #2).

    ``length`` places the backdrop; ``wall_tilt`` is the walls' z-normal
    component (they converge toward the centerline at x = 7/wall_tilt m —
    long driving runs need a smaller tilt so the corridor stays open past
    the travel distance).
    """
    def unit(v):
        v = np.asarray(v, np.float32)
        return v / np.linalg.norm(v)

    prims = []
    # road: y is down in the camera frame; camera ~1.65 m above the road
    nG = unit([0.0, -1.0, -0.02])
    prims.append(Plane(jnp.asarray(nG),
                       jnp.asarray(np.dot(nG, [0, 1.65, 0]), np.float32),
                       jnp.asarray(unit(np.cross(nG, [0, 0, 1.0]))),
                       jnp.asarray(unit(np.cross(nG,
                                                 np.cross(nG, [0, 0, 1.0]))))))
    # building walls at x = ±7 m, slightly converging (keeps texture in
    # view under yaw)
    for sx in (-1.0, 1.0):
        nW = unit([-sx, 0.0, -wall_tilt])
        prims.append(Plane(jnp.asarray(nW),
                           jnp.asarray(np.dot(nW, [sx * 7.0, 0, 0]),
                                       np.float32),
                           jnp.asarray(unit(np.cross(nW, [0, 1.0, 0]))),
                           jnp.asarray([0.0, 1.0, 0.0])))
    # far backdrop closes every ray
    nB = unit([0.0, 0.0, -1.0])
    prims.append(Plane(jnp.asarray(nB),
                       jnp.asarray(np.dot(nB, [0, 0, length]), np.float32),
                       jnp.asarray([1.0, 0.0, 0.0]),
                       jnp.asarray([0.0, 1.0, 0.0])))
    texs = tuple(_texture_params(seed + 10 * k) for k in range(len(prims)))
    return tuple(prims), texs


def dynamic_scene(seed: int = 0, t: float | jnp.ndarray = 0.0):
    """Cluttered scene with ONE independently moving sphere.

    The mover crosses the static world laterally (≈0.25 m per unit t) —
    a non-rigid-scene stressor: its features violate the static-world
    assumption and must be rejected by the outlier gates (reprojection
    kill, depth-consistency gate), not dragged into the map
    (SURVEY.md §4.2.2 hardening; VERDICT r2 missing #1).
    """
    prims, texs = cluttered_scene(seed, n_spheres=5)
    t = jnp.asarray(t, jnp.float32)
    mover = Sphere(
        center=jnp.asarray([-2.5, 0.1, 6.0], jnp.float32)
        + t * jnp.asarray([0.25, 0.0, 0.02], jnp.float32),
        radius=jnp.asarray(0.8, jnp.float32),
        e1=jnp.asarray([0.8, 0.0, 0.6], jnp.float32),
        e2=jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    return prims + (mover,), texs + (_texture_params(seed + 999),)


def get_scene(kind: str, seed: int = 0):
    """Scene factory: 'planes' (two-plane), 'clutter' (spheres+occlusion),
    or 'road' (KITTI-like deep corridor). The time-varying 'dynamic' scene
    is built per-frame via ``dynamic_scene`` (see ``make_sequence``)."""
    if kind in ("planes", "default"):
        return default_scene(seed)
    if kind == "clutter":
        return cluttered_scene(seed)
    if kind == "road":
        return road_scene(seed)
    if kind == "road_long":
        # driving-scale variant: ~180 m corridor, walls converging at
        # x = 7/0.02 = 350 m — stays open past a 700-frame / ~84 m run
        # (VERDICT r3 next #2: drift proof at ≥500 frames)
        return road_scene(seed, length=180.0, wall_tilt=0.02)
    raise ValueError(kind)


def perturb_stereo(left: jnp.ndarray, right: jnp.ndarray, key,
                   gain_jitter: float = 0.15, bias_jitter: float = 12.0,
                   noise_sigma: float = 2.0, vignette: float = 0.30):
    """Photometric nuisance model (SURVEY.md §4.2.3 hardening):

    - per-frame global exposure: gain ~ U(1±gain_jitter), bias ~ U(±bias
      _jitter), shared by both eyes (auto-exposure acts on the pair);
    - static lens vignetting: multiplicative 1 - v·(r/r_max)²;
    - per-pixel iid Gaussian sensor noise, independent per eye.

    Jittable; pass a fresh PRNG key per frame. Output clipped to [0, 255].
    """
    kg, kb, kl, kr = jax.random.split(key, 4)
    g = 1.0 + gain_jitter * (2.0 * jax.random.uniform(kg) - 1.0)
    b = bias_jitter * (2.0 * jax.random.uniform(kb) - 1.0)
    H, W = left.shape
    u = (jnp.arange(W, dtype=jnp.float32) - (W - 1) / 2) / (W / 2)
    v = (jnp.arange(H, dtype=jnp.float32) - (H - 1) / 2) / (W / 2)
    r2 = u[None, :] ** 2 + v[:, None] ** 2
    vig = 1.0 - vignette * r2 / jnp.max(r2)

    def apply(img, k):
        out = vig * (g * img + b)
        out = out + noise_sigma * jax.random.normal(k, img.shape)
        return jnp.clip(out, 0.0, 255.0)

    return apply(left, kl), apply(right, kr)


def render_view(cam: CameraConfig, T_wc: jnp.ndarray, scene,
                aa: int = 1) -> jnp.ndarray:
    """Ray-cast one camera view: (H, W) float32 intensities in [0, 255].

    T_wc: camera→world pose (camera center = translation(T_wc)).

    aa: supersampling factor (anti-aliasing). Point-sampling a
    world-scale texture (up to ~9 cycles/m) at long range puts multiple
    texture cycles inside one pixel footprint — e.g. 2.2 cycles/px on a
    backdrop 180 m from a fx≈719 camera — so distant surfaces render as
    frame-incoherent noise instead of the smooth low-frequency content a
    real camera integrates over its pixel area. aa=2 averages a 2×2
    sub-pixel grid (box filter), which is what sank the 700-frame
    road_long run before it existed (drift 4× the 60 m scene's at equal
    frame counts, then tracking collapse).
    """
    def one_pass(duv):
        """Ray-cast at pixel centers + (du, dv) sub-pixel offset."""
        planes, textures = scene
        H, W = cam.height, cam.width
        u = jnp.arange(W, dtype=jnp.float32)
        v = jnp.arange(H, dtype=jnp.float32)
        uu, vv = jnp.meshgrid(u, v)                  # (H, W)
        # Camera-frame ray directions.
        rx = (uu + duv[0] - cam.cx) / cam.fx
        ry = (vv + duv[1] - cam.cy) / cam.fy
        rays_c = jnp.stack([rx, ry, jnp.ones_like(rx)], axis=-1)
        R = se3.rotation(T_wc)
        o = se3.translation(T_wc)
        rays_w = jnp.einsum("ij,hwj->hwi", R, rays_c, precision=RENDER)

        img = jnp.zeros((H, W), jnp.float32)
        depth = jnp.full((H, W), jnp.inf, jnp.float32)
        for prim, tex in zip(planes, textures):
            s, hit, p1, p2 = _intersect(prim, o, rays_w)
            val = _texture(p1, p2, tex)
            closer = hit & (s < depth)               # z-buffer → occlusion
            img = jnp.where(closer, val, img)
            depth = jnp.where(closer, s, depth)
        return img

    if aa == 1:
        return one_pass(jnp.zeros(2, jnp.float32))
    # sequential sub-pixel passes (lax.map) — one full-image pass is
    # already hundreds of MB of ray/texture intermediates at KITTI
    # resolution; a 2x2-supersampled single pass exceeded HBM
    offs = jnp.asarray([(k + 0.5) / aa - 0.5 for k in range(aa)],
                       jnp.float32)
    duv = jnp.stack(jnp.meshgrid(offs, offs), -1).reshape(-1, 2)
    return jnp.mean(jax.lax.map(one_pass, duv), axis=0)


def gt_depth(cam: CameraConfig, T_wc: jnp.ndarray, uv: jnp.ndarray, scene):
    """Exact z-depth (camera frame) of the scene at pixels uv (…,2)."""
    planes, _ = scene
    rx = (uv[..., 0] - cam.cx) / cam.fx
    ry = (uv[..., 1] - cam.cy) / cam.fy
    rays_c = jnp.stack([rx, ry, jnp.ones_like(rx)], axis=-1)
    R = se3.rotation(T_wc)
    o = se3.translation(T_wc)
    rays_w = jnp.einsum("ij,...j->...i", R, rays_c, precision=RENDER)
    best = jnp.full(uv.shape[:-1], jnp.inf, jnp.float32)
    for prim in planes:
        s, hit, _, _ = _intersect(prim, o, rays_w)
        best = jnp.minimum(best, jnp.where(hit, s, jnp.inf))
    # rays have unit z in the camera frame → ray parameter == z-depth
    return best


def right_camera_pose(cam: CameraConfig, T_wc_left: jnp.ndarray) -> jnp.ndarray:
    """Right camera pose: left shifted by +baseline along camera x."""
    offset = se3.make(jnp.eye(3, dtype=T_wc_left.dtype),
                      jnp.asarray([cam.baseline, 0.0, 0.0], T_wc_left.dtype))
    return se3.compose(T_wc_left, offset)


def render_stereo(cam: CameraConfig, T_wc: jnp.ndarray, scene,
                  aa: int = 1):
    left = render_view(cam, T_wc, scene, aa=aa)
    right = render_view(cam, right_camera_pose(cam, T_wc), scene, aa=aa)
    return left, right


def trajectory_pose(t: jnp.ndarray, kind: str = "arc") -> jnp.ndarray:
    """Ground-truth T_wc at scalar time t (frame index * dt).

    'arc': gentle forward+sideways motion with yaw/roll — exercises all six
    DoF without leaving the rendered planes' field of view.
    """
    if kind == "arc":
        tx = 0.30 * jnp.sin(0.7 * t)
        ty = 0.10 * jnp.sin(0.9 * t + 0.4)
        tz = 0.25 * t
        wy = 0.06 * jnp.sin(0.5 * t)
        wx = 0.03 * jnp.sin(0.8 * t + 1.0)
        wz = 0.02 * jnp.sin(1.1 * t)
    elif kind == "loop":
        # out-and-back: forward then return near the start (long-run
        # stability / revisit behavior)
        tx = 0.20 * jnp.sin(0.5 * t)
        ty = 0.05 * jnp.sin(0.9 * t)
        tz = 0.8 * jnp.sin(0.35 * t)        # advance then come back
        wy = 0.05 * jnp.sin(0.45 * t)
        wx = 0.02 * jnp.sin(0.7 * t)
        wz = 0.015 * jnp.sin(1.0 * t)
    elif kind == "kitti":
        # forward-dominant driving motion with a sustained yaw turn —
        # KITTI's regime (VERDICT r2 missing #1: nothing exercised
        # sustained yaw / forward dominance): ~19x more forward travel
        # than lateral sway, yaw ramping to ±0.17 rad (≈10°)
        tx = 0.08 * jnp.sin(0.5 * t)
        ty = 0.02 * jnp.sin(0.9 * t)
        tz = 1.5 * t
        wy = 0.17 * jnp.sin(0.18 * t)
        wx = 0.01 * jnp.sin(0.8 * t)
        wz = 0.008 * jnp.sin(1.1 * t)
    elif kind == "spin":
        # in-plane-rotation stressor: roll to ±0.25 rad (≈14°) — the
        # motion class grid-pooled place recognition and axis-aligned
        # patches handle worst (VERDICT r2 #10 hardening)
        tx = 0.15 * jnp.sin(0.6 * t)
        ty = 0.05 * jnp.sin(0.9 * t + 0.4)
        tz = 0.15 * t
        wy = 0.03 * jnp.sin(0.5 * t)
        wx = 0.02 * jnp.sin(0.8 * t + 1.0)
        wz = 0.25 * jnp.sin(0.45 * t)
    elif kind == "loop_far":
        # large out-and-back: ~3x the 'loop' amplitudes. Enough travel
        # for ORGANIC odometry drift to exceed loop-edge measurement
        # noise before the revisit (the no-injection loop-closure proof,
        # r5; the standard 'loop' accumulates only ~2-5 cm — below the
        # edge-noise floor)
        tx = 0.4 * jnp.sin(0.5 * t)
        ty = 0.08 * jnp.sin(0.9 * t)
        tz = 2.1 * jnp.sin(0.35 * t)
        wy = 0.08 * jnp.sin(0.45 * t)
        wx = 0.02 * jnp.sin(0.7 * t)
        wz = 0.015 * jnp.sin(1.0 * t)
    elif kind == "still":
        z = jnp.zeros_like(t)
        tx = ty = tz = wx = wy = wz = z
    else:
        raise ValueError(kind)
    xi = jnp.stack([tx, ty, tz, wx, wy, wz], axis=-1)
    return se3.exp(xi)


def make_sequence(cam: CameraConfig, n_frames: int, dt: float = 0.1,
                  kind: str = "arc", seed: int = 0,
                  scene_kind: str = "planes", perturb: bool = False,
                  motion_blur: float = 0.0):
    """Render a full sequence on host: (lefts, rights, gt_T_wc).

    Returns numpy arrays: (N,H,W), (N,H,W), (N,3,4). ``scene_kind``
    selects the geometry (`get_scene`; 'dynamic' rebuilds the scene each
    frame so one sphere moves independently); ``perturb=True`` applies the
    photometric nuisance model per frame (`perturb_stereo`);
    ``motion_blur`` > 0 averages 3 sub-exposures spread over that fraction
    of the inter-frame motion (camera-shutter blur — smears gradients and
    FAST scores, the classic direct-method stressor). The driving-scale
    road scenes render 2x2-supersampled (`render_view`'s ``aa``): their
    far texture aliases into frame-incoherent noise at one sample per
    pixel.
    """
    aa = 2 if scene_kind.startswith("road") else 1
    dynamic = scene_kind == "dynamic"
    if dynamic:
        def render(T, t):
            return render_stereo(cam, T, dynamic_scene(seed, t), aa=aa)
    else:
        scene = get_scene(scene_kind, seed)

        def render(T, t):
            return render_stereo(cam, T, scene, aa=aa)
    if motion_blur > 0.0:
        base = render

        def render(T, t):  # noqa: F811 — blur wraps the base renderer
            taps = []
            for frac in (-motion_blur, 0.0, motion_blur):
                Tb = trajectory_pose(t + frac * dt, kind)
                taps.append(base(Tb, t))
            l = sum(tp[0] for tp in taps) / len(taps)
            r = sum(tp[1] for tp in taps) / len(taps)
            return l, r
    render = jax.jit(render)
    pert = jax.jit(perturb_stereo)
    key = jax.random.PRNGKey(seed)
    lefts, rights, poses = [], [], []
    for i in range(n_frames):
        t = jnp.asarray(i * dt, jnp.float32)
        T = trajectory_pose(t, kind)
        l, r = render(T, t)
        if perturb:
            key, sub = jax.random.split(key)
            l, r = pert(l, r, sub)
        lefts.append(np.asarray(l))
        rights.append(np.asarray(r))
        poses.append(np.asarray(T))
    return np.stack(lefts), np.stack(rights), np.stack(poses)
