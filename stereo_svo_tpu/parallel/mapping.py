"""Multi-sequence distributed mapping (north-star config #5).

Merges the per-sequence keyframe maps produced by the odometry engine into
one global problem — poses from all sequences concatenated, landmarks
concatenated, observation blocks block-diagonal — then refines it with:

  1. the distributed Schur-complement stereo BA (landmarks sharded over the
     ``kf`` mesh axis, pose system psum-reduced across the devices —
     over NVLink between the GPUs of one host — dist_ba.py), and
  2. pose-graph optimization over all keyframe chains, with optional
     cross-sequence loop-closure edges (backend/pose_graph.py).

The reference has no distributed anything (SURVEY.md §2.2) — this module is
the design for a multi-sequence deployment: a KITTI 00+02+05-style map
sharded across devices with distributed Schur-complement BA and
pose-graph optimization.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..backend import loop_closure, pose_graph
from ..config import CameraConfig, SvoConfig
from ..engine.state import STATUS_LANDMARK, SlamState
from ..engine.step import world_points
from ..geometry import se3
from . import dist_ba


class GlobalMap(NamedTuple):
    """Concatenated multi-sequence map (fixed capacity: B·K poses, B·N
    landmarks, observations block-diagonal)."""
    kf_T_wk: jnp.ndarray    # (BK,3,4)
    kf_valid: jnp.ndarray   # (BK,)
    kf_seq: jnp.ndarray     # (BK,) sequence id of each keyframe
    X: jnp.ndarray          # (BN,3)
    X_mask: jnp.ndarray     # (BN,)
    obs_uv: jnp.ndarray     # (BK,BN,2)
    obs_mask: jnp.ndarray   # (BK,BN)
    obs_disp: jnp.ndarray   # (BK,BN)
    obs_dmask: jnp.ndarray  # (BK,BN)
    kf_stamp: jnp.ndarray   # (BK,) frame index at KF creation
    kf_desc: jnp.ndarray    # (BK,D) place-recognition descriptors
    kf_thumb: jnp.ndarray   # (BK,Ht,Wt) coarse thumbnails


def build_global_map(cfg: SvoConfig, states: List[SlamState]) -> GlobalMap:
    """Concatenate per-sequence engine states into one global problem."""
    B = len(states)
    K = cfg.max_keyframes
    N = cfg.max_features
    BK, BN = B * K, B * N

    kf_T_wk = jnp.concatenate([s.kf_T_wk for s in states])
    kf_valid = jnp.concatenate([s.kf_valid for s in states])
    kf_seq = jnp.repeat(jnp.arange(B, dtype=jnp.int32), K)
    X = jnp.concatenate([world_points(cfg, s) for s in states])
    X_mask = jnp.concatenate([s.status == STATUS_LANDMARK for s in states])

    obs_uv = jnp.zeros((BK, BN, 2), jnp.float32)
    obs_mask = jnp.zeros((BK, BN), bool)
    obs_disp = jnp.zeros((BK, BN), jnp.float32)
    obs_dmask = jnp.zeros((BK, BN), bool)
    for b, s in enumerate(states):
        rk = slice(b * K, (b + 1) * K)
        rn = slice(b * N, (b + 1) * N)
        obs_uv = obs_uv.at[rk, rn].set(s.obs_uv)
        obs_mask = obs_mask.at[rk, rn].set(s.obs_mask)
        obs_disp = obs_disp.at[rk, rn].set(s.obs_disp)
        obs_dmask = obs_dmask.at[rk, rn].set(s.obs_dmask)
    kf_stamp = jnp.concatenate([s.kf_stamp for s in states])
    kf_desc = jnp.concatenate([s.kf_desc for s in states])
    kf_thumb = jnp.concatenate([s.kf_thumb for s in states])
    return GlobalMap(kf_T_wk, kf_valid, kf_seq, X, X_mask,
                     obs_uv, obs_mask, obs_disp, obs_dmask,
                     kf_stamp, kf_desc, kf_thumb)


def detect_loop_edges(cfg: SvoConfig, gmap: GlobalMap
                      ) -> Tuple[pose_graph.PoseGraph,
                                 "loop_closure.LoopMeasurement"]:
    """Appearance-based loop-closure detection over the global keyframe
    bank (within and across sequences): descriptor match → thumbnail
    direct-alignment measurement → photometric gate
    (backend/loop_closure.close_loops). The returned graph's rejected
    edges carry weight 0, so it can be passed straight to
    ``optimize_global_map(loop_edges=...)``."""
    return loop_closure.close_loops(
        cfg, gmap.kf_T_wk, gmap.kf_valid, gmap.kf_desc, gmap.kf_thumb,
        gmap.kf_stamp, gmap.kf_seq, gmap.obs_uv, gmap.obs_mask,
        gmap.obs_disp, gmap.obs_dmask)


def optimize_global_map(mesh, cam: CameraConfig, cfg: SvoConfig,
                        gmap: GlobalMap,
                        loop_edges: Optional[pose_graph.PoseGraph] = None,
                        pg_iters: int = 10
                        ) -> Tuple[GlobalMap, jnp.ndarray]:
    """Pose graph (with optional cross-sequence loop closures) then
    distributed Schur BA over the mesh. Returns (refined map, pg cost)."""
    # --- 1. pose graph over all keyframe chains ---
    # chain edges only within a sequence: mask out cross-sequence pairs
    graph = pose_graph.chain_graph(gmap.kf_T_wk, gmap.kf_valid)
    same_seq = (gmap.kf_seq[graph.edges_ij[:, 0]]
                == gmap.kf_seq[graph.edges_ij[:, 1]])
    graph = graph._replace(weight=graph.weight * same_seq)
    if loop_edges is not None:
        graph = pose_graph.PoseGraph(
            edges_ij=jnp.concatenate([graph.edges_ij, loop_edges.edges_ij]),
            Z=jnp.concatenate([graph.Z, loop_edges.Z]),
            weight=jnp.concatenate([graph.weight, loop_edges.weight]))
    T_pg, pg_cost = pose_graph.optimize(
        gmap.kf_T_wk, gmap.kf_valid, graph, n_iters=pg_iters)

    # carry landmarks with their (sequence-local) keyframe correction:
    # X' = T_new_wk · T_old_kw · X using each landmark's dominant observer
    # — approximated by its sequence's first valid KF delta (rigid per-seq)
    # before BA re-polishes everything jointly.
    B = int(gmap.kf_seq.max()) + 1 if gmap.kf_seq.size else 1
    K = gmap.kf_T_wk.shape[0] // max(B, 1)
    N = gmap.X.shape[0] // max(B, 1)
    X = gmap.X
    for b in range(B):
        k0 = b * K + int(jnp.argmax(gmap.kf_valid[b * K:(b + 1) * K]))
        delta = se3.compose(T_pg[k0], se3.inverse(gmap.kf_T_wk[k0]))
        rn = slice(b * N, (b + 1) * N)
        X = X.at[rn].set(se3.transform(delta, X[rn]))

    # --- 2. distributed stereo BA over the refined initialization ---
    # Gauge: pin the first valid keyframe of EACH sequence — the sequences
    # share no observations, so each pose block needs its own anchor or
    # the reduced camera system is singular along that block's gauge.
    BK = gmap.kf_T_wk.shape[0]
    fixed = ~gmap.kf_valid
    for b in range(B):
        k0 = b * K + int(jnp.argmax(gmap.kf_valid[b * K:(b + 1) * K]))
        fixed = fixed.at[k0].set(True)
    T_ba, X_ba = dist_ba.bundle_adjust_sharded(
        mesh, cam, cfg, T_pg, gmap.kf_valid, X, gmap.X_mask,
        gmap.obs_uv, gmap.obs_mask, gmap.obs_disp, gmap.obs_dmask,
        fixed_mask=fixed.astype(jnp.float32))
    return gmap._replace(kf_T_wk=T_ba, X=X_ba), pg_cost


def align_maps_umeyama(X_a: np.ndarray, X_b: np.ndarray
                       ) -> jnp.ndarray:
    """SE(3) aligning landmark cloud b onto a (for loop-closure seeding
    between overlapping sequences). Returns (3,4) pose."""
    from ..eval.ate import align_umeyama
    _, R, t = align_umeyama(np.asarray(X_b), np.asarray(X_a))
    return jnp.asarray(np.concatenate([R, t[:, None]], axis=1),
                       jnp.float32)
