"""Loop closure + relocalization (backend/loop_closure.py).

Tiers (SURVEY.md §4.2): descriptor unit properties, proposal masking
logic, and a synthetic-scene golden test where the measured loop edge must
recover the exact ground-truth relative pose from a drifted initialization
and a pose graph with that edge must shrink the drift.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_svo_tpu.backend import loop_closure, pose_graph
from stereo_svo_tpu.config import CameraConfig, SvoConfig
from stereo_svo_tpu.geometry import se3
from stereo_svo_tpu.io import synthetic
from stereo_svo_tpu.ops import pyramid

pytestmark = pytest.mark.slow  # compile-heavy e2e tier

CAM = CameraConfig(fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                   baseline=0.11, width=256, height=192)
CFG = SvoConfig(camera=CAM, num_levels=3, align_levels=3,
                loop_thumb_level=1, loop_min_score=0.8, loop_min_gap=5,
                loop_max_edges=4)
SCENE = synthetic.default_scene(0)


def _render(t):
    T_wc = synthetic.trajectory_pose(jnp.asarray(t, jnp.float32))
    return T_wc, synthetic.render_view(CAM, T_wc, SCENE)


def test_descriptor_lighting_invariance():
    _, img = _render(0.0)
    d0 = loop_closure.descriptor(img, 6, 8)
    d1 = loop_closure.descriptor(1.7 * img + 25.0, 6, 8)
    assert np.allclose(np.linalg.norm(d0), 1.0, atol=1e-5)
    assert float(d0 @ d1) > 0.9999


def test_descriptor_equals_center_shift_variant():
    """descriptor() must equal shifted_descriptors()[4] exactly — the bank
    stores the former, queries match the latter (advisor r2 #5 made the
    center path direct; this pins the equivalence)."""
    _, img = _render(0.7)
    d = loop_closure.descriptor(img, 6, 8)
    ds = loop_closure.shifted_descriptors(img, 6, 8)
    assert np.allclose(np.asarray(d), np.asarray(ds[4]), atol=1e-6)


def test_descriptor_discriminates_views():
    _, img_a = _render(0.0)
    _, img_a2 = _render(0.02)    # nearly the same place
    _, img_b = _render(3.0)      # far along the trajectory
    da = loop_closure.descriptor(img_a, 6, 8)
    da2 = loop_closure.descriptor(img_a2, 6, 8)
    db = loop_closure.descriptor(img_b, 6, 8)
    assert float(da @ da2) > float(da @ db) + 0.05


def test_relocalize_picks_appearance_nearest():
    descs = []
    imgs = []
    for t in (0.0, 1.5, 3.0):
        _, img = _render(t)
        imgs.append(img)
        descs.append(loop_closure.descriptor(img, 6, 8))
    bank = jnp.stack(descs)
    valid = jnp.asarray([True, True, True])
    _, query = _render(1.52)     # closest to bank entry 1
    slot, score = loop_closure.relocalize(bank, valid, query, 6, 8)
    assert int(slot) == 1 and float(score) > 0.8
    # invalid slots are never returned
    slot2, _ = loop_closure.relocalize(
        bank, jnp.asarray([True, False, True]), query, 6, 8)
    assert int(slot2) != 1


def test_rotated_variants_tolerate_roll():
    """A rolled revisit (±0.25 rad in-plane rotation) must still clear the
    loop/reloc score gates via the rotated query variants; the plain
    shift-only matcher degrades (VERDICT r2 missing #5)."""
    T, img = _render(1.0)
    roll = se3.exp(jnp.asarray([0, 0, 0, 0, 0, 0.25], jnp.float32))
    img_roll = synthetic.render_view(CAM, se3.compose(T, roll), SCENE)
    d_bank = loop_closure.descriptor(img, 6, 8)        # bank stores plain
    q_shift = loop_closure.shifted_descriptors(img_roll, 6, 8)
    q_full = loop_closure.query_descriptors(img_roll, 6, 8,
                                            n_rot=2, rot_step=0.15)
    s_shift = float(jnp.max(q_shift @ d_bank))
    s_full = float(jnp.max(q_full @ d_bank))
    assert s_full > s_shift + 0.03, (s_full, s_shift)
    assert s_full > 0.6, s_full                        # clears loop gate
    # unrotated queries are unaffected (center variant still present)
    q0 = loop_closure.query_descriptors(img, 6, 8, n_rot=2)
    assert float(jnp.max(q0 @ d_bank)) > 0.999


def test_relocalize_rolled_query_picks_right_slot():
    descs, imgs = [], []
    for t in (0.0, 1.5, 3.0):
        _, img = _render(t)
        imgs.append(img)
        descs.append(loop_closure.descriptor(img, 6, 8))
    bank = jnp.stack(descs)
    valid = jnp.ones(3, bool)
    T, _ = _render(1.5)
    roll = se3.exp(jnp.asarray([0, 0, 0, 0, 0, -0.3], jnp.float32))
    query = synthetic.render_view(CAM, se3.compose(T, roll), SCENE)
    slot, score = loop_closure.relocalize(bank, valid, query, 6, 8,
                                          n_rot=2, rot_step=0.15)
    assert int(slot) == 1
    _, score0 = loop_closure.relocalize(bank, valid, query, 6, 8)
    assert float(score) > float(score0)     # rotation variants helped


def test_reverse_heading_revisit_is_documented_miss():
    """Recall envelope (documented limitation): an out-and-back revisit
    facing the OPPOSITE heading images disjoint scene content — no
    appearance descriptor over the forward view can match it. The score
    must stay safely below the proposal gate (a false match would be
    worse than the miss)."""
    T, img_fwd = _render(0.5)
    about_face = se3.exp(jnp.asarray([0, 0, 0, 0, np.pi, 0], jnp.float32))
    img_back = synthetic.render_view(CAM, se3.compose(T, about_face), SCENE)
    d_fwd = loop_closure.descriptor(img_fwd, 6, 8)
    q_back = loop_closure.query_descriptors(img_back, 6, 8, n_rot=2)
    s = float(jnp.max(q_back @ d_fwd))
    assert s < 0.6, f"reverse-heading match scored {s} — envelope changed"


def test_propose_edges_masks_and_threshold():
    # 4 keyframes: 0 and 3 are the same place (score ~1), but 0-1 adjacent
    D = 48
    rng = np.random.default_rng(0)
    base = rng.normal(size=D).astype(np.float32)
    other = rng.normal(size=D).astype(np.float32)

    def norm(v):
        v = v - v.mean()
        return v / np.linalg.norm(v)

    desc = jnp.asarray(np.stack([norm(base), norm(base),
                                 norm(other), norm(base)]))
    valid = jnp.ones(4, bool)
    stamp = jnp.asarray([0, 2, 50, 100], jnp.int32)
    seq = jnp.zeros(4, jnp.int32)
    props = loop_closure.propose_edges(desc, valid, stamp, seq,
                                       min_score=0.8, min_gap=5,
                                       max_edges=4)
    got = {tuple(e) for e, v in zip(np.asarray(props.edges_ij),
                                    np.asarray(props.valid)) if v}
    # (0,1) is blocked by the temporal gap; (0,3) and (1,3) are real
    assert (0, 3) in got and (1, 3) in got and (0, 1) not in got
    # cross-sequence pairs ignore the gap
    seq2 = jnp.asarray([0, 1, 1, 1], jnp.int32)
    props2 = loop_closure.propose_edges(desc, valid, stamp, seq2,
                                        min_score=0.8, min_gap=5,
                                        max_edges=4)
    got2 = {tuple(e) for e, v in zip(np.asarray(props2.edges_ij),
                                     np.asarray(props2.valid)) if v}
    assert (0, 1) in got2


def _grid_obs(T_wc, n=12, m=9):
    """Stereo observations of the synthetic scene on a pixel grid."""
    us = np.linspace(24, CAM.width - 24, n)
    vs = np.linspace(24, CAM.height - 24, m)
    uv = np.stack(np.meshgrid(us, vs), -1).reshape(-1, 2).astype(np.float32)
    z = synthetic.gt_depth(CAM, T_wc, jnp.asarray(uv), SCENE)
    disp = CAM.fx * CAM.baseline / np.asarray(z)
    return jnp.asarray(uv), jnp.asarray(disp)


def _edge_fixture(drift_xi):
    """Two keyframes viewing the same scene; KF1's stored pose is drifted."""
    T_wc0, img0 = _render(0.0)
    T_wc1, img1 = _render(0.25)
    K, N = 2, 12 * 9
    uv0, disp0 = _grid_obs(T_wc0)
    uv1, disp1 = _grid_obs(T_wc1)

    thumbs = []
    descs = []
    for img in (img0, img1):
        pyr = pyramid.build(img, CFG.num_levels)
        thumbs.append(pyr[CFG.thumb_level])
        descs.append(loop_closure.descriptor(pyr[CFG.num_levels - 1],
                                             CFG.loop_desc_rows,
                                             CFG.loop_desc_cols))
    # stored pose of KF1 drifts off ground truth
    T_wk0 = T_wc0
    T_wk1_true = T_wc1
    T_wk1 = se3.compose(T_wk1_true, se3.exp(jnp.asarray(drift_xi,
                                                        jnp.float32)))
    kf_T_wk = jnp.stack([T_wk0, T_wk1])
    # both keyframes carry stereo snapshots (as the production memory
    # bank always does) — the round-trip consistency gate (r5) measures
    # each edge in BOTH directions with independent templates
    obs_uv = jnp.stack([uv0, uv1])
    obs_disp = jnp.stack([disp0, disp1])
    obs_mask = jnp.ones((K, N), bool)
    Z_true = se3.compose(se3.inverse(T_wk0), T_wk1_true)
    return (kf_T_wk, jnp.stack(thumbs), jnp.stack(descs),
            obs_uv, obs_mask, obs_disp, Z_true)


def test_measure_edge_recovers_gt_relative_pose():
    drift = [0.03, -0.02, 0.04, 0.01, -0.012, 0.008]
    (kf_T_wk, thumbs, descs, obs_uv, obs_mask, obs_disp,
     Z_true) = _edge_fixture(drift)
    props = loop_closure.LoopProposals(
        edges_ij=jnp.asarray([[0, 1]], jnp.int32),
        score=jnp.asarray([1.0]), valid=jnp.asarray([True]))
    meas = loop_closure.measure_edges(
        CFG, props, kf_T_wk, thumbs, obs_uv, obs_mask, obs_disp, obs_mask)
    assert bool(meas.accept[0]), float(meas.inlier_frac[0])
    dr, dt = se3.distance(meas.Z[0], Z_true)
    # coarse thumbnail alignment: recover GT well inside the drift scale
    assert float(dt) < 0.02 and float(dr) < 0.01


def test_chain_graph_stamped_follows_temporal_order():
    # 4 slots; slot order != stamp order (ring reuse)
    T = jnp.stack([se3.exp(jnp.asarray([float(i), 0, 0, 0, 0, 0]))
                   for i in range(4)])
    valid = jnp.asarray([True, True, True, False])
    stamp = jnp.asarray([50, 10, 30, 0], jnp.int32)   # temporal: 1, 2, 0
    g = pose_graph.chain_graph_stamped(T, valid, stamp)
    active = [tuple(e) for e, w in zip(np.asarray(g.edges_ij),
                                       np.asarray(g.weight)) if w > 0]
    assert active == [(1, 2), (2, 0)]
    # measured relative poses consistent with the pose estimates
    for (i, j), z in zip(np.asarray(g.edges_ij), np.asarray(g.Z)):
        exp = se3.compose(se3.inverse(T[i]), T[j])
        np.testing.assert_allclose(z, np.asarray(exp), atol=1e-5)


def test_refine_trajectory_end_to_end():
    from stereo_svo_tpu.backend.loop_closure import refine_trajectory
    from stereo_svo_tpu.engine import runner
    from stereo_svo_tpu.eval import ate

    cfg = dataclasses.replace(
        CFG, grid_rows=8, grid_cols=10, max_features=80,
        stereo_max_disp=48, kf_min_tracked=25, border_margin=10,
        loop_min_gap=8, loop_min_score=0.85)
    lefts, rights, gt = synthetic.make_sequence(cfg.camera, 24, dt=0.2,
                                                kind="loop", seed=1)
    svo = runner.StereoSvo(cfg)
    for l, r in zip(lefts, rights):
        svo.new_image(l, r)
    traj2, kf_T, n_edges = refine_trajectory(cfg, svo.state,
                                             svo.trajectory())
    assert np.isfinite(traj2).all()
    err0 = ate.ate_rmse(ate.positions(svo.trajectory()), ate.positions(gt))
    err1 = ate.ate_rmse(ate.positions(traj2), ate.positions(gt))
    # loop closing must never blow up a good trajectory; when edges fire
    # it should not make it meaningfully worse either
    assert err1 < max(2.0 * err0, 0.05), (err0, err1, n_edges)


def test_memory_bank_outlives_window_eviction():
    """The place-recognition memory keeps keyframes the BA window evicts."""
    from stereo_svo_tpu.engine import runner

    cfg = dataclasses.replace(
        CFG, grid_rows=8, grid_cols=10, max_features=80,
        stereo_max_disp=48, kf_min_tracked=25, border_margin=10,
        max_keyframes=3, mem_keyframes=12,
        kf_dist_ratio=0.05)   # force a high keyframe rate
    lefts, rights, gt = synthetic.make_sequence(cfg.camera, 20, dt=0.25,
                                                kind="arc", seed=0)
    svo = runner.StereoSvo(cfg)
    for l, r in zip(lefts, rights):
        svo.new_image(l, r)
    st = svo.state
    n_created = int(st.mem_next)
    assert n_created > cfg.max_keyframes      # eviction definitely happened
    assert int(st.mem_valid.sum()) == min(n_created, cfg.mem_keyframes)
    # memory stamps cover keyframes no longer in the window
    win_stamps = set(np.asarray(st.kf_stamp)[np.asarray(st.kf_valid)])
    mem_stamps = set(np.asarray(st.mem_stamp)[np.asarray(st.mem_valid)])
    assert win_stamps <= mem_stamps and len(mem_stamps) > len(win_stamps)
    # BA write-back: window keyframes' memory poses track the refined ones
    kfm = np.asarray(st.kf_mem)
    for k in np.where(np.asarray(st.kf_valid))[0]:
        np.testing.assert_allclose(np.asarray(st.mem_T_wk[kfm[k]]),
                                   np.asarray(st.kf_T_wk[k]), atol=1e-5)


def test_close_loops_fixes_drift_via_pose_graph():
    drift = [0.03, -0.02, 0.04, 0.01, -0.012, 0.008]
    (kf_T_wk, thumbs, descs, obs_uv, obs_mask, obs_disp,
     Z_true) = _edge_fixture(drift)
    cfg = dataclasses.replace(CFG, loop_min_gap=5, loop_max_edges=2)
    kf_valid = jnp.ones(2, bool)
    stamp = jnp.asarray([0, 100], jnp.int32)
    seq = jnp.zeros(2, jnp.int32)
    graph, meas = loop_closure.close_loops(
        cfg, kf_T_wk, kf_valid, descs, thumbs, stamp, seq,
        obs_uv, obs_mask, obs_disp, obs_mask)
    assert float(graph.weight.sum()) >= 1.0
    # odometry chain (drifted) + loop edge: optimizing moves KF1 toward GT
    chain = pose_graph.chain_graph(kf_T_wk, kf_valid)
    full = pose_graph.PoseGraph(
        edges_ij=jnp.concatenate([chain.edges_ij, graph.edges_ij]),
        Z=jnp.concatenate([chain.Z, graph.Z]),
        weight=jnp.concatenate([chain.weight * 0.1, graph.weight]))
    T_opt, _ = pose_graph.optimize(kf_T_wk, kf_valid, full, n_iters=10)
    T_wk1_true = se3.compose(kf_T_wk[0], Z_true)
    dr0, dt0 = se3.distance(kf_T_wk[1], T_wk1_true)
    dr1, dt1 = se3.distance(T_opt[1], T_wk1_true)
    assert float(dt1) < 0.5 * float(dt0)
    assert float(dr1) < 0.5 * float(dr0)


def test_roundtrip_gate_rejects_false_proposal():
    """r5 round-trip consistency gate: force an edge between two views of
    DIFFERENT scene content (a false proposal — the production risk the
    gate exists for). Each direction's coarse alignment latches onto some
    local photometric minimum; the two directions cannot agree, the
    round-trip error explodes, and the edge must be REJECTED regardless
    of the per-direction inlier fractions — phantom edges of exactly this
    kind compounded 0.3-0.5 m of error on a drift-free run before the
    gate existed (9778a94:BASELINE.md r5). Also asserts the healthy fixture's
    round trip is SMALL — the gate discriminates, not just rejects."""
    drift = [0.03, -0.02, 0.04, 0.01, -0.012, 0.008]
    (kf_T_wk, thumbs, descs, obs_uv, obs_mask, obs_disp,
     Z_true) = _edge_fixture(drift)
    props = loop_closure.LoopProposals(
        edges_ij=jnp.asarray([[0, 1]], jnp.int32),
        score=jnp.asarray([1.0]), valid=jnp.asarray([True]))
    good = loop_closure.measure_edges(
        CFG, props, kf_T_wk, thumbs, obs_uv, obs_mask, obs_disp, obs_mask)
    assert bool(good.accept[0])
    assert float(good.rt_t[0]) < 0.5 * CFG.loop_rt_max_t, float(good.rt_t[0])

    # false proposal (the repeated-texture failure mode): KF1's stored
    # pose stays near KF0, but its thumbnail/snapshot actually IMAGE a
    # different part of the world (view 3 s away) — the initialization
    # is meaningless for the content, each direction falls into its own
    # local photometric minimum, and the directions disagree
    T_far, img_far = _render(3.0)
    pyr_far = pyramid.build(img_far, CFG.num_levels)
    thumbs_bad = thumbs.at[1].set(pyr_far[CFG.thumb_level])
    uv_far, disp_far = _grid_obs(T_far)
    obs_uv_bad = obs_uv.at[1].set(uv_far)
    obs_disp_bad = obs_disp.at[1].set(disp_far)
    bad = loop_closure.measure_edges(
        CFG, props, kf_T_wk, thumbs_bad, obs_uv_bad, obs_mask,
        obs_disp_bad, obs_mask)
    assert not bool(bad.accept[0]), (
        float(bad.rt_t[0]), float(bad.inlier_frac[0]))
