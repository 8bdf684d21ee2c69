"""SLAM tracker integration tests on synthetic feature sequences (known
3D scene + trajectory, descriptors injected -> deterministic end-to-end
tracking/mapping/BA without rendering)."""

import numpy as np

import jax.numpy as jnp

from visualslam.geometry import se3
from visualslam.models.types import Features, Keypoints
from visualslam.slam.evaluation import ate_rmse, centers_from_poses, rpe
from visualslam.slam.tracker import Tracker
from visualslam.utils.config import DEFAULT_CONFIG

INTR = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
W, H = 640, 480

CFG = DEFAULT_CONFIG.replace(
    keyframe_min_inliers=40,
    keyframe_max_gap=4,
    match=DEFAULT_CONFIG.match.replace(max_matches=512, ratio=0.9),
    ransac=DEFAULT_CONFIG.ransac.replace(num_hypotheses=256,
                                         inlier_threshold=5e-5),
    ba=DEFAULT_CONFIG.ba.replace(max_cameras=6, max_landmarks=2048,
                                 max_observations=8192, iters=6),
)


class SyntheticScene:
    """Static point cloud + camera path; emits Features per frame.

    max_depth must cover the camera's travel (z ~ 0.45/frame) or the scene
    literally runs out of landmarks ahead of the camera."""

    def __init__(self, rng, n_points=600, cap=1024, max_depth=40.0):
        self.rng = rng
        self.cap = cap
        self.X = rng.uniform([-12, -6, 8], [12, 6, max_depth],
                             (n_points, 3))
        self.desc = rng.standard_normal((n_points, 64)).astype(np.float32)
        self.desc /= np.linalg.norm(self.desc, axis=1, keepdims=True)

    def pose(self, k):
        """Forward motion with gentle turn (world-to-camera)."""
        w = np.array([0.0, 0.004 * k, 0.0])
        R = np.asarray(se3.exp_so3(jnp.asarray(w)))
        center = np.array([0.05 * k * k * 0.05, 0.0, 0.45 * k])
        t = -R @ center
        return R.astype(np.float32), t.astype(np.float32)

    def features(self, k, pix_noise=0.3):
        R, t = self.pose(k)
        Xc = self.X @ R.T + t
        z = Xc[:, 2]
        uv = Xc[:, :2] / np.maximum(z[:, None], 1e-6)
        px = uv * INTR[:2] + INTR[2:]
        vis = (z > 1.0) & (px[:, 0] >= 5) & (px[:, 0] < W - 5) \
            & (px[:, 1] >= 5) & (px[:, 1] < H - 5)
        idx = np.nonzero(vis)[0][: self.cap]
        n = len(idx)
        px_n = px[idx] + self.rng.normal(0, pix_noise, (n, 2))
        yx = np.zeros((self.cap, 2), np.float32)
        yx[:n] = px_n[:, ::-1]
        desc = np.zeros((self.cap, 64), np.float32)
        desc[:n] = self.desc[idx]
        valid = np.zeros(self.cap, bool)
        valid[:n] = True
        kps = Keypoints.empty(self.cap)._replace(
            yx=jnp.asarray(yx), valid=jnp.asarray(valid))
        return Features(kps, jnp.asarray(desc)), (R, t)


def run_sequence(rng, n_frames=16, pix_noise=0.3, **tracker_kw):
    # cloud depth + density sized to the trajectory length
    scene = SyntheticScene(rng, n_points=max(600, 14 * n_frames),
                           max_depth=max(40.0, 0.45 * n_frames + 30.0))
    tracker = Tracker(CFG, INTR, **tracker_kw)
    gt = []
    for k in range(n_frames):
        feats, (R, t) = scene.features(k, pix_noise=pix_noise)
        tracker.process_features(feats, k)
        Rcw = R.T
        c = -R.T @ t
        gt.append(np.concatenate([Rcw, c[:, None]], 1))
    return tracker, np.stack(gt)


def test_tracker_bootstrap_and_init(rng):
    tracker, gt = run_sequence(rng, n_frames=4)
    assert tracker.frames[0].is_keyframe
    assert tracker.map.lm_valid.sum() > 100, "two-view init failed"
    assert len(tracker.map.kf_order) >= 2


def test_tracker_trajectory_accuracy(rng):
    tracker, gt = run_sequence(rng, n_frames=16)
    ok = [f.tracking_ok for f in tracker.frames]
    assert all(ok), f"tracking lost at frames {np.nonzero(~np.array(ok))[0]}"
    est = tracker.trajectory()
    ate = ate_rmse(centers_from_poses(est), centers_from_poses(gt))
    # scene scale: ~7m of travel; demand cm-level after Sim3 alignment
    assert ate < 0.15, f"ATE {ate:.3f}"
    t_rmse, r_rmse = rpe(est, gt)
    assert r_rmse < 0.5, f"RPE rot {r_rmse:.3f} deg"


def test_tracker_window_slides(rng):
    tracker, gt = run_sequence(rng, n_frames=40)
    assert len(tracker.map.kf_order) <= CFG.ba.max_cameras
    n_kf = sum(f.is_keyframe for f in tracker.frames)
    assert n_kf > CFG.ba.max_cameras, "window never slid"
    est = tracker.trajectory()
    ate = ate_rmse(centers_from_poses(est), centers_from_poses(gt))
    assert ate < 0.5, f"ATE {ate:.3f} after sliding"


def test_tracker_ba_helps_under_noise(rng):
    """At realistic pixel noise, windowed BA should improve (or at least not
    meaningfully hurt) the trajectory vs pure PnP odometry."""
    t_ba, gt = run_sequence(rng, n_frames=12, pix_noise=1.5, run_ba=True)
    t_no, _ = run_sequence(np.random.default_rng(0), n_frames=12,
                           pix_noise=1.5, run_ba=False)
    a_ba = ate_rmse(centers_from_poses(t_ba.trajectory()),
                    centers_from_poses(gt))
    a_no = ate_rmse(centers_from_poses(t_no.trajectory()),
                    centers_from_poses(gt))
    assert a_ba < 0.2 and a_no < 0.3, (a_ba, a_no)
    assert a_ba <= a_no * 1.2 + 0.02, (a_ba, a_no)


def test_keyframe_trajectory_export(rng):
    tracker, gt = run_sequence(rng, n_frames=12)
    ids, poses = tracker.keyframe_trajectory()
    assert len(ids) == len(poses) > 2
    assert poses.shape[1:] == (3, 4)
    # keyframe ids must be a subset of processed frames, increasing
    assert (np.diff(ids) > 0).all()


def test_process_batch_equals_sequential(rng):
    """Batched detection + tracking must produce equivalent results to
    per-frame processing.

    What batching guarantees: identical keypoints and near-identical
    descriptors (vmapped convs reduce in a different order, so descriptor
    floats differ at the 1e-7 level). That epsilon can flip a near-tied
    ratio-test match, so downstream poses are compared statistically (same
    trajectory to within a small fraction of its length), not bitwise."""
    from visualslam.io.kitti import SyntheticSequence

    seq = SyntheticSequence(num_frames=8, h=120, w=160, n_dots=400)
    info = seq.info()
    cfg = CFG.replace(pyramid=CFG.pyramid.replace(num_octaves=2),
                      sift=CFG.sift.replace(max_keypoints_per_octave=256,
                                            max_keypoints=512))
    t1 = Tracker(cfg, info.intrinsics)
    feats_seq = []
    for k in range(len(seq)):
        f = t1._frontend(jnp.asarray(seq.frame(k), jnp.float32))
        feats_seq.append(f)
        t1.process_features(f, k)

    t2 = Tracker(cfg, info.intrinsics)
    imgs = np.stack([seq.frame(k) for k in range(len(seq))])
    t2.process_batch(imgs[:4], 0)
    t2.process_batch(imgs[4:], 4)

    # the hard contract: batched detection finds (essentially) the same
    # keypoint set.  vmapped convs reduce in a different order, so responses
    # differ ~1e-7 and near-tied top-k boundaries can swap — require >=95%
    # set overlap within half a pixel rather than bitwise order equality.
    fb = t2.detect_batch(imgs)
    for k, f in enumerate(feats_seq):
        g = Tracker.features_at(fb, k)
        a = np.asarray(f.keypoints.yx)[np.asarray(f.keypoints.valid)]
        b = np.asarray(g.keypoints.yx)[np.asarray(g.keypoints.valid)]
        assert abs(len(a) - len(b)) <= max(2, 0.05 * len(a))
        d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
        overlap = (d.min(axis=1) < 0.5).mean()
        assert overlap >= 0.95, f"frame {k}: only {overlap:.0%} overlap"

    # the soft contract: same trajectory up to chaotic epsilon amplification
    total = sum(np.linalg.norm(a.t - b.t)
                for a, b in zip(t1.frames[1:], t2.frames[1:]))
    path = max(np.linalg.norm(t1.frames[-1].t), 1e-6)
    assert total / (len(t1.frames) * path) < 0.25


def test_orb_frontend_metric_autoswitch():
    cfg = CFG.replace(frontend="orb")
    assert cfg.match.metric == "l2"
    t = Tracker(cfg, INTR)
    assert t.cfg.match.metric == "hamming"


def test_loop_closer_unpacks_orb_bits(rng):
    from visualslam.slam.loop_closure import LoopCloser

    lc = LoopCloser(INTR, CFG.match.replace(metric="hamming"),
                    CFG.pose_graph, sub_keypoints=32)
    cap = 64
    desc = rng.integers(0, 2**32, (cap, 8), dtype=np.uint32)
    kps = Keypoints.empty(cap)._replace(
        yx=jnp.asarray(rng.uniform(0, 100, (cap, 2)).astype(np.float32)),
        valid=jnp.ones(cap, bool), response=jnp.ones(cap, jnp.float32))
    feats = Features(kps, jnp.asarray(desc))
    idx = lc.add_keyframe(0, np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32), feats,
                          np.full(cap, -1), np.zeros((1, 3), np.float32))
    e = lc.entries[idx]
    assert e.desc.shape == (32, 256)       # unpacked bits
    assert set(np.unique(e.desc)) <= {0.0, 1.0}
    assert lc.match_cfg.metric == "l2"


def test_tracking_loss_recovery(rng):
    """Sustained tracking loss (garbage frames) triggers re-initialization;
    tracking resumes once real frames return."""
    scene = SyntheticScene(rng)
    tracker = Tracker(CFG, INTR)
    for k in range(6):
        feats, _ = scene.features(k)
        tracker.process_features(feats, k)

    def garbage(k):
        cap = scene.cap
        desc = rng.standard_normal((cap, 64)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        kps = Keypoints.empty(cap)._replace(
            yx=jnp.asarray(rng.uniform(10, 400, (cap, 2)).astype(np.float32)),
            valid=jnp.ones(cap, bool))
        return Features(kps, jnp.asarray(desc))

    for k in range(6, 14):
        tracker.process_features(garbage(k), k)
    assert tracker.relocalizations >= 1, "never re-initialized"

    # back to the real scene (scene jumped; mapping restarts from scratch)
    ok_after = []
    for k in range(14, 26):
        feats, _ = scene.features(k)
        res = tracker.process_features(feats, k)
        ok_after.append(res.tracking_ok)
    assert any(ok_after[3:]), "tracking never recovered after re-init"
    assert tracker.map.lm_valid.sum() > 50, "map not rebuilt"


def test_pipelined_equals_sequential_batched():
    """The stage-overlapped pipeline (parallel/pipeline.py) must produce
    bit-identical trajectories to sequential per-frame processing: the
    same jitted frontend runs on the same inputs and features are consumed
    in the same order — only dispatch timing differs."""
    from visualslam.io.kitti import SyntheticSequence
    from visualslam.parallel.pipeline import pipelined_process

    seq = SyntheticSequence(num_frames=8, h=120, w=160, n_dots=400)
    info = seq.info()
    cfg = CFG.replace(pyramid=CFG.pyramid.replace(num_octaves=2),
                      sift=CFG.sift.replace(max_keypoints_per_octave=256,
                                            max_keypoints=512))
    imgs = np.stack([seq.frame(k) for k in range(len(seq))])

    t1 = Tracker(cfg, info.intrinsics)
    # same vmapped frontend AND the same chunking both sides (vmap width
    # changes reduction order -> 1e-7 descriptor drift -> chaos)
    for k in range(0, len(imgs), 3):
        fb = t1.detect_batch(imgs[k:k + 3])
        for i in range(len(imgs[k:k + 3])):
            t1.process_features(Tracker.features_at(fb, i), k + i)

    t2 = Tracker(cfg, info.intrinsics)
    results = pipelined_process(t2, imgs, batch=3)

    assert [r.frame_id for r in results] == list(range(8))
    np.testing.assert_array_equal(t1.trajectory(), t2.trajectory())


def test_process_stream_equals_process_batch():
    """The lag-1 pipelined stream (process_stream + finish) must produce
    bit-identical results to synchronous chunk-by-chunk process_batch:
    the same engine program runs on the same inputs in the same order —
    only the harvest timing differs (telemetry consumed one batch late)."""
    from visualslam.io.kitti import SyntheticSequence

    seq = SyntheticSequence(num_frames=12, h=120, w=160, n_dots=400)
    info = seq.info()
    cfg = CFG.replace(pyramid=CFG.pyramid.replace(num_octaves=2),
                      sift=CFG.sift.replace(max_keypoints_per_octave=256,
                                            max_keypoints=512))
    imgs = np.stack([seq.frame(k) for k in range(len(seq))])

    t1 = Tracker(cfg, info.intrinsics)
    for k in range(0, 12, 4):
        t1.process_batch(imgs[k:k + 4], k)

    t2 = Tracker(cfg, info.intrinsics)
    out = []
    for k in range(0, 12, 4):
        out.extend(t2.process_stream(imgs[k:k + 4], k))
    out.extend(t2.finish())

    assert sorted(r.frame_id for r in out) == list(range(12))
    assert len(t2.frames) == 12
    np.testing.assert_array_equal(t1.trajectory(), t2.trajectory())
    assert sum(f.is_keyframe for f in t1.frames) == sum(
        f.is_keyframe for f in t2.frames)


def test_async_ba_matches_sync(rng):
    """async_ba defers the window-BA writeback by one keyframe (stage
    overlap). The trajectory must stay close to the synchronous result —
    same problems, one-keyframe-later application."""
    cfg_async = CFG.replace(ba=CFG.ba.replace(async_ba=True))
    scene = SyntheticScene(np.random.default_rng(3))
    t_sync = Tracker(CFG, INTR)
    t_async = Tracker(cfg_async, INTR)
    gt = []
    for k in range(14):
        feats, (R, t) = scene.features(k)
        # identical features to both trackers
        t_sync.process_features(feats, k)
        t_async.process_features(feats, k)
        gt.append(np.concatenate([R.T, (-R.T @ t)[:, None]], 1))
    from visualslam.slam.evaluation import ate_rmse, centers_from_poses

    gt = np.stack(gt)
    a_sync = ate_rmse(centers_from_poses(t_sync.trajectory()),
                      centers_from_poses(gt))
    a_async = ate_rmse(centers_from_poses(t_async.trajectory()),
                       centers_from_poses(gt))
    assert a_async < max(2.0 * a_sync, 0.05), (a_sync, a_async)
    # the deferred writeback must actually have landed
    assert t_async.last_ba_cost >= 0


def test_tracker_distributed_window_ba(rng):
    """Tracker(mesh=...) runs the window BA trajectory-sharded across the
    CPU mesh; the trajectory must match the single-device tracker within
    solver tolerance."""
    from visualslam.parallel.mesh import make_mesh
    from visualslam.slam.evaluation import ate_rmse, centers_from_poses

    cfg = CFG.replace(ba=CFG.ba.replace(max_cameras=8, cg_iters=48))
    scene = SyntheticScene(np.random.default_rng(5))
    mesh = make_mesh(4, axis="shard")
    t_single = Tracker(cfg, INTR)
    t_dist = Tracker(cfg, INTR, mesh=mesh)
    gt = []
    for k in range(12):
        feats, (R, t) = scene.features(k)
        t_single.process_features(feats, k)
        t_dist.process_features(feats, k)
        gt.append(np.concatenate([R.T, (-R.T @ t)[:, None]], 1))
    gt = np.stack(gt)
    a1 = ate_rmse(centers_from_poses(t_single.trajectory()),
                  centers_from_poses(gt))
    a2 = ate_rmse(centers_from_poses(t_dist.trajectory()),
                  centers_from_poses(gt))
    assert t_dist.last_ba_cost >= 0, "distributed BA never ran"
    assert a2 < max(2.0 * a1, 0.05), (a1, a2)


def test_tracker_100_frame_ate_regression(rng):
    """Pinned sequence-scale accuracy (VERDICT r1 item 4): 100 frames of
    the injected-feature scene, local-map tracking + windowed BA. Config =
    test CFG (keyframe_max_gap=4, 6-camera window); bound chosen ~2x the
    measured ATE at introduction so real regressions fail, noise doesn't."""
    tracker, gt = run_sequence(rng, n_frames=100)
    from visualslam.slam.evaluation import ate_rmse, centers_from_poses

    ok = [f.tracking_ok for f in tracker.frames]
    assert np.mean(ok) > 0.97, "tracking lost"
    inl = np.asarray([f.num_inliers for f in tracker.frames[2:]])
    # local-map tracking: inlier counts must NOT decay monotonically —
    # the last quarter holds up against the first quarter
    q = len(inl) // 4
    assert inl[-q:].mean() > 0.5 * inl[:q].mean(), (
        inl[:q].mean(), inl[-q:].mean())
    ate = ate_rmse(centers_from_poses(tracker.trajectory()),
                   centers_from_poses(gt))
    assert ate < 0.8, f"100-frame ATE regression: {ate:.3f} m"


def test_orb_tracker_end_to_end():
    """ORB frontend through the fused tracker: bit-packed descriptors flow
    through the local map + hamming matching without dtype mishaps."""
    from visualslam.io.kitti import SyntheticSequence

    seq = SyntheticSequence(num_frames=10, h=120, w=160, n_dots=500)
    info = seq.info()
    cfg = CFG.replace(
        frontend="orb",
        orb=CFG.orb.replace(num_levels=4, max_keypoints=512),
        keyframe_min_inliers=20,
        ransac=CFG.ransac.replace(inlier_threshold=4e-3))
    t = Tracker(cfg, info.intrinsics)
    assert t.cfg.match.metric == "hamming"
    imgs = np.stack([seq.frame(k) for k in range(len(seq))])
    res = t.process_batch(imgs, 0)
    assert len(res) == 10
    # the map must have initialized and tracked at least some frames
    assert t.map.lm_valid.sum() > 20, "ORB two-view init failed"
    ok = [r.tracking_ok for r in res]
    assert sum(ok) >= 6, f"ORB tracking mostly lost: {ok}"
