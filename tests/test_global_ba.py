"""Full-sequence global BA (slam/global_ba.py): the archive must retain the
evicted keyframes' observation graph, and optimizing it must improve (or at
least not hurt) the full trajectory."""

import numpy as np

from visualslam.slam.evaluation import ate_rmse, centers_from_poses
from visualslam.slam.global_ba import build_global_problem, run_global_ba

from test_tracker import CFG, run_sequence


def test_archive_accumulates(rng):
    tracker, gt = run_sequence(rng, n_frames=40)
    m = tracker.map
    n_kf = sum(f.is_keyframe for f in tracker.frames)
    assert len(m.archive) == n_kf - len(m.kf_order)
    # archived observations are uid-keyed and nonempty for interior kfs
    assert sum(len(a.lm_uid) for a in m.archive) > 100
    # archived landmark snapshots exist for dead landmarks
    assert len(m.archived_lm_pos) > 0


def test_global_problem_covers_history(rng):
    tracker, gt = run_sequence(rng, n_frames=40)
    p, fids = build_global_problem(tracker.map)
    n_kf = sum(f.is_keyframe for f in tracker.frames)
    assert len(fids) == n_kf
    assert (np.diff(fids) > 0).all()
    assert int(np.asarray(p.obs_valid).sum()) > 500


def test_global_ba_improves_trajectory(rng):
    tracker, gt = run_sequence(rng, n_frames=40, pix_noise=1.0)
    ate_before = ate_rmse(centers_from_poses(tracker.trajectory()),
                          centers_from_poses(gt))
    res = tracker.global_ba()
    assert res.cost < res.initial_cost
    ate_after = ate_rmse(centers_from_poses(tracker.trajectory()),
                         centers_from_poses(gt))
    assert ate_after < ate_before * 1.05 + 0.01, (ate_before, ate_after)


def test_global_ba_sharded_matches_single(rng):
    tracker, gt = run_sequence(rng, n_frames=40)
    res1 = tracker.global_ba()

    from visualslam.parallel.mesh import make_mesh

    tracker2, _ = run_sequence(np.random.default_rng(0), n_frames=40)
    mesh = make_mesh(4, axis="shard")
    res2 = tracker2.global_ba(mesh=mesh)
    assert res2.n_cameras == res1.n_cameras
    # same optimum within solver tolerance (dense direct vs distributed CG;
    # monocular scale is a gauge freedom the two solvers may pick
    # differently, so compare Sim3-aligned camera centers)
    np.testing.assert_allclose(res2.cost, res1.cost, rtol=0.2)
    c1 = np.stack([-R.T @ t for R, t in zip(res1.R, res1.t)])
    c2 = np.stack([-R.T @ t for R, t in zip(res2.R, res2.t)])
    assert ate_rmse(c2, c1) < 0.03


def test_uid_validation_rejects_recycled_slots(rng):
    """An observation recorded before its landmark slot was recycled must
    not survive into BA arrays or the archive."""
    from visualslam.slam.map_state import SlamMap

    m = SlamMap(window=3, max_landmarks=8, feat_capacity=16)
    s0, _ = m.allocate_keyframe()
    m.set_keyframe(s0, 0, np.eye(3, dtype=np.float32),
                   np.zeros(3, np.float32), np.zeros((16, 4), np.float32),
                   np.zeros((16, 2), np.float32), np.ones(16, bool))
    lm = m.allocate_landmarks(rng.normal(size=(8, 3)))
    m.add_observations(s0, lm, rng.normal(size=(8, 2)).astype(np.float32))
    # kill all landmarks, then reuse every slot for NEW landmarks
    m.lm_valid[:] = False
    lm2 = m.allocate_landmarks(rng.normal(size=(8, 3)))
    assert (m.lm_uid[lm2] >= 8).all()
    # s0's recorded observations refer to the OLD uids -> must be dropped
    (slots, R, t, lm_slots, X, cam_idx, lm_idx, uv,
     valid) = m.build_ba_arrays(max_obs=64)
    assert valid.sum() == 0
