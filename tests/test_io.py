"""IO tests: reference-format serialization, KITTI pose files, synthetic
sequence, checkpoint round-trip."""

import os

import numpy as np

from visualslam.io.kitti import SyntheticSequence
from visualslam.io.serialization import (
    load_descriptors_dat,
    load_kitti_poses,
    save_descriptors_dat,
    save_kitti_poses,
)


def test_descriptor_dat_roundtrip(tmp_path, rng):
    d = rng.random((37, 128)).astype(np.float32)
    p = str(tmp_path / "desc.dat")
    save_descriptors_dat(p, d)
    # header: 3 int32 then raw float32 (ref Diff_of_Gauss.cpp:845-848)
    raw = np.fromfile(p, np.int32, count=3)
    assert raw[0] == 37 and raw[1] == 128
    back = load_descriptors_dat(p)
    np.testing.assert_array_equal(back, d)


def test_descriptor_dat_accepts_reference_quirk(tmp_path, rng):
    """The reference writes frontSize = sizeof(std::vector<float>) = 24."""
    import struct

    d = rng.random((3, 128)).astype(np.float32)
    p = str(tmp_path / "ref.dat")
    with open(p, "wb") as f:
        f.write(struct.pack("<iii", 3, 128, 24))
        f.write(d.tobytes())
    np.testing.assert_array_equal(load_descriptors_dat(p), d)


def test_kitti_poses_roundtrip(tmp_path, rng):
    poses = rng.random((11, 3, 4))
    p = str(tmp_path / "poses.txt")
    save_kitti_poses(p, poses)
    back = load_kitti_poses(p)
    np.testing.assert_allclose(back, poses, rtol=1e-6)


def test_synthetic_sequence_properties():
    seq = SyntheticSequence(num_frames=5, h=120, w=160, n_dots=300)
    assert len(seq) == 5
    f0 = seq.frame(0)
    assert f0.shape == (120, 160)
    assert 0.0 <= f0.min() and f0.max() <= 1.0
    assert f0.std() > 0.02, "synthetic frames must have texture"
    info = seq.info()
    assert info.gt_poses.shape == (5, 3, 4)
    # frames actually differ (camera moves)
    assert np.abs(seq.frame(2) - f0).max() > 0.1


def test_checkpoint_roundtrip(tmp_path, rng):
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_tracker import CFG, INTR, SyntheticScene

    from visualslam.slam.checkpoint import load_checkpoint, save_checkpoint
    from visualslam.slam.tracker import Tracker

    scene = SyntheticScene(rng)
    t1 = Tracker(CFG, INTR)
    for k in range(8):
        feats, _ = scene.features(k)
        t1.process_features(feats, k)
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, t1)

    t2 = Tracker(CFG, INTR)
    load_checkpoint(p, t2)
    np.testing.assert_array_equal(t2.map.kf_valid, t1.map.kf_valid)
    np.testing.assert_allclose(t2.map.X, t1.map.X)
    assert len(t2.frames) == len(t1.frames)

    # both trackers must continue identically
    for k in range(8, 12):
        feats, _ = scene.features(k)
        r1 = t1.process_features(feats, k)
        r2 = t2.process_features(feats, k)
        np.testing.assert_allclose(r1.t, r2.t, atol=1e-5)


def test_kitti_loader_layout(tmp_path, rng):
    """KittiOdometrySequence reads the standard KITTI odometry layout."""
    from PIL import Image

    seqdir = tmp_path / "sequences" / "07"
    imgdir = seqdir / "image_0"
    imgdir.mkdir(parents=True)
    H, W = 48, 64
    for i in range(4):
        arr = (rng.random((H, W)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(imgdir / f"{i:06d}.png")
    P = "7.070912e+02 0.000000e+00 6.018873e+02 0.000000e+00 " \
        "0.000000e+00 7.070912e+02 1.831104e+02 0.000000e+00 " \
        "0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00"
    with open(seqdir / "calib.txt", "w") as f:
        for k in range(4):
            f.write(f"P{k}: {P}\n")
    np.savetxt(seqdir / "times.txt", np.arange(4) * 0.1)
    posedir = tmp_path / "poses"
    posedir.mkdir()
    poses = np.tile(np.eye(3, 4), (4, 1, 1))
    poses[:, 2, 3] = np.arange(4) * 0.8
    from visualslam.io.serialization import save_kitti_poses

    save_kitti_poses(str(posedir / "07.txt"), poses)

    from visualslam.io.kitti import KittiOdometrySequence

    seq = KittiOdometrySequence(str(tmp_path), "07")
    assert len(seq) == 4
    info = seq.info()
    np.testing.assert_allclose(info.intrinsics,
                               [707.0912, 707.0912, 601.8873, 183.1104],
                               rtol=1e-6)
    assert info.image_size == (H, W)
    np.testing.assert_allclose(info.gt_poses[:, 2, 3],
                               np.arange(4) * 0.8)
    frames = list(seq.frames())  # exercises the native prefetcher path
    assert len(frames) == 4
    assert frames[0].shape == (H, W)
    np.testing.assert_allclose(frames[1], seq.frame(1), atol=1e-6)


def test_checkpoint_keeps_loop_corrections(tmp_path):
    """A resumed map carries the pose-graph-corrected keyframe poses, the
    closure count and the closure cooldown, so global BA after a resume
    starts from the same problem as without it."""
    from visualslam.slam.checkpoint import load_checkpoint, save_checkpoint
    from visualslam.slam.tracker import Tracker
    from visualslam.utils.config import DEFAULT_CONFIG

    intr = np.asarray([300.0, 300.0, 160.0, 120.0], np.float32)
    t = Tracker(DEFAULT_CONFIG, intr)
    rng = np.random.default_rng(3)
    for fid in (0, 5, 9):
        t.loop_closer.add_keyframe_light(fid, np.eye(3, dtype=np.float32),
                                         rng.normal(size=3).astype(np.float32))
    corr = [(np.eye(3, dtype=np.float32), rng.normal(size=3).astype(
        np.float32)) for _ in range(3)]
    t.loop_closer.corrected = corr
    t.num_loop_closures = 2
    t._loop_cooldown_until = 7
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, t)

    t2 = Tracker(DEFAULT_CONFIG, intr)
    load_checkpoint(path, t2)
    assert t2.num_loop_closures == 2 and t2._loop_cooldown_until == 7
    got = t2.loop_corrections()
    assert sorted(got) == [0, 5, 9]
    for fid, (R, tt) in zip((0, 5, 9), corr):
        np.testing.assert_array_equal(got[fid][0], R)
        np.testing.assert_array_equal(got[fid][1], tt)
