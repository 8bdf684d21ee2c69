"""CLI surface tests: detect / run / eval drive the real entry points."""

import json
import os
import sys

import numpy as np
import pytest

from visualslam.cli import main


def test_cli_detect_writes_outputs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    main(["detect", "/root/reference/KeyPointDetection/images/blox.jpg",
          "--frontend", "harris", "--out", "blox"])
    assert os.path.exists("blox_keypoints.png")
    assert os.path.exists("blox_descriptors.dat")
    from visualslam.io.serialization import load_descriptors_dat

    d = load_descriptors_dat("blox_descriptors.dat")
    assert d.shape[0] > 10


def test_cli_run_and_eval_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # without --plot, `run` needs no Pillow
    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "PIL", None)
    main(["run", "--synthetic", "10", "--batch", "4",
          "--out", "est.txt", "--metrics", "m.jsonl"])
    assert os.path.exists("est.txt")
    assert not os.path.exists("trajectory.png")
    rows = [json.loads(l) for l in open("m.jsonl")]
    assert len(rows) == 10
    # eval against itself -> ~zero error
    import contextlib
    import io as _io

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["eval", "est.txt", "est.txt"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert res["ate_m"] < 1e-9
    assert res["frames"] == 10


def test_viz_outputs(tmp_path, rng):
    from visualslam.models.types import Features, Keypoints
    from visualslam.slam.viz import draw_keypoints, draw_trajectory
    import jax.numpy as jnp

    img = rng.random((64, 64)).astype(np.float32)
    k = 16
    kps = Keypoints.empty(k)._replace(
        yx=jnp.asarray(rng.uniform(5, 59, (k, 2)).astype(np.float32)),
        sigma=jnp.ones(k), valid=jnp.ones(k, bool))
    feats = Features(kps, jnp.zeros((k, 8)))
    p1 = str(tmp_path / "kp.png")
    draw_keypoints(img, feats, p1)
    assert os.path.getsize(p1) > 100

    poses = np.tile(np.eye(3, 4, dtype=np.float64), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5)
    p2 = str(tmp_path / "traj.png")
    draw_trajectory(poses, p2, gt=poses)
    assert os.path.getsize(p2) > 100


def test_umeyama_known_transform(rng):
    from visualslam.slam.evaluation import umeyama_alignment

    src = rng.standard_normal((40, 3))
    from scipy.spatial.transform import Rotation

    R = Rotation.from_euler("xyz", [0.3, -0.2, 1.0]).as_matrix()
    s, t = 2.5, np.array([1.0, -2.0, 3.0])
    dst = s * src @ R.T + t
    s2, R2, t2 = umeyama_alignment(src, dst)
    np.testing.assert_allclose(s2, s, rtol=1e-6)
    np.testing.assert_allclose(R2, R, atol=1e-6)
    np.testing.assert_allclose(t2, t, atol=1e-6)


def test_cli_run_pipelined(tmp_path, monkeypatch):
    """--pipeline (stage-overlapped dispatch) must run the full sequence and
    produce the same number of pose rows as the sequential path."""
    monkeypatch.chdir(tmp_path)
    main(["run", "--synthetic", "10", "--batch", "4", "--pipeline",
          "--out", "est_p.txt", "--metrics", "mp.jsonl"])
    assert os.path.exists("est_p.txt")
    rows = [json.loads(l) for l in open("mp.jsonl")]
    assert len(rows) == 10


def test_cli_run_plot_option(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    main(["run", "--synthetic", "6", "--batch", "3", "--out", "est.txt",
          "--plot", "traj.png", "--no-prewarm"])
    from PIL import Image

    assert Image.open("traj.png").size[0] > 0
