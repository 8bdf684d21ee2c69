"""Benchmark harness (SURVEY.md §6: the baseline the reference never had).

Measures per-stage device time and end-to-end throughput on the current
jax.devices()[0], which must be a GPU:

  pyramid      build_pyramid on a KITTI-sized frame
  frontend     full SIFT detect+describe
  orb          full ORB detect+describe
  match        1024x1024 descriptor matching (L2 + ratio + mutual)
  ransac       512-hypothesis essential RANSAC on 512 matches
  ba           10-camera / 4k-landmark / 16k-observation LM iteration
  pnp          motion-only refinement, 512 points

Each timed call ends in a host readback of a scalar that depends on all
of its outputs. Prints one JSON object of stage times in ms.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _time(fn, args_list, warmup=2, iters=8):
    for i in range(warmup):
        float(fn(*args_list[i % len(args_list)]))
    ts = []
    for i in range(iters):
        a = args_list[(i + warmup) % len(args_list)]
        t0 = time.perf_counter()
        float(fn(*a))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def run_benchmarks(full: bool = False, h: int = 376, w: int = 1248) -> dict:
    import jax
    import jax.numpy as jnp

    from visualslam.backend.ba import run_ba
    from visualslam.backend.pnp import refine_pose
    from visualslam.frontend import detect_and_describe
    from visualslam.geometry.ransac import estimate_relative_pose
    from visualslam.models.matching import match_features
    from visualslam.models.orb import detect_and_describe_orb
    from visualslam.models.pyramid import build_pyramid
    from visualslam.models.types import Features, Keypoints
    from visualslam.utils.config import DEFAULT_CONFIG

    cfg = DEFAULT_CONFIG
    rng = np.random.default_rng(0)
    imgs = [jnp.asarray(rng.random((h, w), dtype=np.float32))
            for _ in range(4)]
    results: dict[str, float] = {}
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"the harness measures on a GPU; JAX's default device is "
                 f"{dev.platform}")
    print(f"[bench] device={dev.device_kind} image={h}x{w}", file=sys.stderr)

    def scalar(tree):
        return sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(tree)
                   if jnp.issubdtype(x.dtype, jnp.floating))

    # pyramid
    f = jax.jit(lambda im: scalar(build_pyramid(im, cfg.pyramid)))
    results["pyramid_ms"] = _time(f, [(i,) for i in imgs]) * 1e3

    # frontends
    f = jax.jit(lambda im: scalar(detect_and_describe(im, cfg)))
    results["sift_frontend_ms"] = _time(f, [(i,) for i in imgs]) * 1e3
    f = jax.jit(lambda im: scalar(detect_and_describe_orb(im, cfg.orb)))
    results["orb_frontend_ms"] = _time(f, [(i,) for i in imgs]) * 1e3

    # matching (1024 x 1024, 128-D)
    def feats(seed):
        d = np.random.default_rng(seed).standard_normal((1024, 128))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        kps = Keypoints.empty(1024)._replace(valid=jnp.ones(1024, bool))
        return Features(kps, jnp.asarray(d, jnp.float32))

    fs = [feats(i) for i in range(4)]
    f = jax.jit(lambda a, b: scalar(match_features(a, b, cfg.match)))
    results["match_ms"] = _time(
        f, [(fs[i], fs[(i + 1) % 4]) for i in range(4)]) * 1e3

    # RANSAC (512 matches, 512 hypotheses)
    def ransac_args(seed):
        r = np.random.default_rng(seed)
        X = r.uniform([-2, -2, 4], [2, 2, 10], (512, 3))
        x1 = X[:, :2] / X[:, 2:]
        X2 = X + np.array([0.3, 0, 0])
        x2 = X2[:, :2] / X2[:, 2:]
        return (jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32),
                jnp.ones(512, bool), jax.random.PRNGKey(seed))

    f = jax.jit(lambda x1, x2, v, k: scalar(
        estimate_relative_pose(x1, x2, v, cfg.ransac, k)[:3]))
    results["ransac_ms"] = _time(f, [ransac_args(i) for i in range(4)]) * 1e3

    # BA: 10 cams, 4096 landmarks, 16384 obs, one LM iteration
    results.update(_bench_ba(run_ba, cfg, _time))

    # rotated-window sampling: the one micro-benchmark the reference ships
    # (rotate_image_test.cpp:73-94 times 16x16 rotated-ROI extraction)
    from visualslam.ops.patches import extract_rotated_patches

    def rot_args(seed):
        r = np.random.default_rng(seed)
        img = jnp.asarray(r.random((512, 512), dtype=np.float32))
        yx = jnp.asarray(r.uniform(20, 490, (512, 2)).astype(np.float32))
        ang = jnp.asarray(r.uniform(0, 360, 512).astype(np.float32))
        return img, yx, ang

    f = jax.jit(lambda im, yx, a: jnp.sum(
        extract_rotated_patches(im, yx, a, 16)))
    results["rotated_patch_512x16x16_ms"] = _time(
        f, [rot_args(i) for i in range(4)]) * 1e3

    # PnP
    def pnp_args(seed):
        r = np.random.default_rng(seed)
        X = r.uniform([-2, -2, 4], [2, 2, 10], (512, 3)).astype(np.float32)
        uv = X[:, :2] / X[:, 2:]
        return (jnp.eye(3), jnp.zeros(3), jnp.asarray(X),
                jnp.asarray(uv, jnp.float32), jnp.ones(512, bool))

    f = jax.jit(lambda R, t, X, uv, v: scalar(
        refine_pose(R, t, X, uv, v)[:2]))
    results["pnp_ms"] = _time(f, [pnp_args(i) for i in range(4)]) * 1e3

    for k, v in results.items():
        print(f"[bench] {k:22s} {v:10.3f}", file=sys.stderr)
    print(json.dumps({"device": dev.device_kind, "image": f"{h}x{w}",
                      **results}))
    return results


def _bench_ba(run_ba, cfg, timer):
    import jax
    import jax.numpy as jnp

    from visualslam.backend.ba import BAProblem
    from visualslam.utils.config import BAConfig

    C, L, O = 10, 4096, 16384

    def prob(seed):
        r = np.random.default_rng(seed)
        X = r.uniform([-5, -5, 5], [5, 5, 30], (L, 3)).astype(np.float32)
        Rm = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        t = np.zeros((C, 3), np.float32)
        t[:, 0] = np.arange(C) * 0.2
        cam = r.integers(0, C, O)
        lm = r.integers(0, L, O)
        pc = X[lm] + t[cam][:, :]
        uv = pc[:, :2] / pc[:, 2:]
        return BAProblem(
            R=jnp.asarray(Rm), t=jnp.asarray(t),
            X=jnp.asarray(X + r.normal(0, 0.05, X.shape).astype(np.float32)),
            cam_idx=jnp.asarray(cam, jnp.int32),
            lm_idx=jnp.asarray(lm, jnp.int32),
            uv=jnp.asarray(uv, jnp.float32),
            obs_valid=jnp.ones(O, bool),
            cam_valid=jnp.ones(C, bool), lm_valid=jnp.ones(L, bool))

    ba_cfg = BAConfig(iters=1, max_cameras=C, max_landmarks=L,
                      max_observations=O)
    f = jax.jit(lambda p: run_ba(p, ba_cfg).cost)
    ms = timer(f, [(prob(i),) for i in range(3)]) * 1e3
    return {"ba_iter_ms": ms, "ba_iters_per_s": 1000.0 / ms}


if __name__ == "__main__":
    run_benchmarks()
