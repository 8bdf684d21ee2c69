"""Smoke test of the SLAM main path on one NVIDIA GPU.

    python chip_smoke.py            # phases (a)-(e) on one card
    python chip_smoke.py --multi    # the four-card sharded-BA path only

Phases, in one process (any failure raises and exits non-zero):

  (a) device      the default JAX device must be a GPU; prints its kind,
                  the device count and `nvidia-smi`'s name and power limit
  (b) kernels     the fused Triton orientation/descriptor kernels against
                  the plain XLA form (float32 at HIGHEST precision) at an
                  octave-0 capacity of 1024 keypoints of rendered 376x1248
                  frames; warm times of both forms, and of the XLA stages
                  whose kernels were retired (detect, pyramid blur, 2-NN
                  matching) as the bar a future kernel must beat
  (c) frontend    one batch of 16 frames through detect_and_describe on the
                  GPU against the same frames on the in-process CPU device
  (d) main path   bench.py's world: 8 bootstrap frames, 96 frames through
                  Tracker.process_stream in batches of 16, finish()
  (e) loop world  two laps, 256 frames at 376x1248: loop closures, then one
                  single-device global BA

--ab adds an end-to-end comparison: the frontend batch and the main path
with the fused kernels against their XLA form, timed in turns.

--multi runs only: make_mesh(4); trajectory-sharded global BA on the
phase-(e) map against single-device global BA (its CG form) on the same
map; landmark-
sharded BA on that map against the single-device dense solver; and
trajectory-sharded matrix-free BA at benchmarks/ba_scale.py's size (1024
cameras, 32k landmarks) against backend/ba.py on one card. `--map PATH`
loads the phase-(e) map from a checkpoint (`--save-map PATH` on a
one-card run writes it) instead of tracking the loop world again.

The last line of stdout is one JSON object: {"ok": true, "device": {...}}.
Frame rates printed here are observations of one run, not claims.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

H, W, BATCH = 376, 1248, 16
BENCH_WORLD = dict(num_frames=104, h=H, w=W, n_dots=8000, step=0.4)
WARM_WORLD = dict(num_frames=24, h=H, w=W, n_dots=8000, step=0.4, seed=7)
LOOP_WORLD = dict(num_frames=256, h=H, w=W, n_dots=12000, step=0.4,
                  trajectory="loop", laps=2)

# Kernel vs XLA tolerance, relative to the largest histogram entry. Both
# forms sample float32 levels and accumulate in float32; they differ in
# summation order (bilinear corners vs tent-weight matmuls) and in the
# rounding of rotated sample positions, ~1e-6 relative per sample. 1e-3
# leaves room for a sample whose angle lands within rounding of a bin
# edge.
KERNEL_RTOL = 1e-3
BENCH_ATE_M = 1.5       # bench-96 ATE bound: this world's runs on an H100
#                         measured 0.87-1.16 m (tracking amplifies run-to-
#                         run rounding differences; PERF.md)
LOOP_ATE_M = 2.5
SHARD_POSE_TOL = 1e-2   # sharded vs single BA: Sim(3)-aligned RMS camera-
#                         center difference, as a fraction of the
#                         trajectory's extent


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg) -> None:
    """A failed check ends the run with a non-zero exit."""
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str):
    """Decorator: print a phase's start, its wall time and its result."""
    def wrap(fn):
        def run(*a, **kw):
            log(f"[{name}] start")
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
            return out
        return run
    return wrap


def timed(fn, *args, reps: int = 5) -> float:
    """Median warm seconds of fn(*args); each call ends in
    block_until_ready. The first call compiles and is not counted."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# -- frames are rendered on the host by a pool of worker processes ---------

@functools.lru_cache(maxsize=4)
def _sequence(key):
    from visualslam.io.kitti import SyntheticSequence

    return SyntheticSequence(**dict(key))


def _render(job):
    kw, ks = job
    seq = _sequence(tuple(sorted(kw.items())))
    return np.stack([np.clip(seq.frame(k) * 255.0, 0, 255).astype(np.uint8)
                     for k in ks])


def render_async(pool, kw: dict, chunk: int = 8):
    """Start rendering a world's frames; .get() returns uint8 [N, H, W]."""
    n = kw["num_frames"]
    jobs = [(kw, list(range(i, min(i + chunk, n))))
            for i in range(0, n, chunk)]
    res = pool.map_async(_render, jobs)

    class _Frames:
        def get(self):
            return np.concatenate(res.get())
    return _Frames()


def gt_poses(kw: dict):
    from visualslam.io.kitti import SyntheticSequence

    info = SyntheticSequence(**kw).info()
    return info.intrinsics, info.gt_poses


def ate(tracker, gt) -> float:
    from visualslam.slam.evaluation import ate_rmse, centers_from_poses

    est = tracker.trajectory()
    return float(ate_rmse(centers_from_poses(est),
                          centers_from_poses(gt[:len(est)])))


# -- (a) ---------------------------------------------------------------------

@phase("a device")
def phase_device(expect: int) -> dict:
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX's default device is "
                         f"{d.platform} ({d.device_kind})")
    if len(devs) < expect:
        raise SystemExit(f"need {expect} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"device_kind={d.device_kind} count={len(devs)}")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# -- (b) ---------------------------------------------------------------------

def octave0_inputs(frames, cfg):
    """Per frame: octave-0 gradient levels and the detected candidates at
    an octave-0 capacity of cfg.sift.octave_capacity(0) (1024 under
    FAST_CONFIG), vmapped over the batch."""
    import jax
    import jax.numpy as jnp

    from visualslam.models.pyramid import build_pyramid
    from visualslam.ops.extrema import detect_extrema

    sc = cfg.sift

    def one(img):
        with jax.default_matmul_precision("float32"):
            ss = build_pyramid(img.astype(jnp.float32) / 255.0, cfg.pyramid)
            lvl, y, x, off, _, _ = detect_extrema(
                ss.dog[0], sc, capacity=sc.octave_capacity(0))
        glvl = lvl - ss.grad_level_offset
        yx = jnp.stack([y, x], -1).astype(jnp.float32)
        return ss.grad_mag[0], ss.grad_ori[0], glvl, yx, off
    return jax.jit(jax.vmap(one))(frames)


def xla_stage_pair(mag, ori, glvl, yx, sigma, yxf, angle):
    """The plain XLA form of both stages for one frame: patch crop + tent
    sampling + soft histograms (float32 histograms, HIGHEST precision)."""
    import jax
    import jax.numpy as jnp

    from visualslam.ops.histograms import gaussian_window, soft_histogram
    from visualslam.ops.patches import (crop_patches, rotated_grid,
                                        tent_sample_patches)

    K = yx.shape[0]
    with jax.default_matmul_precision("highest"):
        patches, py0, px0 = crop_patches(jnp.stack([mag, ori], -1), glvl,
                                         yx, 28)
        offs = jnp.arange(16, dtype=jnp.float32) - 8
        gy, gx = jnp.meshgrid(offs, offs, indexing="ij")
        grid = jnp.stack([gy, gx], -1)[None]
        both = tent_sample_patches(patches, py0, px0, yx[:, None, None] + grid)
        hist = soft_histogram(both[..., 1].reshape(K, -1),
                              (both[..., 0] * gaussian_window(16, sigma))
                              .reshape(K, -1), 36, 360.0)
        b2 = tent_sample_patches(patches, py0, px0,
                                 rotated_grid(yxf, angle, 16))
        rel = jnp.mod(b2[..., 1] - angle[:, None, None], 360.0)

        def regions(a):
            return a.reshape(K, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(
                K, 16, 16)
        desc = soft_histogram(regions(rel), regions(
            b2[..., 0] * gaussian_window(16, 8.0)[None]), 8, 360.0)
    return hist, desc.reshape(K, 128)


def kernel_stage_pair(mag, ori, glvl, yx, sigma, yxf, angle, interpret=False):
    from visualslam.ops.pallas.descriptor import descriptor, orient_hist

    hist = orient_hist(mag, ori, glvl, yx, sigma, 36, interpret=interpret)
    desc = descriptor(mag, ori, glvl, yxf, angle, 4, 8, interpret=interpret)
    return hist, desc


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-12))


@phase("b kernels")
def phase_kernels(frames, cfg, interpret: bool = False, reps: int = 5):
    import jax
    import jax.numpy as jnp

    mag, ori, glvl, yx, off = octave0_inputs(jnp.asarray(frames), cfg)
    B, K = glvl.shape
    rng = np.random.default_rng(1)
    sigma = jnp.asarray(1.5 * 1.6 * 2 ** (rng.random((B, K)) * 1.5),
                        jnp.float32)
    yxf = yx + off[..., 1:]
    angle = jnp.asarray(rng.random((B, K)) * 360.0, jnp.float32)
    args = (mag, ori, glvl, yx, sigma, yxf, angle)
    log(f"kernel inputs: batch={B} keypoints/frame={K} "
        f"level stack={tuple(mag.shape[1:])}")

    ker = jax.jit(jax.vmap(lambda *a: kernel_stage_pair(
        *a, interpret=interpret)))
    ref = jax.jit(jax.vmap(xla_stage_pair))
    (hk, dk), (hx, dx) = ker(*args), ref(*args)
    e_h, e_d = rel_err(hk, hx), rel_err(dk, dx)
    log(f"orient_hist vs XLA: max rel err {e_h:.3e} (tol {KERNEL_RTOL})")
    log(f"descriptor  vs XLA: max rel err {e_d:.3e} (tol {KERNEL_RTOL})")
    check(np.isfinite(np.asarray(hk)).all() and np.isfinite(
        np.asarray(dk)).all(), "kernel output not finite")
    check(e_h <= KERNEL_RTOL and e_d <= KERNEL_RTOL, (e_h, e_d))

    out = {"orient_rel_err": e_h, "desc_rel_err": e_d}
    if reps:
        out["triton_pair_ms"] = 1e3 * timed(ker, *args, reps=reps)
        out["xla_pair_ms"] = 1e3 * timed(ref, *args, reps=reps)
        out.update(xla_stage_times(frames, cfg, reps))
        log("stage times, batch of %d frames (warm median ms): %s" % (
            B, json.dumps({k: round(v, 3) for k, v in out.items()
                           if k.endswith("_ms")})))
    return out


def xla_stage_times(frames, cfg, reps: int) -> dict:
    """Warm XLA times of the stages whose Pallas kernels were retired, at
    the main path's shapes: the bar a future Hopper kernel must beat."""
    import jax
    import jax.numpy as jnp

    from visualslam.models.matching import match_features
    from visualslam.models.pyramid import build_pyramid, level_sigmas
    from visualslam.models.types import Features, Keypoints
    from visualslam.ops.blur import blur_stack_matmul
    from visualslam.ops.extrema import detect_extrema

    pc = cfg.pyramid
    imgs = jnp.asarray(frames, jnp.float32) / 255.0

    def detect(img):
        with jax.default_matmul_precision("float32"):
            ss = build_pyramid(img, pc)
        return ss.dog

    dogs = jax.jit(jax.vmap(detect))(imgs)

    @jax.jit
    @jax.vmap
    def detect_all(*dog):
        sc = cfg.sift
        return [detect_extrema(d, sc, capacity=sc.octave_capacity(o))
                for o, d in enumerate(dog)]

    @jax.jit
    @jax.vmap
    def blur0(img):
        return blur_stack_matmul(img, level_sigmas(pc), truncate=pc.truncate)

    K = cfg.sift.max_keypoints
    rng = np.random.default_rng(2)
    d = rng.standard_normal((2, K, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def feats(x):
        return Features(Keypoints.empty(K)._replace(
            valid=jnp.ones(K, bool)), jnp.asarray(x))

    fa, fb = feats(d[0]), feats(d[1])
    match = jax.jit(lambda a, b: match_features(a, b, cfg.match))
    return {
        "xla_detect_ms": 1e3 * timed(detect_all, *dogs, reps=reps),
        "xla_blur_octave0_ms": 1e3 * timed(blur0, imgs, reps=reps),
        "xla_match_2nn_1pair_ms": 1e3 * timed(match, fa, fb, reps=reps),
    }


# -- (c) ---------------------------------------------------------------------

@phase("c frontend parity")
def phase_frontend(frames, cfg) -> dict:
    """GPU frontend (the kernel route) against the CPU device running the
    plain XLA form. Bounds: keypoint counts within 2%; >= 95% of GPU
    keypoints within 0.5 px of a CPU keypoint; median descriptor cosine of
    co-located keypoints > 0.99. The XLA form bins descriptors in bf16
    under FAST_CONFIG (hist_compute, ~1e-2), the kernels in float32, and
    the two devices reduce in different orders, so near-tied extrema and
    orientation peaks may swap: the bounds are statistical, not exact."""
    import jax
    import jax.numpy as jnp

    from visualslam.frontend import detect_and_describe

    gpu_fn = jax.jit(jax.vmap(lambda im: detect_and_describe(im, cfg)))
    fg = jax.device_get(gpu_fn(jnp.asarray(frames)))
    cpu = jax.devices("cpu")[0]
    cfg_x = cfg.replace(sift=cfg.sift.replace(patch_impl="xla"))
    cpu_fn = jax.jit(lambda im: detect_and_describe(im, cfg_x))
    # XLA:CPU programs are tied to the host's CPU features, which may
    # differ between runs: keep them out of the persistent cache
    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        fcs = [jax.device_get(cpu_fn(jax.device_put(f, cpu)))
               for f in frames]
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_on)
    cos_all, near_all, n_g, n_c = [], [], 0, 0
    for b, fc in enumerate(fcs):
        vg = fg.keypoints.valid[b]
        vc = fc.keypoints.valid
        n_g += int(vg.sum())
        n_c += int(vc.sum())
        a = fg.keypoints.yx[b][vg]
        c = fc.keypoints.yx[vc]
        dist = np.linalg.norm(a[:, None] - c[None], axis=-1)
        near_all.append(dist.min(1) < 0.5)
        j = dist.argmin(1)
        same = dist.min(1) < 1e-2
        da = fg.descriptors[b][vg][same]
        dc = fc.descriptors[vc][j[same]]
        cos_all.append((da * dc).sum(1) / np.maximum(
            np.linalg.norm(da, axis=1) * np.linalg.norm(dc, axis=1), 1e-9))
    near = float(np.concatenate(near_all).mean())
    cos = float(np.median(np.concatenate(cos_all)))
    log(f"keypoints gpu={n_g} cpu={n_c}; within 0.5 px: {near:.4f}; "
        f"median descriptor cosine: {cos:.5f}")
    check(n_c > 1000 * frames.shape[0] // 16, f"too few keypoints: {n_c}")
    check(abs(n_g - n_c) <= 0.02 * n_c, (n_g, n_c))
    check(near >= 0.95 and cos > 0.99, (near, cos))
    return {"kp_gpu": n_g, "kp_cpu": n_c, "near_frac": near,
            "median_cos": cos}


# -- (d) ---------------------------------------------------------------------

def warm_up(cfg, warm_frames, intr_warm) -> float:
    """Compile the main path's programs on a 24-frame warm-up world of the
    same shapes (another seed); returns the cold-start seconds."""
    from visualslam.slam.tracker import Tracker

    t0 = time.perf_counter()
    warm = Tracker(cfg, intr_warm)
    warm.process_batch(warm_frames[:8], 0)
    warm.process_stream(warm_frames[8:24], 8)
    warm.finish()
    return time.perf_counter() - t0


def run_bench_world(cfg, frames, intr):
    """8 bootstrap frames, then the rest through process_stream in
    batches of 16, then finish(). Returns (frames/s, tracker)."""
    from visualslam.slam.tracker import Tracker

    tracker = Tracker(cfg, intr)
    tracker.process_batch(frames[:8], 0)
    t0 = time.perf_counter()
    for k in range(8, len(frames), BATCH):
        tracker.process_stream(frames[k:k + BATCH], k)
    tracker.finish()
    return (len(frames) - 8) / (time.perf_counter() - t0), tracker


@phase("d main path")
def phase_main(warm_frames, frames, cfg, intr_warm, intr, gt) -> dict:
    import jax

    cold_s = warm_up(cfg, warm_frames, intr_warm)
    log(f"cold start (compile + 24-frame warm-up world): {cold_s:.1f} s")
    fps, tracker = run_bench_world(cfg, frames, intr)
    kfs = int(sum(f.is_keyframe for f in tracker.frames))
    err = ate(tracker, gt)
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use", -1)
    out = {"frames": len(frames) - 8, "fps": fps, "cold_s": cold_s,
           "ate_m": err, "keyframes": kfs,
           "relocalizations": tracker.relocalizations,
           "peak_bytes_in_use": int(peak)}
    log("main path: " + json.dumps(out))
    check(tracker.relocalizations == 0, "tracking was lost")
    check(kfs > 0, "no keyframes")
    check(err < BENCH_ATE_M, f"ATE {err:.3f} m >= {BENCH_ATE_M}")
    return out


@phase("ab kernel vs XLA end to end")
def phase_ab(warm_frames, frames, cfg, intr_warm, intr, gt) -> dict:
    """The frontend batch and the main path with the orientation and
    descriptor stages on the Triton kernels (patch_impl="auto") and on
    their XLA form (patch_impl="xla"), timed in turns: kernel, XLA, XLA,
    kernel."""
    import jax
    import jax.numpy as jnp

    from visualslam.frontend import detect_and_describe

    cfgs = {"triton": cfg,
            "xla": cfg.replace(sift=cfg.sift.replace(patch_impl="xla"))}
    imgs = jnp.asarray(frames[8:8 + BATCH])
    out = {}
    for name, c in cfgs.items():
        fe = jax.jit(jax.vmap(lambda im, c=c: detect_and_describe(im, c)))
        out[f"frontend_batch_ms_{name}"] = 1e3 * timed(fe, imgs, reps=9)
    # the kernel route's programs were compiled by phase (d)
    out["cold_s_xla"] = warm_up(cfgs["xla"], warm_frames, intr_warm)
    for name in ("triton", "xla", "xla", "triton"):
        fps, tracker = run_bench_world(cfgs[name], frames, intr)
        out.setdefault(f"fps_{name}", []).append(fps)
        out.setdefault(f"ate_m_{name}", []).append(ate(tracker, gt))
    log("A/B: " + json.dumps(out))
    return out


# -- (e) ---------------------------------------------------------------------

def track_loop_world(frames, cfg, intr):
    from visualslam.slam.tracker import Tracker

    tracker = Tracker(cfg, intr)
    for k in range(0, len(frames), BATCH):
        tracker.process_stream(frames[k:k + BATCH], k)
    tracker.finish()
    return tracker


@phase("e loop world")
def phase_loop(frames, cfg, intr, gt, save_map: str | None = None) -> dict:
    t0 = time.perf_counter()
    tracker = track_loop_world(frames, cfg, intr)
    wall = time.perf_counter() - t0
    err = ate(tracker, gt)
    out = {"frames": len(frames), "fps": len(frames) / wall, "ate_m": err,
           "closures": tracker.num_loop_closures,
           "relocalizations": tracker.relocalizations}
    log("loop world: " + json.dumps(out))
    check(tracker.num_loop_closures >= 2, "fewer than 2 loop closures")
    check(tracker.relocalizations == 0, "tracking was lost")
    check(err < LOOP_ATE_M, f"ATE {err:.3f} m >= {LOOP_ATE_M}")
    if save_map:
        from visualslam.slam.checkpoint import save_checkpoint

        save_checkpoint(save_map, tracker)
        log(f"saved the loop-world map to {save_map}")
    t0 = time.perf_counter()
    res = tracker.global_ba()
    out["gba"] = {"keyframes": res.n_cameras, "landmarks": res.n_landmarks,
                  "cost0": res.initial_cost, "cost": res.cost,
                  "s": time.perf_counter() - t0}
    log("global BA: " + json.dumps(out["gba"]))
    check(res.cost < res.initial_cost, "global BA did not lower the cost")
    return out


# -- --multi -----------------------------------------------------------------

def pose_gap(R1, t1, R2, t2) -> float:
    """Sim(3)-aligned RMS camera-center difference over the trajectory's
    extent. Monocular BA fixes the first camera but not the scale, so two
    solvers may settle at different points of the scale gauge."""
    from visualslam.slam.evaluation import ate_rmse

    c1 = -np.einsum("cji,cj->ci", R1, t1)
    c2 = -np.einsum("cji,cj->ci", R2, t2)
    extent = max(float(np.ptp(c1, axis=0).max()), 1e-9)
    return float(ate_rmse(c2, c1)) / extent


def compare(name: str, single, sharded, cost_rtol: float = 1e-2) -> dict:
    """single/sharded: (R, t, cost0, cost). Both must lower the cost, to
    final costs within cost_rtol of the initial cost of each other, with
    camera centers within SHARD_POSE_TOL (pose_gap)."""
    R1, t1, c0, c1 = single
    R2, t2, d0, d1 = sharded
    gap = pose_gap(np.asarray(R1), np.asarray(t1), np.asarray(R2),
                   np.asarray(t2))
    out = {"cost0": float(c0), "cost_single": float(c1),
           "cost_sharded": float(d1), "center_gap": gap}
    log(f"{name}: " + json.dumps(out))
    check(c1 < c0 and d1 < d0, f"{name}: cost did not fall")
    check(abs(float(d1) - float(c1)) <= cost_rtol * float(c0), name)
    check(gap <= SHARD_POSE_TOL, f"{name}: center gap {gap:.3e}")
    return out


@phase("multi global BA")
def phase_multi_gba(tracker, mesh) -> dict:
    """Global BA over the loop-world map, sharded against single-device.
    The trajectory-sharded dense-row path solves each LM step with a fixed
    number of Jacobi-PCG steps; its single-device form is
    solver="schur_cg" (the default direct solve is a different algorithm
    whose iterates drift apart along the monocular scale gauge)."""
    import jax
    import jax.numpy as jnp

    from visualslam.backend.ba import run_ba_jit
    from visualslam.parallel.dist_ba import run_ba_sharded, shard_problem
    from visualslam.slam.global_ba import build_global_problem, run_global_ba

    cfg = tracker.cfg.ba.replace(solver="schur_cg")
    corr = tracker.loop_corrections()
    t0 = time.perf_counter()
    single = run_global_ba(tracker.map, cfg, corr)
    t1 = time.perf_counter()
    sharded = run_global_ba(tracker.map, cfg, corr, mesh)
    t4 = time.perf_counter()
    out = {"traj": compare(
        "trajectory-sharded global BA",
        (single.R, single.t, single.initial_cost, single.cost),
        (sharded.R, sharded.t, sharded.initial_cost, sharded.cost))}
    out["traj"].update(keyframes=single.n_cameras,
                       landmarks=single.n_landmarks,
                       single_cold_s=t1 - t0, sharded_cold_s=t4 - t1)

    # landmark-sharded dense BA on the same problem: the same direct solve
    # on every device after one psum of the reduced system
    n = mesh.shape["shard"]
    p, _ = build_global_problem(tracker.map, corr)
    L = p.X.shape[0]
    Lp = -(-L // n) * n
    if Lp != L:
        p = p._replace(X=jnp.concatenate([p.X, jnp.ones((Lp - L, 3))]),
                       lm_valid=jnp.concatenate([p.lm_valid,
                                                 jnp.zeros(Lp - L, bool)]))
    cfg = tracker.cfg.ba.replace(max_cameras=int(p.R.shape[0]),
                                 max_landmarks=Lp,
                                 max_observations=int(p.uv.shape[0]),
                                 solver="schur_dense")
    r1 = jax.device_get(run_ba_jit(p, cfg))
    r4 = run_ba_sharded(shard_problem(p, n), cfg, mesh)
    out["landmark"] = compare(
        "landmark-sharded BA", (r1.R, r1.t, r1.initial_cost, r1.cost),
        (r4.R, r4.t, r4.initial_cost, r4.cost))
    return out


@phase("multi ba_scale")
def phase_multi_scale(mesh, iters: int = 5) -> dict:
    import jax
    import jax.numpy as jnp

    from benchmarks.ba_scale import C, L, O, build_problem
    from visualslam.backend.ba import run_ba_jit
    from visualslam.geometry import se3
    from visualslam.parallel.traj_ba import (run_ba_traj_sharded,
                                             shard_problem_trajectory)
    from visualslam.utils.config import BAConfig

    p = build_problem(jnp, se3, np.random.default_rng(0))
    cfg = BAConfig(max_cameras=C, max_landmarks=L, max_observations=O,
                   iters=iters, solver="schur_mf", cg_iters=48)
    t0 = time.perf_counter()
    r1 = jax.device_get(run_ba_jit(p, cfg))
    t1 = time.perf_counter() - t0
    sp = shard_problem_trajectory(p, mesh.shape["shard"])
    t0 = time.perf_counter()
    r4 = jax.device_get(run_ba_traj_sharded(sp, cfg, mesh))
    t4 = time.perf_counter() - t0
    R4 = np.asarray(r4.R).reshape(-1, 3, 3)[:C]
    t4v = np.asarray(r4.t).reshape(-1, 3)[:C]
    out = compare("ba_scale traj-sharded matrix-free",
                  (r1.R, r1.t, r1.initial_cost, r1.cost),
                  (R4, t4v, r4.initial_cost, r4.cost))
    out.update(single_cold_s=t1, sharded_cold_s=t4, cameras=C,
               landmarks=L, observations=O, lm_iters=iters)
    log(f"ba_scale cold walls (compile included): single {t1:.1f} s, "
        f"4-way {t4:.1f} s")
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded-BA path")
    ap.add_argument("--map", default=None,
                    help="--multi: load the phase-(e) map from this "
                         "checkpoint instead of tracking the loop world")
    ap.add_argument("--save-map", default=None,
                    help="write the phase-(e) map to this checkpoint")
    ap.add_argument("--ab", action="store_true",
                    help="also time the main path with the Triton kernels "
                         "against their XLA form")
    args = ap.parse_args(argv)

    # the CPU device is the frontend reference of phase (c): keep it
    # visible beside the GPU
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"

    t_all = time.perf_counter()
    device = phase_device(4 if args.multi else 1)

    import multiprocessing

    from visualslam.utils.config import FAST_CONFIG

    cfg = FAST_CONFIG
    pool = multiprocessing.get_context("spawn").Pool(
        max(1, min(16, (os.cpu_count() or 2) - 1)))
    try:
        if args.multi:
            from visualslam.parallel.mesh import make_mesh

            mesh = make_mesh(4)
            intr_l, gt_l = gt_poses(LOOP_WORLD)
            if args.map:
                from visualslam.slam.checkpoint import load_checkpoint
                from visualslam.slam.tracker import Tracker

                tracker = Tracker(cfg, intr_l)
                load_checkpoint(args.map, tracker)
            else:
                tracker = track_loop_world(
                    render_async(pool, LOOP_WORLD).get(), cfg, intr_l)
            log(f"loop-world map: closures={tracker.num_loop_closures}")
            phase_multi_gba(tracker, mesh)
            phase_multi_scale(mesh)
        else:
            bench = render_async(pool, BENCH_WORLD)
            warm = render_async(pool, WARM_WORLD)
            loop = render_async(pool, LOOP_WORLD)
            frames = bench.get()
            phase_kernels(frames[8:8 + BATCH], cfg)
            phase_frontend(frames[8:8 + BATCH], cfg)
            intr_w, _ = gt_poses(WARM_WORLD)
            intr, gt = gt_poses(BENCH_WORLD)
            phase_main(warm.get(), frames, cfg, intr_w, intr, gt)
            if args.ab:
                phase_ab(warm.get(), frames, cfg, intr_w, intr, gt)
            intr_l, gt_l = gt_poses(LOOP_WORLD)
            phase_loop(loop.get(), cfg, intr_l, gt_l, args.save_map)
    finally:
        pool.terminate()
        pool.join()
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
