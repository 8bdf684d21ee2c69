"""Full-sequence-scale bundle adjustment benchmark.

Builds a KITTI-00-scale synthetic problem — 1024 cameras, 32k landmarks,
128k observations — and runs the matrix-free Schur LM loop
(backend/ba.py solver="schur_mf") on the default device. The dense path
cannot exist at this scale: Wd [C,L,6,3] alone would be
1024*32768*18*4 B = 2.4 TB; matrix-free keeps O(O) state (~10 MB).

Per-iteration time comes from the slope between iters=N1 and iters=N2
runs (forced host readback; compile + dispatch cancel). Prints one JSON
object. Usage: python -m benchmarks.ba_scale (on a GPU)
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

C, L, O = 1024, 32768, 131072


def build_problem(jnp, se3, rng):
    # forward trajectory with gentle yaw, landmarks scattered along it
    ks = np.arange(C)
    yaw = 0.002 * ks
    cw = np.stack([0.05 * ks, np.zeros(C), 0.4 * ks], -1)
    R = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]] for a in yaw])
    t = -np.einsum("cij,cj->ci", R, cw)

    # landmark k near trajectory position (k/L)*C
    anchor = (np.arange(L) / L * C * 0.4).astype(np.float32)
    X = np.stack([rng.uniform(-20, 20, L), rng.uniform(-10, 10, L),
                  anchor + rng.uniform(8, 40, L)], -1)

    # each landmark observed by 4 consecutive cameras near its anchor
    per = O // L
    base_cam = np.clip((anchor / 0.4).astype(np.int64), 0, C - 1 - per)
    cam_idx = (base_cam[:, None] + np.arange(per)[None]).reshape(-1)
    lm_idx = np.repeat(np.arange(L), per)
    Xc = np.einsum("oij,oj->oi", R[cam_idx], X[lm_idx]) + t[cam_idx]
    z = np.maximum(Xc[:, 2], 1e-3)
    uv = Xc[:, :2] / z[:, None]
    valid = (Xc[:, 2] > 1.0) & (np.abs(uv) < 1.5).all(1)

    from visualslam.backend.ba import BAProblem

    xi = rng.normal(0, 0.01, (C, 6)).astype(np.float32)
    xi[0] = 0
    dR, dt = se3.se3_exp(jnp.asarray(xi))
    R0 = np.asarray(dR) @ R
    t0 = np.einsum("cij,cj->ci", np.asarray(dR), t) + np.asarray(dt)
    return BAProblem(
        R=jnp.asarray(R0, jnp.float32), t=jnp.asarray(t0, jnp.float32),
        X=jnp.asarray(X + rng.normal(0, 0.2, X.shape), jnp.float32),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        lm_idx=jnp.asarray(lm_idx, jnp.int32),
        uv=jnp.asarray(uv, jnp.float32),
        obs_valid=jnp.asarray(valid),
        cam_valid=jnp.ones(C, bool), lm_valid=jnp.ones(L, bool))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from visualslam.backend.ba import run_ba_packed_jit, unpack_ba_result
    from visualslam.geometry import se3
    from visualslam.utils.config import BAConfig

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"ba_scale measures on a GPU, not {dev.platform}")
    out = {"device": dev.device_kind, "C": C, "L": L, "O": O}
    iters_pair = (2, 10)
    # a distinct problem per timed call
    probs = [build_problem(jnp, se3, np.random.default_rng(s))
             for s in range(5)]
    results = {}
    for it in iters_pair:
        cfg = BAConfig(max_cameras=C, max_landmarks=L, max_observations=O,
                       iters=it, solver="schur_mf", cg_iters=48)
        np.asarray(run_ba_packed_jit(probs[0], cfg))     # compile + settle
        ts = []
        for k in (1, 2):
            t0 = time.perf_counter()
            a = np.asarray(run_ba_packed_jit(probs[2 * k + it % 2 - 1], cfg))
            ts.append(time.perf_counter() - t0)
        results[it] = min(ts)
        _, _, _, cost, cost0 = unpack_ba_result(a, C, L)
        out[f"cost_iters{it}"] = [cost0, cost]
    per_iter = (results[iters_pair[1]] - results[iters_pair[0]]) / (
        iters_pair[1] - iters_pair[0])
    out["lm_iter_s"] = round(per_iter, 4)
    out["ba_iters_per_s"] = round(1.0 / max(per_iter, 1e-9), 2)
    out["note"] = ("matrix-free Schur CG (48 CG iters/LM iter); dense Wd "
                   "at this scale would be 2.4 TB")

    print(json.dumps(out))


if __name__ == "__main__":
    main()
