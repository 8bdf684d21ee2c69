"""Distributed bundle adjustment: landmark/observation sharding + psum'd
Schur assembly (SURVEY.md §5 "long-context"/§2.4 accounting).

Parallel decomposition:
  - camera poses are tiny (C <= ~10) and REPLICATED on every device;
  - landmarks and their observations are SHARDED over the 'shard' mesh axis
    (each observation lives with its landmark's shard, so V blocks and
    landmark updates are fully local);
  - each shard assembles its partial reduced camera system
    S_s = U_s - W_s V_s^-1 W_s^T and b_s; one psum produces the global
    6C x 6C system — the only cross-device communication per iteration
    (~ (6C)^2 + 6C floats);
  - every device solves the same tiny system (cheaper than broadcast),
    applies identical pose updates, and back-substitutes its own landmarks.

LM accept/reject uses the psum'd global cost, so control flow is identical
on all shards by construction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from visualslam.backend.ba import (
    BAProblem,
    BAResult,
    apply_increments,
    backsub_landmarks,
    normal_equations,
    robust_cost,
    schur_camera_system,
    solve_cameras,
)
from visualslam.utils.config import BAConfig


class ShardedBAProblem(NamedTuple):
    """Host-side container: leading axis = shard. Shapes:
    R [C,3,3], t [C,3], cam_valid [C] (replicated);
    X [n, L_s, 3], lm_valid [n, L_s];
    cam_idx/lm_idx/uv/obs_valid [n, O_s] (lm_idx LOCAL to the shard);
    lm_order [L] host-side: original landmark index of each packed slot
    (identity for the block partition) — use with unshard_points."""

    R: jnp.ndarray
    t: jnp.ndarray
    cam_valid: jnp.ndarray
    X: jnp.ndarray
    lm_valid: jnp.ndarray
    cam_idx: jnp.ndarray
    lm_idx: jnp.ndarray
    uv: jnp.ndarray
    obs_valid: jnp.ndarray
    lm_order: np.ndarray


def _partition_landmarks(p: BAProblem, n_shards: int, Ls: int,
                         partition: str) -> np.ndarray:
    """Returns lm_order [L]: original landmark index for each packed slot
    (slot s*Ls + k lives on shard s)."""
    L = p.X.shape[0]
    if partition == "block":
        return np.arange(L)
    if partition != "balanced":
        raise ValueError(f"unknown partition {partition!r}")

    # Balanced (covisibility-load-aware) partition: per-shard observation
    # counts determine the padded O_s = max_s count, i.e. every shard pays
    # for the heaviest one. Greedy LPT bin-packing of landmarks by their
    # observation count (heaviest first, onto the lightest non-full shard)
    # keeps loads near-equal, shrinking padding vs. the index-block
    # partition when counts are skewed. Cameras are replicated, so the
    # partition affects load balance only — never communication volume
    # (one psum'd reduced system per iteration regardless).
    lm = np.asarray(p.lm_idx)
    ov = np.asarray(p.obs_valid)
    counts = np.bincount(lm[ov], minlength=L)
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(n_shards, np.int64)
    fill = np.zeros(n_shards, np.int64)
    slots = np.empty(L, np.int64)
    for li in order:
        open_shards = np.nonzero(fill < Ls)[0]
        s = open_shards[np.argmin(load[open_shards])]
        slots[li] = s * Ls + fill[s]
        load[s] += counts[li]
        fill[s] += 1
    lm_order = np.empty(L, np.int64)
    lm_order[slots] = np.arange(L)
    return lm_order


def shard_problem(p: BAProblem, n_shards: int,
                  partition: str = "balanced") -> ShardedBAProblem:
    """Host-side partition of a BAProblem into n landmark shards.

    Observations follow their landmark and are padded to the max per-shard
    count. partition: "balanced" (default; greedy observation-load
    balancing, see _partition_landmarks) or "block" (index blocks).
    Requires L % n_shards == 0."""
    L = p.X.shape[0]
    assert L % n_shards == 0, f"L={L} not divisible by {n_shards}"
    Ls = L // n_shards
    lm_order = _partition_landmarks(p, n_shards, Ls, partition)
    slot_of = np.empty(L, np.int64)      # original lm index -> packed slot
    slot_of[lm_order] = np.arange(L)

    lm = np.asarray(p.lm_idx)
    ov = np.asarray(p.obs_valid)
    lm_slot = slot_of[lm]
    shard_of = lm_slot // Ls

    per = []
    for s in range(n_shards):
        sel = np.nonzero((shard_of == s) & ov)[0]
        per.append(sel)
    O_s = max(max(len(s) for s in per), 1)

    def pad_gather(arr, idxs, fill=0):
        out = np.full((n_shards, O_s) + arr.shape[1:], fill, arr.dtype)
        for s, sel in enumerate(idxs):
            out[s, : len(sel)] = arr[sel]
        return out

    cam_idx = pad_gather(np.asarray(p.cam_idx), per)
    lm_local = pad_gather(lm_slot, per) % Ls
    uv = pad_gather(np.asarray(p.uv), per)
    valid = np.zeros((n_shards, O_s), bool)
    for s, sel in enumerate(per):
        valid[s, : len(sel)] = True

    X_np = np.asarray(p.X)[lm_order]
    lmv_np = np.asarray(p.lm_valid)[lm_order]
    return ShardedBAProblem(
        R=p.R, t=p.t, cam_valid=p.cam_valid,
        X=jnp.asarray(X_np.reshape(n_shards, Ls, 3)),
        lm_valid=jnp.asarray(lmv_np.reshape(n_shards, Ls)),
        cam_idx=jnp.asarray(cam_idx),
        lm_idx=jnp.asarray(lm_local.astype(np.int32)),
        uv=jnp.asarray(uv),
        obs_valid=jnp.asarray(valid),
        lm_order=lm_order,
    )


def unshard_points(X_sharded: jnp.ndarray,
                   lm_order: np.ndarray | None = None) -> jnp.ndarray:
    """Inverse of the shard packing: [n, L_s, 3] -> [L, 3] in the ORIGINAL
    landmark order (pass sp.lm_order for non-block partitions)."""
    X = X_sharded.reshape(-1, 3)
    if lm_order is None:
        return X
    inv = np.empty(len(lm_order), np.int64)
    inv[lm_order] = np.arange(len(lm_order))
    return X[jnp.asarray(inv)]


def run_ba_sharded(sp: ShardedBAProblem, cfg: BAConfig, mesh: Mesh,
                   axis: str = "shard", reduce: str = "psum") -> BAResult:
    """Distributed LM loop under shard_map. Returns BAResult with X stacked
    [n, L_s, 3] (use unshard_points).

    reduce: "psum" (XLA picks the all-reduce) or "ring" (explicit ppermute
    reduce-scatter ring, parallel/collectives.py)."""
    if reduce == "ring":
        from visualslam.parallel.collectives import ring_allreduce

        allreduce = lambda v: ring_allreduce(v, axis)  # noqa: E731
    else:
        allreduce = lambda v: jax.lax.psum(v, axis)    # noqa: E731

    def local_problem(X_s, lmv_s, ci_s, li_s, uv_s, ov_s, R, t):
        return BAProblem(
            R=R, t=t, X=X_s, cam_idx=ci_s, lm_idx=li_s, uv=uv_s,
            obs_valid=ov_s, cam_valid=sp.cam_valid, lm_valid=lmv_s)

    n_shards = mesh.shape[axis]

    def loop(X_s, lmv_s, ci_s, li_s, uv_s, ov_s, R, t):
        # local blocks keep a leading shard axis of size 1 — drop it
        X_s, lmv_s, ci_s, li_s, uv_s, ov_s = (
            a[0] for a in (X_s, lmv_s, ci_s, li_s, uv_s, ov_s))
        if reduce == "ring":
            # ring results are 'varying' in shard_map's type system even
            # though numerically replicated; make the whole carry varying
            # and collapse back to replicated after the scan
            R = jax.lax.pcast(R, axis, to='varying')
            t = jax.lax.pcast(t, axis, to='varying')
        lam = jnp.asarray(cfg.damping_init, X_s.dtype)
        if reduce == "ring":
            lam = jax.lax.pcast(lam, axis, to='varying')
        p0 = local_problem(X_s, lmv_s, ci_s, li_s, uv_s, ov_s, R, t)
        cost = jax.lax.psum(
            robust_cost(p0, R, t, X_s, cfg.huber_delta), axis)
        init_cost = cost

        def body(carry, _):
            R, t, X_s, lam, cost = carry
            p = local_problem(X_s, lmv_s, ci_s, li_s, uv_s, ov_s, R, t)
            U, V, bc, bl, Wd = normal_equations(p, R, t, X_s, cfg)
            S, b, V_inv = schur_camera_system(U, V, bc, bl, Wd, lam)
            S = allreduce(S)                   # the one collective per iter
            b = allreduce(b)
            dc = solve_cameras(S, b, sp.cam_valid, lam, cfg)
            dl = backsub_landmarks(V_inv, bl, Wd, dc, lmv_s)
            Rn, tn, Xn = apply_increments(R, t, X_s, dc, dl)
            new_cost = jax.lax.psum(
                robust_cost(p, Rn, tn, Xn, cfg.huber_delta), axis)
            acc = new_cost < cost
            R2 = jnp.where(acc, Rn, R)
            t2 = jnp.where(acc, tn, t)
            X2 = jnp.where(acc, Xn, X_s)
            c2 = jnp.where(acc, new_cost, cost)
            lam2 = jnp.clip(
                jnp.where(acc, lam * cfg.damping_down, lam * cfg.damping_up),
                1e-9, 1e6)
            return (R2, t2, X2, lam2, c2), new_cost

        (R, t, X_s, lam, cost), _ = jax.lax.scan(
            body, (R, t, X_s, lam, cost), None, length=cfg.iters)
        if reduce == "ring":
            # collapse numerically-replicated varying values to replicated
            inv = 1.0 / n_shards
            R = jax.lax.psum(R, axis) * inv
            t = jax.lax.psum(t, axis) * inv
            cost = jax.lax.psum(cost, axis) * inv
            lam = jax.lax.psum(lam, axis) * inv
        return R, t, X_s[None], cost, init_cost, lam

    smapped = jax.shard_map(
        loop, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(), P()),
        out_specs=(P(), P(), P(axis), P(), P(), P()),
    )
    # float32 matmuls, as backend/ba.run_ba: TF32 passes on the GPU
    # degrade the reduced system's conditioning
    with jax.default_matmul_precision("float32"):
        R, t, X_s, cost, init_cost, lam = jax.jit(smapped)(
            sp.X, sp.lm_valid, sp.cam_idx, sp.lm_idx, sp.uv, sp.obs_valid,
            sp.R, sp.t)
    return BAResult(R=R, t=t, X=X_s, cost=cost, initial_cost=init_cost,
                    lm_lambda=lam)
