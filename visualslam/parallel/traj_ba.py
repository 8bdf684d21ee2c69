"""Trajectory-sharded bundle adjustment: the keyframe axis is partitioned
across devices (SURVEY.md §5 "long-context": the SLAM analogue of sequence
parallelism is trajectory-axis sharding over the covisibility structure).

Parallel decomposition (vs parallel/dist_ba.py, which replicates cameras):

  - cameras are sharded in contiguous trajectory blocks: shard s owns
    keyframes [s*Cs, (s+1)*Cs) — contiguous blocks because covisibility is
    temporally local, so most observations stay shard-local;
  - landmarks go to the shard that owns MOST of their observations
    (covisibility-aware majority partition, host-side); observations live
    with their landmark's shard;
  - residuals/Jacobians need poses of every camera its local observations
    reference: the camera blocks are halo-exchanged with a ppermute ring
    all-gather (C x 12 floats — tiny);
  - each shard assembles the FULL reduced camera system rows its landmarks
    touch, then a ppermute ring REDUCE-SCATTER over camera blocks delivers
    and folds boundary contributions into the owning shard: shard s ends
    with its own rows S[s] in [Cs, 6, C, 6] — the SURVEY §5 "boundary
    observations exchanged ring-style during the Schur reduction";
  - the reduced system is solved DISTRIBUTED: Jacobi-preconditioned CG
    where each shard holds its block rows, the search direction is
    all-gathered per matvec and inner products are psum'd. No device ever
    materializes or factorizes the full 6C x 6C system;
  - back-substitution is landmark-local after an all-gather of the camera
    increments.

Communication per LM iteration: 1 pose ring all-gather + 1 Schur-row ring
reduce-scatter + cg_iters x (all-gather [6C] + 2 psum scalars) + 2 psum'd
costs — all neighbor-hop or small collectives.
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
    _inv3x3,
    backsub_landmarks,
    backsub_landmarks_mf,
    normal_equations,
    normal_equations_mf,
    robust_cost,
    schur_camera_system,
)
from visualslam.geometry import se3
from visualslam.parallel.collectives import (
    ring_all_gather,
    ring_reduce_scatter,
)
from visualslam.utils.config import BAConfig


class TrajShardedBAProblem(NamedTuple):
    """Host-side container; leading axis = shard (n). Shapes:
    R [n, Cs, 3, 3], t [n, Cs, 3], cam_valid [n, Cs]   (camera blocks);
    X [n, Ls, 3], lm_valid [n, Ls]                      (landmark shards);
    cam_idx [n, Os] GLOBAL camera ids, lm_idx [n, Os] LOCAL landmark ids,
    uv [n, Os, 2], obs_valid [n, Os];
    lm_order [L] host-side: original landmark id of packed slot (use with
    unshard)."""

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


def shard_problem_trajectory(p: BAProblem,
                             n_shards: int) -> TrajShardedBAProblem:
    """Host-side covisibility-aware partition. Requires C % n_shards == 0.

    Landmarks are assigned to the shard owning the majority of their
    observations; shards over capacity spill to the least-loaded shard
    (those landmarks simply ride the boundary exchange)."""
    C = p.R.shape[0]
    L = p.X.shape[0]
    assert C % n_shards == 0, f"C={C} not divisible by {n_shards}"
    Cs = C // n_shards
    Ls = -(-L // n_shards)          # ceil

    cam = np.asarray(p.cam_idx)
    lm = np.asarray(p.lm_idx)
    ov = np.asarray(p.obs_valid)
    shard_of_cam = cam // Cs

    # majority vote per landmark
    votes = np.zeros((L, n_shards), np.int64)
    np.add.at(votes, (lm[ov], shard_of_cam[ov]), 1)
    want = np.argmax(votes, axis=1)
    # unobserved landmarks: spread round-robin (they are inert)
    unobserved = votes.sum(1) == 0
    want[unobserved] = np.arange(L)[unobserved] % n_shards

    # capacity-constrained assignment with spill
    fill = np.zeros(n_shards, np.int64)
    assign = np.empty(L, np.int64)
    spill = []
    for li in np.argsort(-votes.max(1), kind="stable"):  # strongest first
        s = want[li]
        if fill[s] < Ls:
            assign[li] = s
            fill[s] += 1
        else:
            spill.append(li)
    for li in spill:
        s = int(np.argmin(fill))
        assign[li] = s
        fill[s] += 1

    # pack: slot s*Ls + k  <-  k-th landmark assigned to shard s
    lm_order = np.empty(n_shards * Ls, np.int64)
    lm_order[:] = -1
    slot_of = np.empty(L, np.int64)
    cursor = np.zeros(n_shards, np.int64)
    for li in range(L):
        s = assign[li]
        slot = s * Ls + cursor[s]
        slot_of[li] = slot
        lm_order[slot] = li
        cursor[s] += 1

    lm_slot = slot_of[lm]
    shard_of_obs = lm_slot // Ls
    per = [np.nonzero((shard_of_obs == s) & ov)[0] for s in range(n_shards)]
    Os = max(max(len(x) for x in per), 1)

    def pad_gather(arr, fill=0):
        out = np.full((n_shards, Os) + arr.shape[1:], fill, arr.dtype)
        for s, sel in enumerate(per):
            out[s, : len(sel)] = arr[sel]
        return out

    valid = np.zeros((n_shards, Os), bool)
    for s, sel in enumerate(per):
        valid[s, : len(sel)] = True

    X_np = np.zeros((n_shards * Ls, 3), np.float32)
    lmv_np = np.zeros(n_shards * Ls, bool)
    filled = lm_order >= 0
    X_np[filled] = np.asarray(p.X)[lm_order[filled]]
    lmv_np[filled] = np.asarray(p.lm_valid)[lm_order[filled]]

    return TrajShardedBAProblem(
        R=jnp.asarray(np.asarray(p.R).reshape(n_shards, Cs, 3, 3)),
        t=jnp.asarray(np.asarray(p.t).reshape(n_shards, Cs, 3)),
        cam_valid=jnp.asarray(np.asarray(p.cam_valid).reshape(n_shards, Cs)),
        X=jnp.asarray(X_np.reshape(n_shards, Ls, 3)),
        lm_valid=jnp.asarray(lmv_np.reshape(n_shards, Ls)),
        cam_idx=jnp.asarray(pad_gather(cam).astype(np.int32)),
        lm_idx=jnp.asarray((pad_gather(lm_slot) % Ls).astype(np.int32)),
        uv=jnp.asarray(pad_gather(np.asarray(p.uv))),
        obs_valid=jnp.asarray(valid),
        lm_order=lm_order,
    )


def unshard_traj(R_s, t_s, X_s, lm_order: np.ndarray, L: int):
    """Undo the shard packing: camera blocks [n, Cs, ...] -> [C, ...];
    landmarks [n, Ls, 3] -> [L, 3] in original order."""
    R = np.asarray(R_s).reshape(-1, 3, 3)
    t = np.asarray(t_s).reshape(-1, 3)
    Xp = np.asarray(X_s).reshape(-1, 3)
    X = np.zeros((L, 3), np.float32)
    filled = lm_order >= 0
    X[lm_order[filled]] = Xp[filled]
    return R, t, X


def _distributed_cg(S_rows, b_rows, frozen_rows, lam, axis: str,
                    cg_iters: int):
    """Jacobi-preconditioned CG on the reduced camera system with block-row
    sharding. S_rows: [Cs, 6, C, 6] this shard's rows; b_rows: [Cs, 6];
    frozen_rows: [Cs*6] bool (gauge + invalid cameras, LOCAL rows).
    Returns dc for the local block [Cs, 6]."""
    Cs = S_rows.shape[0]
    C = S_rows.shape[2]
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    A = S_rows.reshape(Cs * 6, C * 6)
    b = b_rows.reshape(Cs * 6)

    # global frozen mask: columns of frozen rows must be zeroed too; gather
    # the per-shard frozen rows into the full [C*6] mask
    frozen_all = ring_all_gather(frozen_rows, axis).reshape(C * 6)
    free_all = (~frozen_all).astype(A.dtype)
    free_loc = jax.lax.dynamic_slice_in_dim(free_all, idx * Cs * 6, Cs * 6)
    A = A * free_loc[:, None] * free_all[None, :]
    # damping + identity on frozen local rows
    row_ids = idx * Cs * 6 + jnp.arange(Cs * 6)
    diag_add = lam * free_loc + (1.0 - free_loc)
    A = A.at[jnp.arange(Cs * 6), row_ids].add(diag_add)
    b = b * free_loc

    diag_loc = A[jnp.arange(Cs * 6), row_ids]
    inv_diag = 1.0 / jnp.maximum(diag_loc, 1e-12)

    # x starts as zeros but becomes shard-varying — mark it varying so the
    # fori_loop carry type is stable
    x = jax.lax.pcast(jnp.zeros(Cs * 6, A.dtype), axis, to="varying")
    r = b
    z = inv_diag * r
    p_ = z
    rz = jax.lax.psum(jnp.dot(r, z), axis)

    def body(k, carry):
        x, r, p_, rz = carry
        p_full = ring_all_gather(p_, axis).reshape(C * 6)
        q = A @ p_full
        pq = jax.lax.psum(jnp.dot(p_, q), axis)
        alpha = rz / jnp.maximum(pq, 1e-20)
        x2 = x + alpha * p_
        r2 = r - alpha * q
        z2 = inv_diag * r2
        rz2 = jax.lax.psum(jnp.dot(r2, z2), axis)
        beta = rz2 / jnp.maximum(rz, 1e-20)
        p2 = z2 + beta * p_
        return x2, r2, p2, rz2

    x, _, _, _ = jax.lax.fori_loop(0, cg_iters, body, (x, r, p_, rz))
    return x.reshape(Cs, 6)


def run_ba_traj_sharded(sp: TrajShardedBAProblem, cfg: BAConfig,
                        mesh: Mesh, axis: str = "shard") -> BAResult:
    """Distributed LM loop over the trajectory-sharded problem. Returns
    BAResult with R/t/X still stacked per shard (use unshard_traj)."""
    n = mesh.shape[axis]
    Cs = sp.R.shape[1]
    C = n * Cs

    def loop(R_blk, t_blk, cv_blk, X_s, lmv_s, ci, li, uv, ov):
        (R_blk, t_blk, cv_blk, X_s, lmv_s, ci, li, uv, ov) = (
            a[0] for a in (R_blk, t_blk, cv_blk, X_s, lmv_s, ci, li, uv, ov))
        idx = jax.lax.axis_index(axis)
        lam0 = jnp.float32(cfg.damping_init)
        cam_valid_all = ring_all_gather(cv_blk, axis).reshape(C)

        def local_problem(R_all, t_all, X_s):
            return BAProblem(R=R_all, t=t_all, X=X_s, cam_idx=ci, lm_idx=li,
                             uv=uv, obs_valid=ov, cam_valid=cam_valid_all,
                             lm_valid=lmv_s)

        def gather_poses(R_blk, t_blk):
            R_all = ring_all_gather(R_blk, axis).reshape(C, 3, 3)
            t_all = ring_all_gather(t_blk, axis).reshape(C, 3)
            return R_all, t_all

        def cost_of(R_blk, t_blk, X_s):
            R_all, t_all = gather_poses(R_blk, t_blk)
            p = local_problem(R_all, t_all, X_s)
            return jax.lax.psum(
                robust_cost(p, R_all, t_all, X_s, cfg.huber_delta), axis)

        cost = cost_of(R_blk, t_blk, X_s)
        init_cost = cost

        def body_mf(carry, _):
            """Matrix-free distributed step (cfg.solver == "schur_mf"):
            neither the [C,L,6,3] coupling nor the [Cs,6,C,6] Schur rows
            ever materialize. The reduced system's camera-block-diagonal
            part (U, [C,6,6]) and RHS are psum'd and REPLICATED — tiny at
            any C — while the observation-coupled term W V⁻¹ Wᵀ v is
            computed from local observations and psum'd once per CG
            matvec. CG state is replicated, so per-iteration communication
            is exactly ONE [C,6] psum (24 KB at C=1024) vs the dense
            path's [Cs,6,C,6] ring reduce-scatter (151 MB)."""
            R_blk, t_blk, X_s, lam, cost = carry
            R_all, t_all = gather_poses(R_blk, t_blk)
            p = local_problem(R_all, t_all, X_s)
            U_p, V, bc_p, bl, Wo = normal_equations_mf(
                p, R_all, t_all, X_s, cfg)
            U_all = jax.lax.psum(U_p, axis)               # [C, 6, 6]
            eye3 = jnp.eye(3, dtype=U_all.dtype)
            V_inv = _inv3x3(V + lam * eye3)               # local landmarks
            ybl = jnp.einsum("lij,lj->li", V_inv, bl)
            wyb_p = jax.ops.segment_sum(
                jnp.einsum("oij,oj->oi", Wo, ybl[li]), ci, C)
            b_all = jax.lax.psum(bc_p - wyb_p, axis)      # [C, 6]

            frozen = ~cam_valid_all
            if cfg.fix_first_camera:
                frozen = frozen | (jnp.arange(C) == 0)
            free6 = jnp.where(frozen[:, None], 0.0,
                              jnp.ones((C, 6), U_all.dtype))
            b_all = b_all * free6

            Ls_ = V_inv.shape[0]

            def mv(v):
                vm = v * free6
                a = jnp.einsum("oij,oi->oj", Wo, vm[ci])
                q = jax.ops.segment_sum(a, li, Ls_)
                y = jnp.einsum("lij,lj->li", V_inv, q)
                bo = jnp.einsum("oij,oj->oi", Wo, y[li])
                s = jax.lax.psum(jax.ops.segment_sum(bo, ci, C), axis)
                Sv = jnp.einsum("cij,cj->ci", U_all, vm) + lam * vm - s
                return Sv * free6 + v * (1.0 - free6)

            # Jacobi preconditioner from U's diagonal (explicit fori_loop
            # CG: jax.scipy's cg trips the shard_map vma typing when its
            # carry mixes psum'd and local operands)
            diagU = jnp.diagonal(U_all, axis1=-2, axis2=-1) + lam
            inv_diag = free6 / jnp.maximum(diagU, 1e-12) + (1.0 - free6)

            r0 = b_all
            z0 = inv_diag * r0
            rz0 = jnp.sum(r0 * z0)

            def cg_body(_, carry):
                x, r, p_, rz = carry
                q = mv(p_)
                pq = jnp.sum(p_ * q)
                alpha = rz / jnp.maximum(pq, 1e-20)
                x2 = x + alpha * p_
                r2 = r - alpha * q
                z2 = inv_diag * r2
                rz2 = jnp.sum(r2 * z2)
                beta = rz2 / jnp.maximum(rz, 1e-20)
                return x2, r2, z2 + beta * p_, rz2

            dc_all, _, _, _ = jax.lax.fori_loop(
                0, cfg.cg_iters, cg_body,
                (jnp.zeros_like(b_all), r0, z0, rz0))
            dc_all = dc_all * free6                       # replicated [C,6]
            dl = backsub_landmarks_mf(p, V_inv, bl, Wo, dc_all, lmv_s)
            dc_blk = jax.lax.dynamic_slice_in_dim(dc_all, idx * Cs, Cs)
            dR, dt = se3.se3_exp(dc_blk)
            Rn_blk = dR @ R_blk
            tn_blk = (dR @ t_blk[..., None])[..., 0] + dt
            Xn_s = X_s + dl
            new_cost = cost_of(Rn_blk, tn_blk, Xn_s)
            acc = new_cost < cost
            R2 = jnp.where(acc, Rn_blk, R_blk)
            t2 = jnp.where(acc, tn_blk, t_blk)
            X2 = jnp.where(acc, Xn_s, X_s)
            c2 = jnp.where(acc, new_cost, cost)
            lam2 = jnp.clip(
                jnp.where(acc, lam * cfg.damping_down, lam * cfg.damping_up),
                1e-9, 1e6)
            return (R2, t2, X2, lam2, c2), new_cost

        def body(carry, _):
            R_blk, t_blk, X_s, lam, cost = carry
            R_all, t_all = gather_poses(R_blk, t_blk)
            p = local_problem(R_all, t_all, X_s)
            U, V, bc, bl, Wd = normal_equations(p, R_all, t_all, X_s, cfg)
            S, b, V_inv = schur_camera_system(U, V, bc, bl, Wd, lam)
            # boundary exchange: fold this shard's contributions to REMOTE
            # camera rows into their owners (ppermute ring reduce-scatter)
            S_rows = ring_reduce_scatter(
                S.reshape(n, Cs, 6, C, 6), axis)          # [Cs, 6, C, 6]
            b_rows = ring_reduce_scatter(
                b.reshape(n, Cs, 6), axis)                # [Cs, 6]
            frozen = ~cv_blk
            if cfg.fix_first_camera:
                glob = idx * Cs + jnp.arange(Cs)
                frozen = frozen | (glob == 0)
            frozen_rows = jnp.repeat(frozen, 6)
            dc_blk = _distributed_cg(S_rows, b_rows, frozen_rows, lam,
                                     axis, cfg.cg_iters)   # [Cs, 6]
            dc_all = ring_all_gather(dc_blk, axis).reshape(C, 6)
            dl = backsub_landmarks(V_inv, bl, Wd, dc_all, lmv_s)
            dR, dt = se3.se3_exp(dc_blk)
            Rn_blk = dR @ R_blk
            tn_blk = (dR @ t_blk[..., None])[..., 0] + dt
            Xn_s = X_s + dl
            new_cost = cost_of(Rn_blk, tn_blk, Xn_s)
            acc = new_cost < cost
            R2 = jnp.where(acc, Rn_blk, R_blk)
            t2 = jnp.where(acc, tn_blk, t_blk)
            X2 = jnp.where(acc, Xn_s, X_s)
            c2 = jnp.where(acc, new_cost, cost)
            lam2 = jnp.clip(
                jnp.where(acc, lam * cfg.damping_down, lam * cfg.damping_up),
                1e-9, 1e6)
            return (R2, t2, X2, lam2, c2), new_cost

        step = body_mf if cfg.solver == "schur_mf" else body
        (R_blk, t_blk, X_s, lam, cost), _ = jax.lax.scan(
            step, (R_blk, t_blk, X_s, lam0, cost), None, length=cfg.iters)
        return (R_blk[None], t_blk[None], X_s[None], cost, init_cost, lam)

    smapped = jax.shard_map(
        loop, mesh=mesh,
        in_specs=(P(axis),) * 9,
        out_specs=(P(axis), P(axis), P(axis), P(), P(), P()),
    )
    with jax.default_matmul_precision("float32"):
        R, t, X_s, cost, init_cost, lam = jax.jit(smapped)(
            sp.R, sp.t, sp.cam_valid, sp.X, sp.lm_valid,
            sp.cam_idx, sp.lm_idx, sp.uv, sp.obs_valid)
    return BAResult(R=R, t=t, X=X_s, cost=cost, initial_cost=init_cost,
                    lm_lambda=lam)
