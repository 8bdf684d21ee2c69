"""Sharded descriptor matching: the distance matrix is partitioned across
devices (SURVEY.md §2.4 TP row — round 1 left "distance matrices never
sharded" as a gap).

The [Ka, Kb] distance matrix of a big matching problem (loop-closure
retrieval against a long keyframe history, exhaustive map-vs-map matching)
is never materialized globally: the B side is sharded over the mesh, every
device computes a LOCAL 2-NN (best + second-best distance and best index)
against its shard with one matmul, and a psum-min tournament combines
the per-shard results:

    best     = min_s best_s
    second   = min_s second-smallest of {best_s, second_s} pooled
    argmin   = index of the shard achieving the global best

Communication: two [Ka] psum-mins + one [Ka] psum — O(Ka), independent of
Kb. This is exactly the blockwise long-context pattern: each device holds a
context block (descriptor shard), queries are replicated, and softmax-style
running statistics (here: running 2-NN) are exchanged.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

_BIG = jnp.float32(1e30)


def _local_2nn(qa: jnp.ndarray, kb: jnp.ndarray, vb: jnp.ndarray):
    """2-NN of each query row against the local key shard.
    qa [Ka, D], kb [Kb_s, D], vb [Kb_s] validity. Returns
    (best [Ka], second [Ka], idx [Ka] local index)."""
    na = jnp.sum(qa * qa, axis=-1, keepdims=True)
    nb = jnp.sum(kb * kb, axis=-1, keepdims=True)
    d = na + nb.T - 2.0 * jnp.dot(qa, kb.T,
                                  preferred_element_type=jnp.float32)
    d = jnp.maximum(d, 0.0)
    d = jnp.where(vb[None, :], d, _BIG)
    neg2, idx2 = jax.lax.top_k(-d, 2)
    return -neg2[:, 0], -neg2[:, 1], idx2[:, 0]


def sharded_2nn(qa: jnp.ndarray, kb_sharded: jnp.ndarray,
                vb_sharded: jnp.ndarray, mesh: Mesh,
                axis: str = "shard"):
    """Global 2-NN over a B side sharded as [n, Kb_s, D] (+ validity
    [n, Kb_s]). Returns (best [Ka], second [Ka], global_idx [Ka]) with
    global_idx = shard * Kb_s + local index.

    The full [Ka, n*Kb_s] distance matrix never exists on any device."""
    n = mesh.shape[axis]
    Kb_s = kb_sharded.shape[1]

    def local(kb, vb):
        kb, vb = kb[0], vb[0]
        s = jax.lax.axis_index(axis)
        best, second, idx = _local_2nn(qa, kb, vb)
        gidx = (s * Kb_s + idx).astype(jnp.int32)

        # tournament combine:
        gbest = jax.lax.pmin(best, axis)
        # second-best overall = min over shards of (second_s, or best_s if
        # that shard doesn't hold the global best)
        cand = jnp.where(best == gbest, second, best)
        gsecond = jnp.minimum(jax.lax.pmin(cand, axis),
                              jax.lax.pmin(second, axis))
        # winning shard's index: ties keep the lowest shard id so exactly
        # one shard contributes to the psum
        mine = (best == gbest)
        min_winner = -jax.lax.pmax(jnp.where(mine, -(s + 1), -(n + 2))
                                   .astype(jnp.int32), axis)
        keep = mine & (s + 1 == min_winner)
        gidx_out = jax.lax.psum(jnp.where(keep, gidx, 0), axis)
        return gbest, gsecond, gidx_out

    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(P(axis), P(axis)),
                      out_specs=(P(), P(), P()))
    return jax.jit(f)(kb_sharded, vb_sharded)


def shard_descriptors(desc: np.ndarray, valid: np.ndarray, n: int):
    """Host-side: pad + reshape a [Kb, D] descriptor set to [n, Kb_s, D]
    (+ validity) for sharded_2nn."""
    Kb, D = desc.shape
    Kb_s = -(-Kb // n)
    pad = n * Kb_s - Kb
    desc_p = np.concatenate(
        [desc, np.zeros((pad, D), desc.dtype)]) if pad else desc
    valid_p = np.concatenate(
        [valid, np.zeros(pad, bool)]) if pad else valid
    return (jnp.asarray(desc_p.reshape(n, Kb_s, D)),
            jnp.asarray(valid_p.reshape(n, Kb_s)))
