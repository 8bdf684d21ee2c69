"""Collective primitives built on ppermute (SURVEY.md §5: ring-style
exchange during Schur reduction).

`psum` lets XLA choose the all-reduce algorithm; `ring_allreduce` spells the
reduce-scatter ring out explicitly with jax.lax.ppermute so the
communication schedule is pinned to neighbor hops (the building block for overlapping communication with
per-chunk computation). Used by parallel/dist_ba.py when reduce="ring";
numerically identical to psum up to summation order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ring_reduce_scatter(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Reduce-scatter (sum) over `axis_name` via a ppermute ring.

    x: [N, ...] — every device holds a full copy with partial values
    (leading axis = destination shard). Returns this device's summed chunk
    x_sum[idx] of shape x.shape[1:], after N-1 neighbor hops each carrying
    one chunk. This is the "boundary exchange during Schur reduction" of
    SURVEY.md §5: each device's landmark shard contributes Hessian rows for
    REMOTE cameras; the ring delivers and folds them into the owning shard.
    """
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        return x[0]
    idx = jax.lax.axis_index(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    # at step s device d sends its partial sum of chunk (d - s - 1) % n;
    # the receiver d+1 folds it into that same chunk — which in ITS index
    # arithmetic is ((d+1) - s - 2) % n — and passes it on next step. After
    # n-1 steps device d holds the full sum of chunk d.
    acc = x
    for s in range(n - 1):
        send = acc[(idx - s - 1) % n]
        recv = jax.lax.ppermute(send, axis_name, fwd)
        acc = acc.at[(idx - s - 2) % n].add(recv)
    return acc[idx]


def ring_all_gather(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """All-gather over `axis_name` via a ppermute ring: [chunk...] ->
    [N, chunk...] (chunk c from device c). N-1 neighbor hops — the halo
    exchange used to circulate boundary camera blocks."""
    n = jax.lax.axis_size(axis_name)
    out = jnp.zeros((n,) + x.shape, x.dtype)
    idx = jax.lax.axis_index(axis_name)
    out = out.at[idx].set(x)
    if n == 1:
        return out
    fwd = [(i, (i + 1) % n) for i in range(n)]
    cur = x
    for s in range(n - 1):
        cur = jax.lax.ppermute(cur, axis_name, fwd)
        out = out.at[(idx - s - 1) % n].set(cur)
    return out


def ring_allreduce(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """All-reduce (sum) over `axis_name`: ppermute reduce-scatter ring
    (N-1 neighbor hops, each carrying 1/N of the data) followed by an
    all-gather of the reduced chunks.

    x: any array (flattened and chunked internally). Static mesh size N."""
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        return x
    idx = jax.lax.axis_index(axis_name)
    shape = x.shape
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])
    chunks = flat.reshape(n, -1)                   # [N, chunk]
    fwd = [(i, (i + 1) % n) for i in range(n)]

    # Reduce-scatter: at step s, send the partial sum of chunk (idx - s) to
    # the right neighbor, who folds it into its own copy. After N-1 steps
    # device d holds the complete sum of chunk (d + 1) % n.
    acc = chunks
    for s in range(n - 1):
        send = acc[(idx - s) % n]
        recv = jax.lax.ppermute(send, axis_name, fwd)
        acc = acc.at[(idx - s - 1) % n].add(recv)

    own = (idx + 1) % n
    gathered = jax.lax.all_gather(acc[own], axis_name)   # [N, chunk]
    # device d contributed chunk (d + 1) % n -> reorder into chunk order:
    # chunk c came from device (c - 1) % n
    order = (jnp.arange(n) - 1) % n
    full = gathered[order].reshape(-1)
    if pad:
        full = full[: flat.shape[0] - pad]
    return full.reshape(shape)
