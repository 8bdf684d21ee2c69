"""Fixed-capacity masked-set utilities.

The reference accumulates keypoints in `std::vector<SLAM::point>` with
data-dependent append loops (Diff_of_Gauss.cpp:287-290, 362-369). Under XLA
everything must be static-shape, so the whole engine represents "a set of at
most K things" as a struct-of-arrays with a boolean validity mask, and these
helpers replace the append/erase flows:

  - `top_k_select`: dense score map -> top-K flat indices + mask
  - `compact`: push valid entries to the front (stable) so downstream
    fixed-size gathers touch a contiguous prefix
  - `merge`: concatenate two masked sets into a fixed capacity, best-first

All are pure jnp and safe under jit/vmap/shard_map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -jnp.inf


def top_k_select(scores: jnp.ndarray, valid: jnp.ndarray, k: int,
                 approx: bool = False):
    """Select top-k entries of a flat score vector restricted to `valid`.

    Returns (indices[k], mask[k]) where mask marks selections that were
    actually valid (if fewer than k valid entries exist, the tail is masked
    out and indices there are arbitrary but in-range).

    approx=True uses jax.lax.approx_max_k — a partial-reduce
    top-k (recall ~0.95), far faster than exact top_k on multi-million-
    element score maps. Use it where candidates are then re-filtered anyway
    (e.g. extrema selection; exact on CPU regardless).
    """
    n = scores.shape[0]
    # exact top_k needs finite scores; approx_max_k handles -inf fine, but
    # use a large negative sentinel so masked slots never win either way
    scores = jnp.where(valid, scores, NEG_INF)
    kk = min(k, n)
    if approx:
        top_scores, idx = jax.lax.approx_max_k(scores, kk,
                                               recall_target=0.95)
    else:
        top_scores, idx = jax.lax.top_k(scores, kk)
    if kk < k:  # capacity exceeds population: pad with masked slots
        idx = jnp.concatenate([idx, jnp.zeros((k - kk,), idx.dtype)])
        top_scores = jnp.concatenate(
            [top_scores, jnp.full((k - kk,), NEG_INF, top_scores.dtype)])
    mask = top_scores > NEG_INF
    return idx, mask


def block_top_k_select(scores: jnp.ndarray, valid: jnp.ndarray, k: int,
                       block: int | None = None):
    """Two-stage top-k for multi-million-element score maps.

    XLA's exact TopK lowers to a full sort (O(N log N) — ~50 ms on a 3M
    score map), so dense detectors use this instead: stage 1 reduces each
    `block` consecutive scores to their max+argmax (one fast VPU pass);
    stage 2 runs exact top-k over the N/block block winners.

    Semantics delta vs exact top-k: at most ONE candidate per block (a run
    of `block` flat-index-consecutive pixels). For detection score maps this
    acts as an extra 1-D NMS that improves spatial spread; true extrema are
    sparse, so collisions are rare. Returns (indices[k], mask[k]).
    """
    n = scores.shape[0]
    if block is None:
        # adaptive: keep >= ~16k blocks so dense detections don't collide
        # (a block admits at most one candidate)
        block = 1
        while block * 2 <= n // (16 * k):
            block *= 2
    if block < 8 or n <= 4 * block:
        return top_k_select(scores, valid, k)
    pad = (-n) % block
    s = jnp.where(valid, scores, NEG_INF)
    if pad:
        s = jnp.concatenate([s, jnp.full((pad,), NEG_INF, s.dtype)])
    nb = s.shape[0] // block
    sb = s.reshape(nb, block)
    bmax = jnp.max(sb, axis=1)
    barg = jnp.argmax(sb, axis=1)
    kk = min(k, nb)
    top, bidx = jax.lax.top_k(bmax, kk)
    idx = bidx * block + barg[bidx]
    if kk < k:
        idx = jnp.concatenate([idx, jnp.zeros((k - kk,), idx.dtype)])
        top = jnp.concatenate([top, jnp.full((k - kk,), NEG_INF, top.dtype)])
    mask = top > NEG_INF
    idx = jnp.minimum(idx, n - 1)
    return idx, mask


def compact(mask: jnp.ndarray, *arrays: jnp.ndarray):
    """Stable-compact: reorder so all valid entries come first.

    Returns (new_mask, *reordered_arrays). Invalid slots keep *some* value
    (the original invalid entries, in order) but are masked.
    """
    n = mask.shape[0]
    # Stable argsort on (not valid): valid entries (0) first, preserving order.
    order = jnp.argsort(jnp.logical_not(mask), stable=True)
    new_mask = jnp.arange(n) < jnp.sum(mask)
    return (new_mask,) + tuple(a[order] for a in arrays)


def merge(score_a, mask_a, score_b, mask_b, k: int, *array_pairs):
    """Merge two masked sets, keeping the k best by score.

    array_pairs is a flat sequence (a0, b0, a1, b1, ...) of matching arrays.
    Returns (scores[k], mask[k], *merged_arrays).
    """
    assert len(array_pairs) % 2 == 0
    scores = jnp.concatenate([jnp.where(mask_a, score_a, NEG_INF),
                              jnp.where(mask_b, score_b, NEG_INF)])
    top_scores, idx = jax.lax.top_k(scores, k)
    mask = top_scores > NEG_INF
    merged = []
    for i in range(0, len(array_pairs), 2):
        cat = jnp.concatenate([array_pairs[i], array_pairs[i + 1]], axis=0)
        merged.append(cat[idx])
    return (jnp.where(mask, top_scores, 0.0), mask) + tuple(merged)


def masked_mean(x: jnp.ndarray, mask: jnp.ndarray, axis=None, eps: float = 1e-12):
    m = mask.astype(x.dtype)
    return jnp.sum(x * m, axis=axis) / (jnp.sum(m, axis=axis) + eps)
