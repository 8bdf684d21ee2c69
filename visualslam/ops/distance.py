"""All-pairs descriptor distance matrices.

Absent in the reference (README.md:17 lists "Image Matching" as roadmap only;
SURVEY.md §2.3). Both metrics are expressed as matmuls —
  squared L2:  |a|^2 + |b|^2 - 2 a.b           (one [Ka,D]x[D,Kb] matmul)
  Hamming:     |a| + |b| - 2 a.b  on unpacked {0,1} bits (popcount-free)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def l2sq_distance_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Squared-L2 distances. a: [Ka, D], b: [Kb, D] -> [Ka, Kb] float32."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    # HIGHEST: reduced-precision passes (bf16 ~1e-2, TF32 ~1e-3 error on
    # a.b) flip near-tied ratio-test matches of L2-normalized SIFT
    # descriptors; the matmul is ~1 GFLOP at matcher shapes
    ab = jnp.dot(a, b.T, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    na = jnp.sum(a * a, axis=-1, keepdims=True)
    nb = jnp.sum(b * b, axis=-1, keepdims=True)
    return jnp.maximum(na + nb.T - 2.0 * ab, 0.0)


def unpack_bits(packed: jnp.ndarray, bits: int = 32) -> jnp.ndarray:
    """[K, W] uint32 -> [K, W*32] {0,1} float32 (little-endian bit order)."""
    shifts = jnp.arange(bits, dtype=jnp.uint32)
    b = (packed[..., None] >> shifts) & jnp.uint32(1)
    return b.reshape(packed.shape[0], -1).astype(jnp.float32)


def hamming_distance_matrix(a_packed: jnp.ndarray,
                            b_packed: jnp.ndarray) -> jnp.ndarray:
    """Hamming distances between bit-packed descriptors ([K, W] uint32).

    Computed as a matmul on unpacked bits (Hamming = |a| + |b| - 2 a.b for
    binary vectors) so it is one matmul instead of per-pair popcounts."""
    a = unpack_bits(a_packed)
    b = unpack_bits(b_packed)
    ab = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    na = jnp.sum(a, axis=-1, keepdims=True)
    nb = jnp.sum(b, axis=-1, keepdims=True)
    return na + nb.T - 2.0 * ab
