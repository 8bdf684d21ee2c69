"""Scale-space extrema detection + sub-pixel localization.

Reference: `initialKeypointDetection` scans a 3x3x3 neighborhood on a
stride-3 grid (Diff_of_Gauss.cpp:254-297 — quirk (c): the stride skips ~8/9
of candidates) and `FeaturePointLocalization` does a quadratic fit + contrast
test (223-251 — quirk (e): never applies the fitted offset);
`computeEdgeResponse` does the Hessian edge rejection (79-109).

Here the 26-neighbor comparison is a DENSE elementwise program over the
whole DoG stack (27 shifted slices, all-reduce of comparisons; XLA fuses it
into one pass), then a single top-k picks fixed-capacity candidates, and the quadratic fit runs
batched on gathered 3x3x3 cubes with a closed-form 3x3 solve. Dense scan is
the documented delta from the reference's stride-3 grid (we find strictly
more extrema).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from visualslam.utils.config import SiftConfig
from visualslam.utils.masked import block_top_k_select


def extrema_mask(dog: jnp.ndarray) -> jnp.ndarray:
    """Strict 26-neighbor extrema of a DoG stack.

    dog: [D, H, W]. Returns bool [D, H, W]; True only at interior positions
    (levels 1..D-2, spatial 1..H-2/1..W-2) that are strictly greater than all
    26 neighbors or strictly smaller than all 26 (ref comparison at
    Diff_of_Gauss.cpp:273-284).
    """
    D, H, W = dog.shape
    c = dog[1:-1, 1:-1, 1:-1]                                  # [D-2, H-2, W-2]
    gt = jnp.ones_like(c, dtype=bool)
    lt = jnp.ones_like(c, dtype=bool)
    for dl in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dl == dy == dx == 0:
                    continue
                n = dog[1 + dl: D - 1 + dl,
                        1 + dy: H - 1 + dy,
                        1 + dx: W - 1 + dx]
                gt &= c > n
                lt &= c < n
    interior = gt | lt
    return jnp.pad(interior, ((1, 1), (1, 1), (1, 1)))


class Localized(NamedTuple):
    """Batched localization result for K candidates."""

    offset: jnp.ndarray     # [K, 3] fitted sub-pixel offset (ds, dy, dx)
    contrast: jnp.ndarray   # [K] interpolated |D(z-hat)| contrast value (signed)
    edge_ok: jnp.ndarray    # [K] passes the r=10 edge test
    converged: jnp.ndarray  # [K] offset within bounds / solvable


def gather_cubes(dog: jnp.ndarray, lvl: jnp.ndarray, y: jnp.ndarray,
                 x: jnp.ndarray) -> jnp.ndarray:
    """Gather [K, 3, 3, 3] neighborhoods centered at (lvl, y, x) (interior).

    One flat [K, 27] take with precomputed neighbor offsets instead of a
    vmapped dynamic_slice (a gather of K strided sub-arrays)."""
    D, H, W = dog.shape
    base = (lvl * H + y) * W + x                                # [K]
    offs = jnp.asarray([(dl * H + dy) * W + dx
                        for dl in (-1, 0, 1)
                        for dy in (-1, 0, 1)
                        for dx in (-1, 0, 1)], jnp.int32)       # [27]
    idx = base[:, None] + offs[None, :]
    return jnp.take(dog.reshape(-1), idx, axis=0).reshape(-1, 3, 3, 3)


def localize(cubes: jnp.ndarray, cfg: SiftConfig) -> Localized:
    """Quadratic fit on 3x3x3 DoG cubes (axes: [scale, y, x]).

    Solves H z = -g for the sub-pixel offset, computes the interpolated
    contrast D + g.z/2 (ref Diff_of_Gauss.cpp:226-249) and the principal-
    curvature edge test tr^2/det < (r+1)^2/r on the spatial Hessian
    (ref :105-108).
    """
    c = cubes
    d0 = c[:, 1, 1, 1]
    # gradient (central differences)
    gs = 0.5 * (c[:, 2, 1, 1] - c[:, 0, 1, 1])
    gy = 0.5 * (c[:, 1, 2, 1] - c[:, 1, 0, 1])
    gx = 0.5 * (c[:, 1, 1, 2] - c[:, 1, 1, 0])
    g = jnp.stack([gs, gy, gx], axis=-1)                        # [K, 3]
    # Hessian
    hss = c[:, 2, 1, 1] + c[:, 0, 1, 1] - 2 * d0
    hyy = c[:, 1, 2, 1] + c[:, 1, 0, 1] - 2 * d0
    hxx = c[:, 1, 1, 2] + c[:, 1, 1, 0] - 2 * d0
    hsy = 0.25 * (c[:, 2, 2, 1] - c[:, 2, 0, 1] - c[:, 0, 2, 1] + c[:, 0, 0, 1])
    hsx = 0.25 * (c[:, 2, 1, 2] - c[:, 2, 1, 0] - c[:, 0, 1, 2] + c[:, 0, 1, 0])
    hyx = 0.25 * (c[:, 1, 2, 2] - c[:, 1, 2, 0] - c[:, 1, 0, 2] + c[:, 1, 0, 0])
    H = jnp.stack([
        jnp.stack([hss, hsy, hsx], -1),
        jnp.stack([hsy, hyy, hyx], -1),
        jnp.stack([hsx, hyx, hxx], -1),
    ], axis=-2)                                                  # [K, 3, 3]

    # Closed-form 3x3 solve via adjugate (batched; avoids LAPACK inside jit).
    det = (hss * (hyy * hxx - hyx * hyx)
           - hsy * (hsy * hxx - hyx * hsx)
           + hsx * (hsy * hyx - hyy * hsx))
    solvable = jnp.abs(det) > 1e-12
    safe_det = jnp.where(solvable, det, 1.0)
    adj = jnp.stack([
        jnp.stack([hyy * hxx - hyx * hyx, hsx * hyx - hsy * hxx,
                   hsy * hyx - hsx * hyy], -1),
        jnp.stack([hyx * hsx - hsy * hxx, hss * hxx - hsx * hsx,
                   hsy * hsx - hss * hyx], -1),
        jnp.stack([hsy * hyx - hyy * hsx, hsx * hsy - hss * hyx,
                   hss * hyy - hsy * hsy], -1),
    ], axis=-2)
    # note: adjugate of symmetric matrix is symmetric; rows above are cofactor
    # transposes arranged directly.
    z = -jnp.einsum("kij,kj->ki", adj, g) / safe_det[:, None]    # [K, 3]

    contrast = d0 + 0.5 * jnp.einsum("ki,ki->k", g, z)

    # Edge test on the spatial 2x2 Hessian (ref computeEdgeResponse :93-108).
    tr = hxx + hyy
    det2 = hxx * hyy - hyx * hyx
    r = cfg.edge_r
    edge_ok = (det2 > 0) & (tr * tr * r < det2 * (r + 1.0) ** 2)

    in_bounds = jnp.all(jnp.abs(z) <= 1.5, axis=-1)
    converged = solvable & in_bounds
    return Localized(offset=z, contrast=contrast, edge_ok=edge_ok,
                     converged=converged)


def detect_extrema(dog: jnp.ndarray, cfg: SiftConfig,
                   capacity: int | None = None):
    """Full per-octave candidate detection.

    dog: [D, H, W] DoG stack of one octave. Returns
    (lvl[K], y[K], x[K], offset[K,3], score[K], valid[K]) with
    K = capacity (default cfg.max_keypoints_per_octave); (y, x) are
    integer grid positions, offset the clamped sub-pixel refinement
    (ds, dy, dx).
    """
    D, H, W = dog.shape
    k = capacity if capacity is not None else cfg.max_keypoints_per_octave
    mask = extrema_mask(dog)
    score = jnp.abs(dog)
    # Cheap pre-filter: half the final contrast threshold before
    # refinement (standard SIFT practice; the reference filters only after
    # interpolation).
    mask &= score > 0.5 * cfg.contrast_threshold
    idx, sel = block_top_k_select(score.reshape(-1), mask.reshape(-1), k)
    lvl = (idx // (H * W)).astype(jnp.int32)
    rem = idx % (H * W)
    y = (rem // W).astype(jnp.int32)
    x = (rem % W).astype(jnp.int32)
    # masked-out slots: point them at a safe interior location
    lvl = jnp.where(sel, lvl, 1)
    y = jnp.where(sel, y, 1)
    x = jnp.where(sel, x, 1)

    cubes = gather_cubes(dog, lvl, y, x)
    loc = localize(cubes, cfg)
    valid = (sel & loc.converged & loc.edge_ok
             & (jnp.abs(loc.contrast) > cfg.contrast_threshold))
    offset = jnp.clip(loc.offset, -0.5, 0.5)
    return lvl, y, x, offset, jnp.abs(loc.contrast), valid
