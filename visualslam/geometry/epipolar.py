"""Epipolar geometry: 8-point essential matrix, Sampson error, pose
recovery, triangulation.

Absent in the reference (README.md:21-22 roadmap; SURVEY.md §2.3). Built
batched/vmappable: the 8-point solve is a 9x9 symmetric eigendecomposition
(smallest eigenvector of A^T A — eigh is batched and lowers on every backend, unlike
thin SVD of tall A), rank-2 projection uses a 3x3 SVD, triangulation is a
4x4 eigh per point. Conventions: x2^T E x1 = 0 with x in normalized camera
coords; (R, t) maps points from camera-1 frame to camera-2 frame:
X2 = R X1 + t.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


def _normalize_pts(x: jnp.ndarray, w: jnp.ndarray):
    """Hartley normalization with weights: center + sqrt(2) mean distance.

    x: [N, 2]; w: [N] sample weights (0/1 mask). Returns (xn [N, 2],
    T [3, 3]) with xn = T * x in homogeneous terms."""
    wsum = jnp.maximum(jnp.sum(w), _EPS)
    mean = jnp.sum(x * w[:, None], axis=0) / wsum
    d = jnp.sqrt(jnp.sum((x - mean) ** 2, axis=-1))
    mean_d = jnp.sum(d * w, axis=0) / wsum
    s = jnp.sqrt(2.0) / jnp.maximum(mean_d, _EPS)
    xn = (x - mean) * s
    T = jnp.stack([
        jnp.stack([s, jnp.zeros_like(s), -s * mean[0]]),
        jnp.stack([jnp.zeros_like(s), s, -s * mean[1]]),
        jnp.stack([jnp.zeros_like(s), jnp.zeros_like(s), jnp.ones_like(s)]),
    ])
    return xn, T


def eight_point(*args, **kwargs):
    """f32-matmul-precision wrapper of _eight_point_highp (default
    bf16/TF32 passes degrade geometric accuracy)."""
    with jax.default_matmul_precision("float32"):
        return _eight_point_highp(*args, **kwargs)


def _eight_point_highp(x1: jnp.ndarray, x2: jnp.ndarray,
                w: jnp.ndarray | None = None) -> jnp.ndarray:
    """Weighted 8-point essential/fundamental estimate.

    x1, x2: [N >= 8, 2] correspondences in normalized camera coords;
    w: [N] weights (mask). Returns E [3, 3] with x2^T E x1 = 0, projected to
    the essential manifold (singular values (1, 1, 0))."""
    N = x1.shape[0]
    if w is None:
        w = jnp.ones((N,), x1.dtype)
    x1n, T1 = _normalize_pts(x1, w)
    x2n, T2 = _normalize_pts(x2, w)
    u1, v1 = x1n[:, 0], x1n[:, 1]
    u2, v2 = x2n[:, 0], x2n[:, 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones],
                  axis=-1)                                   # [N, 9]
    Aw = A * w[:, None]
    M = Aw.T @ Aw                                            # [9, 9]
    evals, evecs = jnp.linalg.eigh(M)
    f = evecs[:, 0]                                          # smallest eigval
    F = f.reshape(3, 3)
    F = T2.T @ F @ T1                                        # denormalize
    # project to essential manifold: singular values -> (1, 1, 0)
    U, S, Vt = jnp.linalg.svd(F)
    E = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], F.dtype)) @ Vt
    return E


def sampson_error(E: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray):
    """First-order geometric (Sampson) error. x1, x2: [N, 2] normalized
    coords. Returns [N] squared errors."""
    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], -1)                     # [N, 3]
    p2 = jnp.concatenate([x2, ones], -1)
    Ex1 = p1 @ E.T                                           # = (E @ p1^T)^T
    Etx2 = p2 @ E
    num = jnp.sum(p2 * Ex1, axis=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / jnp.maximum(den, _EPS)


def triangulate(*args, **kwargs):
    """f32-matmul-precision wrapper of _triangulate_highp (default
    bf16/TF32 passes degrade geometric accuracy)."""
    with jax.default_matmul_precision("float32"):
        return _triangulate_highp(*args, **kwargs)


def _triangulate_highp(R: jnp.ndarray, t: jnp.ndarray, x1: jnp.ndarray,
                x2: jnp.ndarray) -> jnp.ndarray:
    """Linear (DLT) triangulation in camera-1 frame.

    R, t: relative pose (X2 = R X1 + t); x1, x2: [N, 2] normalized coords.
    Returns X [N, 3]. Smallest eigenvector of the 4x4 DLT normal matrix."""
    P1 = jnp.concatenate([jnp.eye(3, dtype=R.dtype),
                          jnp.zeros((3, 1), R.dtype)], axis=1)   # [3, 4]
    P2 = jnp.concatenate([R, t[:, None]], axis=1)                # [3, 4]

    def dlt_rows(P, x):
        # rows: x * P3 - P1 ; y * P3 - P2
        return jnp.stack([x[..., 0, None] * P[2] - P[0],
                          x[..., 1, None] * P[2] - P[1]], axis=-2)  # [N, 2, 4]

    A = jnp.concatenate([dlt_rows(P1, x1), dlt_rows(P2, x2)], axis=-2)  # [N,4,4]
    M = jnp.einsum("nij,nik->njk", A, A)                     # [N, 4, 4]
    evals, evecs = jnp.linalg.eigh(M)
    Xh = evecs[..., 0]                                       # [N, 4]
    w = Xh[..., 3]
    sign = jnp.where(w < 0, -1.0, 1.0)
    Xh = Xh * sign[..., None]
    return Xh[..., :3] / jnp.where(jnp.abs(Xh[..., 3:]) < _EPS, _EPS, Xh[..., 3:])


def decompose_essential(E: jnp.ndarray):
    """E -> ((R1, R2), t) candidate decompositions (4 combos with +-t)."""
    U, S, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                  E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return (R1, R2), t


def recover_pose(E: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray,
                 w: jnp.ndarray):
    """Pick the (R, t) among the 4 decompositions with max cheirality
    support. Returns (R, t, X [N, 3], front_mask [N])."""
    (R1, R2), tt = decompose_essential(E)

    def score(R, t):
        X = triangulate(R, t, x1, x2)
        z1 = X[..., 2]
        X2 = (R @ X[..., None])[..., 0] + t
        z2 = X2[..., 2]
        front = (z1 > _EPS) & (z2 > _EPS)
        return jnp.sum(front * w), X, front

    cands = [(R1, tt), (R1, -tt), (R2, tt), (R2, -tt)]
    scores, Xs, fronts = [], [], []
    for R, t in cands:
        s, X, f = score(R, t)
        scores.append(s)
        Xs.append(X)
        fronts.append(f)
    scores = jnp.stack(scores)
    best = jnp.argmax(scores)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    return (Rs[best], ts[best], jnp.stack(Xs)[best], jnp.stack(fronts)[best])
