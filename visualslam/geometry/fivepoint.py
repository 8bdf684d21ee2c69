"""Minimal 5-point essential-matrix solver (Nister's problem), built
as fixed-shape array code with the hidden-variable resultant method.

SURVEY.md §2.3 prescribes "8-point/5-point" minimal solvers; the round-1
engine shipped only 8-point. Five points is the minimal set, so at equal
inlier rates RANSAC needs far fewer hypotheses (p_good = w^5 vs w^8).

The classic Nister solver needs the eigenvalues of a NONSYMMETRIC 10x10
action matrix. This implementation avoids a general eig and keeps every
step batched with fixed shapes:

  1. nullspace basis E = x E1 + y E2 + z E3 + E4 from eigh(A^T A) (9x9);
  2. the 10 cubic constraints (det E = 0, 2 E E^T E - tr(E E^T) E = 0) are
     converted to coefficient form NUMERICALLY: evaluate each constraint at
     20 fixed sample points and multiply by a precomputed inverse
     monomial-Vandermonde — no hand-derived symbolic expansion;
  3. hidden variable z: group the 20 monomials by their (x, y) part into a
     10x10 polynomial matrix M(z) with entries of z-degree <= 3 (column
     z-degrees 0/1/2/3 for the x^3.. / x^2.. / x. / 1 groups — total degree
     of det M(z) is 10, matching Nister);
  4. det M(z) (a degree-10 polynomial) is recovered by evaluating batched
     10x10 LU determinants at 11 fixed z nodes and interpolating through a
     precomputed inverse Vandermonde;
  5. real roots via a tan-substitution sign-change grid + fixed-iteration
     bisection (vmappable, no data-dependent control flow);
  6. per root, the solution (x, y) comes from the eigh-smallest eigenvector
     of M(z*)^T M(z*).

Spurious or lost roots (double roots, >10-candidate edge cases) are handled
by the RANSAC scorer — a missed candidate costs one hypothesis, never
correctness.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Precomputed constants (float64 numpy at import; frozen into the jaxpr).
# ---------------------------------------------------------------------------

# 20 cubic monomials in (x, y, z), grouped by (x, y) part for the hidden-
# variable matrix. XY_GROUPS order defines M(z)'s columns.
_EXPS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0),
    (2, 0, 1), (2, 0, 0), (0, 2, 1), (0, 2, 0),
    (1, 1, 1), (1, 1, 0), (1, 0, 2), (1, 0, 1), (1, 0, 0),
    (0, 1, 2), (0, 1, 1), (0, 1, 0),
    (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_XY_GROUPS = [(3, 0), (0, 3), (2, 1), (1, 2), (2, 0), (0, 2), (1, 1),
              (1, 0), (0, 1), (0, 0)]
_COL_OF = {g: i for i, g in enumerate(_XY_GROUPS)}

# sample points for coefficient extraction: fixed pseudo-random, unit-scale
_rng = np.random.default_rng(12345)
_SAMPLES = _rng.uniform(-1.0, 1.0, (20, 3))
_V = np.stack([[x ** a * y ** b * z ** c for (a, b, c) in _EXPS]
               for x, y, z in _SAMPLES])           # [20 samples, 20 mons]
_VINV = np.linalg.inv(_V)                           # [20, 20]
assert np.linalg.cond(_V) < 1e6

# scatter map: 20-mon coefficient -> (z_degree, column) of M(z)
_ZDEG = np.asarray([c for (_, _, c) in _EXPS])
_COL = np.asarray([_COL_OF[(a, b)] for (a, b, _) in _EXPS])
# one-hot scatter tensor [20 mons, 4 zdeg, 10 cols]
_SCATTER = np.zeros((20, 4, 10))
for k in range(20):
    _SCATTER[k, _ZDEG[k], _COL[k]] = 1.0

# z nodes for det interpolation: degree-10 poly -> 11 Chebyshev nodes x 2
_ZN = 2.0 * np.cos((2 * np.arange(11) + 1) / 22.0 * np.pi)
_ZV = np.stack([_ZN ** k for k in range(11)], axis=1)   # [11 nodes, 11 pow]
_ZVINV = np.linalg.inv(_ZV)

_SAMPLES_J = jnp.asarray(_SAMPLES, jnp.float32)
_VINV_J = jnp.asarray(_VINV, jnp.float32)
_SCATTER_J = jnp.asarray(_SCATTER.reshape(20, 40), jnp.float32)
_ZN_J = jnp.asarray(_ZN, jnp.float32)
_ZVINV_J = jnp.asarray(_ZVINV, jnp.float32)

_N_GRID = 256
_THETA = jnp.asarray(
    np.linspace(-np.pi / 2 + 1e-3, np.pi / 2 - 1e-3, _N_GRID), jnp.float32)

MAX_CANDIDATES = 10


def _constraint_values(Eb, xyz):
    """The 10 cubic constraint polynomials at one (x, y, z)."""
    x, y, z = xyz[0], xyz[1], xyz[2]
    E = x * Eb[0] + y * Eb[1] + z * Eb[2] + Eb[3]
    EEt = E @ E.T
    trace_c = 2.0 * (EEt @ E) - jnp.trace(EEt) * E
    return jnp.concatenate([jnp.linalg.det(E)[None], trace_c.reshape(9)])


def _poly_eval_trig(c, th):
    """q(theta) = sum_k c_k sin^k cos^(10-k): det-poly at z = tan(theta),
    scaled by cos^10 so it stays bounded."""
    s = jnp.sin(th)
    co = jnp.cos(th)
    powers = jnp.stack([s ** k * co ** (10 - k) for k in range(11)])
    return jnp.einsum("k,k...->...", c, powers)


def _real_roots_deg10(c):
    """Real roots of sum c_k z^k (degree <= 10) via sign-change bisection in
    theta = atan(z). Returns (roots [10], valid [10])."""
    c = c / jnp.maximum(jnp.max(jnp.abs(c)), 1e-30)
    vals = _poly_eval_trig(c, _THETA)                     # [G]
    sc = vals[:-1] * vals[1:] < 0                         # [G-1] brackets
    score = jnp.where(sc, jnp.arange(_N_GRID - 1, dtype=jnp.float32),
                      -jnp.inf)
    _, idx = jax.lax.top_k(score, MAX_CANDIDATES)
    valid = sc[idx]
    lo = _THETA[idx]
    hi = _THETA[jnp.minimum(idx + 1, _N_GRID - 1)]
    flo = _poly_eval_trig(c, lo)

    def body(_, carry):
        lo, hi, flo = carry
        mid = 0.5 * (lo + hi)
        fm = _poly_eval_trig(c, mid)
        left = flo * fm > 0
        lo2 = jnp.where(left, mid, lo)
        flo2 = jnp.where(left, fm, flo)
        hi2 = jnp.where(left, hi, mid)
        return lo2, hi2, flo2

    lo, hi, _ = jax.lax.fori_loop(0, 40, body, (lo, hi, flo))
    th = 0.5 * (lo + hi)
    return jnp.tan(th), valid


def five_point(x1: jnp.ndarray, x2: jnp.ndarray):
    """Essential matrices from 5 normalized correspondences.

    x1, x2: [5, 2]. Returns (E [10, 3, 3] candidates, valid [10]); invalid
    slots hold garbage matrices the caller must mask via `valid`.
    Convention matches epipolar.py: x2^T E x1 = 0."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                   u1, v1, ones], axis=-1)                # [5, 9]
    _, vecs = jnp.linalg.eigh(A.T @ A)
    Eb = vecs[:, :4].T.reshape(4, 3, 3)                   # E1..E4

    P = jax.vmap(lambda s: _constraint_values(Eb, s))(_SAMPLES_J)  # [20, 10]
    C = (_VINV_J @ P).T                                   # [10 polys, 20]
    # row-normalize: each constraint polynomial to unit coefficient norm
    # (det M(z) conditioning in f32)
    C = C / jnp.maximum(
        jnp.linalg.norm(C, axis=1, keepdims=True), 1e-30)
    Mz = (C @ _SCATTER_J).reshape(10, 4, 10)              # [10, zdeg, col]
    Mz = jnp.moveaxis(Mz, 1, 0)                           # [zdeg, 10, 10]

    def m_of(z):
        return Mz[0] + z * Mz[1] + (z * z) * Mz[2] + (z ** 3) * Mz[3]

    dets = jax.vmap(lambda z: jnp.linalg.det(m_of(z)))(_ZN_J)   # [11]
    dets = dets / jnp.maximum(jnp.max(jnp.abs(dets)), 1e-30)
    coef = _ZVINV_J @ dets                                # c_0..c_10
    roots, valid = _real_roots_deg10(coef)

    def e_of(z):
        M = m_of(z)
        _, vv = jnp.linalg.eigh(M.T @ M)
        m = vv[:, 0]                                      # xy-monomial vec
        denom = m[9]
        denom = jnp.where(jnp.abs(denom) < 1e-12,
                          jnp.where(denom < 0, -1e-12, 1e-12), denom)
        xyz = jnp.stack([m[7] / denom, m[8] / denom, z])

        # Gauss-Newton polish of (x, y, z) on the 10 constraint values —
        # recovers the accuracy f32 interpolation/bisection leaves behind
        def gn(v, _):
            J = jax.jacfwd(lambda u: _constraint_values(Eb, u))(v)  # [10,3]
            r = _constraint_values(Eb, v)
            H = J.T @ J + 1e-10 * jnp.eye(3, dtype=v.dtype)
            return v - jnp.linalg.solve(H, J.T @ r), None

        xyz, _ = jax.lax.scan(gn, xyz, None, length=3)
        E = (xyz[0] * Eb[0] + xyz[1] * Eb[1] + xyz[2] * Eb[2] + Eb[3])
        return E / jnp.maximum(jnp.linalg.norm(E), 1e-12)

    Es = jax.vmap(e_of)(roots)
    return Es, valid
