"""Bundle-adjustment tests on synthetic scenes with known ground truth."""

import numpy as np

import jax
import jax.numpy as jnp

from visualslam.backend.ba import (
    BAProblem,
    _residuals_jacobians,
    robust_cost,
    run_ba_jit,
)
from visualslam.geometry import se3
from visualslam.utils.config import BAConfig


def make_ba_problem(rng, n_cams=6, n_lms=300, pose_noise=0.02,
                    point_noise=0.05, pix_noise=0.0, drop=0.2):
    """Cameras on an arc looking at a point cloud; perturbed initialization."""
    X_gt = rng.uniform([-3, -2, 6], [3, 2, 12], (n_lms, 3))
    R_gt, t_gt = [], []
    for c in range(n_cams):
        w = np.array([0.0, 0.05 * c, 0.0])
        R = np.asarray(se3.exp_so3(jnp.asarray(w)))
        center = np.array([0.6 * c - 0.3 * n_cams, 0.0, 0.0])
        R_gt.append(R)
        t_gt.append(-R @ center)
    R_gt = np.stack(R_gt)
    t_gt = np.stack(t_gt)

    # observations: every camera sees a random subset
    cams, lms, uvs = [], [], []
    for c in range(n_cams):
        seen = rng.random(n_lms) > drop
        idx = np.nonzero(seen)[0]
        Xc = X_gt[idx] @ R_gt[c].T + t_gt[c]
        uv = Xc[:, :2] / Xc[:, 2:]
        if pix_noise:
            uv = uv + rng.normal(0, pix_noise, uv.shape)
        cams.append(np.full(len(idx), c))
        lms.append(idx)
        uvs.append(uv)
    cam_idx = np.concatenate(cams)
    lm_idx = np.concatenate(lms)
    uv = np.concatenate(uvs)
    O = len(cam_idx)

    # perturb initial state (keep camera 0 exact: it's the gauge)
    xi = rng.normal(0, pose_noise, (n_cams, 6))
    xi[0] = 0
    dR, dt = se3.se3_exp(jnp.asarray(xi, jnp.float32))
    R0 = np.asarray(dR) @ R_gt
    t0 = np.einsum("cij,cj->ci", np.asarray(dR), t_gt) + np.asarray(dt)
    X0 = X_gt + rng.normal(0, point_noise, X_gt.shape)

    p = BAProblem(
        R=jnp.asarray(R0, jnp.float32),
        t=jnp.asarray(t0, jnp.float32),
        X=jnp.asarray(X0, jnp.float32),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        lm_idx=jnp.asarray(lm_idx, jnp.int32),
        uv=jnp.asarray(uv, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        cam_valid=jnp.ones(n_cams, bool),
        lm_valid=jnp.ones(n_lms, bool),
    )
    return p, R_gt, t_gt, X_gt


def test_jacobians_match_autodiff(rng):
    """Analytic Jacobians vs jax.jacfwd of the residual function."""
    p, *_ = make_ba_problem(rng, n_cams=3, n_lms=20)
    r, Jc, Jl, w = _residuals_jacobians(p, p.R, p.t, p.X, huber_delta=1e9)

    o = 7  # arbitrary observation
    c = int(p.cam_idx[o])
    l = int(p.lm_idx[o])

    def res(xi, dX):
        dRc, dtc = se3.se3_exp(xi)
        R = dRc @ p.R[c]
        t = (dRc @ p.t[c]) + dtc
        X = p.X[l] + dX
        pc = R @ X + t
        return pc[:2] / pc[2] - p.uv[o]

    Jc_ad = jax.jacfwd(res, argnums=0)(jnp.zeros(6), jnp.zeros(3))
    Jl_ad = jax.jacfwd(res, argnums=1)(jnp.zeros(6), jnp.zeros(3))
    np.testing.assert_allclose(np.asarray(Jc[o]), np.asarray(Jc_ad),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(Jl[o]), np.asarray(Jl_ad),
                               rtol=1e-3, atol=1e-5)


def test_ba_converges_noiseless(rng):
    """Perfect measurements, perturbed init -> BA recovers GT nearly exactly."""
    p, R_gt, t_gt, X_gt = make_ba_problem(rng)
    cfg = BAConfig(iters=15)
    res = run_ba_jit(p, cfg)
    assert float(res.cost) < float(res.initial_cost) * 1e-4, (
        f"cost {float(res.initial_cost):.3e} -> {float(res.cost):.3e}")
    # camera rotation errors
    for c in range(R_gt.shape[0]):
        Rr = np.asarray(res.R[c])
        cos = (np.trace(Rr.T @ R_gt[c]) - 1) / 2
        err = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        assert err < 0.1, f"cam {c} rot err {err:.3f} deg"


def test_ba_noisy_observations(rng):
    """With measurement noise BA still reduces cost and stays near GT."""
    p, R_gt, t_gt, X_gt = make_ba_problem(rng, pix_noise=1e-3)
    res = run_ba_jit(p, BAConfig(iters=10))
    assert float(res.cost) < float(res.initial_cost) * 0.2
    Rr = np.asarray(res.R[3])
    cos = (np.trace(Rr.T @ R_gt[3]) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.5


def test_ba_respects_masks(rng):
    """Invalid observations/landmarks must not move the solution."""
    p, *_ = make_ba_problem(rng, n_cams=4, n_lms=100)
    # poison half the observations wildly but mark them invalid
    O = p.uv.shape[0]
    bad = np.zeros(O, bool)
    bad[::2] = True
    uv_poisoned = np.array(p.uv)
    uv_poisoned[bad] += 100.0
    p2 = p._replace(uv=jnp.asarray(uv_poisoned),
                    obs_valid=jnp.asarray(~bad))
    res = run_ba_jit(p2, BAConfig(iters=10))
    # cost over the valid half only; must still converge
    assert float(res.cost) < float(res.initial_cost) * 1e-3


def test_ba_gauge_fixed_camera(rng):
    p, R_gt, t_gt, _ = make_ba_problem(rng, n_cams=4, n_lms=120)
    res = run_ba_jit(p, BAConfig(iters=8))
    np.testing.assert_allclose(np.asarray(res.R[0]), np.asarray(p.R[0]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.t[0]), np.asarray(p.t[0]),
                               atol=1e-6)


def test_ba_cg_solver_matches_dense(rng):
    """schur_cg and schur_dense converge to the same optimum."""
    p, R_gt, t_gt, X_gt = make_ba_problem(rng, n_cams=5, n_lms=200)
    r_dense = run_ba_jit(p, BAConfig(iters=10, solver="schur_dense"))
    r_cg = run_ba_jit(p, BAConfig(iters=10, solver="schur_cg", cg_iters=60))
    assert float(r_cg.cost) < float(r_cg.initial_cost) * 1e-3
    np.testing.assert_allclose(np.asarray(r_cg.R), np.asarray(r_dense.R),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(r_cg.t), np.asarray(r_dense.t),
                               atol=2e-2)


def test_ba_matrix_free_matches_dense(rng):
    """schur_mf (matrix-free CG: no [C,L,6,3] coupling, no [C,6,C,6]
    reduced system) reaches the same optimum as the dense solver."""
    p, R_gt, t_gt, X_gt = make_ba_problem(rng, n_cams=5, n_lms=200)
    r_dense = run_ba_jit(p, BAConfig(iters=10, solver="schur_dense"))
    r_mf = run_ba_jit(p, BAConfig(iters=10, solver="schur_mf", cg_iters=60))
    assert float(r_mf.cost) < float(r_mf.initial_cost) * 1e-3
    np.testing.assert_allclose(np.asarray(r_mf.R), np.asarray(r_dense.R),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(r_mf.t), np.asarray(r_dense.t),
                               atol=2e-2)


def test_ba_matrix_free_step_matches_dense_step(rng):
    """One matrix-free GN step equals one dense-Schur step (same linear
    system, different solve path) to CG tolerance."""
    from visualslam.backend.ba import ba_step

    p, *_ = make_ba_problem(rng, n_cams=4, n_lms=120)
    lam = jnp.asarray(1e-3)
    dense = ba_step(p, p.R, p.t, p.X, lam,
                    BAConfig(iters=1, solver="schur_dense"))
    mf = ba_step(p, p.R, p.t, p.X, lam,
                 BAConfig(iters=1, solver="schur_mf", cg_iters=200))
    for a, b in zip(dense, mf):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=3e-4)
