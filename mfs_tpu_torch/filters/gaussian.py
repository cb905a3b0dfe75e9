"""Gaussian (Kalman-family) filters and smoothers.

Port of ``mfs_tpu/filters/gaussian.py``: the Kalman filter and RTS
smoother, the extended Kalman filter and smoother, their
continuous-discrete RK4 variants, and sigma-point (Gauss–Hermite /
cubature) filters and smoothers.  Each filter returns filtering means,
covariances and the running negative log likelihood.

Batch-first: ``m0 (..., d)``, ``v0 (..., d, d)`` and ``ys (T, ..., dy)``
may carry leading trial axes, and a Python loop over time replaces
``lax.scan``.  Callbacks take batches of states, e.g.
``state_cond_m_cov(x (..., d), dt) -> ((..., d), (..., d, d))``; the
sigma-point filters call them on ``(P, ..., d)`` points (the rule's
point axis leads, ``sigma_points.py``), and a callback may return a
constant covariance that broadcasts.  The EKF Jacobians are
``torch.func.jacrev`` (or ``jacfwd``) of the callback at one state,
vmapped over the trials.  A Cholesky factor of a matrix that is not
positive definite comes back NaN, as in JAX, so a diverged trial does
not stop the batch.
"""
import math
from typing import Callable, Tuple

import torch
from torch.func import jacfwd, jacrev, vmap

from mfs_tpu_torch.filters.sigma_points import SigmaPoints, rk4_m_cov, rk4_m_cov_backward
from mfs_tpu_torch.typings import Array, FloatScalar


def _mv(A: Array, x: Array) -> Array:
    return (A @ x[..., None])[..., 0]


def _outer(a: Array, b: Array) -> Array:
    return a[..., :, None] * b[..., None, :]


def _point_outer(a: Array, b: Array) -> Array:
    return torch.einsum("p...j,p...k->p...jk", a, b)


def _cholesky(A: Array) -> Array:
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], float("nan"), L)


def _jacobian(f: Callable, x: Array, forward: bool) -> Array:
    """Per-trial Jacobian of ``f`` at ``x (..., d)``: ``(..., dy, d)``."""
    flat = x.reshape(-1, x.shape[-1])
    J = vmap(jacfwd(f) if forward else jacrev(f))(flat)
    return J.reshape(x.shape[:-1] + J.shape[1:])


def _log_mvn_pdf(x: Array, mu: Array, chol: Array) -> Array:
    z = torch.linalg.solve_triangular(chol, (x - mu)[..., None], upper=False)[..., 0]
    half_log_det = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    k = x.shape[-1]
    return -0.5 * torch.sum(z * z, dim=-1) - half_log_det - 0.5 * k * math.log(2.0 * math.pi)


def _predict_linear(F: Array, Sigma: Array, m: Array, P: Array) -> Tuple[Array, Array]:
    return _mv(F, m), F @ P @ F.mT + Sigma


def _update_linear(
    mp: Array, vp: Array, H: Array, pred_y: Array, Xi: Array, y: Array
) -> Tuple[Array, Array, Array]:
    """Gaussian measurement update; returns (mean, cov, nell increment)."""
    S = H @ vp @ H.mT + Xi
    chol = _cholesky(S)
    K = torch.cholesky_solve(H @ vp, chol).mT
    nell_inc = -_log_mvn_pdf(y, pred_y, chol)
    return mp + _mv(K, y - pred_y), vp - K @ S @ K.mT, nell_inc


def _smooth_shared(
    DT: Array, mf: Array, vf: Array, mp: Array, vp: Array, ms: Array, vs: Array
) -> Tuple[Array, Array]:
    """One step of the generic Gaussian smoother given D^T = Cov[x_k, x_{k+1}]^T."""
    G = torch.cholesky_solve(DT, _cholesky(vp)).mT
    return mf + _mv(G, ms - mp), vf + G @ (vs - vp) @ G.mT


def _filter_loop(step: Callable, m0: Array, v0: Array, ys: Array):
    mf, vf = m0, v0
    nell = torch.zeros(m0.shape[:-1], dtype=m0.dtype, device=m0.device)
    mfs, vfs, nells = [], [], []
    for y in ys:
        mf, vf, inc = step(mf, vf, y)
        nell = nell + inc
        mfs.append(mf)
        vfs.append(vf)
        nells.append(nell)
    return torch.stack(mfs), torch.stack(vfs), torch.stack(nells)


def _smoother_loop(step: Callable, mfs: Array, vfs: Array) -> Tuple[Array, Array]:
    """The reverse scan: ``step(ms, vs, mf, vf)`` from the last filtering
    estimate back to the first; returns the smoothed (T, ...) stacks."""
    ms, vs = mfs[-1], vfs[-1]
    mss, vss = [ms], [vs]
    for t in range(mfs.shape[0] - 2, -1, -1):
        ms, vs = step(ms, vs, mfs[t], vfs[t])
        mss.append(ms)
        vss.append(vs)
    return torch.stack(mss[::-1]), torch.stack(vss[::-1])


def kf(
    F: Array, Sigma: Array, H: Array, Xi: Array, m0: Array, v0: Array, ys: Array
) -> Tuple[Array, Array, Array]:
    """Kalman filter for linear-Gaussian state-space models.

    Returns filtering means (T, ..., dx), covariances (T, ..., dx, dx),
    and the running negative log likelihood (T, ...).
    """

    def step(mf, vf, y):
        mp, vp = _predict_linear(F, Sigma, mf, vf)
        return _update_linear(mp, vp, H, _mv(H, mp), Xi, y)

    return _filter_loop(step, m0, v0, ys)


def rts(F: Array, Sigma: Array, mfs: Array, vfs: Array) -> Tuple[Array, Array]:
    """Rauch–Tung–Striebel smoother from Kalman filtering results."""

    def step(ms, vs, mf, vf):
        return _smooth_shared(F @ vf, mf, vf, _mv(F, mf), F @ vf @ F.mT + Sigma, ms, vs)

    return _smoother_loop(step, mfs, vfs)


def _linearised_update(measurement_cond_m_cov, fwd_jacobian):
    def update(mp, vp, y):
        jac = _jacobian(lambda u: measurement_cond_m_cov(u)[0], mp, fwd_jacobian)
        pred_m, pred_cov = measurement_cond_m_cov(mp)
        return _update_linear(mp, vp, jac, pred_m, pred_cov, y)

    return update


def _linearised_predict(state_cond_m_cov, dt, mf, vf):
    jacF = _jacobian(lambda u: state_cond_m_cov(u, dt)[0], mf, True)
    mp, Sigma = state_cond_m_cov(mf, dt)
    return jacF, mp, jacF @ vf @ jacF.mT + Sigma


def ekf(
    state_cond_m_cov: Callable[[Array, FloatScalar], Tuple[Array, Array]],
    measurement_cond_m_cov: Callable[[Array], Tuple[Array, Array]],
    m0: Array,
    v0: Array,
    dt: FloatScalar,
    ys: Array,
    fwd_jacobian: bool = False,
) -> Tuple[Array, Array, Array]:
    """Extended Kalman filter (first-order linearisation)."""
    update = _linearised_update(measurement_cond_m_cov, fwd_jacobian)

    def step(mf, vf, y):
        _, mp, vp = _linearised_predict(state_cond_m_cov, dt, mf, vf)
        return update(mp, vp, y)

    return _filter_loop(step, m0, v0, ys)


def eks(
    state_cond_m_cov: Callable[[Array, FloatScalar], Tuple[Array, Array]],
    mfs: Array,
    vfs: Array,
    dt: FloatScalar,
) -> Tuple[Array, Array]:
    """Extended Kalman smoother."""

    def step(ms, vs, mf, vf):
        jacF, mp, vp = _linearised_predict(state_cond_m_cov, dt, mf, vf)
        return _smooth_shared(jacF @ vf, mf, vf, mp, vp, ms, vs)

    return _smoother_loop(step, mfs, vfs)


def cd_ekf(
    drift: Callable[[Array], Array],
    dispersion: Callable[[Array], Array],
    measurement_cond_m_cov: Callable[[Array], Tuple[Array, Array]],
    m0: Array,
    v0: Array,
    dt: FloatScalar,
    ys: Array,
    fwd_jacobian: bool = False,
) -> Tuple[Array, Array, Array]:
    """Continuous-discrete EKF: RK4 on the mean/cov moment ODEs."""
    update = _linearised_update(measurement_cond_m_cov, fwd_jacobian)

    def odes(m, v):
        J = _jacobian(drift, m, True)
        b = dispersion(m)
        return drift(m), v @ J.mT + J @ v + b @ b.mT

    def step(mf, vf, y):
        mp, vp = rk4_m_cov(odes, mf, vf, dt)
        return update(mp, vp, y)

    return _filter_loop(step, m0, v0, ys)


def cd_eks(
    drift: Callable[[Array], Array],
    dispersion: Callable[[Array], Array],
    mfs: Array,
    vfs: Array,
    dt: FloatScalar,
) -> Tuple[Array, Array]:
    """Continuous-discrete EKS: backward RK4 smoothing ODEs."""
    dt = -dt

    def odes(m, v, mf, vf):
        b = dispersion(m)
        gamma = b @ b.mT
        L = _cholesky(vf)
        A = _jacobian(drift, m, True) + torch.cholesky_solve(gamma.mT, L).mT
        dm = drift(m) + _mv(gamma, torch.cholesky_solve((m - mf)[..., None], L)[..., 0])
        dv = A @ v + v @ A.mT - gamma
        return dm, dv

    def step(ms, vs, mf, vf):
        return rk4_m_cov_backward(odes, ms, vs, mf, vf, dt)

    return _smoother_loop(step, mfs, vfs)


def _sgp_predict(sgps, cond_m_cov, dt, mf, vf):
    chi = sgps.gen_sigma_points(mf, _cholesky(vf))
    ms, covs = cond_m_cov(chi, dt)
    mp = sgps.expectation(ms)
    vp = sgps.expectation(_point_outer(ms, ms) + covs) - _outer(mp, mp)
    return mp, vp, chi, ms


def _sgp_update(sgps, meas_m_cov, mp, vp, y, const_measurement_cov=False):
    chi = sgps.gen_sigma_points(mp, _cholesky(vp))
    ms, xis = meas_m_cov(chi)
    pred = sgps.expectation(ms)
    outer = _point_outer(ms, ms)
    if const_measurement_cov:
        xi0 = torch.broadcast_to(xis, outer.shape)[0]
        S = sgps.expectation(outer) - _outer(pred, pred) + xi0
    else:
        S = sgps.expectation(outer + xis) - _outer(pred, pred)
    C = sgps.expectation(_point_outer(chi, ms)) - _outer(mp, pred)
    chol = _cholesky(S)
    K = torch.cholesky_solve(C.mT, chol).mT
    return mp + _mv(K, y - pred), vp - K @ S @ K.mT, -_log_mvn_pdf(y, pred, chol)


def sgp_filter(
    state_cond_m_cov: Callable[[Array, FloatScalar], Tuple[Array, Array]],
    measurement_cond_m_cov: Callable[[Array], Tuple[Array, Array]],
    sgps: SigmaPoints,
    m0: Array,
    v0: Array,
    dt: FloatScalar,
    ys: Array,
    const_measurement_cov: bool = False,
) -> Tuple[Array, Array, Array]:
    """Sigma-point (e.g. Gauss–Hermite) filter on a discretised SDE."""

    def step(mf, vf, y):
        mp, vp, _, _ = _sgp_predict(sgps, state_cond_m_cov, dt, mf, vf)
        return _sgp_update(sgps, measurement_cond_m_cov, mp, vp, y, const_measurement_cov)

    return _filter_loop(step, m0, v0, ys)


def sgp_smoother(
    state_cond_m_cov: Callable[[Array, FloatScalar], Tuple[Array, Array]],
    sgps: SigmaPoints,
    mfs: Array,
    vfs: Array,
    dt: FloatScalar,
) -> Tuple[Array, Array]:
    """Sigma-point smoother."""

    def step(ms, vs, mf, vf):
        mp, vp, chi, prop_ms = _sgp_predict(sgps, state_cond_m_cov, dt, mf, vf)
        D = sgps.expectation(_point_outer(chi, prop_ms)) - _outer(mf, mp)
        return _smooth_shared(D.mT, mf, vf, mp, vp, ms, vs)

    return _smoother_loop(step, mfs, vfs)


def _cd_sgp_moment_odes(sgps, drift, dispersion_const, m, P):
    chi = sgps.gen_sigma_points(m, _cholesky(P))
    evals = drift(chi)
    dm = sgps.expectation(evals)
    cross = sgps.expectation(_point_outer(chi - m, evals))
    return dm, cross + cross.mT + dispersion_const @ dispersion_const.mT


def cd_sgp_filter(
    drift: Callable[[Array], Array],
    dispersion: Array,
    measurement_cond_m_cov: Callable[[Array], Tuple[Array, Array]],
    sgps: SigmaPoints,
    m0: Array,
    v0: Array,
    dt: FloatScalar,
    ys: Array,
    const_measurement_cov: bool = False,
) -> Tuple[Array, Array, Array]:
    """Continuous-discrete sigma-point filter (RK4 moment ODEs)."""

    def odes(m, v):
        return _cd_sgp_moment_odes(sgps, drift, dispersion, m, v)

    def step(mf, vf, y):
        mp, vp = rk4_m_cov(odes, mf, vf, dt)
        return _sgp_update(sgps, measurement_cond_m_cov, mp, vp, y, const_measurement_cov)

    return _filter_loop(step, m0, v0, ys)


def cd_sgp_smoother(
    drift: Callable[[Array], Array],
    dispersion: Array,
    sgps: SigmaPoints,
    mfs: Array,
    vfs: Array,
    dt: FloatScalar,
) -> Tuple[Array, Array]:
    """Continuous-discrete sigma-point smoother."""
    dt = -dt
    gamma = dispersion @ dispersion.mT

    def odes(m, v, mf, vf):
        G = torch.cholesky_solve(gamma.expand(vf.shape), _cholesky(vf))
        dm, dP = _cd_sgp_moment_odes(sgps, drift, dispersion, m, v)
        return dm + _mv(G.mT, m - mf), dP + G.mT @ v + v @ G - 2 * gamma

    def step(ms, vs, mf, vf):
        return rk4_m_cov_backward(odes, ms, vs, mf, vf, dt)

    return _smoother_loop(step, mfs, vfs)
