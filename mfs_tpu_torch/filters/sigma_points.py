"""Sigma-point rules and RK4 integrators for Gaussian filters.

Port of ``mfs_tpu/filters/sigma_points.py``.  Gauss–Hermite nodes and
weights come from ``numpy.polynomial`` when the rule is built.

Batch-first: a rule's points go on a new LEADING axis.  For means
``m (..., d)`` and Cholesky factors ``(..., d, d)``, ``gen_sigma_points``
returns ``chi (P, ..., d)``, so a batched callback sees the points as
one more batch axis, and ``expectation`` sums that leading axis.
"""
import math
from typing import Callable, NamedTuple, Tuple, Union

import numpy as np
import torch

from mfs_tpu_torch.config import DTYPE, default_device
from mfs_tpu_torch.typings import Array


def rk4_m_cov(
    m_cov_ode: Callable[[Array, Array], Tuple[Array, Array]],
    m: Array,
    v: Array,
    dt: float,
) -> Tuple[Array, Array]:
    """Classic RK4 step for a coupled mean/covariance ODE system."""
    k1m, k1v = m_cov_ode(m, v)
    k2m, k2v = m_cov_ode(m + dt * k1m / 2, v + dt * k1v / 2)
    k3m, k3v = m_cov_ode(m + dt * k2m / 2, v + dt * k2v / 2)
    k4m, k4v = m_cov_ode(m + dt * k3m, v + dt * k3v)
    return (
        m + dt * (k1m + 2 * k2m + 2 * k3m + k4m) / 6,
        v + dt * (k1v + 2 * k2v + 2 * k3v + k4v) / 6,
    )


def rk4_m_cov_backward(
    m_cov_ode: Callable[[Array, Array, Array, Array], Tuple[Array, Array]],
    m: Array,
    v: Array,
    mf: Array,
    vf: Array,
    dt: float,
) -> Tuple[Array, Array]:
    """RK4 step for the backward (smoothing) mean/covariance ODEs."""
    k1m, k1v = m_cov_ode(m, v, mf, vf)
    k2m, k2v = m_cov_ode(m + dt * k1m / 2, v + dt * k1v / 2, mf, vf)
    k3m, k3v = m_cov_ode(m + dt * k2m / 2, v + dt * k2v / 2, mf, vf)
    k4m, k4v = m_cov_ode(m + dt * k3m, v + dt * k3v, mf, vf)
    return (
        m + dt * (k1m + 2 * k2m + 2 * k3m + k4m) / 6,
        v + dt * (k1v + 2 * k2v + 2 * k3v + k4v) / 6,
    )


class SigmaPoints(NamedTuple):
    r"""Sigma-point integration rule.

    ``∫ z(x) N(x | m, P) dx ≈ Σ_i w_i z(m + chol(P) ξ_i)``.  The
    constructors take ``device`` (``None``: cuda, raising without a GPU).
    """

    d: int
    n_points: int
    w: Array
    wc: Union[Array, None]
    xi: Array  # (n_points, d)

    @classmethod
    def cubature(cls, d: int, device=None) -> "SigmaPoints":
        """Spherical cubature rule (2d points)."""
        device = default_device(device)
        n_points = 2 * d
        w = torch.full((n_points,), 1.0 / n_points, dtype=DTYPE, device=device)
        eye = torch.eye(d, dtype=DTYPE, device=device)
        xi = math.sqrt(d) * torch.cat([eye, -eye], dim=0)
        return cls(d=d, n_points=n_points, w=w, wc=None, xi=xi)

    @classmethod
    def gauss_hermite(cls, d: int, order: int = 3, device=None) -> "SigmaPoints":
        """Tensor-product Gauss–Hermite rule (order^d points).

        1D nodes/weights from ``numpy.polynomial.hermite_e.hermegauss``
        (probabilists' convention: weight function N(0, 1)).
        """
        device = default_device(device)
        nodes_1d, weights_1d = np.polynomial.hermite_e.hermegauss(order)
        weights_1d = weights_1d / math.sqrt(2.0 * math.pi)
        grids = np.meshgrid(*([nodes_1d] * d), indexing="ij")
        xi = np.stack([g.ravel() for g in grids], axis=-1)  # (order^d, d)
        wgrids = np.meshgrid(*([weights_1d] * d), indexing="ij")
        w = np.prod(np.stack([g.ravel() for g in wgrids], axis=-1), axis=-1)
        return cls(d=d, n_points=order**d, w=torch.as_tensor(w, dtype=DTYPE, device=device),
                   wc=None, xi=torch.as_tensor(xi, dtype=DTYPE, device=device))

    @classmethod
    def unscented(cls, d: int, alpha: float = 1.0, beta: float = 2.0, kappa: float = None,
                  device=None) -> "SigmaPoints":
        """Unscented transform points (2d + 1) with the standard Julier
        weights; ``wc`` (covariance weights) differ from ``w`` when
        alpha != 1 or beta != 0."""
        device = default_device(device)
        if kappa is None:
            kappa = 3.0 - d
        lam = alpha**2 * (d + kappa) - d
        xs = math.sqrt(d + lam) * torch.eye(d, dtype=DTYPE, device=device)
        xi = torch.cat([torch.zeros((1, d), dtype=DTYPE, device=device), xs, -xs], dim=0)
        w = torch.full((2 * d + 1,), 1.0 / (2.0 * (d + lam)), dtype=DTYPE, device=device)
        w[0] = lam / (d + lam)
        wc = w.clone()
        wc[0] += 1.0 - alpha**2 + beta
        return cls(d=d, n_points=2 * d + 1, w=w, wc=wc, xi=xi)

    def gen_sigma_points(self, m: Array, chol_of_v: Array) -> Array:
        """``m (..., d)``, ``chol_of_v (..., d, d)`` -> ``chi (P, ..., d)``."""
        return m + torch.einsum("...ij,pj->p...i", chol_of_v, self.xi)

    def expectation_from_nodes(self, v_f: Callable, chi: Array) -> Array:
        return self.expectation(v_f(chi))

    def expectation(self, evals_of_integrand: Array) -> Array:
        """Weighted sum over the leading point axis of ``(P, ...)``."""
        return torch.einsum("p,p...->...", self.w, evals_of_integrand)


def gaussian_expectation(
    ms: Array,
    chol_vs: Array,
    func: Callable,
    d: int = 1,
    order: int = 10,
    force_shape: bool = False,
) -> Array:
    """E[g(V_k)] for a trajectory of Gaussians V_k ~ N(m_k, P_k), by GH.

    ``ms (K, d)``, ``chol_vs (K, d, d)``; ``func`` maps points ``(P, K, d)``
    to ``(P, K, ...)`` (the JAX package vmaps it over k instead).
    """
    if force_shape:
        ms = torch.reshape(ms, (-1, 1))
        chol_vs = torch.reshape(chol_vs, (-1, 1, 1))
    sgps = SigmaPoints.gauss_hermite(d=d, order=order, device=ms.device)
    return sgps.expectation_from_nodes(func, sgps.gen_sigma_points(ms, chol_vs))
