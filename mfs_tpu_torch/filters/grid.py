"""Brute-force 1D grid filter — the "exact" reference solution.

Port of ``mfs_tpu/filters/grid.py``.  Evolves the filtering density on a
fixed uniform grid; the Chapman–Kolmogorov prediction

    p_pred(x) = ∫ p(x | x') p(x') dx'

is a transition-kernel matrix, built once, times the density vector:
the whole integration interval is one matrix power, so each filter step
is one ``(trials, n) x (n, n)`` product (a cuBLAS DGEMM on the card).
"""
import math
from typing import Callable

import torch

from mfs_tpu_torch.sde import tme
from mfs_tpu_torch.sde.tme import _jvp_1d
from mfs_tpu_torch.typings import Array, FloatScalar


def _trapezoid_weights(n: int, dx: Array) -> Array:
    w = dx * torch.ones(n, dtype=dx.dtype, device=dx.device)
    w[0] *= 0.5
    w[-1] *= 0.5
    return w


def _normal_pdf(x: Array, loc: Array, scale: Array) -> Array:
    # as jax.scipy.stats.norm.pdf: exp of the log density
    var = scale * scale
    return torch.exp(-0.5 * (torch.log(2.0 * math.pi * var) + (x - loc) ** 2 / var))


def _derivative(f: Callable) -> Callable:
    """The elementwise derivative of an elementwise ``f``, by autograd
    (JAX: ``jax.vmap(jax.grad(f))``); it keeps its graph, so it nests."""
    return lambda u: _jvp_1d(lambda w: f(w) * torch.ones_like(w), u)[1]


def brute_force_filter(
    drift: Callable,
    dispersion: Callable,
    measurement_cond_pdf: Callable,
    init_ps: Array,
    xs: Array,
    ys: Array,
    dt: FloatScalar,
    integration_steps: int = 1,
    pred_method: str = "chapman-tme-2",
) -> Array:
    """Filtering PDFs on a uniform grid (1D state).

    Parameters
    ----------
    drift, dispersion : callables
        SDE coefficients, elementwise on the grid.
    measurement_cond_pdf : (y, xs) -> (..., n)
        Measurement likelihood, elementwise on the grid.
    init_ps : Array (..., n)
        Initial density values at ``xs``; leading trial axes are matched
        by ``ys (T, ...)``, so a whole Monte-Carlo ensemble filters in one
        call.
    xs : Array (n,)
        Uniform grid.
    ys : Array (T, ...)
        Measurements.
    dt : float
        Inter-measurement interval.
    integration_steps : int
        Chapman/Kolmogorov substeps per interval.
    pred_method : str
        'kolmogorov' (finite-difference Fokker–Planck + Euler; the
        derivatives of drift and diffusion by autograd),
        'chapman-euler', or 'chapman-tme-<order>'.

    Returns
    -------
    Array (T, ..., n)
        Filtering densities at all measurement times.
    """
    n = xs.shape[0]
    dx = xs[1] - xs[0]
    ddt = dt / integration_steps
    tw = _trapezoid_weights(n, dx)
    batched = init_ps.ndim > 1

    if pred_method.startswith("chapman"):
        if pred_method == "chapman-euler":
            m = xs + drift(xs) * ddt
            scale = dispersion(xs) * math.sqrt(ddt) * torch.ones_like(xs)
        else:
            order = int(pred_method.split("-")[-1])
            m, v = tme.mean_and_var_1d(xs, ddt, drift, dispersion, order=order)
            scale = torch.sqrt(v)
        # K[i, j] = p(x_i | x_j) tw_j.  The kernel is time-homogeneous, so
        # the interval's substeps collapse into one matrix power.
        kernel = _normal_pdf(xs[:, None], m[None, :], scale[None, :]) * tw[None, :]
        kernel_full = (
            torch.linalg.matrix_power(kernel, integration_steps)
            if integration_steps > 1
            else kernel
        )
        kernel_t = kernel_full.mT

        def predict(ps):
            return ps @ kernel_t

    elif pred_method == "kolmogorov":
        gamma = lambda x: dispersion(x) ** 2
        d_drift = _derivative(drift)(xs).detach()
        d_gamma, dd_gamma = (t.detach() for t in _jvp_1d(_derivative(gamma), xs))
        drift_xs = drift(xs) * torch.ones_like(xs)
        gamma_xs = gamma(xs) * torch.ones_like(xs)
        # jnp.gradient's and torch.gradient's edges are both first-order
        # one-sided differences (edge_order=1)
        h = float(dx)

        def fokker_planck(ps):
            (dps,) = torch.gradient(ps, spacing=h, dim=-1)
            (ddps,) = torch.gradient(dps, spacing=h, dim=-1)
            adv = -(d_drift * ps + drift_xs * dps)
            diff = 0.5 * (dd_gamma * ps + 2 * d_gamma * dps + gamma_xs * ddps)
            return adv + diff

        def predict(ps):
            for _ in range(integration_steps):
                ps = ps + fokker_planck(ps) * ddt
            return ps

    else:
        raise NotImplementedError(f"Prediction method {pred_method} not implemented.")

    ps = init_ps
    out = []
    for y in ys:
        ps = predict(ps)
        y_b = y[..., None] if (batched and y.ndim == ps.ndim - 1) else y
        unnorm = measurement_cond_pdf(y_b, xs) * ps
        ps = unnorm / torch.sum(unnorm * tw, dim=-1, keepdim=True)
        out.append(ps)
    return torch.stack(out)
