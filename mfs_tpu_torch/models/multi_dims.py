"""Multidimensional test models (port of ``mfs_tpu/models/multi_dims.py``).

The model callables are batch-first: ``drift (..., d) -> (..., d)``,
``dispersion (..., d) -> (..., d, d)``.  ``simulate`` generates a whole
ensemble with the diagonal-noise Milstein scheme, every trajectory
advancing together.
"""
import math
from typing import Callable, NamedTuple

import torch

from mfs_tpu_torch.config import DTYPE, default_device
from mfs_tpu_torch.typings import Array
from mfs_tpu_torch.utils.gaussian import GaussianSumND
from mfs_tpu_torch.utils.profiling import span


@span("mfs.build.model")
def satellite_orbital_stability(a=1.0, b=1.0, c=1.0):
    """Drift and dispersion of the satellite orbital-stability SDE (part
    of the model zoo; no experiment uses it)."""

    def drift(x: Array) -> Array:
        x0, x1 = x[..., 0], x[..., 1]
        return torch.stack([x1, -b * x1 - torch.sin(x0) - c * torch.sin(2 * x0)], dim=-1)

    def dispersion(x: Array) -> Array:
        x0, x1 = x[..., 0], x[..., 1]
        zero = torch.zeros_like(x0)
        row0 = torch.stack([zero, zero], dim=-1)
        row1 = torch.stack([zero, -a * b * x1 - b * torch.sin(x0)], dim=-1)
        return torch.stack([row0, row1], dim=-2)

    return drift, dispersion


class ModelND(NamedTuple):
    dt: float
    T: int
    ts: Array
    init_cond: GaussianSumND
    drift: Callable
    dispersion: Callable
    emission: Callable
    measurement_cond_pdf: Callable
    simulate: Callable  # (generator, nsamples, integration_steps) -> (x0s, xss, yss)


def _logistic_emission(x):
    return 1.0 / (1.0 + torch.exp(-(x**3) + 1.0))


def _bernoulli_prey_pdf(y, x):
    p = _logistic_emission(x[..., 0])
    return torch.where(y[..., 0] == 1, p, 1.0 - p)


def _model(dt, T, gs, drift, sigma, device) -> ModelND:
    """Diagonal multiplicative noise ``sigma x dW`` and Bernoulli prey
    observations, shared by the Lotka–Volterra models."""

    def dispersion(x):
        return torch.diag_embed(sigma * x)

    def simulate(generator: torch.Generator, nsamples: int = 1, integration_steps: int = 100,
                 dws: Array = None, x0s: Array = None):
        """Milstein simulation of ``nsamples`` paths over T observation
        intervals of ``integration_steps`` sub-steps each.  Returns
        ``x0s (n, d)``, ``xss (T, n, d)`` and ``yss (T, n, 1)``.

        ``generator`` lives on the model's device.  ``dws (T,
        integration_steps, n, d)`` and ``x0s (n, d)``, when given, are
        the Brownian increments and the initial states (a test feeds the
        JAX package's own).
        """
        ddt = dt / integration_steps
        if x0s is None:
            x0s = gs.sampler(generator, nsamples)
        d = x0s.shape[-1]
        x = x0s
        xss = []
        for t in range(T):
            if dws is None:
                dw_t = math.sqrt(ddt) * torch.randn((integration_steps, nsamples, d),
                                                    generator=generator, dtype=DTYPE,
                                                    device=x.device)
            else:
                dw_t = dws[t]
            for dw in dw_t:
                x = x + drift(x) * ddt + sigma * x * dw + 0.5 * sigma**2 * x * (dw**2 - ddt)
            xss.append(x)
        xss = torch.stack(xss)
        u = torch.rand(xss.shape[:-1], generator=generator, dtype=DTYPE, device=x.device)
        yss = (u < _logistic_emission(xss[..., 0])).to(DTYPE)
        return x0s, xss, yss[..., None]

    return ModelND(
        dt=dt,
        T=T,
        ts=torch.linspace(dt, dt * T, T, dtype=DTYPE, device=device),
        init_cond=gs,
        drift=drift,
        dispersion=dispersion,
        emission=_logistic_emission,
        measurement_cond_pdf=_bernoulli_prey_pdf,
        simulate=simulate,
    )


@span("mfs.build.model")
def prey_predator(multi_indices, device=None) -> ModelND:
    """2D stochastic Lotka–Volterra with Bernoulli prey observations:

        dX_1 = X_1 (alp - beta X_2) dt + sigma X_1 dW_1,
        dX_2 = X_2 (delta X_1 - gamma) dt + sigma X_2 dW_2,
        Y_k ~ Bernoulli(logistic(X_1^3 - 1)),

    dt = 1e-3, T = 2000, alp = beta = delta = gamma = 4, sigma = 0.1; the
    initial condition is an equal mixture of N((1, 1), 1e-3 I) and
    N((1, 1), 2e-3 I).
    """
    device = default_device(device)
    alp, beta, delta, gamma, sigma = 4.0, 4.0, 4.0, 4.0, 0.1
    gs = GaussianSumND.new(
        [[1.0, 1.0], [1.0, 1.0]],
        [[[0.001, 0.0], [0.0, 0.001]], [[0.002, 0.0], [0.0, 0.002]]],
        [0.5, 0.5], multi_indices, device=device)
    rates = torch.tensor([-beta, delta], dtype=DTYPE, device=device)
    offsets = torch.tensor([alp, -gamma], dtype=DTYPE, device=device)

    def drift(x):
        return x * (x.flip(-1) * rates.to(x.device) + offsets.to(x.device))

    return _model(1e-3, 2000, gs, drift, sigma, device)


@span("mfs.build.model")
def lotka_volterra_3d(multi_indices, device=None) -> ModelND:
    """3D stochastic Lotka–Volterra food chain with a Bernoulli prey sensor:

        dX_1 = X_1 (alp - beta X_2) dt              + sigma X_1 dW_1,
        dX_2 = X_2 (delta X_1 - gamma - eps X_3) dt + sigma X_2 dW_2,
        dX_3 = X_3 (zeta X_2 - eta) dt              + sigma X_3 dW_3,
        Y_k ~ Bernoulli(logistic(X_1^3 - 1)),

    with alp/beta = eta/zeta, so (1, 1, 1) is a neutrally stable
    equilibrium; dt = 1e-3, T = 2000, sigma = 0.1.
    """
    device = default_device(device)
    alp, beta, delta, gamma, eps, zeta, eta = 4.0, 4.0, 4.0, 2.0, 2.0, 4.0, 4.0
    sigma = 0.1
    eye = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    gs = GaussianSumND.new(
        [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
        [[[0.001 * v for v in row] for row in eye], [[0.002 * v for v in row] for row in eye]],
        [0.5, 0.5], multi_indices, device=device)

    def drift(x):
        x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
        return torch.stack([x1 * (alp - beta * x2),
                            x2 * (delta * x1 - gamma - eps * x3),
                            x3 * (zeta * x2 - eta)], dim=-1)

    return _model(1e-3, 2000, gs, drift, sigma, device)
