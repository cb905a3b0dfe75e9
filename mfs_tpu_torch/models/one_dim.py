"""Canonical 1D test models (port of ``mfs_tpu/models/one_dim.py``).

Batch-first: ``simulate`` generates a whole Monte-Carlo ensemble in one
call, every trajectory advancing together.
"""
from typing import Callable, NamedTuple

import torch

from mfs_tpu_torch.config import DTYPE, default_device
from mfs_tpu_torch.sde import tme
from mfs_tpu_torch.typings import Array
from mfs_tpu_torch.utils.gaussian import GaussianSum1D
from mfs_tpu_torch.utils.sdes import simulate_sde


class Model1D(NamedTuple):
    """A continuous-discrete 1D test model."""

    dt: float
    T: int
    ts: Array
    init_cond: GaussianSum1D
    drift: Callable
    dispersion: Callable
    emission: Callable
    measurement_cond_pdf: Callable
    simulate: Callable  # (generator, nsamples) -> xss (nsamples, T)


def benes_bernoulli(N: int = 2, device=None) -> Model1D:
    """Beneš SDE with Bernoulli measurements — the flagship model.

        dX = tanh(X) dt + dW,   Y_k ~ Bernoulli(logistic(X_k^3 / 5)).
    """
    device = default_device(device)
    dt = 1e-2
    T = 100
    ts = torch.linspace(dt, dt * T, T, dtype=DTYPE, device=device)

    init_cond = GaussianSum1D.new(
        means=[-0.5, 0.5], variances=[0.05, 0.05], weights=[0.5, 0.5],
        N=N, device=device,
    )

    def drift(x):
        return torch.tanh(x)

    def dispersion(x):
        return torch.ones_like(x) if torch.is_tensor(x) else 1.0

    def emission(x):
        return 1.0 / (1.0 + torch.exp(-(x**3) / 5.0))

    def measurement_cond_pdf(y, x):
        p = emission(x)
        return torch.where(y == 1, p, 1.0 - p)

    def m_and_cov(x, _dt):
        m, v = tme.mean_and_var_1d(x[..., 0], _dt, drift, dispersion, order=3)
        return m[..., None], v[..., None, None]

    def simulate(generator: torch.Generator, nsamples: int = 1,
                 integration_steps: int = 100) -> Array:
        """Simulate an ensemble of trajectories; returns (nsamples, T).

        ``generator`` must live on the model's device.
        """
        x0s = init_cond.sampler(generator, nsamples)
        traj = simulate_sde(
            m_and_cov, x0s[:, None], dt, T, generator=generator,
            integration_steps=integration_steps,
        )  # (T, nsamples, 1)
        return traj[..., 0].T

    return Model1D(
        dt=dt,
        T=T,
        ts=ts,
        init_cond=init_cond,
        drift=drift,
        dispersion=dispersion,
        emission=emission,
        measurement_cond_pdf=measurement_cond_pdf,
        simulate=simulate,
    )
