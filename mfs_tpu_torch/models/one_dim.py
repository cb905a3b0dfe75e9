"""Canonical 1D test models (port of ``mfs_tpu/models/one_dim.py``).

Batch-first: ``simulate`` generates a whole Monte-Carlo ensemble in one
call, every trajectory advancing together.
"""
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from mfs_tpu_torch.config import DTYPE, default_device
from mfs_tpu_torch.sde import tme
from mfs_tpu_torch.typings import Array
from mfs_tpu_torch.utils.gaussian import GaussianSum1D
from mfs_tpu_torch.utils.profiling import span
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
    simulate_trials: Callable = None  # (seed, trial_ids) -> xss


def _trial_draws(seed: int, trial_ids: Sequence[int], init_cond: GaussianSum1D, T: int,
                integration_steps: int):
    """Each trial's initial state and standard-normal increments, drawn
    from its own stream ``np.random.default_rng([seed, i])``, so trial
    ``i`` depends only on ``(seed, i)``.  Returns ``x0s (B,)`` and
    ``eps (T, integration_steps, B, 1)`` as numpy arrays."""
    cum = np.cumsum(init_cond.weights.cpu().numpy())
    means = init_cond.means.cpu().numpy()
    sds = np.sqrt(init_cond.variances.cpu().numpy())
    x0s, eps = [], []
    for i in trial_ids:
        rng = np.random.default_rng([seed, int(i)])
        c = min(int(np.searchsorted(cum, rng.random(), side="right")), cum.shape[0] - 1)
        x0s.append(means[c] + sds[c] * rng.standard_normal())
        eps.append(rng.standard_normal((T, integration_steps)))
    return np.asarray(x0s), np.stack(eps, axis=-1)[..., None]


@span("mfs.build.model")
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

    def simulate_trials(seed: int, trial_ids: Sequence[int],
                        integration_steps: int = 100) -> Array:
        """Per-trial reproducible ensemble, ``(len(trial_ids), T)``: trial
        ``i`` depends only on ``(seed, i)`` (``_trial_draws``), so chunked
        sweeps give the same trajectories for any chunk size (JAX:
        ``jax.random.fold_in(base_key, i)``)."""
        x0s, eps = _trial_draws(seed, trial_ids, init_cond, T, integration_steps)
        traj = simulate_sde(
            m_and_cov, torch.as_tensor(x0s, device=device)[:, None], dt, T,
            eps=torch.as_tensor(eps, device=device), integration_steps=integration_steps,
        )  # (T, B, 1)
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
        simulate_trials=simulate_trials,
    )


@span("mfs.build.model")
def well_poisson(true_p1: float, N: int = 2, device=None):
    """Double-well SDE with softplus-Poisson emissions — the
    parameter-estimation model (JAX: ``mfs_tpu/models/one_dim.py::well_poisson``).

        dX = X (1 - p1 X^2) dt + dW,   Y_k ~ Poisson(log(1 + e^{p2 X_k})).

    Returns the JAX tuple ``(dt, T, ts, init_cond, drift, dispersion,
    emission, measurement_cond_pmf, simulate)``: the model pieces take
    (p1, p2) as arguments, which may be tensors that broadcast against
    the nodes (one parameter pair per trial), and ``simulate(generator,
    nsamples, integration_steps)`` returns an ensemble ``(nsamples, T)``
    at ``true_p1``, simulated by TME-3 sub-steps.
    """
    device = default_device(device)
    dt = 1e-2
    T = 1000
    ts = torch.linspace(dt, dt * T, T, dtype=DTYPE, device=device)

    init_cond = GaussianSum1D.new(
        means=[-0.5, 0.5], variances=[0.05, 0.05], weights=[0.5, 0.5],
        N=N, device=device,
    )

    def drift(x, p1):
        return x * (1.0 - p1 * x**2)

    def dispersion(x):
        return torch.ones_like(x) if torch.is_tensor(x) else 1.0

    def emission(x, p2):
        # log(1 + e^z) by logaddexp, as the JAX package writes it:
        # torch's softplus switches to z above a threshold
        z = p2 * x
        return torch.logaddexp(torch.zeros((), dtype=z.dtype, device=z.device), z)

    def measurement_cond_pmf(y, x, p2):
        rate = emission(x, p2)
        return torch.exp(y * torch.log(rate) - rate - torch.lgamma(y + 1.0))

    def m_and_cov(x, _dt):
        m, v = tme.mean_and_var_1d(
            x[..., 0], _dt, lambda u: drift(u, true_p1), dispersion, order=3
        )
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

    return dt, T, ts, init_cond, drift, dispersion, emission, measurement_cond_pmf, simulate
