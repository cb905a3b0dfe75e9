"""SDE trajectory simulation (port of ``mfs_tpu/utils/sdes.py::simulate_sde``).

Batch-first: ``x0`` may carry leading trial axes, and all trajectories
advance together, one Python-loop iteration per sub-step.
"""
from typing import Callable, Tuple

import torch

from mfs_tpu_torch.config import DTYPE, default_device
from mfs_tpu_torch.typings import Array, FloatScalar


def simulate_sde(
    m_and_cov: Callable[[Array, FloatScalar], Tuple[Array, Array]],
    x0: Array,
    dt: FloatScalar,
    T: int,
    generator: torch.Generator = None,
    eps: Array = None,
    diagonal_cov: bool = False,
    integration_steps: int = 1,
    device=None,
) -> Array:
    """Simulate an SDE with conditional-Gaussian increments on a uniform grid.

    Parameters
    ----------
    m_and_cov : ((..., d), float) -> ((..., d), (..., d, d))
        Conditional mean and covariance over one sub-step.
    x0 : Array (..., d) or scalar
        Initial state(s); a 0-d tensor is one 1D state.
    generator : torch.Generator
        Source of the Gaussian increments when ``eps`` is not given.
    eps : Array (T, integration_steps, ..., d), optional
        Explicit standard-normal increments (the tests feed JAX's own
        draws here).
    integration_steps : int
        Sub-steps per observation interval.
    device : torch.device, optional
        Where a non-tensor ``x0`` is placed (``None``: cuda, raising when
        there is no GPU).  A tensor ``x0`` keeps its own device.

    Returns
    -------
    Array (T, ..., d)
    """
    if not isinstance(x0, torch.Tensor):
        x0 = torch.as_tensor(x0, device=default_device(device))
    x0 = torch.atleast_1d(x0.to(DTYPE))
    ddt = dt / integration_steps
    if eps is None:
        eps = torch.randn(
            (T, integration_steps) + tuple(x0.shape),
            generator=generator, dtype=DTYPE, device=x0.device,
        )
    x = x0
    traj = []
    for t in range(T):
        for s in range(integration_steps):
            m, cov = m_and_cov(x, ddt)
            e = eps[t, s]
            if diagonal_cov:
                x = m + (torch.sqrt(cov) @ e[..., None])[..., 0]
            else:
                x = m + (torch.linalg.cholesky(cov) @ e[..., None])[..., 0]
        traj.append(x)
    return torch.stack(traj)


def simulate_sde_ensemble(
    m_and_cov: Callable[[Array, FloatScalar], Tuple[Array, Array]],
    x0s: Array,
    dt: FloatScalar,
    T: int,
    generator: torch.Generator = None,
    eps: Array = None,
    diagonal_cov: bool = False,
    integration_steps: int = 1,
) -> Array:
    """Simulate B independent trajectories at once (JAX:
    ``mfs_tpu/utils/sdes.py::simulate_sde_ensemble``, one PRNG key a path).

    Parameters
    ----------
    x0s : Array (B, d)
    generator : torch.Generator
        Source of every path's increments when ``eps`` is not given.
    eps : Array (B, T, integration_steps, d), optional
        Each path's own standard-normal increments (the tests feed the
        draws of JAX's per-path keys here).

    Returns
    -------
    Array (B, T, d)
    """
    if eps is not None:
        eps = eps.movedim(0, 2)  # (T, integration_steps, B, d)
    traj = simulate_sde(m_and_cov, x0s, dt, T, generator=generator, eps=eps,
                        diagonal_cov=diagonal_cov, integration_steps=integration_steps)
    return traj.movedim(1, 0)
