"""Posterior Cramér–Rao lower bound by Monte Carlo (port of
``mfs_tpu/utils/pcrlb.py``).

Tichavský's information-matrix recursion, driven by Monte-Carlo averages
of the Hessians of the transition and likelihood log-densities, each
``torch.func.hessian`` / ``jacfwd(jacrev)`` vmapped over the
trajectories; a Python loop over time replaces ``lax.scan``.
"""
from typing import Callable

import torch

from mfs_tpu_torch.typings import Array, FloatScalar


def posterior_cramer_rao(
    state_trajectories: Array,
    measurements: Array,
    j0: Array,
    logpdf_transition: Callable[[Array, Array], FloatScalar],
    logpdf_likelihood: Callable[[Array, Array], FloatScalar],
) -> Array:
    """Information matrices J_k along a trajectory ensemble.

    Parameters
    ----------
    state_trajectories : Array (T + 1, N, dx)
        Monte-Carlo state trajectories including the initial time.
    measurements : Array (T, N, dy)
        Monte-Carlo measurements.
    j0 : Array (dx, dx)
        Initial information matrix -E[Hess log p(x0)].
    logpdf_transition : ((dx,), (dx,)) -> scalar
        log p(x_k | x_{k-1}); the first argument is x_k.
    logpdf_likelihood : ((dy,), (dx,)) -> scalar
        log p(y_k | x_k); the first argument is y_k.

    Returns
    -------
    Array (T, dx, dx)
        The information matrices J_k (the PCRLB is J_k^{-1}).
    """
    vmap, hessian, jacfwd, jacrev = (torch.func.vmap, torch.func.hessian, torch.func.jacfwd,
                                     torch.func.jacrev)
    h_tt_trans = vmap(hessian(logpdf_transition, argnums=0))
    h_ts_trans = vmap(jacfwd(jacrev(logpdf_transition, argnums=1), argnums=0))
    h_ss_trans = vmap(hessian(logpdf_transition, argnums=1))
    h_tt_lik = vmap(hessian(logpdf_likelihood, argnums=1))

    j = torch.as_tensor(j0, dtype=state_trajectories.dtype, device=state_trajectories.device)
    js = []
    for y, x_t, x_s in zip(measurements, state_trajectories[1:], state_trajectories[:-1]):
        d11 = -torch.mean(h_ss_trans(x_t, x_s), dim=0)
        d12 = -torch.mean(h_ts_trans(x_t, x_s), dim=0)
        d22 = -torch.mean(h_tt_trans(x_t, x_s) + h_tt_lik(y, x_t), dim=0)
        j = d22 - d12.T @ torch.linalg.solve(j + d11, d12)
        js.append(j)
    return torch.stack(js)
