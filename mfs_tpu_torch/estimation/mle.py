"""Gradient-based maximum-likelihood estimation through the filters
(port of ``mfs_tpu/estimation/mle.py``).

The moment filters return a negative log likelihood that autograd
differentiates (the fused quadrature through its implicit-function
backward); these routines optimise model parameters with either

- ``fit_mle_scipy``: SciPy L-BFGS-B fed by torch value-and-grad, or
- ``fit_mle_optax``: a torch optimiser loop (default L-BFGS with a
  strong-Wolfe line search).  The name is the JAX package's, where the
  loop is an optax transform in a jitted scan.

Many independent problems at once (one per Monte-Carlo trial) go to
``lbfgs_batched`` (a batch-first objective) or ``fit_mle_batched`` (a
per-trial objective, batched by ``torch.func.vmap``).
"""
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from mfs_tpu_torch.estimation.lbfgs_batched import _minimise
from mfs_tpu_torch.typings import Array


def _value_and_grad(nell_fn: Callable[[Array], Array], params: Array):
    params = params.detach().requires_grad_(True)
    with torch.enable_grad():
        value = nell_fn(params)
        (grad,) = torch.autograd.grad(value, params)
    return value.detach(), grad


def fit_mle_scipy(
    nell_fn: Callable[[Array], Array],
    init_params: Array,
    method: str = "L-BFGS-B",
    tol: Optional[float] = None,
    options: Optional[dict] = None,
):
    """Minimise a differentiable nell with SciPy + torch gradients.

    Parameters
    ----------
    nell_fn : (p,) -> scalar
        Differentiable negative log likelihood (typically closing over
        the measurements and calling a moment filter).
    init_params : Array (p,)
        Its dtype and device are those ``nell_fn`` is called with.

    Returns
    -------
    scipy.optimize.OptimizeResult
        ``result.x`` are the fitted parameters.
    """
    import scipy.optimize

    x0 = torch.as_tensor(init_params)

    def fun(x):
        v, g = _value_and_grad(nell_fn, torch.as_tensor(x, dtype=x0.dtype, device=x0.device))
        return float(v), g.cpu().numpy().astype(np.float64)

    return scipy.optimize.minimize(
        fun,
        x0.detach().cpu().numpy().astype(np.float64),
        jac=True,
        method=method,
        tol=tol,
        options=options,
    )


def _default_optimiser(params):
    # One L-BFGS iteration per ``step`` (torch's default runs 20), so
    # ``num_steps`` counts iterations as optax's L-BFGS does.  The line
    # search may take max_eval - 1 evaluations: 25, torch's own default.
    return torch.optim.LBFGS(params, max_iter=1, max_eval=26, line_search_fn="strong_wolfe")


def fit_mle_optax(
    nell_fn: Callable[[Array], Array],
    init_params: Array,
    optimiser: Optional[Callable] = None,
    num_steps: int = 100,
    chunk_steps: int = 0,
) -> Tuple[Array, Array]:
    """MLE by a torch optimiser loop, ``num_steps`` optimiser steps.

    ``optimiser`` maps a list of parameter tensors to a
    ``torch.optim.Optimizer`` (default: L-BFGS, one iteration a step,
    strong-Wolfe line search).  ``chunk_steps`` is kept for the JAX
    signature: there it cuts the jitted loop into dispatches, and it
    must divide ``num_steps``; the host loop here has no dispatch to
    bound, so it changes nothing else.

    Returns
    -------
    params : Array (p,), losses : Array (num_steps,)
        ``losses[k]`` is the loss before step k.
    """
    if chunk_steps and chunk_steps < num_steps and num_steps % chunk_steps:
        raise ValueError(
            f"chunk_steps {chunk_steps} must divide num_steps {num_steps}"
        )
    params = torch.as_tensor(init_params).detach().clone().requires_grad_(True)
    opt = (optimiser or _default_optimiser)([params])

    def closure():
        opt.zero_grad()
        with torch.enable_grad():
            loss = nell_fn(params)
            loss.backward()
        return loss

    losses = [opt.step(closure).detach() for _ in range(num_steps)]
    return params.detach(), torch.stack(losses)


def fit_mle_batched(
    per_trial_nell: Callable[[Array, Any], Array],
    init_params: Array,
    data: Any,
    optimiser: Any = None,
    max_steps: int = 200,
    chunk_steps: int = 10,
    gtol: float = 1e-5,
    ptol: float = 0.0,
) -> Tuple[Array, dict]:
    """Per-trial L-BFGS over a batch of independent MLE problems.

    Each trial gets its own quasi-Newton iteration (curvature pairs,
    direction and line search), run for all trials in lockstep, as in
    the JAX package, where ``jax.vmap`` runs one optax L-BFGS per trial.
    Here the iteration is ``lbfgs_batched``'s: its two-loop recursion
    already keeps per-trial state, and ``torch.func.vmap`` turns the
    per-trial objective into one batched call for all trials, so an
    objective evaluation is one call, not B (torch's own
    ``torch.optim.LBFGS`` keeps its state in Python per instance and
    does not batch).  Its line search is backtracking Armijo where
    optax's is a zoom (strong Wolfe) search: the iterates and ``steps``
    differ from JAX's, the minimisers they converge to agree.

    A trial is frozen once its gradient inf-norm drops below ``gtol``,
    its step's largest parameter change is at most ``ptol``, its line
    search fails or its nell is not finite; the loop stops, between
    segments of ``chunk_steps`` steps, once every trial is done.

    Parameters
    ----------
    per_trial_nell : (params (p,), datum) -> scalar nell
        Objective for one trial, differentiable by autograd and
        vmappable; ``datum`` is the per-trial slice of ``data``.
    init_params : Array (B, p)
    data : tensor tree with leading trial axis B (e.g. the measurements).
    optimiser : None
        JAX's optax transform (default ``optax.lbfgs()``); the port has
        no optax, so only None (the per-trial L-BFGS above) is taken.
    max_steps, chunk_steps : int
        Iteration cap and segment length.
    gtol, ptol : float
        Per-trial stopping tolerances.

    Returns
    -------
    params : Array (B, p)
    info : dict with ``converged (B,)``, ``steps (B,)``, ``nell (B,)``,
        ``segments_run`` (int).
    """
    if optimiser is not None:
        raise TypeError("fit_mle_batched takes optimiser=None only: the port runs its own "
                        "per-trial L-BFGS and has no optax")
    batched = torch.func.vmap(per_trial_nell)
    params, info = _minimise(lambda P: batched(P, data), init_params, history=10,
                             max_steps=max_steps, chunk_steps=chunk_steps, gtol=gtol,
                             max_backtracks=20, c1=1e-4, callback=None, ptol=ptol)
    return params, {k: info[k] for k in ("converged", "steps", "nell", "segments_run")}
