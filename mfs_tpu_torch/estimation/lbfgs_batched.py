"""Batch-of-problems L-BFGS with per-trial state (port of
``mfs_tpu/estimation/lbfgs_batched.py``).

Solves B independent small minimisations at once where the objective
is *batch-first*: ``f(P) -> (B,)`` with ``P (B, p)``.  The filters take
the Monte-Carlo batch as their leading axis and the fused quadrature
launches one kernel for all trials, so the objective is called ONCE for
all trials per evaluation.

Everything is vectorised over the trial axis:

- the two-loop recursion keeps per-trial curvature pairs
  ``S, Y (m, B, p)`` and takes its inner products over the parameter
  axis only, so each trial gets its OWN quasi-Newton direction;
- the line search is per-trial backtracking Armijo: each halving costs
  one batched objective evaluation (under ``torch.no_grad()``), and
  trials accept independently;
- converged trials are frozen (params, state) with ``where`` masks, and
  the host loop stops when every trial is done, checked every
  ``chunk_steps`` steps.

The JAX package's ``lax.while_loop`` line search and ``lax.scan``
segments are host loops here.  One difference, which changes no
result: a trial already done does not hold the line search open (JAX
keeps halving for it until every trial accepts or ``max_backtracks``
runs out, and then discards what it found), so a diverged trial does
not cost ``max_backtracks`` evaluations a step.
"""
import time
from typing import Callable, Optional, Tuple

import torch

from mfs_tpu_torch.typings import Array


def _dot(a: Array, b: Array) -> Array:
    return (a * b).sum(-1)


def _two_loop(g, S, Y, rho, valid, gamma):
    """Vectorised L-BFGS two-loop recursion.

    g (B, p); S, Y (m, B, p); rho, valid (m, B); gamma (B,).  Invalid
    history slots (not yet filled, or curvature breakdown) are skipped.
    Returns the approximate ``H^-1 g`` per trial, (B, p).
    """
    m = S.shape[0]
    q = g
    alphas = []
    for i in range(m - 1, -1, -1):
        a = torch.where(valid[i], rho[i] * _dot(S[i], q), 0.0)
        q = q - a[:, None] * Y[i]
        alphas.append(a)
    alphas.reverse()
    r = gamma[:, None] * q
    for i in range(m):
        b = torch.where(valid[i], rho[i] * _dot(Y[i], r), 0.0)
        r = r + (alphas[i] - b)[:, None] * S[i]
    return r


def lbfgs_batched(
    batched_nell: Callable[[Array], Array],
    init_params: Array,
    history: int = 10,
    max_steps: int = 200,
    chunk_steps: int = 10,
    gtol: float = 1e-5,
    max_backtracks: int = 20,
    c1: float = 1e-4,
    callback: Optional[Callable[[Array, Array], None]] = None,
) -> Tuple[Array, dict]:
    """Minimise B independent objectives with per-trial L-BFGS.

    Parameters
    ----------
    batched_nell : (B, p) -> (B,)
        Batch-first objective (per-trial negative log likelihoods),
        differentiable by autograd; evaluated for ALL trials jointly.
    init_params : Array (B, p)
    history : int
        Number of curvature pairs per trial.
    max_steps, chunk_steps : int
        Iteration cap, run as ``ceil(max_steps / chunk_steps)`` segments
        of ``chunk_steps`` steps; the all-done check runs between
        segments.
    gtol : float
        Per-trial gradient inf-norm stopping tolerance.
    max_backtracks : int
        Armijo halvings per line search (each costs one batched eval).
    c1 : float
        Armijo sufficient-decrease constant.
    callback : (P (B, p), nell (B,)) -> None, optional
        Called after every step with the kept parameters and nell.

    Returns
    -------
    params : (B, p)
    info : dict — ``converged (B,)``, ``steps (B,)``, ``nell (B,)``,
        ``grad_inf_norm (B,)``, ``segments_run`` int, ``wall_s`` (the
        steps only, not the first evaluation).
    """
    return _minimise(batched_nell, init_params, history, max_steps, chunk_steps, gtol,
                     max_backtracks, c1, callback)


def _minimise(batched_nell, init_params, history, max_steps, chunk_steps, gtol,
              max_backtracks, c1, callback, ptol=None):
    """``lbfgs_batched``'s iteration; with ``ptol`` a trial also stops once
    its step's largest parameter change is at most ``ptol``
    (``fit_mle_batched``'s second tolerance)."""
    P = torch.as_tensor(init_params).detach()
    B, p = P.shape
    m = history

    def value_and_grad(Q):
        # block-separable: the VJP against ones IS the stack of per-trial
        # gradients (one forward + one backward pass)
        Q = Q.detach().requires_grad_(True)
        with torch.enable_grad():
            vals = batched_nell(Q)
            (grads,) = torch.autograd.grad(vals, Q, torch.ones_like(vals))
        return vals.detach(), grads

    def line_search(P, fv, d, dg, done):
        # per-trial backtracking Armijo: alpha halves until
        # f(P + alpha d) <= f(P) + c1 alpha <d, g>
        alpha = torch.ones_like(fv)
        accepted = done.clone()
        fnew = fv
        with torch.no_grad():
            for _ in range(max_backtracks):
                if not bool((~accepted).any()):
                    break
                fc = batched_nell(P + alpha[:, None] * d)
                ok = (fc <= fv + c1 * alpha * dg) & torch.isfinite(fc)
                fnew = torch.where(ok & ~accepted, fc, fnew)
                alpha = torch.where(ok | accepted, alpha, alpha * 0.5)
                accepted = accepted | ok
        return alpha, accepted, fnew

    def step(P, fv, g, S, Y, rho, valid, done, steps):
        gamma_num = _dot(S[-1], Y[-1])
        gamma_den = _dot(Y[-1], Y[-1])
        gamma = torch.where(valid[-1] & (gamma_den > 0), gamma_num / (gamma_den + 1e-300), 1.0)
        d = -_two_loop(g, S, Y, rho, valid, gamma)
        # descent safeguard: fall back to steepest descent per trial
        dg = _dot(d, g)
        bad = (dg >= 0) | ~torch.isfinite(dg)
        d = torch.where(bad[:, None], -g, d)
        dg = torch.where(bad, -_dot(g, g), dg)

        alpha, accepted, fnew = line_search(P, fv, d, dg, done)
        # trials whose line search failed take no step this iteration
        alpha = torch.where(accepted, alpha, 0.0)
        newP = P + alpha[:, None] * d
        fnew = torch.where(accepted, fnew, fv)
        _, gnew = value_and_grad(newP)

        s = newP - P
        y = gnew - g
        sy = _dot(s, y)
        ok_pair = (sy > 1e-12) & torch.isfinite(sy) & accepted
        S2 = torch.cat([S[1:], s[None]])
        Y2 = torch.cat([Y[1:], y[None]])
        rho2 = torch.cat([rho[1:], torch.where(ok_pair, 1.0 / (sy + 1e-300), 0.0)[None]])
        valid2 = torch.cat([valid[1:], ok_pair[None]])

        gnorm = gnew.abs().amax(-1)
        finished = (gnorm < gtol) | ~accepted | ~torch.isfinite(fnew)
        if ptol is not None:
            finished = finished | (s.abs().amax(-1) <= ptol)

        keep = lambda old, new: torch.where(done[:, None] if new.ndim == 2 else done, old, new)
        keep_hist = lambda old, new: torch.where(
            done[None, :, None] if new.ndim == 3 else done[None, :], old, new)
        return (keep(P, newP), keep(fv, fnew), keep(g, gnew),
                keep_hist(S, S2), keep_hist(Y, Y2), keep_hist(rho, rho2),
                keep_hist(valid, valid2), done | finished, steps + (~done).to(steps.dtype))

    fv0, g0 = value_and_grad(P)
    done0 = (g0.abs().amax(-1) < gtol) | ~torch.isfinite(fv0)
    zeros = lambda *shape: torch.zeros(shape, dtype=P.dtype, device=P.device)
    state = (P, fv0, g0, zeros(m, B, p), zeros(m, B, p), zeros(m, B),
             torch.zeros((m, B), dtype=torch.bool, device=P.device), done0,
             torch.zeros(B, dtype=torch.int32, device=P.device))
    t0 = time.perf_counter()
    segments_run = 0
    for _ in range(-(-max_steps // chunk_steps)):
        if bool(state[7].all()):
            break
        for _ in range(chunk_steps):
            state = step(*state)
            if callback is not None:
                callback(state[0], state[1])
        segments_run += 1
    if P.is_cuda:
        torch.cuda.synchronize(P.device)
    wall_s = time.perf_counter() - t0
    P, fv, g = state[0], state[1], state[2]
    return P, dict(
        converged=state[7],
        steps=state[8],
        nell=fv,
        grad_inf_norm=g.abs().amax(-1),
        segments_run=segments_run,
        wall_s=wall_s,
    )
