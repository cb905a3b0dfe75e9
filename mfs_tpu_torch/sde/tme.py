"""Taylor moment expansion (TME) of scalar-state SDE conditional expectations.

Port of the 1D half of ``mfs_tpu/sde/tme.py``.  For

    dX(t) = a(X(t)) dt + b(X(t)) dW(t)

the generator is ``A f = a f' + ½ b² f''`` and the TME of order ``p``
approximates ``E[f(X_{t+dt}) | X_t = x] ≈ Σ_{r=0}^{p} dt^r / r! (A^r f)(x)``.

Derivatives are nested forward-mode ``torch.func.jvp`` along a unit
tangent: every function here is elementwise in ``x``, so that
directional derivative *is* the elementwise derivative, and ``phi`` may
append trailing output axes (the vector of all 2N monomials).  The
vector-state half waits for the ND slice.
"""
import math
from typing import Callable, Tuple

import torch
from torch.func import jvp

from mfs_tpu_torch.typings import Array, FloatScalar


def generator_1d(phi: Callable, drift: Callable, dispersion: Callable) -> Callable:
    """Generator for scalar-state SDEs: ``A phi = a phi' + 0.5 b^2 phi''``."""

    def a_phi(x):
        d_phi = lambda u: jvp(phi, (u,), (torch.ones_like(u),))[1]
        # One nested JVP gives phi' (its primal) and phi'' (its tangent).
        dphi, ddphi = jvp(d_phi, (x,), (torch.ones_like(x),))
        extra = (None,) * (dphi.ndim - x.ndim)
        a = (drift(x) * torch.ones_like(x))[(...,) + extra]
        b = (dispersion(x) * torch.ones_like(x))[(...,) + extra]
        return a * dphi + 0.5 * b * b * ddphi

    return a_phi


def _expansion(phi: Callable, gen: Callable, x, dt, order: int):
    terms = phi(x)
    a_r = phi
    coeff = 1.0
    for r in range(1, order + 1):
        a_r = gen(a_r)
        coeff = coeff * dt / r
        terms = terms + coeff * a_r(x)
    return terms


def expectation_1d(
    phi: Callable,
    x: Array,
    dt: FloatScalar,
    drift: Callable,
    dispersion: Callable,
    order: int = 3,
):
    """TME of ``E[phi(X_{t+dt}) | X_t = x]`` for scalar-state SDEs."""
    gen = lambda f: generator_1d(f, drift, dispersion)
    return _expansion(phi, gen, x, dt, order)


def _generator_powers(phi: Callable, gen_of: Callable, x, order: int):
    """[(A^0 phi)(x), ..., (A^order phi)(x)] by iterated generator."""
    terms = [phi(x)]
    a_r = phi
    for _ in range(order):
        a_r = gen_of(a_r)
        terms.append(a_r(x))
    return terms


def _consistent_mean_cov(id_terms, sq_terms, dt, order, outer_fn):
    """Consistently truncated TME mean/cov (Zhao 2021):

    cov = Σ_{r=1}^{p} dt^r/r! [ A^r(x xᵀ) − Σ_{k=0}^{r} C(r,k) (A^k x) ⊗ (A^{r−k} x) ],

    so order 1 coincides exactly with Euler–Maruyama.
    """
    mean = id_terms[0]
    coeff = 1.0
    for r in range(1, order + 1):
        coeff = coeff * dt / r
        mean = mean + coeff * id_terms[r]

    cov = None
    coeff = 1.0
    for r in range(1, order + 1):
        coeff = coeff * dt / r
        inner = sq_terms[r]
        for k in range(r + 1):
            inner = inner - math.comb(r, k) * outer_fn(id_terms[k], id_terms[r - k])
        cov = coeff * inner if cov is None else cov + coeff * inner
    return mean, cov


def mean_and_var_1d(
    x: Array,
    dt: FloatScalar,
    drift: Callable,
    dispersion: Callable,
    order: int = 3,
) -> Tuple[Array, Array]:
    """TME conditional mean and variance for scalar-state SDEs."""
    gen_of = lambda f: generator_1d(f, drift, dispersion)
    id_terms = _generator_powers(lambda u: u, gen_of, x, order)
    sq_terms = _generator_powers(lambda u: u * u, gen_of, x, order)
    return _consistent_mean_cov(
        id_terms, sq_terms, dt, order, lambda a, b: a * b
    )
