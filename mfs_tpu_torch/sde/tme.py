"""Taylor moment expansion (TME) of SDE conditional expectations.

Port of ``mfs_tpu/sde/tme.py``.  For

    dX(t) = a(X(t)) dt + b(X(t)) dW(t)

the generator is ``A f = a f' + ½ b² f''`` and the TME of order ``p``
approximates ``E[f(X_{t+dt}) | X_t = x] ≈ Σ_{r=0}^{p} dt^r / r! (A^r f)(x)``.

Scalar state: every function is elementwise in ``x`` (``phi`` may
append trailing output axes, the vector of all 2N monomials), so the
derivative along a unit tangent *is* the elementwise derivative.  It is
taken by autograd's double-backward trick (``_jvp_1d``), nested once per
derivative order.  Nested ``torch.func.jvp`` computes the same numbers,
but at TME-3's six levels its inner levels run through Python
decompositions, ~30x slower on a CPU core.  The results carry an autograd
graph only when ``x`` or a tensor the callables close over requires
grad and grad mode is on.

The vector-state half (``generator``, ``expectation``, ``mean_and_cov``)
is batch-first in the same way: states are ``x (..., d)``, ``drift``
maps ``(..., d) -> (..., d)`` and ``dispersion`` maps ``(..., d) ->
(..., d, m)`` (or returns a constant matrix that broadcasts).  A
directional derivative along a tangent field ``(..., d)`` is taken per
state, so no ``vmap`` is needed, unlike the JAX package's per-node
functions.
"""
import math
from typing import Callable, Tuple

import torch
from torch.func import jvp

from mfs_tpu_torch.typings import Array, FloatScalar


def _jvp_1d(f: Callable, u: Array) -> Tuple[Array, Array]:
    """``(f(u), f'(u))`` for ``f`` elementwise in ``u``, which keeps
    ``u``'s shape on its leading axes and may append trailing ones.

    The double-backward trick: ``g = J^T v`` for a dummy cotangent ``v``,
    then the derivative of ``<g, 1>`` in ``v`` is ``J 1``, the
    elementwise derivative.  ``create_graph`` keeps both differentiable,
    so calls nest."""
    with torch.enable_grad():
        if not u.requires_grad:
            u = u.detach().requires_grad_(True)
        y = f(u)
        zeros = torch.zeros_like(y)
        if not y.requires_grad:
            return y, zeros
        v = torch.zeros_like(y, requires_grad=True)
        # y may depend only on closed-over tensors (a constant drift with a
        # parameter that requires grad): then its derivative is zero
        (g,) = torch.autograd.grad(y, u, v, create_graph=True, allow_unused=True)
        if g is None:
            return y, zeros
        (t,) = torch.autograd.grad(g, v, torch.ones_like(g), create_graph=True)
    return y, t


def _keeps_graph(x: Array, *probes) -> bool:
    """Whether a 1D TME result needs its autograd graph: grad mode is on
    and ``x`` or one of ``probes`` (the callables evaluated at ``x``)
    requires grad.  Otherwise the graph only reaches ``_jvp_1d``'s own
    leaf, and a filter loop would chain it from step to step."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(p) and p.requires_grad for p in (x,) + probes)


def generator_1d(phi: Callable, drift: Callable, dispersion: Callable) -> Callable:
    """Generator for scalar-state SDEs: ``A phi = a phi' + 0.5 b^2 phi''``."""

    def a_phi(x):
        d_phi = lambda u: _jvp_1d(phi, u)[1]
        # One nested derivative gives phi' (its primal) and phi'' (its tangent).
        dphi, ddphi = _jvp_1d(d_phi, x)
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
    out = _expansion(phi, gen, x, dt, order)
    return out if _keeps_graph(x, phi(x), drift(x), dispersion(x)) else out.detach()


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
    mean, var = _consistent_mean_cov(
        id_terms, sq_terms, dt, order, lambda a, b: a * b
    )
    if _keeps_graph(x, drift(x), dispersion(x)):
        return mean, var
    return mean.detach(), var.detach()


def _trailing(v: Array, out: Array, batch_ndim: int) -> Array:
    """``v (...)`` with singleton axes for ``out``'s trailing output axes."""
    return v.reshape(v.shape + (1,) * (out.ndim - batch_ndim))


def generator(phi: Callable, drift: Callable, dispersion: Callable) -> Callable:
    """Generator for vector-state SDEs, ``phi: (..., d) -> (..., *out)``:
    ``A phi = (grad phi) . a + 1/2 (b b^T) : hess phi``.

    The Hessian contraction takes d(d+1)/2 nested JVPs along basis
    vectors, exact for any output shape.
    """

    def a_phi(x):
        d = x.shape[-1]
        a = drift(x) * torch.ones_like(x)
        b = torch.as_tensor(dispersion(x), dtype=x.dtype, device=x.device)
        if b.ndim < 2:
            b = b.reshape(1, 1)
        gamma = (b @ b.mT).expand(x.shape + (d,))

        first = jvp(phi, (x,), (a,))[1]
        out = first
        for i in range(d):
            e_i = torch.zeros_like(x)
            e_i[..., i] = 1.0
            di_phi = lambda u, _e=e_i: jvp(phi, (u,), (_e,))[1]
            for j in range(i, d):
                e_j = torch.zeros_like(x)
                e_j[..., j] = 1.0
                dij = jvp(di_phi, (x,), (e_j,))[1]
                w = gamma[..., i, j] if i == j else 2.0 * gamma[..., i, j]
                out = out + 0.5 * _trailing(w, dij, x.ndim - 1) * dij
        return out

    return a_phi


def expectation(
    phi: Callable,
    x: Array,
    dt: FloatScalar,
    drift: Callable,
    dispersion: Callable,
    order: int = 3,
):
    """TME of ``E[phi(X_{t+dt}) | X_t = x]`` for vector-state SDEs."""
    gen = lambda f: generator(f, drift, dispersion)
    return _expansion(phi, gen, x, dt, order)


def _outer(a: Array, b: Array) -> Array:
    return a[..., :, None] * b[..., None, :]


def mean_and_cov(
    x: Array,
    dt: FloatScalar,
    drift: Callable,
    dispersion: Callable,
    order: int = 3,
) -> Tuple[Array, Array]:
    """TME conditional mean ``(..., d)`` and covariance ``(..., d, d)``
    for vector-state SDEs (consistently truncated covariance)."""
    gen_of = lambda f: generator(f, drift, dispersion)
    id_terms = _generator_powers(lambda u: u, gen_of, x, order)
    sq_terms = _generator_powers(lambda u: _outer(u, u), gen_of, x, order)
    return _consistent_mean_cov(id_terms, sq_terms, dt, order, _outer)
