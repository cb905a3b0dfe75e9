"""Multidimensional moments and transition-moment factories.

Port of ``mfs_tpu/multi_dims/moments.py``:

- **Kan–Magnus moments from static term tables.**  The Kan (2008)
  formulas are finite sums over an enumeration that depends only on the
  multi-indices, so the enumeration (term vectors h, coefficients,
  exponents) is built once per multi-index set in NumPy and every
  moment is a few einsums and one segment sum on the device.
- **Monomials by power-stack gathers**: exact for negative coordinates,
  differentiable, no pow or log.
- Transition factories are batch-first over nodes and trials, like the
  1D ``mfs_tpu_torch.sde.transitions``.
"""
import itertools
import math
from functools import lru_cache
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from mfs_tpu_torch.multi_dims.multi_indices import find_indices
from mfs_tpu_torch.sde import tme
from mfs_tpu_torch.typings import Array, FloatScalar
from mfs_tpu_torch.utils.profiling import span


def _key(multi_indices) -> tuple:
    return tuple(tuple(int(v) for v in row) for row in np.asarray(multi_indices))


# ---------------------------------------------------------------------------
# Kan–Magnus closed forms
# ---------------------------------------------------------------------------


def _kan_terms_one(kappa: Tuple[int, ...]):
    """The Kan Proposition-2 terms of one multi-index:

    E[X^kappa] = sum over v in prod([0..kappa_i]) and r in [0..s/2] of
        (-1)^{|v|} prod_i C(kappa_i, v_i)
        * (h' cov h / 2)^r * (h' mean)^{s - 2r} / (r! (s - 2r)!)

    with h = kappa/2 - v and s = |kappa|.
    """
    s = sum(kappa)
    hs, coefs, r_exps, m_exps = [], [], [], []
    for v in itertools.product(*[range(k + 1) for k in kappa]):
        sign = (-1) ** sum(v)
        comb = math.prod(math.comb(k, vi) for k, vi in zip(kappa, v))
        h = np.asarray(kappa, dtype=np.float64) / 2.0 - np.asarray(v, np.float64)
        for r in range(s // 2 + 1):
            hs.append(h)
            coefs.append(sign * comb / (math.factorial(r) * math.factorial(s - 2 * r)))
            r_exps.append(r)
            m_exps.append(s - 2 * r)
    return (np.asarray(hs), np.asarray(coefs), np.asarray(r_exps, np.int64),
            np.asarray(m_exps, np.int64))


@lru_cache(maxsize=None)
def _kan_tables(multi_indices_key) -> tuple:
    """Flat term tables for a multi-index set: (hs (t, d), coefs (t,),
    r_exps (t,), m_exps (t,), seg_ids (t,), z, max_exp)."""
    mi = np.asarray(multi_indices_key, dtype=np.int64)
    parts = [_kan_terms_one(tuple(int(v) for v in kappa)) for kappa in mi]
    hs = np.concatenate([p[0] for p in parts])
    coefs = np.concatenate([p[1] for p in parts])
    r_exps = np.concatenate([p[2] for p in parts])
    m_exps = np.concatenate([p[3] for p in parts])
    seg_ids = np.concatenate([np.full(len(p[1]), z, np.int64) for z, p in enumerate(parts)])
    max_exp = int(max(r_exps.max(initial=0), m_exps.max(initial=0)))
    return hs, coefs, r_exps, m_exps, seg_ids, len(mi), max_exp


def _int_pow(base: Array, exps: np.ndarray, max_exp: int) -> Array:
    """``base (..., t) ** exps (t,)`` for static integer exponents >= 0,
    by a power stack and a gather."""
    stack = [torch.ones_like(base)]
    for _ in range(max_exp):
        stack.append(stack[-1] * base)
    stack = torch.stack(stack, dim=-1)  # (..., t, max_exp + 1)
    idx = torch.as_tensor(exps, device=base.device)
    return stack.gather(-1, idx.expand(base.shape)[..., None])[..., 0]


def raw_moments_mvn_kan_all(mean: Array, cov: Array, multi_indices) -> Array:
    """All raw moments E[X^kappa], X ~ N(mean (..., d), cov (..., d, d)),
    for the static (z, d) ``multi_indices``; returns (..., z)."""
    hs, coefs, r_exps, m_exps, seg_ids, z, max_exp = _kan_tables(_key(multi_indices))
    dev, dt = mean.device, mean.dtype
    hs_t = torch.as_tensor(hs, dtype=dt, device=dev)
    quad = 0.5 * torch.einsum("td,...de,te->...t", hs_t, cov, hs_t)
    dot = torch.einsum("td,...d->...t", hs_t, mean)
    terms = (torch.as_tensor(coefs, dtype=dt, device=dev)
             * _int_pow(quad, r_exps, max_exp) * _int_pow(dot, m_exps, max_exp))
    onehot = np.zeros((len(seg_ids), z))
    onehot[np.arange(len(seg_ids)), seg_ids] = 1.0
    return torch.einsum("...t,tz->...z", terms, torch.as_tensor(onehot, dtype=dt, device=dev))


def raw_moments_mvn_kan(mean: Array, cov: Array, multi_index) -> Array:
    """One moment E[X^kappa] through the table form."""
    mi = np.asarray(multi_index, dtype=np.int64).reshape(1, -1)
    return raw_moments_mvn_kan_all(mean, cov, mi)[..., 0]


def central_moments_mvn_kan(cov: Array, multi_index) -> Array:
    """Central moment E[X^kappa], X ~ N(0, cov) (Kan Proposition 1)."""
    zero = torch.zeros(cov.shape[:-1], dtype=cov.dtype, device=cov.device)
    return raw_moments_mvn_kan(zero, cov, multi_index)


def raw_moments_mvn_mgf(mean: Array, cov: Array, multi_index) -> Array:
    """One moment E[X^kappa], X ~ N(mean, cov), by differentiating the
    MGF with nested ``torch.func.grad``: a slow test oracle (JAX:
    ``raw_moments_mvn_mgf``).  ``mean (d,)``, ``cov (d, d)``."""
    mean, cov = torch.as_tensor(mean), torch.as_tensor(cov)

    def mgf(z):
        return torch.exp(torch.dot(z, mean) + 0.5 * torch.dot(z, cov @ z))

    f = mgf
    for axis, order in enumerate(np.asarray(multi_index, np.int64)):
        for _ in range(int(order)):
            f = (lambda g, a: lambda z: torch.func.grad(g)(z)[a])(f, axis)
    return f(torch.zeros(cov.shape[0], dtype=cov.dtype, device=cov.device))


def moments_nd_uniform(bounds, multi_index, means=None) -> float:
    """Raw moment of an independent uniform distribution on a box."""
    if means is None:
        means = [0.0] * len(bounds)
    out = 1.0
    for power, (lo, hi), mean in zip(multi_index, bounds, means):
        p = int(power)
        out *= ((hi - mean) ** (p + 1) - (lo - mean) ** (p + 1)) / ((p + 1) * (hi - lo))
    return float(out)


# ---------------------------------------------------------------------------
# Moment-vector accessors (graded-lex layout)
# ---------------------------------------------------------------------------


def _take(ms: Array, ranks: np.ndarray) -> Array:
    return ms[..., torch.as_tensor(ranks, device=ms.device)]


def extract_moments(ms: Array, multi_index) -> Array:
    """Moment(s) selected by multi-index from a graded-lex vector."""
    return _take(ms, find_indices(multi_index))


def extract_mean(ms: Array, d: int) -> Array:
    """The order-1 moments (the mean of a raw-moment vector)."""
    return _take(ms, find_indices(np.eye(d, dtype=np.int64)))


def extract_cov(ms: Array, d: int) -> Array:
    """Covariance (central input) or second-moment matrix (raw input)."""
    eye = np.eye(d, dtype=np.int64)
    return _take(ms, find_indices(eye[:, None, :] + eye[None, :, :]))


def marginalise_moments(ms: Array, d: int, N: int, var_axis: int) -> Array:
    """Marginal 1D moments (orders 0..2N-1) of one coordinate."""
    mi = np.zeros((2 * N, d), dtype=np.int64)
    mi[:, var_axis] = np.arange(2 * N)
    return _take(ms, find_indices(mi))


# ---------------------------------------------------------------------------
# Monomial evaluation
# ---------------------------------------------------------------------------


def _power_stack(x: Array, max_deg: int) -> Array:
    """``x (..., d) -> (..., d, max_deg + 1)`` with entries x_i^k."""
    xe = x[..., None]
    stack = [torch.ones_like(xe)]
    for _ in range(max_deg):
        stack.append(stack[-1] * xe)
    return torch.cat(stack, dim=-1)


@lru_cache(maxsize=None)
def _monomial_onehots(mi_key, device: torch.device) -> Array:
    """(d, max_deg + 1, z) 0/1 selectors: column z of slice i picks degree k_i."""
    mi = np.asarray(mi_key, dtype=np.int64)
    z, d = mi.shape
    onehot = np.zeros((d, int(mi.max(initial=0)) + 1, z))
    for i in range(d):
        onehot[i, mi[:, i], np.arange(z)] = 1.0
    return torch.as_tensor(onehot, dtype=torch.float64, device=device)


def monomials_nd(x: Array, multi_indices) -> Array:
    """prod_i x_i^{k_i} for every multi-index: ``x (..., d) -> (..., z)``.

    One power stack per coordinate; each dimension's degrees are picked by
    a product with a static one-hot matrix (exact: one term per sum), as
    the JAX package does, and multiplied over the dimensions in order.
    ``cat`` and the matrix products keep the nested JVPs of the autodiff
    TME cheap, where ``stack`` and advanced indexing cost ~6x more.
    """
    mi = np.asarray(multi_indices, dtype=np.int64)
    stack = _power_stack(x, int(mi.max(initial=0)))
    onehot = _monomial_onehots(_key(mi), x.device).to(x.dtype)
    out = stack[..., 0, :] @ onehot[0]
    for i in range(1, mi.shape[-1]):
        out = out * (stack[..., i, :] @ onehot[i])
    return out


def weighted_monomials_nd(weights: Array, x: Array, multi_indices) -> Array:
    """Σ_m w_m prod_i x_{m,i}^{k_i}: ``weights (..., m)``, ``x (..., m, d)``
    -> ``(..., z)``.

    The same sum as contracting ``monomials_nd(x)`` with the weights, but
    factorised over the dimensions: one contraction of the d power stacks
    over the nodes gives every mixed power sum at once (a (K, K) matrix
    per trial in 2D, K = max degree + 1), and the z entries are gathered
    from it.  This never materialises the (..., m, z) monomials, which at
    2D N=7 with 1024 trials would be 0.7-0.9 GB per call.  The powers are
    stacked with the node axis last, so each is one contiguous copy.  The
    sums run in another order than the JAX package's, so results differ
    in the last bits.
    """
    mi = np.asarray(multi_indices, dtype=np.int64)
    d = mi.shape[-1]
    xt = x.movedim(-1, -2)  # (..., d, m)
    powers = [torch.ones_like(xt)]
    for _ in range(int(mi.max(initial=0))):
        powers.append(powers[-1] * xt)
    P = torch.stack(powers, dim=-2)  # (..., d, K, m)
    first = P[..., 0, :, :] * weights[..., None, :]  # (..., K, m)
    letters = "abcdefghijkl"[:d]
    spec = ",".join(f"...{c}m" for c in letters) + "->..." + letters
    sums = torch.einsum(spec, first, *[P[..., i, :, :] for i in range(1, d)])  # (..., K^d)
    idx = tuple(torch.as_tensor(mi[:, i], device=x.device) for i in range(d))
    return sums[(...,) + idx]


# ---------------------------------------------------------------------------
# Transition-moment factories
# ---------------------------------------------------------------------------


class TransitionMomentsND(NamedTuple):
    """Conditional-moment callables for a d-dimensional SDE and step
    (m quadrature nodes; leading batch axes allowed):

    - ``rms(nodes (..., m, d))              -> (..., m, z)``
    - ``cms(nodes, mean (..., d))           -> (..., m, z)``
    - ``scms(nodes, mean, scale (..., d))   -> (..., m, z)``
    - ``mean(nodes)                         -> (..., m, d)``
    - ``mean_var(nodes) -> ((..., m, d), (..., m, d))`` (cov diagonal)
    """

    rms: Callable
    cms: Callable
    scms: Callable
    mean: Callable
    mean_var: Callable


def _per_node(v: Array, nodes: Array) -> Array:
    """A per-trial ``(..., d)`` (or per-node) tensor broadcast to ``nodes``."""
    v = torch.as_tensor(v, dtype=nodes.dtype, device=nodes.device)
    if v.ndim == nodes.ndim - 1:
        v = v[..., None, :]
    return v


@span("mfs.build.transition")
def sde_cond_moments_nd_tme(
    drift: Callable,
    dispersion: Callable,
    dt: FloatScalar,
    tme_order: int,
    multi_indices: np.ndarray,
) -> TransitionMomentsND:
    """TME conditional moments of all monomials (no Normal closure).

    One vector-valued TME expansion per node gives all z moments.
    ``cms``/``scms`` expand the shifted and scaled monomials
    prod_i ((u_i - m_i)/s_i)^{k_i} directly: deriving them from the raw
    pass by a binomial shift cancels catastrophically when the mean is
    far from the origin.
    """
    mi = np.asarray(multi_indices, dtype=np.int64)

    def _tme(nodes: Array, shift=None, scale=None) -> Array:
        if shift is None:
            phi = lambda u: monomials_nd(u, mi)
        else:
            m0 = _per_node(shift, nodes)
            s0 = torch.ones_like(m0) if scale is None else _per_node(scale, nodes)
            phi = lambda u: monomials_nd((u - m0) / s0, mi)
        return tme.expectation(phi, nodes, dt, drift, dispersion, tme_order)

    def rms(nodes: Array) -> Array:
        return _tme(nodes)

    def cms(nodes: Array, mean: Array) -> Array:
        return _tme(nodes, shift=mean)

    def scms(nodes: Array, mean: Array, scale: Array) -> Array:
        return _tme(nodes, shift=mean, scale=scale)

    def mean_fn(nodes: Array) -> Array:
        return tme.expectation(lambda u: u, nodes, dt, drift, dispersion, tme_order)

    def mean_var(nodes: Array) -> Tuple[Array, Array]:
        m, c = tme.mean_and_cov(nodes, dt, drift, dispersion, tme_order)
        return m, torch.diagonal(c, dim1=-2, dim2=-1)

    return TransitionMomentsND(rms, cms, scms, mean_fn, mean_var)


def _normal_closure_factory_nd(
    cond_mean_cov: Callable[[Array], Tuple[Array, Array]],
    multi_indices: np.ndarray,
) -> TransitionMomentsND:
    """Factory from an elementwise conditional mean/cov map with Normal
    closure, evaluated through the Kan tables."""
    mi = np.asarray(multi_indices, dtype=np.int64)

    def rms(nodes: Array) -> Array:
        m, c = cond_mean_cov(nodes)
        return raw_moments_mvn_kan_all(m, c, mi)

    def cms(nodes: Array, mean: Array) -> Array:
        m, c = cond_mean_cov(nodes)
        return raw_moments_mvn_kan_all(m - _per_node(mean, nodes), c, mi)

    def scms(nodes: Array, mean: Array, scale: Array) -> Array:
        return cms(nodes, mean) / monomials_nd(_per_node(scale, nodes), mi)

    def mean_fn(nodes: Array) -> Array:
        return cond_mean_cov(nodes)[0]

    def mean_var(nodes: Array) -> Tuple[Array, Array]:
        m, c = cond_mean_cov(nodes)
        return m, torch.diagonal(c, dim1=-2, dim2=-1)

    return TransitionMomentsND(rms, cms, scms, mean_fn, mean_var)


@span("mfs.build.transition")
def sde_cond_moments_nd_euler_maruyama(
    drift: Callable,
    dispersion: Callable,
    dt: FloatScalar,
    multi_indices: np.ndarray,
) -> TransitionMomentsND:
    """Euler–Maruyama mean/cov with Normal closure."""

    def cond_mean_cov(nodes):
        b = torch.as_tensor(dispersion(nodes), dtype=nodes.dtype, device=nodes.device)
        if b.ndim < 2:
            b = b.reshape(1, 1)
        cov = (b @ b.mT * dt).expand(nodes.shape + (nodes.shape[-1],))
        return nodes + drift(nodes) * dt, cov

    return _normal_closure_factory_nd(cond_mean_cov, multi_indices)


@span("mfs.build.transition")
def sde_cond_moments_nd_tme_normal(
    drift: Callable,
    dispersion: Callable,
    dt: FloatScalar,
    tme_order: int,
    multi_indices: np.ndarray,
) -> TransitionMomentsND:
    """TME mean/cov with Normal closure."""

    def cond_mean_cov(nodes):
        return tme.mean_and_cov(nodes, dt, drift, dispersion, tme_order)

    return _normal_closure_factory_nd(cond_mean_cov, multi_indices)
