"""Densities recovered from moments or cumulants (port of
``mfs_tpu/one_dim/pdf_approximations.py``).

Batched: the moments or cumulants may carry leading trial axes ``b``,
and each returned ``pdf(x)`` evaluates every trial's density at every
point of ``x``, giving ``b + x.shape`` (one vector gives the JAX
function's ``x.shape``).  Hermite and Legendre ladders are computed for
every order in one recurrence pass, and the Bell-polynomial coefficients
come from one programme over the trial axes.
"""
import math
from typing import Callable

import numpy as np
import torch

from mfs_tpu_torch.config import DTYPE
from mfs_tpu_torch.typings import Array, FloatScalar
from mfs_tpu_torch.utils.combinatorics import _bell_table, hermite_probabilist_all


def _on(x, like: Array) -> Array:
    return torch.as_tensor(x, dtype=DTYPE, device=like.device)


def _per_point(t: Array, x: Array) -> Array:
    """A per-trial ``t (b)`` shaped to broadcast against ``x``'s axes."""
    return t.reshape(t.shape + (1,) * x.ndim)


def _series(hermites: Array, coeffs: Array, x: Array) -> Array:
    """``Σ_j He_j(h) c_j`` with hermites ``b + x.shape + (J,)`` and the
    trials' coefficients ``b + (J,)``."""
    lead = coeffs.shape[:-1]
    flat = hermites.reshape(lead + (-1, hermites.shape[-1]))
    return torch.einsum("...mj,...j->...m", flat, coeffs).reshape(hermites.shape[:-1])


def gram_charlier(cumulants: Array) -> Callable[[Array], Array]:
    """Gram–Charlier A series around a Normal base density.

    Parameters
    ----------
    cumulants : Array (..., 2n - 1)
        Cumulants k_1, ..., k_{2n-1} (from ``sms_to_cumulants``).

    Returns
    -------
    pdf : x -> (..., *x.shape)
        ``phi(h) / sigma * sum_j He_j(h) B_j(0, 0, k_3, ...) / (j! sigma^j)``
        with h the standardised coordinate.
    """
    order = cumulants.shape[-1]
    mean = cumulants[..., 0]
    variance = cumulants[..., 1]
    zeros = torch.zeros(cumulants.shape[:-1] + (2,), dtype=cumulants.dtype,
                        device=cumulants.device)
    bell_input = torch.cat([zeros, cumulants[..., 2:]], dim=-1)
    table = _bell_table(order, order, bell_input)

    def bell(j):
        return 1.0 if j == 0 else sum(table[j][k] for k in range(1, j + 1))

    coeffs = torch.stack(
        [torch.as_tensor(bell(j), dtype=cumulants.dtype, device=cumulants.device).expand(
            mean.shape) / (float(math.factorial(j)) * variance ** (j / 2.0))
         for j in range(order + 1)],
        dim=-1,
    )

    def pdf(x: Array) -> Array:
        x = _on(x, cumulants)
        h = (x - _per_point(mean, x)) / torch.sqrt(_per_point(variance, x))
        base = torch.exp(-0.5 * h * h) / torch.sqrt(2 * torch.pi * _per_point(variance, x))
        return base * _series(hermite_probabilist_all(order, h), coeffs, x)

    return pdf


def edgeworth(cumulants: Array, order: int = 2) -> Callable[[Array], Array]:
    """Edgeworth expansion around the Normal (Petrov's grouping):

        f(x) = phi(h)/sigma [ 1 + sum_{s=1}^{order} P_s(h) ],
        P_s(h) = sum_{k=1}^{s} He_{s+2k}(h) B_{s,k}(x_1, ..., x_{s-k+1}) / s!,
        x_j = j! * k_{j+2} / (sigma^{j+2} (j+2)!).

    ``cumulants (..., >= order + 2)``: k_1, k_2, ....
    """
    mean = cumulants[..., 0]
    variance = cumulants[..., 1]
    sigma = torch.sqrt(variance)

    def x_j(j: int):
        return (
            cumulants[..., j + 1]
            * math.factorial(j)
            / (sigma ** (j + 2) * math.factorial(j + 2))
        )

    max_he = 3 * order
    zero = torch.zeros_like(mean)
    coeff = [zero] * (max_he + 1)  # coeff[m] multiplies He_m(h)
    coeff[0] = torch.ones_like(mean)
    for s in range(1, order + 1):
        xs = [x_j(j) for j in range(1, s + 1)]
        table = _bell_table(s, s, xs)
        for k in range(1, s + 1):
            c = torch.as_tensor(table[s][k], dtype=DTYPE, device=mean.device) / math.factorial(s)
            coeff[s + 2 * k] = coeff[s + 2 * k] + c
    coeffs = torch.stack(coeff, dim=-1)

    def pdf(x: Array) -> Array:
        x = _on(x, cumulants)
        h = (x - _per_point(mean, x)) / _per_point(sigma, x)
        base = torch.exp(-0.5 * h * h) / (math.sqrt(2 * math.pi) * _per_point(sigma, x))
        return base * _series(hermite_probabilist_all(max_he, h), coeffs, x)

    return pdf


def _legendre_matrix(num_moments: int) -> np.ndarray:
    """``L[k, i]`` = coefficient of u^i in P_k(u)."""
    L = np.zeros((num_moments, num_moments))
    for k in range(num_moments):
        for i in range(k // 2 + 1):
            L[k, k - 2 * i] = (
                (-1) ** i
                * 2.0 ** (-k)
                * math.factorial(2 * k - 2 * i)
                / (
                    math.factorial(i)
                    * math.factorial(k - i)
                    * math.factorial(k - 2 * i)
                )
            )
    return L


def legendre_poly_expansion(
    rms: Array, a: FloatScalar = -1.0, b: FloatScalar = 1.0
) -> Callable[[Array], Array]:
    """Legendre expansion of a density supported on [a, b].

    Coefficient c_k = (2k + 1)/2 * Σ_i L[k, i] m_i with ``rms (..., M)``:
    as in the JAX function, the raw moments are applied directly, i.e.
    E[P_k(X)] with the *unshifted* moments; the pdf evaluates P_k at the
    shifted variable u = (2x - (a + b)) / (b - a).
    """
    num_moments = rms.shape[-1]
    Lt = torch.as_tensor(_legendre_matrix(num_moments), dtype=DTYPE, device=rms.device)
    ks = torch.arange(num_moments, dtype=DTYPE, device=rms.device)
    cks = (2 * ks + 1) / 2.0 * torch.einsum("ki,...i->...k", Lt, rms)

    def pdf(x: Array) -> Array:
        x = _on(x, rms)
        u = (2 * x - (a + b)) / (b - a)
        pows = [torch.ones_like(u)]
        for _ in range(num_moments - 1):
            pows.append(pows[-1] * u)
        legvals = torch.einsum("...i,ki->...k", torch.stack(pows, dim=-1), Lt)
        return 2.0 / (b - a) * _series(legvals.expand(cks.shape[:-1] + legvals.shape), cks, x)

    return pdf


def truncated_cumulant_generating_function(
    z: FloatScalar, ms: Array, mean: FloatScalar = 0.0, scale: FloatScalar = 1.0
) -> Array:
    """K(z) = z mean + log Σ_n (z scale)^n m_n / n! (truncated MGF), for
    ``ms (..., M)``: raw (defaults), central (mean given) or scaled
    central (scale given).  Returns ``ms.shape[:-1] + z.shape``."""
    num_moments = ms.shape[-1]
    facts = torch.as_tensor([math.factorial(n) for n in range(num_moments)], dtype=DTYPE,
                            device=ms.device)
    zs = _on(z, ms)
    mean, scale = (_per_point(_on(v, ms).expand(ms.shape[:-1]), zs) for v in (mean, scale))
    pows = [torch.ones_like(zs * scale)]
    for _ in range(num_moments - 1):
        pows.append(pows[-1] * (zs * scale))
    smgf = _series(torch.stack(pows, dim=-1).expand(ms.shape[:-1] + zs.shape + (num_moments,)),
                   ms / facts, zs)
    return zs * mean + torch.log(smgf)


def _cgf_terms(coeffs, mean: Array, scale: Array, s: Array):
    """S(u), K'(s) and K''(s) of K(s) = s mean + log S(s scale), with
    S(u) = Σ_n coeffs[n] u^n, S' and S'' by Horner's rule: the closed
    forms K' = mean + scale S'/S, K'' = scale^2 (S''/S - (S'/S)^2)."""
    u = s * scale
    p = coeffs[-1].expand(u.shape)
    dp = torch.zeros_like(u)
    ddp = torch.zeros_like(u)
    for c in coeffs[-2::-1]:
        ddp = ddp * u + dp
        dp = dp * u + p
        p = p * u + c
    ratio = dp / p
    return p, mean + scale * ratio, scale * scale * (2.0 * ddp / p - ratio**2)


def saddle_point(
    sms: Array, mean: FloatScalar, scale: FloatScalar, newton_iters: int = 50
) -> Callable[[Array], Array]:
    """Saddle-point density from the polynomial-truncated CGF
    K(z) = z mean + log S(z scale), S(u) = Σ_n m_n u^n / n!.

    Solves ``K'(s) = x`` by damped Newton from ``s0 = (x - mean)/scale^2``
    (``newton_iters`` steps, each clipped to ±2/scale to stay inside the
    S(u) > 0 branch), then returns ``exp(K(s) - s x) / sqrt(2 pi K''(s))``,
    and 0 where that is not finite or K'' <= 0.  K' and K'' are the
    polynomial's closed-form derivatives (``_cgf_terms``), where the JAX
    function takes them by autodiff.  ``sms (..., M)`` with per-trial
    ``mean``/``scale``.
    """
    num_moments = sms.shape[-1]
    facts = torch.as_tensor([math.factorial(n) for n in range(num_moments)], dtype=DTYPE,
                            device=sms.device)
    coeffs = sms / facts  # S's coefficients, lowest degree first
    mean = _on(mean, sms).expand(sms.shape[:-1])
    scale = _on(scale, sms).expand(sms.shape[:-1])

    def pdf(x: Array) -> Array:
        x = _on(x, sms)
        mu, sc = _per_point(mean, x), _per_point(scale, x)
        c = [_per_point(coeffs[..., n], x) for n in range(num_moments)]
        s = (x - mu) / sc**2
        for _ in range(newton_iters):
            _, d1, d2 = _cgf_terms(c, mu, sc, s)
            step = (d1 - x) / torch.where(d2.abs() < 1e-12, 1e-12, d2)
            step = torch.clamp(step, -2.0 / sc, 2.0 / sc)
            s = s - step
        p, _, k2 = _cgf_terms(c, mu, sc, s)
        val = torch.exp(s * mu + torch.log(p) - s * x) / torch.sqrt(2 * torch.pi * k2)
        return torch.where(torch.isfinite(val) & (k2 > 0), val, 0.0)

    return pdf


def inverse_fourier(x: Array, cfs: Array, zs: Array) -> Array:
    """Density by inverse Fourier transform of a characteristic function:
    ``p(x) = (1 / 2 pi) ∫ e^{-i x z} phi(z) dz`` by the trapezoid rule.
    ``cfs (..., Z)`` on ``zs (Z,)``; returns ``cfs.shape[:-1] + x.shape``."""
    zs = torch.as_tensor(zs, dtype=DTYPE, device=cfs.device)
    x = torch.as_tensor(x, dtype=DTYPE, device=cfs.device)
    lead = cfs.shape[:-1]
    cf = cfs.reshape(lead + (1,) * x.ndim + cfs.shape[-1:])
    integrand = torch.exp(-1j * x[..., None] * zs) * cf
    return torch.real(torch.trapezoid(integrand, zs, dim=-1)) / (2 * math.pi)
