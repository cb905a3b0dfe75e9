"""1D moment algebra (port of ``mfs_tpu/one_dim/moments.py``): mode
conversions, cumulants and characteristic functions.

Conversions are single masked matrix contractions built from Pascal
triangles, batched over leading axes.  ``sms_to_cumulants`` is batched
too (the JAX function takes one vector): one Bell-polynomial programme
over the last axis serves every trial.
"""
import math

import numpy as np
import torch

from mfs_tpu_torch.config import DTYPE
from mfs_tpu_torch.one_dim.quadrature import moment_quadrature
from mfs_tpu_torch.typings import Array, FloatScalar
from mfs_tpu_torch.utils.combinatorics import _bell_table, pascal_lower


def _on(x, like: Array) -> Array:
    return torch.as_tensor(x, dtype=DTYPE, device=like.device)


def _powers(x: Array, num: int) -> Array:
    """[1, x, x^2, ..., x^{num-1}] along a new last axis, by iterated
    products (exact for any sign of x)."""
    out = [torch.ones_like(x)]
    for _ in range(num - 1):
        out.append(out[-1] * x)
    return torch.stack(out, dim=-1)


def _binomial_shift_matrix(s: int, shift: Array) -> Array:
    """``M[n, j] = C(n, j) shift^{n-j}`` (lower triangular), ``(..., s, s)``."""
    binom = torch.as_tensor(pascal_lower(s), device=shift.device)
    expo = np.arange(s)[:, None] - np.arange(s)[None, :]  # n - j
    mask = torch.as_tensor(expo >= 0, device=shift.device)
    pows = _powers(shift, s)
    powmat = pows[..., torch.as_tensor(np.where(expo >= 0, expo, 0), device=shift.device)]
    return torch.where(mask, binom * powmat, 0.0)


def raw_to_central(rms: Array) -> Array:
    """E[X^n] -> E[(X - E X)^n] for all n at once (batched)."""
    M = _binomial_shift_matrix(rms.shape[-1], -rms[..., 1])
    return torch.einsum("...nj,...j->...n", M, rms)


def central_to_raw(cms: Array, mean: FloatScalar) -> Array:
    """E[(X - mean)^n] -> E[X^n] for all n at once (batched)."""
    M = _binomial_shift_matrix(cms.shape[-1], _on(mean, cms))
    return torch.einsum("...nj,...j->...n", M, cms)


def raw_to_scaled(rms: Array, scale: FloatScalar = None) -> Array:
    """E[X^n] -> E[((X - mean)/scale)^n]; default scale = std."""
    if scale is None:
        scale = torch.sqrt(rms[..., 2] - rms[..., 1] ** 2)
    return raw_to_central(rms) / _powers(_on(scale, rms), rms.shape[-1])


def scaled_to_central(sms: Array, scale: FloatScalar) -> Array:
    """E[((X - mean)/scale)^n] -> E[(X - mean)^n]."""
    return sms * _powers(_on(scale, sms), sms.shape[-1])


def sms_to_cumulants(sms: Array, mean: FloatScalar, scale: FloatScalar) -> Array:
    """Cumulants k_1..k_{2n-1} ``(..., 2n - 1)`` from scaled central
    moments ``(..., 2n)``, by Faà di Bruno over partial Bell polynomials
    of the central moments.  k_1 = mean + cms[1] covers both the centred
    (cms[1] = 0) and the raw-with-zero-mean conventions."""
    cms = scaled_to_central(sms, scale)
    xs = cms[..., 1:]
    order = sms.shape[-1] - 1
    table = _bell_table(order, order, xs) if order >= 2 else None

    def nth(n: int):
        if n == 1:
            return _on(mean, cms) + cms[..., 1]
        # float(): (k - 1)! passes int64 at k = 22, as a torch scalar must not
        return sum(float((-1) ** (k - 1) * math.factorial(k - 1)) * table[n][k]
                   for k in range(1, n + 1))

    return torch.stack([nth(n) for n in range(1, order + 1)], dim=-1)


def characteristic_fn(
    zs: Array, ms: Array, mean: FloatScalar = 0.0, scale: FloatScalar = 1.0
) -> Array:
    """Characteristic function at ``zs`` via moment quadrature:
    ``E[e^{izX}] ≈ Σ_j w_j e^{i z x_j}``, one rule serving every point.
    The rule comes from K1 ("fused": the CUDA kernel on a CUDA tensor,
    its plain version on a CPU tensor); the sum is complex128.

    Returns ``ms.shape[:-1] + zs.shape``.
    """
    zs = _on(zs, ms)
    weights, nodes = moment_quadrature(ms, mean, scale, eigh_impl="fused")
    phase = torch.exp(1j * nodes[..., None] * zs.reshape(-1))
    vals = torch.sum(weights[..., None] * phase, dim=-2)
    return vals.reshape(ms.shape[:-1] + zs.shape)


def characteristic_from_pdf(zs: Array, ps: Array, xs: Array) -> Array:
    """Characteristic function by trapezoid integration of a gridded pdf."""
    zs = _on(zs, ps)
    integrand = torch.exp(1j * zs.reshape(-1, 1) * xs) * ps
    return torch.trapezoid(integrand, xs, dim=-1).reshape(zs.shape)
