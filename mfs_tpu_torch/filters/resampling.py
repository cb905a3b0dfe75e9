"""Resampling kernels for sequential Monte Carlo — batch-first.

Port of ``mfs_tpu/filters/resampling.py``: systematic / stratified /
multinomial index resamplers (inverse CDF over the weight cumsum) and
the sorted-interpolation continuous resampler that makes the particle
likelihood differentiable.  Every resampler takes ``(..., n)`` weights
and returns ``(..., n)`` indices, with independent noise per trial.
Where JAX takes a PRNG key, these take a ``torch.Generator`` on the
weights' device (another device raises).
"""
import numpy as np
import torch

from mfs_tpu_torch.config import check_generator
from mfs_tpu_torch.typings import Array


def _uniform(shape, like: Array, generator: torch.Generator) -> Array:
    check_generator(generator, like.device)
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def _inverse_cdf(weights: Array, us: Array) -> Array:
    """Batched inverse-CDF lookup: weights (..., n), us (..., m) -> (..., m).

    Left-side search, as ``jnp.searchsorted``; clipped to n - 1, since a
    cumsum that ends just below 1 sends the last uniforms past the end."""
    n = weights.shape[-1]
    cdf = torch.cumsum(weights, dim=-1).reshape(-1, n)
    idx = torch.searchsorted(cdf, us.reshape(-1, us.shape[-1]).contiguous())
    return torch.clamp(idx.reshape(us.shape), max=n - 1)


def systematic(weights: Array, generator: torch.Generator) -> Array:
    """Systematic resampling: one shared uniform offset per trial."""
    n = weights.shape[-1]
    u = _uniform(weights.shape[:-1] + (1,), weights, generator)
    grid = torch.arange(n, dtype=weights.dtype, device=weights.device)
    return _inverse_cdf(weights, (grid + u) / n)


def stratified(weights: Array, generator: torch.Generator) -> Array:
    """Stratified resampling: one uniform per stratum per trial."""
    n = weights.shape[-1]
    us = _uniform(weights.shape, weights, generator)
    grid = torch.arange(n, dtype=weights.dtype, device=weights.device)
    return _inverse_cdf(weights, (grid + us) / n)


def multinomial(weights: Array, generator: torch.Generator) -> Array:
    """Multinomial resampling with sorted uniforms (Chopin's trick)."""
    n = weights.shape[-1]
    es = -torch.log(_uniform(weights.shape[:-1] + (n + 1,), weights, generator))
    z = torch.cumsum(es, dim=-1)
    return _inverse_cdf(weights, z[..., :-1] / z[..., -1:])


def _interp(x: Array, xp: Array, fp: Array) -> Array:
    """``jnp.interp`` along the last axis, per trial: ``x (..., m)``,
    ``xp``, ``fp (..., n)``; clamped to the end values outside ``xp``."""
    n = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(), right=True), 1, n - 1)
    xp_lo, xp_hi = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    fp_lo, fp_hi = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = xp_hi - xp_lo
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, fp_lo,
                    fp_lo + (x - xp_lo) / torch.where(dx0, torch.ones_like(dx), dx) * (fp_hi - fp_lo))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def continuous_resampling(
    samples: Array, weights: Array, nsamples: int, generator: torch.Generator
) -> Array:
    """Differentiable 1D resampling by inverse-CDF interpolation.

    Sorts the particles per trial, builds a piecewise-linear CDF from
    midpoint-averaged weights, and interpolates stratified uniforms
    through it, so gradients flow to both samples and weights.
    ``samples``/``weights`` are ``(..., n)``; returns ``(..., nsamples)``.
    """
    xs, order = torch.sort(samples, dim=-1, stable=True)
    ws = torch.gather(weights, -1, order)
    half = 0.5 * ws
    cdf = torch.cumsum(torch.cat([half[..., :1], half[..., 1:] + half[..., :-1]], dim=-1), dim=-1)
    grid = torch.arange(nsamples, dtype=samples.dtype, device=samples.device)
    us = (_uniform(samples.shape[:-1] + (nsamples,), samples, generator) + grid) / nsamples
    return _interp(us, cdf, xs)
