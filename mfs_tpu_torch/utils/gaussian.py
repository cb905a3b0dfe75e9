"""Gaussian moment closed forms and Gaussian-sum initial conditions.

Port of ``mfs_tpu/utils/gaussian.py`` (1D half): ``normal_raw_moments_all``
computes every moment order 0..P-1 in one O(P) three-term recurrence,
elementwise over batched mean/variance tensors.
"""
import math
from typing import NamedTuple

import torch

from mfs_tpu_torch.config import DTYPE, as_tensor
from mfs_tpu_torch.typings import Array


def normal_raw_moments_all(mean, variance, num_moments: int) -> Array:
    """Raw moments E[X^p], p = 0..num_moments-1, of X ~ N(mean, variance).

    Uses the recurrence ``m_p = mean * m_{p-1} + (p-1) * variance * m_{p-2}``.
    ``mean`` and ``variance`` broadcast elementwise; at least one of them
    must be a tensor (its device is used).  Returns ``(..., P)``.
    """
    ref = mean if torch.is_tensor(mean) else variance
    mean = torch.as_tensor(mean, dtype=DTYPE, device=ref.device)
    variance = torch.as_tensor(variance, dtype=DTYPE, device=ref.device)
    shape = torch.broadcast_shapes(mean.shape, variance.shape)
    ms = [torch.ones(shape, dtype=DTYPE, device=ref.device)]
    if num_moments >= 2:
        ms.append(mean.expand(shape))
    for p in range(2, num_moments):
        ms.append(mean * ms[-1] + (p - 1) * variance * ms[-2])
    return torch.stack(ms[:num_moments], dim=-1)


class GaussianSum1D(NamedTuple):
    """A 1D Gaussian mixture with precomputed moments up to order 2N-1."""

    means: Array
    variances: Array
    weights: Array
    mean: Array
    variance: Array
    rms: Array
    cms: Array
    scms: Array

    def pdf(self, xs: Array) -> Array:
        xs = torch.atleast_1d(xs)[..., None]
        sd = torch.sqrt(self.variances)
        comp = torch.exp(-0.5 * ((xs - self.means) / sd) ** 2) / (
            sd * math.sqrt(2.0 * math.pi)
        )
        return torch.sum(comp * self.weights, dim=-1)

    def sampler(self, generator: torch.Generator, n: int) -> Array:
        """``n`` draws; ``generator`` must live on the mixture's device."""
        cs = torch.multinomial(self.weights, n, replacement=True, generator=generator)
        eps = torch.randn(
            n, generator=generator, dtype=DTYPE, device=self.means.device
        )
        return self.means[cs] + torch.sqrt(self.variances[cs]) * eps

    @classmethod
    def new(cls, means, variances, weights, N: int = 2, device=None):
        means = as_tensor(means, device)
        variances = as_tensor(variances, device)
        weights = as_tensor(weights, device)
        num_moments = 2 * N
        comp_rms = normal_raw_moments_all(means, variances, num_moments)  # (c, 2N)
        rms = torch.einsum("c,cp->p", weights, comp_rms)
        centre = rms[1]
        comp_cms = normal_raw_moments_all(means - centre, variances, num_moments)
        cms = torch.einsum("c,cp->p", weights, comp_cms)
        variance = cms[2]
        orders = torch.arange(num_moments, dtype=DTYPE, device=means.device)
        scms = cms / torch.sqrt(variance) ** orders
        return cls(
            means=means,
            variances=variances,
            weights=weights,
            mean=centre,
            variance=variance,
            rms=rms,
            cms=cms,
            scms=scms,
        )
