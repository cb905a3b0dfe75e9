"""Gaussian moment closed forms and Gaussian-sum initial conditions.

Port of ``mfs_tpu/utils/gaussian.py``: ``normal_raw_moments_all``
computes every moment order 0..P-1 in one O(P) three-term recurrence,
elementwise over batched mean/variance tensors; ``GaussianSumND`` keeps
a d-dimensional mixture's graded-lex moment vectors.
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


def raw_moment_of_standard_normal(p: int) -> float:
    """E[X^p] for X ~ N(0, 1): (p-1)!! for even p, 0 for odd p."""
    if p % 2 == 1:
        return 0.0
    return math.factorial(p) / (2 ** (p // 2) * math.factorial(p // 2))


def raw_moment_of_normal(mean, variance, p: int) -> Array:
    """E[X^p] for X ~ N(mean, variance), single static order p; as for
    ``normal_raw_moments_all``, one of mean and variance is a tensor."""
    return normal_raw_moments_all(mean, variance, p + 1)[..., p]


def central_moment_of_normal(variance, p: int):
    """p-th central moment of a Normal: variance^{p/2} (p-1)!! (even p)."""
    if p % 2 == 1:
        return 0.0
    return torch.sqrt(torch.as_tensor(variance, dtype=DTYPE)) ** p * raw_moment_of_standard_normal(p)


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


class GaussianSumND(NamedTuple):
    """A d-dimensional Gaussian mixture with graded-lex moment vectors
    (raw and central) over the given multi-indices, computed with the
    Kan–Magnus tables of ``mfs_tpu_torch.multi_dims.moments``."""

    d: int
    means: Array  # (c, d)
    covs: Array  # (c, d, d)
    weights: Array  # (c,)
    mean: Array  # (d,)
    cov: Array  # (d, d)
    rms: Array  # (z,)
    cms: Array  # (z,)

    def _components(self):
        return torch.distributions.MultivariateNormal(self.means, self.covs)

    def pdf(self, x: Array) -> Array:
        """Density at ``x (..., d)``."""
        return torch.exp(self.logpdf(x))

    def logpdf(self, x: Array) -> Array:
        """Log density at ``x (..., d)``."""
        comp = self._components().log_prob(x[..., None, :])  # (..., c)
        return torch.logsumexp(comp + torch.log(self.weights), dim=-1)

    def sampler(self, generator: torch.Generator, n: int) -> Array:
        """``n`` draws ``(n, d)``; ``generator`` must live on the mixture's device."""
        cs = torch.multinomial(self.weights, n, replacement=True, generator=generator)
        chols = torch.linalg.cholesky(self.covs[cs])
        eps = torch.randn((n, self.d), generator=generator, dtype=DTYPE,
                          device=self.means.device)
        return self.means[cs] + torch.einsum("nij,nj->ni", chols, eps)

    @classmethod
    def new(cls, means, covs, weights, multi_indices, device=None):
        from mfs_tpu_torch.multi_dims.moments import raw_moments_mvn_kan_all

        means = as_tensor(means, device)
        covs = as_tensor(covs, device)
        weights = as_tensor(weights, device)
        centre = torch.einsum("c,cd->d", weights, means)
        second = torch.einsum("c,cde->de", weights,
                              covs + means[:, :, None] * means[:, None, :])
        cov = second - torch.outer(centre, centre)
        rms = torch.einsum("c,cz->z", weights,
                           raw_moments_mvn_kan_all(means, covs, multi_indices))
        cms = torch.einsum("c,cz->z", weights,
                           raw_moments_mvn_kan_all(means - centre, covs, multi_indices))
        return cls(d=means.shape[1], means=means, covs=covs, weights=weights,
                   mean=centre, cov=cov, rms=rms, cms=cms)


def _expm(X: Array) -> Array:
    """``torch.linalg.matrix_exp`` through the identity shift
    exp(X) = e^-1 exp(X + I).  Its degree-8 branch, taken for 1-norms in
    [3.4e-4, 5e-2) (a step's A dt, typically), is off by up to ~1e-12
    (torch 2.13 on a CPU, against mpmath at 40 digits); the shifted
    argument goes to the degree-18 branch, off by ~2e-16, as SciPy's
    ``expm`` (the JAX package's) is."""
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    return torch.linalg.matrix_exp(X + eye) * math.exp(-1.0)


def discretise_lti_sde(A: Array, B: Array, dt):
    """Exact discretisation of dX = A X dt + B dW over a step dt.

    Returns the transition matrix F and the transition covariance Q by
    the matrix-fraction decomposition (Axelsson–Gustafsson), with
    ``torch.linalg.matrix_exp`` (``_expm``; JAX:
    ``mfs_tpu/utils/gaussian.py:198``, SciPy's ``expm`` for concrete
    inputs).  ``A (d, d)`` and ``B (d, m)`` are tensors; F and Q are on
    their device.
    """
    d = A.shape[-1]
    F = _expm(A * dt)
    zeros = torch.zeros_like(A)
    blk = torch.cat([torch.cat([A, B @ B.mT], dim=-1), torch.cat([zeros, -A.mT], dim=-1)],
                    dim=-2)
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    m = _expm(blk * dt) @ torch.cat([zeros, eye], dim=-2)
    return F, m[..., :d, :] @ F.mT
