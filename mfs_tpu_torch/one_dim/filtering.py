"""1D moment filters: raw / central / scaled-central modes.

Port of ``mfs_tpu/one_dim/filtering.py``.  Per time step:

    PREDICT: quadrature from current moments; contract the conditional
             transition moments with the quadrature weights.
    UPDATE:  second quadrature from predicted moments; pointwise
             measurement likelihood at the nodes; normalised posterior
             moments; accumulate ``nell -= log p(y_k | y_{1:k-1})``.

Batch-first: carries may have leading trial axes — ``cms0 (..., 2N)``,
``ys (T, ...)`` — and a Python loop over time replaces ``lax.scan``.
With ``eigh_impl="auto"`` (or ``"fused"``) every quadrature of a CUDA
run goes through the hand-written kernel.
"""
import warnings
from typing import Any, Callable, Tuple

import torch

from mfs_tpu_torch.one_dim.quadrature import moment_quadrature
from mfs_tpu_torch.typings import Array, FloatScalar


def _monomials(u: Array, num: int) -> Array:
    out = [torch.ones_like(u)]
    for _ in range(num - 1):
        out.append(out[-1] * u)
    return torch.stack(out, dim=-1)


def _check_even(num_moments: int) -> None:
    if num_moments % 2 != 0:
        warnings.warn(f"The number of moments {num_moments} should be even.")


def _batch_constant(x, like: Array) -> Array:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(like.shape[:-1])


def moment_filter_rms(
    state_cond_raw_moments: Callable[[Array], Array],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    rms0: Array,
    ys: Array,
    stable: bool = False,
    eigh_impl: str = "auto",
    quad_jitter: float = 0.0,
) -> Tuple[Array, Array]:
    r"""Moment filter with raw-moment representation.

    Returns ``rmss (T, ..., 2N)`` and ``nell (...)``.
    """
    num_moments = rms0.shape[-1]
    _check_even(num_moments)
    quad = dict(stable=stable, eigh_impl=eigh_impl, quad_jitter=quad_jitter)

    rms = rms0
    nell = torch.zeros(rms0.shape[:-1], dtype=rms0.dtype, device=rms0.device)
    rmss = []
    for y in ys:
        weights, nodes = moment_quadrature(rms, **quad)
        rms = torch.einsum("...nj,...n->...j", state_cond_raw_moments(nodes), weights)

        weights, nodes = moment_quadrature(rms, **quad)
        pdf_vals = measurement_cond_pdf(y[..., None], nodes)
        pdf_y = torch.einsum("...n,...n->...", pdf_vals, weights)
        post = _monomials(nodes, num_moments) * (pdf_vals * weights)[..., None]
        rms = torch.sum(post, dim=-2) / pdf_y[..., None]
        nell = nell - torch.log(pdf_y)
        rmss.append(rms)
    return torch.stack(rmss), nell


def moment_filter_cms(
    state_cond_central_moments: Callable[[Array, Array], Array],
    state_cond_mean: Callable[[Array], Array],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    cms0: Array,
    mean0: FloatScalar,
    ys: Array,
    stable: bool = False,
    eigh_impl: str = "auto",
    quad_jitter: float = 0.0,
) -> Tuple[Array, Array, Array]:
    r"""Moment filter with central-moment representation.

    Carries (cms, mean); the posterior mean comes from the order-1
    unnormalised posterior moment.

    Returns ``cmss (T, ..., 2N)``, ``means (T, ...)``, ``nell (...)``.
    """
    num_moments = cms0.shape[-1]
    _check_even(num_moments)
    quad = dict(stable=stable, eigh_impl=eigh_impl, quad_jitter=quad_jitter)

    cms = cms0
    mean = _batch_constant(mean0, cms0)
    nell = torch.zeros(cms0.shape[:-1], dtype=cms0.dtype, device=cms0.device)
    cmss, means = [], []
    for y in ys:
        weights, nodes = moment_quadrature(cms, mean, **quad)
        mean = torch.einsum("...n,...n->...", state_cond_mean(nodes), weights)
        cond_cms = state_cond_central_moments(nodes, mean[..., None])
        cms = torch.einsum("...nj,...n->...j", cond_cms, weights)

        weights, nodes = moment_quadrature(cms, mean, **quad)
        pdf_vals = measurement_cond_pdf(y[..., None], nodes)
        wp = pdf_vals * weights
        pdf_y = torch.sum(wp, dim=-1)
        mean = torch.sum(nodes * wp, dim=-1) / pdf_y
        post = _monomials(nodes - mean[..., None], num_moments) * wp[..., None]
        cms = torch.sum(post, dim=-2) / pdf_y[..., None]
        nell = nell - torch.log(pdf_y)
        cmss.append(cms)
        means.append(mean)
    return torch.stack(cmss), torch.stack(means), nell


def moment_filter_scms(
    state_cond_scaled_central_moments: Callable[[Array, Array, Array], Array],
    state_cond_mean_var: Callable[[Array], Tuple[Array, Array]],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    scms0: Array,
    mean0: FloatScalar,
    scale0: FloatScalar,
    ys: Array,
    stable: bool = False,
    eigh_impl: str = "auto",
    quad_jitter: float = 0.0,
) -> Tuple[Array, Array, Array, Array]:
    r"""Moment filter with scaled-central-moment representation.

    .. note:: **Scale-output convention** (as in the JAX package): the
       prediction step's ``scale`` is the *full* predicted standard
       deviation (law of total variance), not the within-transition
       part ``sqrt(E[cond_var])`` of the original paper code.  Means and
       ``nell`` are identical in exact arithmetic; ``scales``/``scmss``
       are not bit-comparable with the paper code's.

    Returns ``scmss (T, ..., 2N)``, ``means (T, ...)``, ``scales (T, ...)``,
    ``nell (...)``.
    """
    num_moments = scms0.shape[-1]
    _check_even(num_moments)
    quad = dict(stable=stable, eigh_impl=eigh_impl, quad_jitter=quad_jitter)

    scms = scms0
    mean = _batch_constant(mean0, scms0)
    scale = _batch_constant(scale0, scms0)
    nell = torch.zeros(scms0.shape[:-1], dtype=scms0.dtype, device=scms0.device)
    scmss, means, scales = [], [], []
    for y in ys:
        weights, nodes = moment_quadrature(scms, mean, scale, **quad)
        cond_means, cond_vars = state_cond_mean_var(nodes)
        mean = torch.einsum("...n,...n->...", cond_means, weights)
        # Full predicted standard deviation (law of total variance).
        second = torch.einsum("...n,...n->...", cond_vars + cond_means**2, weights)
        scale = torch.sqrt(second - mean**2)
        cond_scms = state_cond_scaled_central_moments(
            nodes, mean[..., None], scale[..., None]
        )
        scms = torch.einsum("...nj,...n->...j", cond_scms, weights)

        weights, nodes = moment_quadrature(scms, mean, scale, **quad)
        pdf_vals = measurement_cond_pdf(y[..., None], nodes)
        wp = pdf_vals * weights
        pdf_y = torch.sum(wp, dim=-1)
        mean = torch.sum(nodes * wp, dim=-1) / pdf_y
        centred = nodes - mean[..., None]
        scale = torch.sqrt(torch.sum(centred**2 * wp, dim=-1) / pdf_y)
        post = _monomials(centred / scale[..., None], num_moments) * wp[..., None]
        scms = torch.sum(post, dim=-2) / pdf_y[..., None]
        nell = nell - torch.log(pdf_y)
        scmss.append(scms)
        means.append(mean)
        scales.append(scale)
    return torch.stack(scmss), torch.stack(means), torch.stack(scales), nell
