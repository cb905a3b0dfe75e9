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
run goes through the hand-written kernel K1.  The Bayes update of the
three quadrature loops is ``ops/posterior_kernel.py``: a CUDA kernel on
CUDA tensors whatever the route, its plain version on the CPU.
``moment_filter_taylor`` replaces the quadratures by Taylor expansions
around the running mean.
"""
import warnings
from typing import Any, Callable, Tuple

import torch

from mfs_tpu_torch.one_dim.quadrature import moment_quadrature, taylor_quadrature
from mfs_tpu_torch.ops.posterior_kernel import posterior_moments_1d
from mfs_tpu_torch.typings import Array, FloatScalar
from mfs_tpu_torch.utils.combinatorics import monomials
from mfs_tpu_torch.utils.profiling import count, span


def _check_even(num_moments: int) -> None:
    if num_moments % 2 != 0:
        warnings.warn(f"The number of moments {num_moments} should be even.")


def _batch_constant(x, like: Array) -> Array:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(like.shape[:-1])


@span("mfs.filter")
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
        with span("mfs.step"):
            count("filter.steps")
            weights, nodes = moment_quadrature(rms, **quad)
            with span("mfs.transition"):
                rms = torch.einsum("...nj,...n->...j", state_cond_raw_moments(nodes), weights)

            weights, nodes = moment_quadrature(rms, **quad)
            with span("mfs.update"):
                pdf_vals = measurement_cond_pdf(y[..., None], nodes)
                rms, pdf_y = posterior_moments_1d(nodes, weights, pdf_vals, "raw", num_moments)
                nell = nell - torch.log(pdf_y)
                rmss.append(rms)
    return torch.stack(rmss), nell


@span("mfs.filter")
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
        with span("mfs.step"):
            count("filter.steps")
            weights, nodes = moment_quadrature(cms, mean, **quad)
            with span("mfs.transition"):
                mean = torch.einsum("...n,...n->...", state_cond_mean(nodes), weights)
                cond_cms = state_cond_central_moments(nodes, mean[..., None])
                cms = torch.einsum("...nj,...n->...j", cond_cms, weights)

            weights, nodes = moment_quadrature(cms, mean, **quad)
            with span("mfs.update"):
                pdf_vals = measurement_cond_pdf(y[..., None], nodes)
                cms, mean, pdf_y = posterior_moments_1d(nodes, weights, pdf_vals, "central",
                                                        num_moments)
                nell = nell - torch.log(pdf_y)
                cmss.append(cms)
                means.append(mean)
    return torch.stack(cmss), torch.stack(means), nell


@span("mfs.filter")
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
        with span("mfs.step"):
            count("filter.steps")
            weights, nodes = moment_quadrature(scms, mean, scale, **quad)
            with span("mfs.transition"):
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
            with span("mfs.update"):
                pdf_vals = measurement_cond_pdf(y[..., None], nodes)
                scms, mean, scale, pdf_y = posterior_moments_1d(nodes, weights, pdf_vals,
                                                                "scaled", num_moments)
                nell = nell - torch.log(pdf_y)
                scmss.append(scms)
                means.append(mean)
                scales.append(scale)
    return torch.stack(scmss), torch.stack(means), torch.stack(scales), nell


@span("mfs.filter")
def moment_filter_taylor(
    state_cond_central_moments: Callable[[Array, Array], Array],
    state_cond_mean: Callable[[Array], Array],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    cms0: Array,
    mean0: FloatScalar,
    ys: Array,
    taylor_order: int = None,
) -> Tuple[Array, Array, Array]:
    r"""Quadrature-free moment filter: every expectation by the Taylor rule
    ``E[f(X)] ≈ Σ_r f^{(r)}(mean) cms[r] / r!`` (``taylor_quadrature``).

    Parameters mirror ``moment_filter_cms``; the model callables must be
    differentiable in the node argument and elementwise in it.  Batch-first:
    ``cms0 (..., 2N)``, ``ys (T, ...)``.  ``taylor_order`` defaults to
    ``2N - 1``.

    Returns ``cmss (T, ..., 2N)``, ``means (T, ...)``, ``nell (...)``.
    """
    num_moments = cms0.shape[-1]
    _check_even(num_moments)
    order = taylor_order if taylor_order is not None else num_moments - 1

    cms = cms0
    mean = _batch_constant(mean0, cms0)
    nell = torch.zeros(cms0.shape[:-1], dtype=cms0.dtype, device=cms0.device)
    cmss, means = [], []
    for y in ys:
        with span("mfs.step"):
            count("filter.steps")
            # Prediction: E[g(X)] by Taylor with the current central moments.
            with span("mfs.transition"):
                new_mean = taylor_quadrature(state_cond_mean, cms, mean, order)
                cms_p = taylor_quadrature(
                    lambda u: state_cond_central_moments(u, new_mean), cms, mean, order
                )
                mean = new_mean

            # Update: unnormalised posterior moments by Taylor.
            with span("mfs.update"):
                like = lambda u: measurement_cond_pdf(y, u)
                pdf_y = taylor_quadrature(like, cms_p, mean, order)
                mean_u = taylor_quadrature(lambda u: u * like(u), cms_p, mean, order) / pdf_y
                centred = lambda u: monomials(u - mean_u, num_moments) * like(u)[..., None]
                cms = taylor_quadrature(centred, cms_p, mean, order) / pdf_y[..., None]
                mean = mean_u
                nell = nell - torch.log(pdf_y)
                cmss.append(cms)
                means.append(mean)
    return torch.stack(cmss), torch.stack(means), nell
