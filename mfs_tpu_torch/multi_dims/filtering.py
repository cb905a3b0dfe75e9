"""Multidimensional moment filters: raw, central and scaled-central modes.

Port of ``mfs_tpu/multi_dims/filtering.py``.  Per time step: quadrature,
contract the conditional moments with the weights (or one fused
``predict_fn`` call), second quadrature, Bayes update of the graded-lex
moment vector, the per-dimension means (and scales), and the running
negative log likelihood.

Batch-first: carries may have leading trial axes (``cms0 (..., z)``,
``mean0 (..., d)``), ``ys`` is ``(T, ..., dy)``, and a Python loop over
time replaces ``lax.scan``.  With ``eigh_impl="auto"`` every quadrature
of a CUDA run goes through the fused kernels: one K2 launch for s <= 10,
one launch each of ``nd_ldl`` and ``nd_ksolve`` (then f64 ``eigh``) for
10 < s <= 119.
"""
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from mfs_tpu_torch.multi_dims.moments import weighted_monomials_nd
from mfs_tpu_torch.multi_dims.quadrature import moment_quadrature_nd
from mfs_tpu_torch.typings import Array
from mfs_tpu_torch.utils.profiling import count, span


def _prep(moments_partial_order, m0: Array):
    multi_indices, inds = moments_partial_order
    multi_indices = np.asarray(multi_indices, dtype=np.int64)
    if multi_indices.shape[0] != m0.shape[-1]:
        raise ValueError(
            f"multi_indices size {multi_indices.shape[0]} must match the "
            f"moment vector size {m0.shape[-1]}."
        )
    return multi_indices, np.asarray(torch.as_tensor(inds).cpu(), dtype=np.int64)


def _carry(x, like: Array, d: int) -> Array:
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x.expand(like.shape[:-1] + (d,))


def _contract(values: Array, weights: Array) -> Array:
    """Σ_m w_m values_m: values (..., m, k), weights (..., m) -> (..., k)."""
    return (weights[..., None, :] @ values)[..., 0, :]


@span("mfs.filter")
def moment_filter_nd_rms(
    state_cond_raw_moments: Callable[[Array], Array],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    ys: Array,
    moments_partial_order: Tuple[np.ndarray, np.ndarray],
    rms0: Array,
    stable: bool = False,
    eigh_impl: str = "auto",
) -> Tuple[Array, Array]:
    r"""N-D moment filter, raw-moment representation.

    ``state_cond_raw_moments`` maps nodes (..., m, d) to (..., m, z);
    ``measurement_cond_pdf(y, x)`` gives p(y | x) with x (..., m, d), y
    expanded with a node axis.  ``moments_partial_order`` is
    ``(multi_indices (z, d), inds (d + 1, s, s))``.

    Returns ``rmss (T, ..., z)`` and ``nell (...)``.
    """
    multi_indices, inds = _prep(moments_partial_order, rms0)
    quad = dict(stable=stable, eigh_impl=eigh_impl)
    rms = rms0
    nell = torch.zeros(rms0.shape[:-1], dtype=rms0.dtype, device=rms0.device)
    rmss = []
    for y in ys:
        with span("mfs.step"):
            count("filter.steps")
            weights, nodes = moment_quadrature_nd(rms, inds, **quad)
            with span("mfs.transition"):
                rms = _contract(state_cond_raw_moments(nodes), weights)

            weights, nodes = moment_quadrature_nd(rms, inds, **quad)
            with span("mfs.update"):
                wp = measurement_cond_pdf(y[..., None, :], nodes) * weights
                pdf_y = torch.sum(wp, dim=-1)
                rms = weighted_monomials_nd(wp, nodes, multi_indices) / pdf_y[..., None]
                nell = nell - torch.log(pdf_y)
                rmss.append(rms)
    return torch.stack(rmss), nell


@span("mfs.filter")
def moment_filter_nd_cms(
    state_cond_central_moments: Callable[[Array, Array], Array],
    state_cond_mean: Callable[[Array], Array],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    ys: Array,
    moments_partial_order: Tuple[np.ndarray, np.ndarray],
    cms0: Array,
    mean0: Array,
    stable: bool = False,
    eigh_impl: str = "auto",
    predict_fn: Optional[Callable] = None,
) -> Tuple[Array, Array, Array]:
    r"""N-D moment filter, central-moment representation; carries
    (cms (..., z), mean (..., d)).

    ``predict_fn(weights, nodes, mean) -> (pred_mean, pred_cms)``, when
    given, replaces the two per-node transition contractions with one
    fused call (``PolyTME.predict_cms``).

    Returns ``cmss (T, ..., z)``, ``means (T, ..., d)``, ``nell (...)``.
    """
    multi_indices, inds = _prep(moments_partial_order, cms0)
    d = multi_indices.shape[-1]
    unit = np.eye(d, dtype=np.int64)
    quad = dict(stable=stable, eigh_impl=eigh_impl)
    cms = cms0
    mean = _carry(mean0, cms0, d)
    nell = torch.zeros(cms0.shape[:-1], dtype=cms0.dtype, device=cms0.device)
    cmss, means = [], []
    for y in ys:
        with span("mfs.step"):
            count("filter.steps")
            weights, nodes = moment_quadrature_nd(cms, inds, mean, **quad)
            with span("mfs.transition"):
                if predict_fn is not None:
                    mean, cms = predict_fn(weights, nodes, mean)
                else:
                    mean = _contract(state_cond_mean(nodes), weights)
                    cms = _contract(state_cond_central_moments(nodes, mean), weights)

            weights, nodes = moment_quadrature_nd(cms, inds, mean, **quad)
            with span("mfs.update"):
                wp = measurement_cond_pdf(y[..., None, :], nodes) * weights
                pdf_y = torch.sum(wp, dim=-1)
                mean = weighted_monomials_nd(wp, nodes, unit) / pdf_y[..., None]
                centred = nodes - mean[..., None, :]
                cms = weighted_monomials_nd(wp, centred, multi_indices) / pdf_y[..., None]
                nell = nell - torch.log(pdf_y)
                cmss.append(cms)
                means.append(mean)
    return torch.stack(cmss), torch.stack(means), nell


@span("mfs.filter")
def moment_filter_nd_scms(
    state_cond_scms: Callable[[Array, Array, Array], Array],
    state_cond_mean_vars: Callable[[Array], Tuple[Array, Array]],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    ys: Array,
    moments_partial_order: Tuple[np.ndarray, np.ndarray],
    scms0: Array,
    mean0: Array,
    scale0: Array,
    stable: bool = False,
    eigh_impl: str = "auto",
    predict_fn: Optional[Callable] = None,
) -> Tuple[Array, Array, Array, Array]:
    r"""N-D moment filter, scaled-central representation; carries
    (scms (..., z), mean (..., d), scale (..., d)).  The predicted scale
    is the full standard deviation by the law of total variance, as in
    the JAX package.

    ``predict_fn(weights, nodes, mean, scale) -> (pred_mean, pred_scale,
    pred_scms)``, when given, replaces the per-node transition
    contractions (``PolyTME.predict_scms``).

    Returns ``scmss (T, ..., z)``, ``means``, ``scales (T, ..., d)``,
    ``nell (...)``.
    """
    multi_indices, inds = _prep(moments_partial_order, scms0)
    d = multi_indices.shape[-1]
    unit = np.eye(d, dtype=np.int64)
    quad = dict(stable=stable, eigh_impl=eigh_impl)
    scms = scms0
    mean = _carry(mean0, scms0, d)
    scale = _carry(scale0, scms0, d)
    nell = torch.zeros(scms0.shape[:-1], dtype=scms0.dtype, device=scms0.device)
    scmss, means, scales = [], [], []
    for y in ys:
        with span("mfs.step"):
            count("filter.steps")
            weights, nodes = moment_quadrature_nd(scms, inds, mean, scale, **quad)
            with span("mfs.transition"):
                if predict_fn is not None:
                    mean, scale, scms = predict_fn(weights, nodes, mean, scale)
                else:
                    cond_means, cond_vars = state_cond_mean_vars(nodes)
                    mean = _contract(cond_means, weights)
                    second = _contract(cond_vars + cond_means**2, weights)
                    scale = torch.sqrt(second - mean**2)
                    scms = _contract(state_cond_scms(nodes, mean, scale), weights)

            weights, nodes = moment_quadrature_nd(scms, inds, mean, scale, **quad)
            with span("mfs.update"):
                wp = measurement_cond_pdf(y[..., None, :], nodes) * weights
                pdf_y = torch.sum(wp, dim=-1)
                mean = weighted_monomials_nd(wp, nodes, unit) / pdf_y[..., None]
                centred = nodes - mean[..., None, :]
                scale = torch.sqrt(weighted_monomials_nd(wp, centred, 2 * unit)
                                   / pdf_y[..., None])
                scms = weighted_monomials_nd(wp, centred / scale[..., None, :],
                                             multi_indices) / pdf_y[..., None]
                nell = nell - torch.log(pdf_y)
                scmss.append(scms)
                means.append(mean)
                scales.append(scale)
    return torch.stack(scmss), torch.stack(means), torch.stack(scales), nell
