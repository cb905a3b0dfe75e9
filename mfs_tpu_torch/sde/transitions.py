"""Conditional transition-moment factories for scalar-state SDEs.

Port of ``mfs_tpu/sde/transitions.py``.  Every returned function is
elementwise in the node tensor and broadcasts over batch axes:

- ``rms(nodes)``                  -> (..., 2N)
- ``cms(nodes, mean)``            -> (..., 2N)  (mean broadcasts)
- ``scms(nodes, mean, scale)``    -> (..., 2N)
- ``mean(nodes)``                 -> (...,)
- ``mean_var(nodes)``             -> ((...,), (...,))
"""
from typing import Callable, NamedTuple, Tuple

import torch

from mfs_tpu_torch.sde import tme
from mfs_tpu_torch.typings import Array, FloatScalar
from mfs_tpu_torch.utils.combinatorics import monomials
from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all
from mfs_tpu_torch.utils.profiling import span


class TransitionMoments1D(NamedTuple):
    """Bundle of conditional-moment callables for one SDE + step size."""

    rms: Callable[[Array], Array]
    cms: Callable[[Array, Array], Array]
    scms: Callable[[Array, Array, Array], Array]
    mean: Callable[[Array], Array]
    mean_var: Callable[[Array], Tuple[Array, Array]]


@span("mfs.build.transition")
def sde_cond_moments_tme(
    drift: Callable, dispersion: Callable, dt: FloatScalar, tme_order: int, N: int
) -> TransitionMoments1D:
    """Exact-in-expansion TME conditional moments (no Normal closure):
    one vector-valued expansion covers all 2N orders."""
    num_moments = 2 * N

    def rms(nodes: Array) -> Array:
        phi = lambda u: monomials(u, num_moments)
        return tme.expectation_1d(phi, nodes, dt, drift, dispersion, tme_order)

    def cms(nodes: Array, mean: Array) -> Array:
        phi = lambda u: monomials(u - mean, num_moments)
        return tme.expectation_1d(phi, nodes, dt, drift, dispersion, tme_order)

    def scms(nodes: Array, mean: Array, scale: Array) -> Array:
        phi = lambda u: monomials((u - mean) / scale, num_moments)
        return tme.expectation_1d(phi, nodes, dt, drift, dispersion, tme_order)

    def mean_fn(nodes: Array) -> Array:
        return tme.expectation_1d(lambda u: u, nodes, dt, drift, dispersion, tme_order)

    def mean_var(nodes: Array) -> Tuple[Array, Array]:
        return tme.mean_and_var_1d(nodes, dt, drift, dispersion, tme_order)

    return TransitionMoments1D(rms, cms, scms, mean_fn, mean_var)


@span("mfs.build.transition")
def sde_cond_moments_tme_normal(
    drift: Callable, dispersion: Callable, dt: FloatScalar, tme_order: int, N: int
) -> TransitionMoments1D:
    """TME mean/variance + Normal-closure higher moments (a valid,
    PD-Hankel moment vector: the Beneš benchmark's transition)."""

    def _m_v(nodes):
        return tme.mean_and_var_1d(nodes, dt, drift, dispersion, tme_order)

    return _normal_closure_factory(_m_v, 2 * N)


@span("mfs.build.transition")
def sde_cond_moments_euler(
    drift: Callable, dispersion: Callable, dt: FloatScalar, N: int
) -> TransitionMoments1D:
    """Euler–Maruyama mean/variance + Normal-closure higher moments."""

    def _m_v(nodes):
        b = dispersion(nodes)
        return nodes + drift(nodes) * dt, b * b * dt

    return _normal_closure_factory(_m_v, 2 * N)


def _normal_closure_factory(
    cond_mean_var: Callable[[Array], Tuple[Array, Array]], num_moments: int
) -> TransitionMoments1D:
    """All five callables from an elementwise mean/variance map, closing
    the transition with a Normal distribution."""

    def rms(nodes: Array) -> Array:
        m, v = cond_mean_var(nodes)
        return normal_raw_moments_all(m, v, num_moments)

    def cms(nodes: Array, mean: Array) -> Array:
        m, v = cond_mean_var(nodes)
        return normal_raw_moments_all(m - mean, v, num_moments)

    def scms(nodes: Array, mean: Array, scale: Array) -> Array:
        m, v = cond_mean_var(nodes)
        out = normal_raw_moments_all(m - mean, v, num_moments)
        return out / monomials(torch.as_tensor(scale, dtype=out.dtype, device=out.device),
                               num_moments)

    def mean_fn(nodes: Array) -> Array:
        return cond_mean_var(nodes)[0]

    return TransitionMoments1D(rms, cms, scms, mean_fn, cond_mean_var)
