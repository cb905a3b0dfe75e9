"""1D moment-matched Gauss quadrature (port of ``mfs_tpu/one_dim/quadrature.py``).

Given the first 2n moments, builds the n-point Gauss rule that matches
them.  Two routes, chosen by ``eigh_impl``:

- ``"fused"`` (the counterpart of the JAX package's ``"pallas"``): the
  hand-written CUDA kernel on a GPU tensor, its plain version on a CPU
  tensor (``mfs_tpu_torch.ops.quadrature_kernel``);
- ``"xla"`` / ``"refined"``: the f64 linear-algebra pipeline

      gather Hankel pair G, H  →  R = chol(G)  →  K = R^{-1} H R^{-T}
      →  eigh(K)  →  weights = (first eigenvector components)^2,
                     nodes   = scale * eigenvalues + mean.
"""
import functools
from typing import Tuple

import numpy as np
import torch

from mfs_tpu_torch.config import DTYPE, default_device
from mfs_tpu_torch.ops.eigh import eigh_batched, eigh_refined, eigh_xla
from mfs_tpu_torch.ops.quadrature_kernel import MAX_N, moment_quadrature_fused
from mfs_tpu_torch.typings import Array, FloatScalar
from mfs_tpu_torch.utils.linalg import ldl_chol


@functools.lru_cache(maxsize=None)
def _hankel_indices_np(n: int) -> Tuple[np.ndarray, np.ndarray]:
    base = np.arange(n)[:, None] + np.arange(n)[None, :]
    return base, base + 1


def hankel_indices(n: int, device=None) -> Tuple[Array, Array]:
    """Index matrices building the Hankel pair (G over orders 0..2n-2,
    H over orders 1..2n-1) from a flat moment vector."""
    device = default_device(device)
    g, h = _hankel_indices_np(n)
    return torch.as_tensor(g, device=device), torch.as_tensor(h, device=device)


def _cholesky_or_nan(G: Array) -> Array:
    # torch raises on a non-PD matrix; the JAX reference returns NaN and
    # lets the trial diverge (the rescue tiers pick it up).
    R, info = torch.linalg.cholesky_ex(G)
    return torch.where((info != 0)[..., None, None], float("nan"), R)


def resolve_impl_1d(ms: Array, requested: str) -> str:
    """``"auto"`` → ``"fused"`` for CUDA tensors with n <= 32, else
    ``"refined"``; any other name passes through."""
    if requested != "auto":
        return requested
    return "fused" if ms.is_cuda and ms.shape[-1] // 2 <= MAX_N else "refined"


def moment_quadrature(
    ms: Array,
    mean: FloatScalar = 0.0,
    scale: FloatScalar = 1.0,
    sort_nodes: bool = False,
    stable: bool = False,
    eigh_impl: str = "refined",
    quad_jitter: float = 0.0,
) -> Tuple[Array, Array]:
    """Moment-matched Gauss quadrature from a (batched) moment vector.

    Parameters
    ----------
    ms : Array (..., 2n)
        Moments ``[m_0, ..., m_{2n-1}]``: raw by default, central when
        ``mean`` is given, scaled central when ``scale`` is also given.
    mean, scale : scalar or Array (...)
        Affine map of the nodes.
    sort_nodes : bool
        Accepted for parity; ``torch.linalg.eigh`` returns ascending
        values, and the fused path (like the JAX kernel path) ignores it.
    stable : bool
        LDL-based modified Cholesky (PD completion) instead of Cholesky.
    eigh_impl : {"auto", "fused", "refined", "xla", "jacobi"}
    quad_jitter : float
        Gram regularisation of the fused path (ignored by the f64 paths,
        whose ``stable=True`` completion plays the same role).

    Returns
    -------
    weights : Array (..., n), nodes : Array (..., n)
    """
    eigh_impl = resolve_impl_1d(ms, eigh_impl)
    if eigh_impl == "fused":
        return moment_quadrature_fused(ms, mean, scale, jitter=quad_jitter)

    g_inds, h_inds = hankel_indices(ms.shape[-1] // 2, ms.device)
    G = ms[..., g_inds]
    H = ms[..., h_inds]

    R = ldl_chol(G) if stable else _cholesky_or_nan(G)
    X = torch.linalg.solve_triangular(R, H, upper=False)
    K = torch.linalg.solve_triangular(R.mT, X, upper=True, left=False)
    # K is symmetric (tridiagonal in exact arithmetic); symmetrise.
    K = 0.5 * (K + K.mT)

    if eigh_impl == "jacobi":
        vals, vecs = eigh_batched(K, sort=sort_nodes)
    elif eigh_impl == "xla":
        vals, vecs = eigh_xla(K, sort=sort_nodes)
    elif eigh_impl == "refined":
        vals, vecs = eigh_refined(K, sort=sort_nodes)
    else:
        raise ValueError(f"unknown eigh_impl {eigh_impl!r}")

    weights = vecs[..., 0, :] ** 2
    mean = torch.as_tensor(mean, dtype=DTYPE, device=ms.device)
    scale = torch.as_tensor(scale, dtype=DTYPE, device=ms.device)
    nodes = scale[..., None] * vals + mean[..., None]
    return weights, nodes
