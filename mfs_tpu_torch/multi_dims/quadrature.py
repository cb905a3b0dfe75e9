"""Multidimensional moment-matched quadrature (port of ``mfs_tpu/multi_dims/quadrature.py``).

From the graded-lex moment vector: the Gram matrix G and the d
multiplication matrices H_i, orthonormalised against chol(G) into the
commuting operators K_i = R^{-1} H_i R^{-T}, and their eigenpairs.
Nodes are the Cartesian products of the per-dimension eigenvalues; the
weight of a node combination c = (c_1, ..., c_d) is

    w(c) = v_1(c_1)[0] * prod_i <v_i(c_i), v_{i+1}(c_{i+1})> * v_d(c_d)[0],

assembled from d-1 batched (s, s) Gram products of consecutive
eigenvector sets and static Cartesian-index gathers.

Routes, chosen by ``eigh_impl``:

- ``"fused"``, or its alias ``"pallas"`` (the JAX package's name),
  d <= 3: for s <= 10 the kernel K2 gives the eigenpairs directly; up to
  s = 119 the pair ``nd_ldl`` + ``nd_ksolve`` (``nd_k_fused``, the
  counterpart of the JAX package's K-builders, monolithic and staged)
  builds the K_i and ``torch.linalg.eigh`` decomposes them in f64
  (``mfs_tpu_torch.ops.quadrature_nd_kernel``; plain versions on CPU
  tensors);
- ``"refined"`` / ``"xla"``: f64 Cholesky (or ``ldl_chol`` with
  ``stable``), two triangular solves and ``torch.linalg.eigh``;
- ``"auto"``: ``"fused"`` for a CUDA tensor within the kernels' own
  limits, else ``"refined"`` (``mfs_tpu_torch.ops.dispatch``).  In 2D
  this sends N <= 14 (s <= 105) to the kernels.

Each K_i has structurally repeated eigenvalues (each coordinate value
appears for several basis polynomials).  Within an exactly degenerate
cluster any orthonormal basis gives the same chained-inner-product
quadrature, so the eigensolvers' different in-cluster rotations do not
change the rule.
"""
import itertools
from functools import lru_cache
from typing import Tuple, Union

import numpy as np
import torch

from mfs_tpu_torch.config import DTYPE
from mfs_tpu_torch.ops.eigh import eigh_batched, eigh_refined, eigh_xla
from mfs_tpu_torch.ops.dispatch import fused_nd_kernel, resolve_impl_nd
from mfs_tpu_torch.ops.quadrature_nd_kernel import (
    MAX_D_K,
    MAX_S_K,
    nd_eigh_fused,
    nd_k_fused,
)
from mfs_tpu_torch.typings import Array
from mfs_tpu_torch.utils.linalg import ldl_chol
from mfs_tpu_torch.utils.profiling import count, span

@lru_cache(maxsize=None)
def _cartesian_indices(d: int, n: int) -> np.ndarray:
    """All n^d index combinations, shape (n^d, d)."""
    return np.asarray(list(itertools.product(range(n), repeat=d)), dtype=np.int64)


@lru_cache(maxsize=None)
def _cartesian_on(d: int, n: int, device: torch.device) -> Array:
    return torch.as_tensor(_cartesian_indices(d, n), device=device)


def nd_cartesian_prod_indices(d: int, n: int) -> np.ndarray:
    """All n^d index combinations, shape (n^d, d)."""
    return _cartesian_indices(d, n).copy()


def nd_cartesian_prod(x: Array, inds: np.ndarray = None) -> Array:
    """All n^d combinations of d n-vectors (rows of ``x (d, n, ...)``);
    returns (n^d, ..., d)."""
    d, n = x.shape[:2]
    if inds is None:
        inds = _cartesian_indices(d, n)
    idx = torch.as_tensor(inds, device=x.device)
    return torch.stack([x[i, idx[:, i]] for i in range(d)], dim=-1)


def _cholesky_or_nan(G: Array) -> Array:
    # torch raises on a non-PD matrix; the JAX reference returns NaN.
    R, info = torch.linalg.cholesky_ex(G)
    return torch.where((info != 0)[..., None, None], float("nan"), R)


@span("mfs.quadrature")
def moment_quadrature_nd(
    ms: Array,
    inds: Union[Array, np.ndarray],
    mean: Array = None,
    scale: Array = None,
    sort_nodes: bool = False,
    stable: bool = False,
    eigh_impl: str = "refined",
) -> Tuple[Array, Array]:
    """Multidimensional Gauss quadrature from a graded-lex moment vector.

    Parameters
    ----------
    ms : Array (..., z)
        Moments in graded-lex order; raw, central or scaled depending on
        whether ``mean``/``scale`` are given.
    inds : (d + 1, s, s) index array from
        ``gram_and_hankel_indices_graded_lexico``.
    mean : Array (..., d), optional — recentre the nodes.
    scale : Array (..., d), optional — rescale the nodes.
    sort_nodes : sort each dimension's eigenvalues (the f64 routes
        always return them ascending).
    stable : LDL-based modified Cholesky on the f64 routes.
    eigh_impl : {"auto", "fused", "pallas", "refined", "xla", "jacobi"}

    Returns
    -------
    weights : Array (..., s^d), nodes : Array (..., s^d, d)
    """
    inds = np.asarray(torch.as_tensor(inds).cpu(), dtype=np.int64)
    d, s = inds.shape[0] - 1, inds.shape[1]
    trials = ms[..., 0].numel()
    eigh_impl = resolve_impl_nd(s, trials, eigh_impl, d, device=ms.device)
    route = fused_nd_kernel(s, d) if eigh_impl == "fused" else eigh_impl
    if route is None:
        raise ValueError(f"no fused ND quadrature for d = {d}, s = {s} (the kernels take "
                         f"d <= {MAX_D_K}, s <= {MAX_S_K}): use eigh_impl='refined'")
    count("quadrature.calls." + route)
    count("quadrature.trials." + route, trials)

    if route == "nd_eigh":
        vals, vecs = nd_eigh_fused(ms, inds)
        if sort_nodes:
            vals, order = torch.sort(vals, dim=-1)
            vecs = torch.gather(vecs, -1, order[..., None, :].expand(vecs.shape))
    elif route == "nd_k":
        vals, vecs = eigh_refined(nd_k_fused(ms, inds), sort=sort_nodes)
    else:
        idx = torch.as_tensor(inds, device=ms.device)
        G = ms[..., idx[0]]
        Hs = ms[..., idx[1:]]
        R = ldl_chol(G) if stable else _cholesky_or_nan(G)
        Rb = R[..., None, :, :]
        X = torch.linalg.solve_triangular(Rb, Hs, upper=False)
        Ks = torch.linalg.solve_triangular(Rb.mT, X, upper=True, left=False)
        Ks = 0.5 * (Ks + Ks.mT)
        if eigh_impl == "jacobi":
            vals, vecs = eigh_batched(Ks, sort=sort_nodes)
        elif eigh_impl == "xla":
            vals, vecs = eigh_xla(Ks, sort=sort_nodes)
        elif eigh_impl == "refined":
            vals, vecs = eigh_refined(Ks, sort=sort_nodes)
        else:
            raise ValueError(f"unknown eigh_impl {eigh_impl!r}")
    # vals: (..., d, s); vecs: (..., d, s, s), columns are eigenvectors.

    combs = _cartesian_on(d, s, ms.device)  # (s^d, d)
    nodes = torch.stack([vals[..., i, combs[:, i]] for i in range(d)], dim=-1)

    w = vecs[..., 0, 0, combs[:, 0]] * vecs[..., d - 1, 0, combs[:, d - 1]]
    for i in range(d - 1):
        gram = vecs[..., i, :, :].mT @ vecs[..., i + 1, :, :]
        w = w * gram[..., combs[:, i], combs[:, i + 1]]

    if mean is None:
        return w, nodes
    mean = torch.as_tensor(mean, dtype=DTYPE, device=ms.device)
    if scale is None:
        return w, nodes + mean[..., None, :]
    scale = torch.as_tensor(scale, dtype=DTYPE, device=ms.device)
    return w, nodes * scale[..., None, :] + mean[..., None, :]
