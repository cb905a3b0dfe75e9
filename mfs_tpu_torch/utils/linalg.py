"""Dense linear-algebra helpers for the moment core (batched).

Port of ``mfs_tpu/utils/linalg.py``.  ``ldl`` and ``ldl_chol`` run a
static column loop of full-width masked ops, so they batch over any
leading axes; ``lanczos`` and ``lanczos_ritz`` take one matrix, as
JAX's do.
"""
from typing import Tuple

import torch

from mfs_tpu_torch.typings import Array


def ldl(mat: Array) -> Tuple[Array, Array]:
    """Batched LDL^T of symmetric ``mat (..., n, n)``: ``L (..., n, n)``
    unit lower triangular and ``d (..., n)``, with the true pivots."""
    n = mat.shape[-1]
    L = torch.zeros_like(mat) + torch.eye(n, dtype=mat.dtype, device=mat.device)
    d = torch.zeros(mat.shape[:-1], dtype=mat.dtype, device=mat.device)
    idx = torch.arange(n, device=mat.device)
    for j in range(n):
        v = torch.where(idx < j, L[..., j, :] * d, 0.0)  # (..., n)
        dj = mat[..., j, j] - torch.sum(L[..., j, :] * v, dim=-1)
        d[..., j] = dj
        col = (mat[..., :, j] - torch.einsum("...ik,...k->...i", L, v)) / dj[..., None]
        L[..., :, j] = torch.where(idx > j, col, L[..., :, j])
    return L, d


def ldl_chol(mat: Array, eps: float = None) -> Array:
    """Modified-Cholesky PD completion via LDL (batched): negative
    pivots become ``eps`` (default ``1e-8 * ||mat||_F``) on the factor's
    diagonal — the ``stable=True`` path of the moment filters."""
    if eps is None:
        eps_val = 1e-8 * torch.linalg.matrix_norm(mat, "fro")[..., None]
    else:
        eps_val = eps
    L, d = ldl(mat)
    scale = torch.where(d < 0, eps_val, torch.sqrt(torch.clamp(d, min=0.0)))
    return L * scale[..., None, :]


def lanczos(a: Array, v0: Array, m: int) -> Tuple[Array, Array, Array]:
    """Lanczos tridiagonalisation ``a ~ V T V^T`` (JAX:
    ``mfs_tpu/utils/linalg.py::lanczos``), no re-orthogonalisation.

    Parameters
    ----------
    a : Array (n, n) symmetric.
    v0 : Array (n,) with unit norm.
    m : int, number of iterations (1 <= m <= n).

    Returns
    -------
    V : Array (n, m), alphas : Array (m,), betas : Array (m - 1,)
    """
    av = a @ v0
    alpha = torch.dot(av, v0)
    vs, alphas, betas = [v0], [alpha], []
    v_prev, w = v0, av - alpha * v0
    for _ in range(m - 1):
        beta = torch.sqrt(torch.sum(w**2))
        v = w / beta
        av = a @ v
        alpha = torch.dot(av, v)
        w = av - alpha * v - beta * v_prev
        v_prev = v
        vs.append(v)
        alphas.append(alpha)
        betas.append(beta)
    return (torch.stack(vs, dim=1), torch.stack(alphas),
            torch.stack(betas) if betas else a.new_zeros(0))


def lanczos_ritz(a: Array, v0: Array, m: int,
                 sort_eigenvalues: bool = True) -> Tuple[Array, Array]:
    """Ritz pairs from m Lanczos iterations started at ``v0 / |v0|``:
    ``(ritz_vectors (n, m), ritz_values (m,))``, with the JAX package's
    vector formula ``V U diag(U[0] |v0|)``.  ``torch.linalg.eigh`` is
    always ascending, so ``sort_eigenvalues=False`` returns the same
    order (JAX leaves it to the backend)."""
    norm = torch.linalg.vector_norm(v0)
    V, alphas, betas = lanczos(a, v0 / norm, m)
    T = torch.diag(alphas) + torch.diag(betas, -1) + torch.diag(betas, 1)
    vals, vecs = torch.linalg.eigh(T)
    ritz_vectors = torch.einsum("ik,kj,j->ij", V, vecs, vecs[0, :] * norm)
    return ritz_vectors, vals
