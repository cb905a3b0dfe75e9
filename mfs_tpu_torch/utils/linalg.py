"""Dense linear-algebra helpers for the moment core (batched).

Port of ``mfs_tpu/utils/linalg.py::ldl`` and ``ldl_chol``: a static
column loop of full-width masked ops, so every routine batches over any
leading axes.
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
