"""Batched small symmetric eigendecomposition (port of ``mfs_tpu/ops/eigh.py``).

On the H100 f64 is native, so the JAX package's TPU work-arounds
(``eigh_refined``'s f32 seed + f64 polish) collapse to one
``torch.linalg.eigh`` call in f64.  ``eigh_batched`` (the in-repo
round-robin Jacobi solver) waits for ROADMAP E3.

Non-finite matrices (diverged trials) are replaced by the identity
before the call and their outputs set to NaN: LAPACK and cuSOLVER may
raise on them, while the JAX reference returns NaN and lets the rescue
tiers pick those trials up.
"""
from typing import Tuple

import torch

from mfs_tpu_torch.typings import Array


def _eigh_f64(a: Array) -> Tuple[Array, Array]:
    n = a.shape[-1]
    ok = torch.isfinite(a).all(dim=-1).all(dim=-1)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    vals, vecs = torch.linalg.eigh(torch.where(ok[..., None, None], a, eye))
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    return (
        torch.where(ok[..., None], vals, nan),
        torch.where(ok[..., None, None], vecs, nan),
    )


def eigh_xla(a: Array, sort: bool = False) -> Tuple[Array, Array]:
    """f64 ``torch.linalg.eigh`` with the ``(vals, vecs)`` return
    convention (columns are eigenvectors).  The values always come back
    ascending, so ``sort`` is accepted for signature parity only."""
    return _eigh_f64(a)


def eigh_refined(a: Array, sort: bool = False) -> Tuple[Array, Array]:
    """Same as ``eigh_xla``: with native f64 there is nothing to refine."""
    return _eigh_f64(a)


def eigh_batched(a: Array, sweeps: int = None, sort: bool = False) -> Tuple[Array, Array]:
    """The in-repo cyclic-Jacobi solver: not ported yet."""
    raise NotImplementedError(
        "eigh_impl='jacobi' (the round-robin Jacobi solver) is not ported "
        "yet: ROADMAP E3"
    )
