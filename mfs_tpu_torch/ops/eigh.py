"""Batched small symmetric eigendecomposition (port of ``mfs_tpu/ops/eigh.py``).

Two solvers:

- ``eigh_xla`` / ``eigh_refined``: f64 ``torch.linalg.eigh`` (LAPACK on
  the CPU, cuSOLVER on the card).  The JAX package's TPU work-arounds
  (``eigh_refined``'s f32 seed + f64 polish) collapse to this one call,
  since the H100 has native f64.
- ``eigh_batched``: the JAX package's parallel-ordered cyclic Jacobi
  solver in plain torch, with a fixed sweep count and the eigh
  derivative rule as a ``torch.autograd.Function``.

The f64 route returns NaN where the JAX reference does, instead of
raising for the whole batch:

- Matrices of diverged trials are replaced by the identity before the
  call and their outputs set to NaN.  A trial has diverged when its
  matrix has a non-finite entry or one larger than ``DIVERGED_ABS`` in
  magnitude: the eigenvalues are quadrature nodes, so such a trial has
  nodes ~1e100 from its frame's origin.  cuSOLVER's batched Jacobi (used
  at n <= 32) fails to converge on such matrices.
- The batch goes to ``torch.linalg.eigh`` in chunks of at most
  ``EIGH_CHUNK`` matrices: cuSOLVER's batched eigh rejects larger
  batches (see ``EIGH_CHUNK``).
- A chunk that raises ``torch.linalg.LinAlgError`` for a finite matrix
  that does not converge is split in halves until the failing matrices
  stand alone; those come back NaN, as LAPACK marks them in JAX, so the
  rescue tiers pick their trials up.  The counter ``eigh.nonconverged``
  (``utils/profiling.py``) counts them.  Any other error raises.

Each ``torch.linalg.eigh`` call is a span ``mfs.eigh`` and counts under
``eigh.calls``; on a CUDA tensor it also blocks the host until the
device has finished it (``sync.eigh``).
"""
from typing import List, Tuple

import torch

from mfs_tpu_torch.ops.quadrature_nd_kernel import round_robin_schedule
from mfs_tpu_torch.typings import Array
from mfs_tpu_torch.utils.profiling import count, span


DIVERGED_ABS = 1e100
# The most matrices one torch.linalg.eigh call takes.  On an H100 80GB
# HBM3 (700 W; torch 2.11, CUDA 12.8) cuSOLVER's batched f64 eigh takes
# 16,384 matrices a call and refuses 32,768 with
# CUSOLVER_STATUS_INVALID_VALUE from cusolverDnXsyevBatched_bufferSize,
# raised as LinAlgError (chip_smoke.py's eigh_batch_limit line).  Every
# batch the filters hand it (at most 2 x 4,096 in 1D, 2,048 at 2D order
# 11) fits in one call.
EIGH_CHUNK = 16_384


def _eigh_converged(a: Array) -> List[Tuple[Array, Array]]:
    """``torch.linalg.eigh`` of a (b, n, n) batch; where it reports that a
    matrix failed to converge, the batch is split in halves until each
    failing matrix stands alone, and that one comes back NaN.  Returns
    (vals, vecs) parts in batch order."""
    count("eigh.calls")
    if a.is_cuda:
        count("sync.eigh")
    try:
        with span("mfs.eigh"):
            return [torch.linalg.eigh(a)]
    except torch.linalg.LinAlgError as e:
        if "failed to converge" not in str(e):
            raise
        if a.shape[0] == 1:
            count("eigh.nonconverged")
            nan = torch.full_like(a, float("nan"))
            return [(nan[..., 0], nan)]
    half = a.shape[0] // 2
    return _eigh_converged(a[:half]) + _eigh_converged(a[half:])


def _eigh_f64(a: Array) -> Tuple[Array, Array]:
    n = a.shape[-1]
    ok = (torch.isfinite(a) & (a.abs() <= DIVERGED_ABS)).all(dim=-1).all(dim=-1)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    flat = torch.where(ok[..., None, None], a, eye).reshape(-1, n, n)
    parts = [p for chunk in flat.split(EIGH_CHUNK) for p in _eigh_converged(chunk)]
    if len(parts) == 1:
        vals, vecs = parts[0]
    else:
        vals, vecs = (torch.cat([p[i] for p in parts]) for i in (0, 1))
    vals = vals.reshape(a.shape[:-1])
    vecs = vecs.reshape(a.shape)
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


def eigh_refined(a: Array, polish_sweeps: int = 0, sort: bool = False) -> Tuple[Array, Array]:
    """Same as ``eigh_xla``: with native f64 there is nothing to refine,
    so ``polish_sweeps`` (the JAX package's f64 polish of an f32 seed) is
    accepted for signature parity and ignored."""
    return _eigh_f64(a)


# ---------------------------------------------------------------------------
# The cyclic Jacobi solver
# ---------------------------------------------------------------------------


def _default_sweeps(n: int) -> int:
    # Cyclic Jacobi converges quadratically; these are the JAX package's
    # conservative counts (validated to f64 precision for n <= 32).
    if n <= 4:
        return 6
    if n <= 12:
        return 8
    if n <= 24:
        return 10
    return 12


def _jacobi_eigh(a: Array, sweeps: int) -> Tuple[Array, Array]:
    """``sweeps`` sweeps of the round-robin schedule, each round one
    orthogonal Q of disjoint rotations applied as a = Qᵀ a Q, v = v Q."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    v = eye.expand(a.shape).clone()
    rounds = [(torch.as_tensor(ps, device=a.device), torch.as_tensor(qs, device=a.device))
              for ps, qs in round_robin_schedule(n)]
    for i in range(sweeps * len(rounds)):
        ps, qs = rounds[i % len(rounds)]
        if ps.numel() == 0:
            continue
        app, aqq, apq = a[..., ps, ps], a[..., qs, qs], a[..., ps, qs]
        # Golub–Van Loan 8.4.1 (smaller-angle root), the JAX package's
        # relative skip threshold: rotations below f64 epsilon are dropped.
        diag_scale = app.abs() + aqq.abs()
        small = apq.abs() <= 1e-18 * diag_scale
        safe_apq = torch.where(small, 1.0, apq)
        tau = (aqq - app) / (2.0 * safe_apq)
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(tau == 0.0, 1.0, t)
        t = torch.where(small, 0.0, t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        # Q = I + Σ [(c - 1)(E_pp + E_qq) + s (E_pq - E_qp)]
        q = eye.expand(a.shape).clone()
        cd = 1.0 + (c - 1.0)
        q[..., ps, ps] = cd
        q[..., qs, qs] = cd
        q[..., ps, qs] = s
        q[..., qs, ps] = -s
        a = q.mT @ (a @ q)
        a = 0.5 * (a + a.mT)  # re-symmetrise against rounding drift
        v = v @ q
    return torch.diagonal(a, dim1=-2, dim2=-1), v


def _safe_gap_reciprocal(vals: Array) -> Array:
    """Degeneracy-guarded ``F[i, j] = 1/(w_j - w_i)`` for the eigh
    derivative: gaps below ``1e-9 * spread`` (a degenerate cluster, where
    the downstream quadrature is invariant under in-cluster rotations)
    contribute zero, and the others are clamped away from zero."""
    n = vals.shape[-1]
    gaps = vals[..., None, :] - vals[..., :, None]  # gaps[i, j] = w_j - w_i
    off = ~torch.eye(n, dtype=torch.bool, device=vals.device)
    spread = (vals.amax(-1) - vals.amin(-1))[..., None, None] + torch.finfo(vals.dtype).tiny
    degenerate = gaps.abs() <= 1e-9 * spread
    keep = off & ~degenerate
    mag = torch.maximum(gaps.abs(), 1e-12 * spread)
    return torch.where(keep, torch.sign(gaps) / mag, 0.0)


class _JacobiEigh(torch.autograd.Function):
    """Cyclic Jacobi with the eigh derivative rule.  JAX's JVP is

        S = Vᵀ sym(dA) V,  dw = diag(S),  dV = V (F ∘ S);

    its transpose, for cotangents (gw, gV), is

        dA = sym(V M Vᵀ),  M = diag(gw) + F ∘ (Vᵀ gV)."""

    @staticmethod
    def forward(ctx, a, sweeps):
        vals, vecs = _jacobi_eigh(a, sweeps)
        ctx.save_for_backward(vals, vecs)
        return vals, vecs

    @staticmethod
    def backward(ctx, gvals, gvecs):
        vals, vecs = ctx.saved_tensors
        m = _safe_gap_reciprocal(vals) * (vecs.mT @ gvecs) if gvecs is not None \
            else torch.zeros_like(vecs)
        if gvals is not None:
            m = m + torch.diag_embed(gvals)
        ga = vecs @ m @ vecs.mT
        return 0.5 * (ga + ga.mT), None


def eigh_batched(a: Array, sweeps: int = None, sort: bool = False) -> Tuple[Array, Array]:
    """Eigendecomposition of a batch of small symmetric matrices by
    cyclic Jacobi.

    Parameters
    ----------
    a : Array (..., n, n)
        Symmetric matrices.
    sweeps : int, optional
        Number of sweeps (no stopping test); default ``_default_sweeps(n)``.
    sort : bool
        Sort eigenvalues (and eigenvectors) ascending.

    Returns
    -------
    vals : Array (..., n), vecs : Array (..., n, n)
        ``a ≈ vecs @ diag(vals) @ vecs.T`` (columns are eigenvectors).
    """
    if sweeps is None:
        sweeps = _default_sweeps(a.shape[-1])
    vals, vecs = _JacobiEigh.apply(a, sweeps)
    if sort:
        order = torch.argsort(vals, dim=-1)
        vals = torch.take_along_dim(vals, order, dim=-1)
        vecs = torch.take_along_dim(vecs, order[..., None, :], dim=-1)
    return vals, vecs
