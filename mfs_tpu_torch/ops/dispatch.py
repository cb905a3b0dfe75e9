"""Which quadrature route ``eigh_impl="auto"`` takes (port of ``mfs_tpu/ops/dispatch.py``).

The JAX package routes by thresholds measured on a TPU (lane-block
padding, VMEM budgets, the Mosaic compiler's statement-count limit).
None of them is carried over.  Here "auto" takes the hand-written CUDA
kernels wherever they take the problem, by their own limits, and the f64
library route ("refined") everywhere else:

- 1D: n <= ``quadrature_kernel.MAX_N`` (32) -> "fused" (K1);
- ND, d <= 3: s <= 10 -> K2, s <= ``MAX_S_K`` (119) -> ``nd_ldl`` +
  ``nd_ksolve``, followed by f64 ``torch.linalg.eigh``.  The pair also
  takes s <= 28, where the TPU's K3 computes the same K_m in one program:
  on an H100 a one-program port of K3 was slower than the pair at 2D
  order 7 (PERF.md §6), so the port keeps no kernel of its own for K3.

The kernels run on CUDA tensors only, so a tensor on another device goes
to "refined".  The JAX package's name for the kernel route, "pallas", is
an alias of "fused" here.  ``batch`` keeps the JAX package's signature; no batch
threshold has been measured on the H100, so no route reads it.
"""
from typing import Optional

import torch

from mfs_tpu_torch.ops import quadrature_kernel as qk
from mfs_tpu_torch.ops import quadrature_nd_kernel as qnd


_ALIASES = {"pallas": "fused"}


def _on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def resolve_impl_1d(n: int, batch: int, requested: str = "auto", *, device) -> str:
    """``eigh_impl`` for the 1D quadrature of order ``n`` over ``batch``
    trials on ``device``: "pallas" becomes "fused", and any other name but
    "auto" passes through."""
    if requested != "auto":
        return _ALIASES.get(requested, requested)
    return "fused" if _on_cuda(device) and n <= qk.MAX_N else "refined"


def fused_nd_kernel(s: int, d: int) -> Optional[str]:
    """The kernel route "fused" takes at basis size ``s`` in ``d``
    dimensions: "nd_eigh" (K2), "nd_k" (``nd_ldl`` + ``nd_ksolve``), or
    None beyond every kernel's limits."""
    if d > qnd.MAX_D_K:
        return None
    if s <= qnd.MAX_S_EIGH and d <= qnd.MAX_D_EIGH:
        return "nd_eigh"
    if s <= qnd.MAX_S_K:
        return "nd_k"
    return None


def resolve_impl_nd(s: int, batch: int, requested: str = "auto", d: int = 2, *,
                    device) -> str:
    """``eigh_impl`` for the ND quadrature with basis size ``s`` in ``d``
    dimensions over ``batch`` trials on ``device``: "pallas" becomes
    "fused", and any other name but "auto" passes through."""
    if requested != "auto":
        return _ALIASES.get(requested, requested)
    return "fused" if _on_cuda(device) and fused_nd_kernel(s, d) else "refined"
