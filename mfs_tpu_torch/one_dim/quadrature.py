"""1D moment-matched Gauss quadrature (port of ``mfs_tpu/one_dim/quadrature.py``).

Given the first 2n moments, builds the n-point Gauss rule that matches
them.  Two routes, chosen by ``eigh_impl``:

- ``"fused"``, or its alias ``"pallas"`` (the JAX package's name): the
  hand-written CUDA kernel on a GPU tensor, its plain version on a CPU
  tensor (``mfs_tpu_torch.ops.quadrature_kernel``);
- ``"xla"`` / ``"refined"``: the f64 linear-algebra pipeline

      gather Hankel pair G, H  →  R = chol(G)  →  K = R^{-1} H R^{-T}
      →  eigh(K)  →  weights = (first eigenvector components)^2,
                     nodes   = scale * eigenvalues + mean;

- ``"jacobi"``: the same pipeline with the in-repo cyclic Jacobi solver
  (``ops/eigh.py::eigh_batched``, plain torch).

Also the textbook Golub–Welsch rule and the Taylor-expansion rule of the
quadrature-free filter (``taylor_quadrature``), whose derivative towers
are nested forward-mode products (``torch.func``).
"""
import functools
import math
from typing import Any, Callable, Tuple

import numpy as np
import torch

from mfs_tpu_torch.config import DTYPE, default_device
from mfs_tpu_torch.ops.eigh import eigh_batched, eigh_refined, eigh_xla
from mfs_tpu_torch.ops.dispatch import resolve_impl_1d
from mfs_tpu_torch.ops.quadrature_kernel import moment_quadrature_fused
from mfs_tpu_torch.typings import Array, FloatScalar
from mfs_tpu_torch.utils.linalg import ldl_chol
from mfs_tpu_torch.utils.profiling import count, span


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


@span("mfs.quadrature")
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
    eigh_impl : {"auto", "fused", "pallas", "refined", "xla", "jacobi"}
        "auto" resolves by ``ops/dispatch.py::resolve_impl_1d``;
        "pallas" is "fused".
    quad_jitter : float
        Gram regularisation of the fused path (ignored by the f64 paths,
        whose ``stable=True`` completion plays the same role).

    Returns
    -------
    weights : Array (..., n), nodes : Array (..., n)
    """
    trials = ms[..., 0].numel()
    eigh_impl = resolve_impl_1d(ms.shape[-1] // 2, trials, eigh_impl, device=ms.device)
    count("quadrature.calls." + eigh_impl)
    count("quadrature.trials." + eigh_impl, trials)
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


def gauss_quadrature_golub_welsch(
    ms: Array,
    mean: FloatScalar = 0.0,
    scale: FloatScalar = 1.0,
    sort_nodes: bool = False,
) -> Tuple[Array, Array]:
    """Textbook Golub–Welsch: the tridiagonal Jacobi matrix from ratios of
    the Gram matrix's Cholesky factor, decomposed by ``eigh_batched``.
    Batched like ``moment_quadrature``; from ``2n`` moments it returns an
    ``(n - 1)``-point rule, as the JAX function does."""
    n = ms.shape[-1] // 2
    g_inds, _ = hankel_indices(n, ms.device)
    Rt = _cholesky_or_nan(ms[..., g_inds]).mT  # upper triangular

    diag = torch.diagonal(Rt, dim1=-2, dim2=-1)  # (..., n)
    sup = torch.diagonal(Rt, offset=1, dim1=-2, dim2=-1)  # (..., n-1)
    betas = diag[..., 1:-1] / diag[..., :-2]
    alpha0 = Rt[..., 0, 1] / Rt[..., 0, 0]
    alphas_rest = sup[..., 1:] / diag[..., 1:-1] - sup[..., :-1] / diag[..., :-2]
    alphas = torch.cat([alpha0[..., None], alphas_rest], dim=-1)
    K = torch.diag_embed(alphas) + torch.diag_embed(betas, 1) + torch.diag_embed(betas, -1)

    vals, vecs = eigh_batched(K, sort=sort_nodes)
    weights = vecs[..., 0, :] ** 2
    mean = torch.as_tensor(mean, dtype=DTYPE, device=ms.device)
    scale = torch.as_tensor(scale, dtype=DTYPE, device=ms.device)
    return weights, scale[..., None] * vals + mean[..., None]


def make_derivatives(f: Callable, order: int, argnum: int = 0):
    """``[f, f', ..., f^{(order)}]`` with respect to argument ``argnum``,
    by forward-mode Jacobians (``torch.func.jacfwd``), so vector-valued
    integrands work too.  For the batched tower of the filters see
    ``make_derivatives_elementwise``."""
    derivatives = [f]
    for _ in range(order):
        derivatives.append(
            (lambda g: lambda x, *args: torch.func.jacfwd(g, argnums=argnum)(x, *args))(
                derivatives[-1]
            )
        )
    return derivatives


def make_derivatives_elementwise(f: Callable, order: int):
    """Derivative tower ``[f, f', ..., f^{(order)}]`` of an *elementwise*
    f (possibly with extra trailing output axes): each derivative is a
    forward-mode product along ``ones_like(x)`` (``torch.func.jvp``),
    which for such an f IS the elementwise derivative.  No (B, B)
    Jacobian is formed, so the tower batches over leading axes."""
    derivatives = [f]
    for _ in range(order):
        derivatives.append(
            (
                lambda g: lambda x, *args: torch.func.jvp(
                    lambda u: g(u, *args), (x,), (torch.ones_like(x),)
                )[1]
            )(derivatives[-1])
        )
    return derivatives


def taylor_quadrature(
    f: Callable[..., FloatScalar],
    cms: Array,
    mean: FloatScalar,
    order: int,
    *operands: Any,
) -> Array:
    """E[f(X)] by Taylor expansion around the mean with central moments:
    ``f(m) + Σ_r f^{(r)}(m) cms[..., r] / r!``.  ``cms (..., 2N)`` and
    ``mean (...)`` may carry leading trial axes; ``f`` must be elementwise
    in its first argument, and extra trailing output axes broadcast."""
    # contiguous: forward-mode AD takes no primal whose entries share memory
    mean = torch.as_tensor(mean, dtype=DTYPE, device=cms.device).contiguous()
    derivatives = make_derivatives_elementwise(f, order)
    result = derivatives[0](mean, *operands)
    for r in range(1, order + 1):
        coeff = cms[..., r] / float(math.factorial(r))
        d_r = derivatives[r](mean, *operands)
        coeff = coeff.reshape(coeff.shape + (1,) * (d_r.ndim - coeff.ndim))
        result = result + d_r * coeff
    return result
