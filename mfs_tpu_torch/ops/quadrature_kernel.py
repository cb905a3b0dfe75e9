"""Fused 1D moment quadrature: the CUDA kernel K1 and its plain version.

``moment_quadrature_fused`` replaces the Pallas TPU kernel
``mfs_tpu/ops/pallas_quadrature.py::_quadrature_kernel`` (reached there
through ``moment_quadrature_pallas`` / ``moment_quadrature_fused``).  It
turns a batch of moment vectors into n-point Gauss rules in one pass:
van der Sluis equilibration, true-pivot LDL^T of the Hankel Gram with
1e-8*n completion, Golub-Welsch coefficients, Sturm bisection plus
clamped Newton for the nodes, Christoffel weights, affine node map.

- On a CUDA tensor it launches ``csrc/quadrature_1d.cu`` (f64, a team
  of 16 lanes per trial up to n = 16, a warp above, one eigenvalue a
  lane), built by ``nvcc`` at first use, or raises.
- On a CPU tensor it runs ``moment_quadrature_fused_plain``, the same
  six stages in PyTorch f64, vectorised over the batch.

What bounds the kernel on the H100: FP64 divisions and FMAs (32*n*n
divisions per trial in the Sturm counts alone), not bytes.

Mass convention: the weights carry the measure's mass, ``sum_k w_k = m_0``,
as the TPU kernel's do; the f64 ``moment_quadrature`` path returns the
normalised rule.  The filters pass normalised moment vectors (m_0 = 1),
where the two coincide.

Gradients are not ported: the JAX package differentiates this kernel
through an implicit-function JVP, which arrives with the estimation
slice (ROADMAP B3).  Inputs that require grad raise.
"""
import ctypes
import functools

import torch

from mfs_tpu_torch.config import DTYPE
from mfs_tpu_torch.ops import build
from mfs_tpu_torch.typings import Array

MAX_N = 32
# Launches of the CUDA kernel (not of its plain version) since import.
LAUNCHES = 0

_BISECT_ITERS = 32
_NEWTON_ITERS = 8
_HANDOFF_MARGIN = 2.0**-17
_PIVOT_DIAG = 1e-8


def _prepare(ms: Array, mean, scale):
    if not torch.is_tensor(ms):
        raise TypeError("ms must be a tensor")
    if any(torch.is_tensor(t) and t.requires_grad for t in (ms, mean, scale)):
        raise NotImplementedError(
            "gradients through the fused quadrature are not ported yet: "
            "the implicit-function JVP comes with the estimation slice "
            "(ROADMAP B3); use eigh_impl='xla' to differentiate"
        )
    if ms.dtype != DTYPE:
        raise TypeError(f"ms must be float64, got {ms.dtype}")
    two_n = ms.shape[-1]
    n = two_n // 2
    if two_n % 2 or not 2 <= n <= MAX_N:
        raise ValueError(f"the fused quadrature takes 2n moments with 2 <= n <= {MAX_N}, "
                         f"got {two_n}")
    batch_shape = ms.shape[:-1]
    B = ms[..., 0].numel()
    mean = torch.as_tensor(mean, dtype=DTYPE, device=ms.device).expand(batch_shape)
    scale = torch.as_tensor(scale, dtype=DTYPE, device=ms.device).expand(batch_shape)
    return n, batch_shape, B, mean.reshape(B), scale.reshape(B)


def moment_quadrature_fused(ms: Array, mean=0.0, scale=1.0, jitter: float = 0.0):
    """Fused quadrature of ``ms (..., 2n)``; returns ``(weights, nodes)``,
    each ``(..., n)``.  ``mean``/``scale`` broadcast to the batch shape.

    ``jitter`` adds ``jitter * I`` to the equilibrated (unit-diagonal)
    Gram before factorising: the rescue tier's relative Tikhonov
    regularisation.
    """
    global LAUNCHES
    if torch.is_tensor(ms) and ms.device.type == "cpu":
        return moment_quadrature_fused_plain(ms, mean, scale, jitter)
    n, batch_shape, B, mean, scale = _prepare(ms, mean, scale)
    if ms.device.type != "cuda":
        raise ValueError(f"no fused quadrature for device {ms.device}")
    ms2 = ms.reshape(B, 2 * n).T.contiguous()  # (2n, B): thread b reads column b
    mean = mean.contiguous()
    scale = scale.contiguous()
    w = torch.empty((n, B), dtype=DTYPE, device=ms.device)
    x = torch.empty((n, B), dtype=DTYPE, device=ms.device)
    fn = _kernel()
    with torch.cuda.device(ms.device):
        stream = torch.cuda.current_stream(ms.device).cuda_stream
        err = fn(ms2.data_ptr(), mean.data_ptr(), scale.data_ptr(), w.data_ptr(),
                 x.data_ptr(), n, B, float(jitter), stream)
    if err != 0:
        raise RuntimeError(f"quadrature_1d launch failed: CUDA error {err}")
    LAUNCHES += 1
    return w.T.reshape(batch_shape + (n,)), x.T.reshape(batch_shape + (n,))


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("quadrature_1d").mfs_quadrature_1d
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sturm_count(alphas, betas2, x, n):
    """Number of eigenvalues of the Jacobi matrix below ``x`` (f64)."""
    tiny = 1e-20
    q = alphas[0] - x
    q = torch.where(q.abs() < tiny, -tiny, q)
    cnt = (q < 0).to(torch.int32)
    for i in range(1, n):
        q = alphas[i] - x - betas2[i - 1] / q
        q = torch.where(q.abs() < tiny, -tiny, q)
        cnt = cnt + (q < 0).to(torch.int32)
    return cnt


def moment_quadrature_fused_plain(ms: Array, mean=0.0, scale=1.0, jitter: float = 0.0):
    """The kernel's six stages in plain PyTorch f64, on any device.

    Rows of ``(n, B)`` tensors play the TPU kernel's lane rows; Python
    loops over ``n`` replace its unrolled column program.  Used by the
    CPU path of ``moment_quadrature_fused`` and as the reference the
    CUDA kernel is held against.
    """
    n, batch_shape, B, mean, scale = _prepare(ms, mean, scale)
    ms2 = ms.reshape(B, 2 * n).T  # (2n, B)
    rows = torch.arange(n, device=ms.device)[:, None]

    # ---- van der Sluis equilibration ---------------------------------
    sq, cs = [], []
    for j in range(n):
        m2j = ms2[2 * j]
        m2j = torch.where(m2j <= 1e-30, 1e-30, m2j)
        sq.append(torch.sqrt(m2j))
        cs.append(1.0 / sq[-1])
    rs = [sq[i + 1] / sq[i] for i in range(n - 1)]
    cvec = torch.stack(cs)  # (n, B)

    # ---- LDL^T of the equilibrated Gram, true pivots -----------------
    pivot_diag = _PIVOT_DIAG * n
    lunits, ds, diag = [], [], []
    for j in range(n):
        acc = (cvec * ms2[j:j + n]) * cs[j]
        acc = torch.where(rows == j, acc + jitter, acc)
        for k in range(j):
            acc = acc - lunits[k] * (ds[k] * lunits[k][j])
        d = acc[j]
        bad = d <= 0.0
        signed_tiny = torch.where(d < 0.0, torch.full_like(d, -1e-35), torch.full_like(d, 1e-35))
        d = torch.where(d.abs() < 1e-35, signed_tiny, d)
        diag.append(torch.where(bad, pivot_diag, torch.sqrt(torch.where(bad, 1.0, d))))
        cu = torch.where(rows > j, acc / d, 0.0)
        lunits.append(torch.where(rows == j, 1.0, cu))
        ds.append(d)

    # ---- Golub-Welsch recurrence coefficients ------------------------
    sup = [rs[i] * lunits[i][i + 1] for i in range(n - 1)]
    alphas = [sup[0]] + [sup[i] - sup[i - 1] for i in range(1, n - 1)]
    betas = [rs[k - 1] * (diag[k] / diag[k - 1]) for k in range(1, n)]

    # alpha_{n-1} = u^T H u with R^T u = e_{n-1}, H[i, j] = m_{i+j+1}.
    v = [None] * n
    v[n - 1] = 1.0 / diag[n - 1]
    for i in range(n - 2, -1, -1):
        acc = torch.zeros_like(v[n - 1])
        for j in range(i + 1, n):
            acc = acc + lunits[i][j] * v[j]
        v[i] = -acc
    u = [cs[i] * v[i] for i in range(n)]
    alpha_last = torch.zeros_like(u[0])
    for i in range(n):
        for j in range(i, n):
            term = (u[i] * u[j]) * ms2[i + j + 1]
            if j > i:
                term = term * 2.0
            alpha_last = alpha_last + term
    alphas.append(alpha_last)
    betas2 = [bt * bt for bt in betas]

    # ---- eigenvalues: Gershgorin, Sturm bisection, clamped Newton ----
    babs = [torch.sqrt(b2.abs()) for b2 in betas2]
    glo = alphas[0] - babs[0]
    ghi = alphas[0] + babs[0]
    for i in range(1, n):
        left = babs[i - 1] + (babs[i] if i < n - 1 else 0.0)
        glo = torch.minimum(glo, alphas[i] - left)
        ghi = torch.maximum(ghi, alphas[i] + left)
    pad = 1e-3 * (ghi - glo) + 1e-20
    glo = glo - pad
    ghi = ghi + pad

    lo = glo.expand(n, B)
    hi = ghi.expand(n, B)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        take_hi = _sturm_count(alphas, betas2, mid, n) >= rows + 1
        lo = torch.where(take_hi, lo, mid)
        hi = torch.where(take_hi, mid, hi)
    margin = _HANDOFF_MARGIN * (ghi - glo)
    clamp_lo = lo - margin
    clamp_hi = hi + margin

    lam = 0.5 * (lo + hi)
    for _ in range(_NEWTON_ITERS):
        p_prev = torch.zeros_like(lam)
        p_cur = torch.ones_like(lam)
        d_prev = torch.zeros_like(lam)
        d_cur = torch.zeros_like(lam)
        for j in range(n):
            t = (lam - alphas[j]) * p_cur
            dt = (lam - alphas[j]) * d_cur + p_cur
            if j > 0:
                t = t - betas2[j - 1] * p_prev
                dt = dt - betas2[j - 1] * d_prev
            p_prev, p_cur = p_cur, t
            d_prev, d_cur = d_cur, dt
        denom = torch.where(d_cur.abs() < 1e-30, 1e-30, d_cur)
        lam = lam - p_cur / denom
        lam = torch.where(lam < clamp_lo, clamp_lo, lam)
        lam = torch.where(lam > clamp_hi, clamp_hi, lam)

    # ---- Christoffel weights -----------------------------------------
    r00 = diag[0] * sq[0]
    p_prev = torch.zeros_like(lam)
    p = (1.0 / r00).expand(n, B)
    s = p * p
    for j in range(n - 1):
        t = (lam - alphas[j]) * p
        if j > 0:
            t = t - betas[j - 1] * p_prev
        p_prev, p = p, t / betas[j]
        s = s + p * p
    w = 1.0 / s

    # ---- affine node map ---------------------------------------------
    nodes = lam * scale + mean
    return w.T.reshape(batch_shape + (n,)), nodes.T.reshape(batch_shape + (n,))
