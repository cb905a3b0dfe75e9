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

Gradients: both routes run inside one ``torch.autograd.Function``
(``_FusedQuadrature``), whose forward runs under no grad and whose
backward is the transpose of the JAX package's implicit-function JVP
(``mfs_tpu/ops/pallas_quadrature.py::_implicit_tangent``).  That
derivative is exact at the primal: the rule solves the
moment-reproduction identity ``sum_k w_k lam_k^j = m_j`` (j < 2n), so
its Jacobian is the inverse of that identity's confluent Vandermonde
matrix.  The backward
is plain PyTorch: one batched f64 LU of the equilibrated (2n x 2n)
matrix, solved transposed.  Bisection has no useful autograd
derivative, so the plain route goes through the same Function.
"""
import ctypes
import functools

import torch

from mfs_tpu_torch.config import DTYPE
from mfs_tpu_torch.ops import build, flops
from mfs_tpu_torch.typings import Array
from mfs_tpu_torch.utils.profiling import span

MAX_N = 32

_BISECT_ITERS = 32
_NEWTON_ITERS = 8
_HANDOFF_MARGIN = 2.0**-17
_PIVOT_DIAG = 1e-8


def _prepare(ms: Array, mean, scale):
    if not torch.is_tensor(ms):
        raise TypeError("ms must be a tensor")
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

    Differentiable in ``ms`` and in ``mean``/``scale`` when they are
    tensors (a Python number gets no gradient); ``jitter`` is a constant.
    """
    if not torch.is_tensor(ms):
        raise TypeError("ms must be a tensor")
    as_t = lambda v: v if torch.is_tensor(v) else torch.as_tensor(v, dtype=DTYPE,
                                                                    device=ms.device)
    return _FusedQuadrature.apply(ms, as_t(mean), as_t(scale), float(jitter))


def _quadrature(ms: Array, mean: Array, scale: Array, jitter: float):
    """The forward routes: the plain version on a CPU tensor, the CUDA
    kernel on a CUDA tensor, and an error on any other device."""
    if ms.device.type == "cpu":
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
    with span("mfs.kernel.k1"), torch.cuda.device(ms.device):
        stream = torch.cuda.current_stream(ms.device).cuda_stream
        err = fn(ms2.data_ptr(), mean.data_ptr(), scale.data_ptr(), w.data_ptr(),
                 x.data_ptr(), n, B, float(jitter), stream)
    if err != 0:
        raise RuntimeError(f"quadrature_1d launch failed: CUDA error {err}")
    flops.kernel_launch("quadrature_1d", B, lambda: flops.k1_flops(n)[0])
    return w.T.reshape(batch_shape + (n,)), x.T.reshape(batch_shape + (n,))


class _FusedQuadrature(torch.autograd.Function):
    """Either forward route, with the implicit-function backward.

    The backward transposes ``_implicit_tangent``'s JVP.  In the frame
    ``t = lam / sigma``, ``lam = (x - mean) / scale``, the tangent solves
    ``A [dw; dt] = dms / sigma^j`` and maps ``dx = dscale lam + scale
    sigma dt + dmean``.  So for cotangents ``(gw, gx)``: ``gmean = sum_k
    gx_k``, ``gscale = sum_k gx_k lam_k``, and ``gms = z / sigma^j`` with
    ``A^T z = [gw; sigma scale gx]``.  ``A`` is rebuilt from the saved
    primal rather than kept.
    """

    @staticmethod
    def forward(ctx, ms, mean, scale, jitter):
        w, x = _quadrature(ms, mean, scale, jitter)
        ctx.save_for_backward(w, x, ms, mean, scale)
        return w, x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gw, gx):
        w, x, ms, mean, scale = ctx.saved_tensors
        batch_shape = ms.shape[:-1]
        mean_b = mean.to(DTYPE).expand(batch_shape)[..., None]
        scale_b = scale.to(DTYPE).expand(batch_shape)[..., None]
        lam = (x - mean_b) / scale_b
        need_ms, need_mean, need_scale, _ = ctx.needs_input_grad
        g_ms = _implicit_vjp(w, lam, ms, scale_b, gw, gx) if need_ms else None
        g_mean = gx.sum(-1).sum_to_size(mean.shape) if need_mean else None
        g_scale = (gx * lam).sum(-1).sum_to_size(scale.shape) if need_scale else None
        return g_ms, g_mean, g_scale, None


def _vdm_frame(w, lam, ms):
    """The moment-reproduction identity's confluent Vandermonde system in
    the frame ``t = lam / sigma`` (JAX: ``_vdm_frame``): returns ``A``
    (..., 2n, 2n), the Jacobian ``[P | w dP/dt]`` of ``sum_k w_k t_k^j``
    in ``[w, t]``, with ``sigma`` (..., 1) and the orders ``j``.

    The frame scale ``sigma = sqrt(m_2 / m_0)`` is a constant of the
    derivative (JAX: a stop-gradient), with the same ``tiny`` clamps.
    """
    two_n = ms.shape[-1]
    tiny = torch.finfo(DTYPE).tiny
    m0 = ms[..., 0].clamp_min(tiny)
    sigma = torch.sqrt((ms[..., 2] / m0).clamp_min(tiny))[..., None]
    t = lam / sigma
    powers = [torch.ones_like(t)]
    for _ in range(two_n - 1):
        powers.append(powers[-1] * t)
    P = torch.stack(powers, dim=-2)  # (..., 2n, n): t_k^j
    j = torch.arange(two_n, dtype=DTYPE, device=ms.device)
    dPdt = j[:, None] * torch.cat([torch.zeros_like(P[..., :1, :]), P[..., :-1, :]], dim=-2)
    return torch.cat([P, w[..., None, :] * dPdt], dim=-1), sigma, j


def _implicit_vjp(w, lam, ms, scale, gw, gx):
    """``gms`` of the implicit-function backward (``_FusedQuadrature``)."""
    A, sigma, j = _vdm_frame(w, lam, ms)
    z = _solve_transposed(A, torch.cat([gw, sigma * scale * gx], dim=-1))
    return z / sigma**j


def _solve_transposed(a: Array, b: Array) -> Array:
    """``z`` with ``a^T z = b`` per trial, by one f64 LU of ``a`` after
    max-abs row and column equilibration (``R a C``, as the JAX package's
    ``_solve_f32_refined`` scales it), solved transposed: ``z = R (R a
    C)^-T C b``.  A trial whose matrix is not finite or whose LU meets a
    zero pivot gets NaN; its matrix is replaced by the identity before
    the factorisation, so the batch does not raise."""
    tiny = torch.finfo(a.dtype).tiny
    row_s = 1.0 / a.abs().amax(-1).clamp_min(tiny)
    a1 = a * row_s[..., :, None]
    col_s = 1.0 / a1.abs().amax(-2).clamp_min(tiny)
    a2 = a1 * col_s[..., None, :]
    ok = torch.isfinite(a2).flatten(-2).all(-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    lu, piv, info = torch.linalg.lu_factor_ex(torch.where(ok[..., None, None], a2, eye))
    y = torch.linalg.lu_solve(lu, piv, (col_s * b)[..., None], adjoint=True)[..., 0]
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    return torch.where((ok & (info == 0))[..., None], row_s * y, nan)


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
