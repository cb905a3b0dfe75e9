"""ND moment-quadrature kernels and their plain versions.

Counterpart of ``mfs_tpu/ops/pallas_quadrature_nd.py``.  Every kernel
starts from a graded-lex moment vector ``ms (..., z)`` and the index
tables ``inds (d + 1, s, s)`` of
``gram_and_hankel_indices_graded_lexico``:

- the equilibrated Gram G'_ij = c_i G_ij c_j, c_j = 1/sqrt(G_jj)
  (G_jj <= 1e-30 -> 1), factorised LDL^T with true pivots: a pivot
  <= 0 gets the completion diagonal 1e-8*s, and a pivot below 1e-35 in
  magnitude is replaced by a signed 1e-35 before dividing;
- the d multiplication operators K_m = R^{-1} H'_m R^{-T},
  R = Lu diag(scale), by two triangular solves, symmetrised.

``nd_k_fused`` returns the K_m for s <= ``MAX_S_K``; the caller
eigendecomposes them.  It runs two launches: ``nd_ldl_fused`` (replaces
``_nd_ldl_kernel``, ``_nd_cvec_kernel`` and ``_nd_ldl_panel_kernel``)
factorises G' once per trial, and ``nd_ksolve_fused`` (replaces
``_nd_fsolve_kernel`` and ``_nd_tsolve_kernel``) runs the two unit
solves and the scaling per (trial, dimension).  Together they replace
``_nd_k_kernel`` (K3) as well, which computes the same K_m for s <= 28
in one program; the TPU's five staged programs exist only to stay under
its compiler's statement-count limit.
``nd_eigh_fused`` (K2, replaces ``_nd_kernel``) continues with cyclic
Jacobi in f64, in the round-robin order of
``mfs_tpu/ops/eigh.py::_round_robin_schedule``, until the off-diagonal
mass falls below ``(1e-14)^2`` of the total (capped at ``MAX_SWEEPS``).  The TPU kernel's f32 sweeps and Newton–Schulz
re-orthonormalisation exist only because the TPU has no f64 ALU; they
are not ported.  K2 keeps its JAX body's order of the solves (the
division by ``scale[r]`` inside each recursion), ``nd_ksolve`` K3's (two
unit solves, then the ``1/scale`` scaling).

- On a CUDA tensor each wrapper launches its kernel in
  ``csrc/quadrature_nd.cu`` (built by ``nvcc`` at first use) or raises.
- On a CPU tensor it runs the plain PyTorch version below, the same
  arithmetic in the same order, vectorised over the batch.

A trial whose moments are not finite comes out NaN.  Gradients are not
defined (the JAX kernels define none); inputs that require grad raise.
"""
import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from mfs_tpu_torch.config import DTYPE
from mfs_tpu_torch.ops import build, flops
from mfs_tpu_torch.typings import Array
from mfs_tpu_torch.utils.profiling import span

MAX_S_EIGH = 10  # K2: one warp per (trial, dimension), matrices in shared memory
MAX_D_EIGH = 3
# nd_ksolve holds Lu and one W, s padded to 120, in one CTA's shared
# memory: s = 119 takes 232,320 of the 232,448 bytes Hopper allows.
MAX_S_K = 119
MAX_D_K = 3
MAX_SWEEPS = 20
JACOBI_TOL = 1e-14
_PIVOT_DIAG = 1e-8


@functools.lru_cache(maxsize=None)
def round_robin_schedule(n: int) -> Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]:
    """Tournament schedule of the cyclic Jacobi sweep: n-1 rounds (n even)
    of disjoint (p, q) pairs, p < q, by the circle method; for odd n one
    virtual index sits out each round.  A copy of
    ``mfs_tpu/ops/eigh.py::_round_robin_schedule``; the CUDA kernel
    builds the same schedule."""
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        ps, qs = [], []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                ps.append(min(a, b))
                qs.append(max(a, b))
        rounds.append((tuple(ps), tuple(qs)))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


def _prepare(ms: Array, inds, max_s: int, max_d: int):
    if not torch.is_tensor(ms):
        raise TypeError("ms must be a tensor")
    if ms.requires_grad:
        raise NotImplementedError(
            "the fused ND quadrature kernels have no gradient (neither do the "
            "JAX kernels); use eigh_impl='refined' to differentiate"
        )
    if ms.dtype != DTYPE:
        raise TypeError(f"ms must be float64, got {ms.dtype}")
    inds = np.asarray(torch.as_tensor(inds).cpu(), dtype=np.int64)
    if inds.ndim != 3 or inds.shape[1] != inds.shape[2]:
        raise ValueError(f"inds must be (d + 1, s, s), got {inds.shape}")
    d, s = inds.shape[0] - 1, inds.shape[1]
    z = ms.shape[-1]
    if not (1 <= d <= max_d and 1 <= s <= max_s):
        raise ValueError(f"this kernel takes d <= {max_d} and s <= {max_s}, got d={d}, s={s}")
    if inds.min() < 0 or inds.max() >= z:
        raise ValueError(f"inds reach moment {inds.max()} of a {z}-vector")
    batch_shape = ms.shape[:-1]
    B = int(np.prod(batch_shape)) if batch_shape else 1
    return inds, d, s, z, batch_shape, B


@functools.lru_cache(maxsize=None)
def _inds_on(key: bytes, shape: Tuple[int, ...], device: torch.device) -> Array:
    arr = np.frombuffer(key, dtype=np.int64).reshape(shape).astype(np.int32)
    return torch.as_tensor(arr, device=device)


def _device_inds(inds: np.ndarray, device) -> Array:
    return _inds_on(inds.tobytes(), inds.shape, torch.device(device))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("quadrature_nd")
    eigh = lib.mfs_nd_eigh
    eigh.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    eigh.restype = ctypes.c_int
    ldl = lib.mfs_nd_ldl
    ldl.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    ldl.restype = ctypes.c_int
    ksolve = lib.mfs_nd_ksolve
    ksolve.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    ksolve.restype = ctypes.c_int
    layout = lib.mfs_nd_ksolve_layout
    layout.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    layout.restype = ctypes.c_int
    return eigh, ldl, ksolve, layout


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, fn, device, *args) -> None:
    with span("mfs.kernel." + name), torch.cuda.device(device):
        err = fn(*args, _stream(device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# The K-builder: plain-version helpers
# ---------------------------------------------------------------------------


def _equilibration(ms2: Array, inds: np.ndarray) -> Array:
    """c (B, s): c_j = 1/sqrt(G_jj), G_jj <= 1e-30 -> 1."""
    diag = np.diagonal(inds[0]).copy()
    gjj = ms2[:, torch.as_tensor(diag, device=ms2.device)]
    return 1.0 / torch.sqrt(torch.where(gjj <= 1e-30, 1.0, gjj))


def _scaled(c: Array, X: Array) -> Array:
    """(c_i X_ij) c_j for X (B, s, s) or (B, d, s, s), c (B, s)."""
    c = c.reshape(c.shape[:1] + (1,) * (X.ndim - 3) + c.shape[1:])
    return (c[..., :, None] * X) * c[..., None, :]


def _equilibrated(ms2: Array, inds: np.ndarray):
    """c (B, s) and the equilibrated G' (B, s, s), H' (B, d, s, s)."""
    idx = torch.as_tensor(inds, device=ms2.device)
    c = _equilibration(ms2, inds)
    return c, _scaled(c, ms2[:, idx[0]]), _scaled(c, ms2[:, idx[1:]])


def _ldl_plain(Gp: Array):
    """Right-looking LDL^T of G' (B, s, s), true pivots: unit-lower
    ``Lu``, guarded pivots and R's diagonal ``scale``.  Each entry gets
    its updates in the order k = 0, 1, ..., as in the kernels'
    left-looking loops."""
    s = Gp.shape[-1]
    A = Gp.clone()
    Lu = torch.zeros_like(Gp)
    piv = torch.empty(Gp.shape[:-1], dtype=Gp.dtype, device=Gp.device)
    scale = torch.empty_like(piv)
    for j in range(s):
        dj = A[:, j, j]
        bad = dj <= 0.0
        dj = torch.where(dj.abs() < 1e-35, torch.where(dj < 0.0, -1e-35, 1e-35), dj)
        scale[:, j] = torch.where(bad, _PIVOT_DIAG * s, torch.sqrt(torch.where(bad, 1.0, dj)))
        piv[:, j] = dj
        Lu[:, j, j] = 1.0
        Lu[:, j + 1:, j] = A[:, j + 1:, j] / dj[:, None]
        # A_ik -= L_ij (d_j L_kj) for the columns still to come
        A[:, j + 1:, j + 1:] -= Lu[:, j + 1:, j, None] * (dj[:, None, None] * Lu[:, None, j + 1:, j])
    return Lu, piv, scale


def _unit_forward(Lu: Array, rhs: Array) -> Array:
    """Lu^{-1} rhs column by column (axpy order, as the kernels do):
    Lu (B, s, s), rhs (B, d, s, s)."""
    v = rhs.clone()
    for k in range(v.shape[-2] - 1):
        v[..., k + 1:, :] -= Lu[:, None, k + 1:, k, None] * v[..., k, None, :]
    return v


def nd_k_fused_plain(ms: Array, inds) -> Array:
    """``nd_k_fused``'s arithmetic in plain PyTorch f64 on any device: the
    plain versions of ``nd_ldl`` and ``nd_ksolve`` chained."""
    Lu, _, c, isc = nd_ldl_plain(ms, inds)
    return nd_ksolve_plain(ms, inds, Lu, c, isc)


# ---------------------------------------------------------------------------
# The K-builder's kernels: nd_ldl and nd_ksolve
# ---------------------------------------------------------------------------


def nd_ldl_fused(ms: Array, inds) -> Tuple[Array, Array, Array, Array]:
    """The equilibrated true-pivot LDL^T of each trial's Gram:
    ``(Lu (..., s, s), piv, c, inv_scale (..., s))``: unit-lower factor,
    guarded pivots, equilibration vector and 1/scale of R = Lu diag(scale).
    ``nd_ldl_kernel`` on a CUDA tensor, its plain version on a CPU tensor."""
    if torch.is_tensor(ms) and ms.device.type == "cpu":
        return nd_ldl_plain(ms, inds)
    inds, d, s, z, batch_shape, B = _prepare(ms, inds, MAX_S_K, MAX_D_K)
    if ms.device.type != "cuda":
        raise ValueError(f"no fused ND quadrature for device {ms.device}")
    ms2 = ms.reshape(B, z).contiguous()
    Lu = torch.empty((B, s, s), dtype=DTYPE, device=ms.device)
    piv, c, isc = torch.empty((3, B, s), dtype=DTYPE, device=ms.device)
    _launch("nd_ldl", _lib()[1], ms.device, ms2.data_ptr(),
            _device_inds(inds, ms.device).data_ptr(), Lu.data_ptr(), piv.data_ptr(),
            c.data_ptr(), isc.data_ptr(), s, z, B)
    flops.kernel_launch("nd_ldl", B, lambda: flops.ldl_flops(s))
    return (Lu.reshape(batch_shape + (s, s)),) + tuple(
        v.reshape(batch_shape + (s,)) for v in (piv, c, isc))


def nd_ksolve_fused(ms: Array, inds, Lu: Array, cvec: Array, inv_scale: Array) -> Array:
    """K (..., d, s, s), symmetrised, from ``nd_ldl_fused``'s factor:
    ``nd_ksolve_kernel`` on a CUDA tensor, its plain version on a CPU
    tensor.

    The kernel runs one CTA per trial: Lu is read once into shared
    memory and serves every dimension.  Both solves are blocked
    X <- Lu^{-1} X (the second on W^T), one warp per 8-column strip:
    each 8-row panel's update from the rows above and the inverse of its
    unit diagonal block (inverted once per trial) run on the FP64 tensor
    cores (``mma.sync`` m8n8k4).  Its bound is bytes (moments and Lu read
    once, K written once; ``chip_smoke.py::pair_timing``)."""
    if torch.is_tensor(ms) and ms.device.type == "cpu":
        return nd_ksolve_plain(ms, inds, Lu, cvec, inv_scale)
    inds, d, s, z, batch_shape, B = _prepare(ms, inds, MAX_S_K, MAX_D_K)
    if ms.device.type != "cuda":
        raise ValueError(f"no fused ND quadrature for device {ms.device}")
    Lu, cvec, inv_scale = _factor_args(ms, Lu, cvec, inv_scale, B, s)
    ms2 = ms.reshape(B, z).contiguous()
    K = torch.empty((B, d, s, s), dtype=DTYPE, device=ms.device)
    _launch("nd_ksolve", _lib()[2], ms.device, ms2.data_ptr(),
            _device_inds(inds, ms.device).data_ptr(), Lu.data_ptr(), cvec.data_ptr(),
            inv_scale.data_ptr(), K.data_ptr(), d, s, z, B)
    flops.kernel_launch("nd_ksolve", B, lambda: flops.ksolve_flops(s, d))
    return K.reshape(batch_shape + (d, s, s))


def ksolve_layout(s: int, d: int, device="cuda") -> dict:
    """``nd_ksolve_kernel``'s launch layout for (s, d) on a CUDA device:
    s padded to ``sp``, row stride ``ld``, ``g`` dimensions side by side,
    ``warps`` a CTA, its dynamic ``smem_bytes`` and the ``ctas_per_sm``
    the card holds at once."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = _lib()[3](s, d, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"nd_ksolve layout query failed: CUDA error {err}")
    return dict(zip(("sp", "ld", "g", "warps", "smem_bytes", "ctas_per_sm"), out))


def nd_k_fused(ms: Array, inds) -> Array:
    """The d multiplication operators ``K (..., d, s, s)`` (symmetrised)
    of ``ms (..., z)`` for s <= ``MAX_S_K``: ``nd_ldl_fused`` then
    ``nd_ksolve_fused``, two launches on a CUDA tensor, their plain
    versions on a CPU tensor."""
    Lu, _, c, isc = nd_ldl_fused(ms, inds)
    return nd_ksolve_fused(ms, inds, Lu, c, isc)


def _factor_args(ms: Array, Lu: Array, cvec: Array, inv_scale: Array, B: int, s: int):
    """The factor's tensors as contiguous (B, s, s), (B, s), (B, s) f64
    on ``ms``'s device, or raise."""
    out = []
    for name, v, shape in (("Lu", Lu, (s, s)), ("cvec", cvec, (s,)),
                           ("inv_scale", inv_scale, (s,))):
        if not torch.is_tensor(v) or v.dtype != DTYPE or v.device != ms.device:
            raise TypeError(f"{name} must be a float64 tensor on {ms.device}")
        if v.numel() != B * int(np.prod(shape)) or tuple(v.shape[-len(shape):]) != shape:
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected (..., "
                             + ", ".join(map(str, shape)) + f") for {B} trials")
        out.append(v.reshape((B,) + shape).contiguous())
    return out


def nd_ldl_plain(ms: Array, inds) -> Tuple[Array, Array, Array, Array]:
    """``nd_ldl``'s arithmetic in plain PyTorch f64 on any device."""
    inds, d, s, z, batch_shape, B = _prepare(ms, inds, MAX_S_K, MAX_D_K)
    ms2 = ms.reshape(B, z)
    c = _equilibration(ms2, inds)
    Lu, piv, scale = _ldl_plain(_scaled(c, ms2[:, torch.as_tensor(inds[0], device=ms.device)]))
    return (Lu.reshape(batch_shape + (s, s)),) + tuple(
        v.reshape(batch_shape + (s,)) for v in (piv, c, 1.0 / scale))


def nd_ksolve_plain(ms: Array, inds, Lu: Array, cvec: Array, inv_scale: Array) -> Array:
    """``nd_ksolve``'s arithmetic in plain PyTorch f64 on any device:
    W = Lu^{-1} H', Y = W Lu^{-T}, K_ij = (Y_ij / scale_i) / scale_j,
    symmetrised."""
    inds, d, s, z, batch_shape, B = _prepare(ms, inds, MAX_S_K, MAX_D_K)
    Lu, c, isc = _factor_args(ms, Lu, cvec, inv_scale, B, s)
    Hp = _scaled(c, ms.reshape(B, z)[:, torch.as_tensor(inds[1:], device=ms.device)])
    W = _unit_forward(Lu, Hp)  # Lu^{-1} H'
    Y = _unit_forward(Lu, W.mT).mT  # W Lu^{-T}
    K = (Y * isc[:, None, :, None]) * isc[:, None, None, :]
    return (0.5 * (K + K.mT)).reshape(batch_shape + (d, s, s))


# ---------------------------------------------------------------------------
# K2: fused eigenpairs
# ---------------------------------------------------------------------------


def nd_eigh_fused(ms: Array, inds) -> Tuple[Array, Array]:
    """Eigenpairs of the d multiplication operators of ``ms (..., z)``:
    ``vals (..., d, s)``, ``vecs (..., d, s, s)`` with eigenvectors in
    the columns, unsorted.  K2 on a CUDA tensor, its plain version on a
    CPU tensor.

    The kernel runs one warp per (trial, dimension), two trials a CTA,
    with every matrix in shared memory: each trial's LDL is factored
    once, lanes over rows, then each warp runs its scaled solves (lanes
    over columns) and its cyclic Jacobi, the rotations of a round
    spread over the lanes.  Its bound is FP64 operations outside the
    tensor cores (``ops/flops.py::k2_flops``); it is latency-bound."""
    if torch.is_tensor(ms) and ms.device.type == "cpu":
        return nd_eigh_fused_plain(ms, inds)
    inds, d, s, z, batch_shape, B = _prepare(ms, inds, MAX_S_EIGH, MAX_D_EIGH)
    if ms.device.type != "cuda":
        raise ValueError(f"no fused ND quadrature for device {ms.device}")
    ms2 = ms.reshape(B, z).contiguous()
    vals = torch.empty((B, d, s), dtype=DTYPE, device=ms.device)
    vecs = torch.empty((B, d, s, s), dtype=DTYPE, device=ms.device)
    _launch("nd_eigh", _lib()[0], ms.device, ms2.data_ptr(),
            _device_inds(inds, ms.device).data_ptr(), vals.data_ptr(), vecs.data_ptr(),
            d, s, z, B)
    # The sweeps depend on the data: counted at one a dimension, a lower bound.
    flops.kernel_launch("nd_eigh", B, lambda: flops.k2_flops(s, d, [1] * d), lower_bound=True)
    return vals.reshape(batch_shape + (d, s)), vecs.reshape(batch_shape + (d, s, s))


def _solve_scaled(Lu: Array, scale: Array, rhs: Array) -> Array:
    """R^{-1} rhs with R = Lu diag(scale), the division by scale[r]
    inside the recursion (K2's JAX order): rhs (B, d, s, s)."""
    v = rhs.clone()
    s = v.shape[-2]
    for k in range(s):
        v[..., k, :] = v[..., k, :] / scale[:, None, k, None]
        if k < s - 1:
            v[..., k + 1:, :] -= Lu[:, None, k + 1:, k, None] * (
                scale[:, None, k, None, None] * v[..., k, None, :])
    return v


def jacobi_plain(A: Array):
    """Cyclic Jacobi on symmetric ``A (..., s, s)`` in round-robin order,
    each matrix stopping once its off-diagonal mass is at most
    ``JACOBI_TOL^2`` of its total (a NaN mass stops it too), after at most
    ``MAX_SWEEPS`` sweeps.  Per round: all rotation
    angles, then all column updates, then all row updates, then the
    eigenvector updates, exactly as the CUDA kernel orders them.
    Returns (vals, vecs, sweeps)."""
    s = A.shape[-1]
    A = A.clone()
    V = torch.eye(s, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    sweeps = torch.zeros(A.shape[:-2], dtype=torch.int32, device=A.device)
    offmask = ~torch.eye(s, dtype=torch.bool, device=A.device)
    rounds = [(torch.as_tensor(p, device=A.device), torch.as_tensor(q, device=A.device))
              for p, q in round_robin_schedule(s)]
    for _ in range(MAX_SWEEPS):
        sq = A * A
        off = torch.where(offmask, sq, 0.0).sum(dim=(-2, -1))
        active = off > (JACOBI_TOL * JACOBI_TOL) * sq.sum(dim=(-2, -1))
        if not bool(active.any()):
            break
        sweeps += active.to(torch.int32)
        for P, Q in rounds:
            app, aqq, apq = A[..., P, P], A[..., Q, Q], A[..., P, Q]
            safe = torch.where(apq == 0.0, 1.0, apq)
            tau = (aqq - app) / (2.0 * safe)
            t = torch.where(tau >= 0.0, 1.0, -1.0) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(active[..., None] & (apq != 0.0), t, 0.0)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            sn = t * c
            cc, ss = c[..., None, :], sn[..., None, :]
            Ap, Aq = A[..., :, P], A[..., :, Q]
            A[..., :, P] = cc * Ap - ss * Aq
            A[..., :, Q] = ss * Ap + cc * Aq
            cr, sr = c[..., :, None], sn[..., :, None]
            Ap, Aq = A[..., P, :], A[..., Q, :]
            A[..., P, :] = cr * Ap - sr * Aq
            A[..., Q, :] = sr * Ap + cr * Aq
            Vp, Vq = V[..., :, P], V[..., :, Q]
            V[..., :, P] = cc * Vp - ss * Vq
            V[..., :, Q] = ss * Vp + cc * Vq
    return torch.diagonal(A, dim1=-2, dim2=-1), V, sweeps


def nd_eigh_operators_plain(ms: Array, inds) -> Array:
    """The K_m that K2 decomposes, ``(..., d, s, s)``: ``nd_k_fused``'s function
    computed in K2's order of the solves (plain PyTorch f64)."""
    inds, d, s, z, batch_shape, B = _prepare(ms, inds, MAX_S_EIGH, MAX_D_EIGH)
    _, Gp, Hp = _equilibrated(ms.reshape(B, z), inds)
    Lu, _, scale = _ldl_plain(Gp)
    X = _solve_scaled(Lu, scale, Hp)  # R^{-1} H'
    K = _solve_scaled(Lu, scale, X.mT)  # R^{-1} X^T = R^{-1} H' R^{-T}
    return (0.5 * (K + K.mT)).reshape(batch_shape + (d, s, s))


def nd_eigh_fused_plain(ms: Array, inds, return_sweeps: bool = False):
    """K2's arithmetic in plain PyTorch f64 on any device.  With
    ``return_sweeps`` also the Jacobi sweeps each ``(trial, dimension)``
    ran, int32 ``(..., d)`` (the kernel stops on the same test)."""
    inds, d, s, z, batch_shape, B = _prepare(ms, inds, MAX_S_EIGH, MAX_D_EIGH)
    K = nd_eigh_operators_plain(ms, inds).reshape(B, d, s, s)
    finite = torch.isfinite(K).all(dim=-1).all(dim=-1)
    eye = torch.eye(s, dtype=K.dtype, device=K.device)
    vals, vecs, sweeps = jacobi_plain(torch.where(finite[..., None, None], K, eye))
    nan = torch.full((), float("nan"), dtype=K.dtype, device=K.device)
    vals = torch.where(finite[..., None], vals, nan)
    vecs = torch.where(finite[..., None, None], vecs, nan)
    out = (vals.reshape(batch_shape + (d, s)), vecs.reshape(batch_shape + (d, s, s)))
    if return_sweeps:
        out += (sweeps.reshape(batch_shape + (d,)),)
    return out
