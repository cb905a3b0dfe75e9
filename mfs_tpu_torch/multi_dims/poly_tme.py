"""Closed-form (matmul) TME transition moments for polynomial SDEs.

Port of ``mfs_tpu/multi_dims/poly_tme.py``.  For polynomial drift ``a``
and diffusion outer product ``b bᵀ`` (the stochastic Lotka–Volterra
models), the SDE generator

    L f = a · ∇f + 1/2 (b bᵀ) : ∇²f

maps polynomials to polynomials, so the TME expansion

    E[φ(X_{t+dt}) | X_t = x]  ≈  Σ_k dt^k/k!  (L^k φ)(x)

is linear algebra over monomial-coefficient vectors:

- at build time (NumPy, once per model and basis): the exact Taylor
  coefficients of ``a`` and ``b bᵀ`` (nested ``torch.func.jacfwd`` at 0,
  exact for polynomials), and one constant operator per coefficient
  monomial γ, ``O[(γ, i)] = M_γ D_i`` and ``O[(γ, i, j)] = 1/2 M_γ D_i D_j``
  on the graded-lex basis;
- at run time: the generator in the shifted and scaled frame
  v = (u − m)/s is ``L̃ = Σ_t c_t(m, s) O_t`` with per-trial scalars
  ``c_t`` from a Pascal shift/scale transform of the base coefficients,
  and applying ``L̃ᵀ`` is one GEMM against the stacked operators.

The fused predict moves the weight contraction inside the tower,

    predicted_j = Σ_k dt^k/k! · ((C̃ᵀ)^k q₀)_j,   q₀ = Σ_node w · mono_ext(v_node),

so the tower acts on ONE ``z_ext``-vector per trial instead of one per
node.  Truncating at the extended degree ``2N−1 + order·rise`` is exact
for every entry the filter reads.
"""
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from mfs_tpu_torch.config import DTYPE, default_device
from mfs_tpu_torch.multi_dims.moments import monomials_nd, weighted_monomials_nd
from mfs_tpu_torch.multi_dims.multi_indices import (
    generate_graded_lexico_multi_indices,
    graded_lexico_indexof_multi_index,
)
from mfs_tpu_torch.typings import Array, FloatScalar
from mfs_tpu_torch.utils.profiling import span


def poly_coefficients(f: Callable, d: int, deg: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact graded-lex Taylor coefficients of a polynomial callable.

    ``f: (d,) -> (k,)`` must be a polynomial of total degree <= ``deg``
    (checked by ``_check_poly``).  Returns ``(coefs (k, z), mis (z, d))``.
    Runs nested ``jacfwd`` at 0 on the CPU, once.
    """
    mis = generate_graded_lexico_multi_indices(d, deg)
    x0 = torch.zeros((d,), dtype=DTYPE)
    out0 = f(x0).detach().numpy()
    coefs = np.zeros((out0.shape[0], mis.shape[0]))
    coefs[:, 0] = out0

    fn = f
    for order in range(1, deg + 1):
        fn = jacfwd(fn)
        tensor = fn(x0).detach().numpy()  # (k, d, ..., d) with `order` d-axes
        for r, alpha in enumerate(mis):
            if alpha.sum() != order:
                continue
            idx: Tuple[int, ...] = ()
            for i, a_i in enumerate(alpha):
                idx += (i,) * int(a_i)
            fact = np.prod([math.factorial(int(a)) for a in alpha])
            coefs[:, r] = tensor[(slice(None),) + idx] / fact
    return coefs, np.asarray(mis, dtype=np.int64)


def _check_poly(f: Callable, coefs: np.ndarray, mis: np.ndarray, rtol=1e-9) -> None:
    """Probe that ``f`` really is the polynomial its coefficients claim."""
    xs = torch.as_tensor(np.random.default_rng(0).normal(size=(5, mis.shape[-1])))
    exact = f(xs).numpy()
    approx = monomials_nd(xs, mis).numpy() @ coefs.T
    scale = max(np.abs(exact).max(), 1.0)
    if not np.allclose(exact, approx, atol=rtol * scale):
        raise ValueError(
            "callable is not a polynomial of the declared degree "
            f"(max deviation {np.abs(exact - approx).max():.2e})"
        )


def _rank(mis_ext: np.ndarray, alpha: np.ndarray) -> Optional[int]:
    if alpha.sum() > mis_ext.sum(axis=-1).max():
        return None
    return int(graded_lexico_indexof_multi_index(alpha))


def _diff_matrix(mis_ext: np.ndarray, i: int) -> np.ndarray:
    """D_i on coefficient vectors over ``mis_ext``."""
    z = mis_ext.shape[0]
    D = np.zeros((z, z))
    for c, alpha in enumerate(mis_ext):
        if alpha[i] == 0:
            continue
        beta = alpha.copy()
        beta[i] -= 1
        D[_rank(mis_ext, beta), c] = alpha[i]
    return D


def _mul_matrix(mis_ext: np.ndarray, gamma: np.ndarray) -> np.ndarray:
    """M_γ (multiply by mono_γ) on coefficient vectors; truncating."""
    z = mis_ext.shape[0]
    max_deg = int(mis_ext.sum(axis=-1).max())
    M = np.zeros((z, z))
    for c, alpha in enumerate(mis_ext):
        beta = alpha + gamma
        if beta.sum() > max_deg:
            continue
        M[_rank(mis_ext, beta), c] = 1.0
    return M


class _ShiftTable(NamedTuple):
    """Pascal shift/scale transform of a coefficient basis:
    mono_β(s v + m) = Σ_{γ<=β} binom(β,γ) s^γ m^{β-γ} mono_γ(v).
    Row r holds one (β, γ) pair.  ``seg`` is the one-hot (P, zc) matrix
    of ``out_rank``, on the device."""

    out_rank: np.ndarray  # (P,)
    in_rank: np.ndarray  # (P,)
    binom: np.ndarray  # (P,)
    s_pow: np.ndarray  # (P, d)
    m_pow: np.ndarray  # (P, d)
    seg: Array  # (P, zc)


def _shift_table(mis_coef: np.ndarray, device) -> _ShiftTable:
    rows = []
    for b_r, beta in enumerate(mis_coef):
        for g_r, gamma in enumerate(mis_coef):
            if np.any(gamma > beta):
                continue
            binom = float(np.prod([math.comb(int(b), int(g)) for b, g in zip(beta, gamma)]))
            rows.append((g_r, b_r, binom, gamma.copy(), (beta - gamma).copy()))
    out_rank = np.array([r[0] for r in rows], dtype=np.int64)
    seg = np.zeros((len(rows), mis_coef.shape[0]))
    seg[np.arange(len(rows)), out_rank] = 1.0
    return _ShiftTable(
        out_rank,
        np.array([r[1] for r in rows], dtype=np.int64),
        np.array([r[2] for r in rows]),
        np.stack([r[3] for r in rows]).astype(np.int64),
        np.stack([r[4] for r in rows]).astype(np.int64),
        torch.as_tensor(seg, dtype=DTYPE, device=device),
    )


def _shift_coefs(table: _ShiftTable, base: Array, m: Array, s: Array) -> Array:
    """Per-trial v-frame coefficients: base (k, zc) -> (..., k, zc)."""
    w = (torch.as_tensor(table.binom, dtype=m.dtype, device=m.device)
         * monomials_nd(s, table.s_pow) * monomials_nd(m, table.m_pow))  # (..., P)
    contrib = w[..., None, :] * base[:, torch.as_tensor(table.in_rank, device=m.device)]
    return torch.einsum("...kp,pz->...kz", contrib, table.seg)


class PolyTME(NamedTuple):
    """Polynomial-TME machinery for one SDE and basis.

    ``ops_t`` stacks the transposed constant generator blocks
    ``(n_ops, z_ext, z_ext)`` on the device; ``ops_mat`` is the same
    tensor laid out as one ``(z_ext, n_ops * z_ext)`` GEMM operand.  The
    run-time v-frame generator is ``Σ_t coefs[..., t] · ops[t]``.
    """

    dt: float
    order: int
    mis: np.ndarray  # filter basis (z, d)
    mis_ext: np.ndarray  # extended basis (z_ext, d)
    ops_t: Array  # (n_ops, z_ext, z_ext)
    ops_mat: Array  # (z_ext, n_ops * z_ext)
    a_coefs: Array  # (d, zc_a)
    bbt_coefs: Array  # (d, d, zc_b)
    a_table: _ShiftTable
    b_table: _ShiftTable
    a_slots: np.ndarray  # (d, zc_a) -> op index
    b_slots: np.ndarray  # (d, d, zc_b) -> op index
    small_z: int  # sub-basis size reachable by coordinate towers
    pair_rank: np.ndarray  # (small_z, small_z) -> ext rank of α+β

    def _ranks(self, alphas, device) -> Array:
        return torch.as_tensor([_rank(self.mis_ext, a) for a in alphas], device=device)

    def frame_coefs(self, m: Array, s: Array) -> Array:
        """Per-trial scalars c_t(m, s): (..., n_ops).  The slots number
        the drift terms first, then the diffusion terms, each in
        row-major order, so the coefficients are one concatenation."""
        d = self.a_coefs.shape[0]
        a_v = _shift_coefs(self.a_table, self.a_coefs, m, s) / s[..., :, None]
        bb = self.bbt_coefs.reshape(-1, self.bbt_coefs.shape[-1])
        b_v = _shift_coefs(self.b_table, bb, m, s)
        b_v = b_v.reshape(b_v.shape[:-2] + (d, d, b_v.shape[-1]))
        b_v = b_v / (s[..., :, None, None] * s[..., None, :, None])
        return torch.cat([a_v.flatten(-2), b_v.flatten(-3)], dim=-1)

    def apply_gen_t(self, coefs: Array, q: Array) -> Array:
        """(L̃ᵀ q) for per-trial generators: q (..., z_ext)."""
        r = (q @ self.ops_mat).unflatten(-1, self.ops_t.shape[:2])  # (..., o, y)
        return (coefs[..., None, :] @ r)[..., 0, :]

    def tower_t(self, coefs: Array, q0: Array) -> Array:
        """Σ_k dt^k/k! (L̃ᵀ)^k q0, truncated at ``order``."""
        out = q0
        q = q0
        fac = 1.0
        for k in range(1, self.order + 1):
            q = self.apply_gen_t(coefs, q)
            fac *= self.dt / k
            out = out + fac * q
        return out

    def _weighted_monomials(self, weights: Array, v: Array) -> Array:
        """Σ_n w_n mono_ext(v_n): weights (..., n), v (..., n, d) -> (..., z_ext)."""
        return weighted_monomials_nd(weights, v, self.mis_ext)

    # ------------------------------------------------------------------
    # Fused predict: weights + nodes -> (new mean, new moments)
    # ------------------------------------------------------------------
    def predict_cms(self, weights: Array, nodes: Array, mean: Array) -> Tuple[Array, Array]:
        """One fused prediction for the central-moment filter.

        weights (..., n), nodes (..., n, d), mean (..., d), the current
        posterior mean (the quadrature frame).  Returns
        (pred_mean (..., d), pred_cms (..., z)): tower 1 in the frame of
        the current mean gives the predicted mean from its degree-1
        entries, tower 2 in the frame of the predicted mean gives the
        central moments without moment-space shifts.
        """
        d = nodes.shape[-1]
        ones = torch.ones_like(mean)
        coefs_old = self.frame_coefs(mean, ones)
        q0 = self._weighted_monomials(weights, nodes - mean[..., None, :])
        t_old = self.tower_t(coefs_old, q0)
        pred_mean = mean + t_old[..., self._ranks(np.eye(d, dtype=np.int64), mean.device)]

        coefs_new = self.frame_coefs(pred_mean, ones)
        q2 = self._weighted_monomials(weights, nodes - pred_mean[..., None, :])
        t_new = self.tower_t(coefs_new, q2)
        return pred_mean, t_new[..., : self.mis.shape[0]]

    def predict_scms(
        self, weights: Array, nodes: Array, mean: Array, scale: Array
    ) -> Tuple[Array, Array, Array]:
        """One fused prediction for the scaled-central filter.

        Returns (pred_mean, pred_scale, pred_scms), the predicted scale
        by the law of total variance with the consistently truncated
        conditional covariance.  Everything is computed in the old frame
        v = (u−m)/s: the conditional mean and variance per node are
        coefficient-side towers c_k = C̃^k e_i over the small-degree
        sub-basis, and their weighted products are bilinear forms in q0.
        """
        d = nodes.shape[-1]
        dev = nodes.device
        coefs_old = self.frame_coefs(mean, scale)
        v = (nodes - mean[..., None, :]) / scale[..., None, :]
        q0 = self._weighted_monomials(weights, v)

        zs = int(self.small_z)
        C_small_t = torch.einsum("...o,oyz->...yz", coefs_old, self.ops_t[:, :zs, :zs])

        unit = np.eye(d, dtype=np.int64)
        id_ranks = self._ranks(unit, dev)
        sq_ranks = self._ranks(2 * unit, dev)

        c0 = torch.eye(zs, dtype=nodes.dtype, device=dev)[id_ranks].expand(
            mean.shape[:-1] + (d, zs))
        c_ks = [c0]
        for _ in range(self.order):
            c_ks.append(torch.einsum("...zy,...dz->...dy", C_small_t, c_ks[-1]))

        Qmat = q0[..., torch.as_tensor(self.pair_rank, device=dev)]  # (..., zs, zs)

        def Ew(ca, cb):
            return torch.einsum("...da,...ab,...db->...d", ca, Qmat, cb)

        s_ks = [q0[..., sq_ranks]]
        q_iter = q0
        for _ in range(self.order):
            q_iter = self.apply_gen_t(coefs_old, q_iter)
            s_ks.append(q_iter[..., sq_ranks])

        coeffs = [1.0]
        for r in range(1, self.order + 1):
            coeffs.append(coeffs[-1] * self.dt / r)

        m_v = q0[..., id_ranks]
        for r in range(1, self.order + 1):
            m_v = m_v + coeffs[r] * torch.einsum("...dz,...z->...d", c_ks[r], q0[..., :zs])

        second = torch.zeros_like(m_v)
        for r in range(self.order + 1):
            for r2 in range(self.order + 1):
                second = second + coeffs[r] * coeffs[r2] * Ew(c_ks[r], c_ks[r2])
        for r in range(1, self.order + 1):
            inner = s_ks[r]
            for k in range(r + 1):
                inner = inner - math.comb(r, k) * Ew(c_ks[k], c_ks[r - k])
            second = second + coeffs[r] * inner

        pred_mean = mean + scale * m_v
        pred_scale = scale * torch.sqrt(second - m_v**2)

        coefs_new = self.frame_coefs(pred_mean, pred_scale)
        v2 = (nodes - pred_mean[..., None, :]) / pred_scale[..., None, :]
        t_new = self.tower_t(coefs_new, self._weighted_monomials(weights, v2))
        return pred_mean, pred_scale, t_new[..., : self.mis.shape[0]]

    # ------------------------------------------------------------------
    # Per-node callables (TransitionMomentsND-compatible)
    # ------------------------------------------------------------------
    def _per_node(self, nodes: Array, shift: Array, scale: Array) -> Array:
        coefs = self.frame_coefs(shift, scale)
        v = (nodes - shift[..., None, :]) / scale[..., None, :]
        out = self.tower_t(coefs[..., None, :], monomials_nd(v, self.mis_ext))
        return out[..., : self.mis.shape[0]]

    def _frame(self, nodes: Array, v) -> Array:
        shape = nodes.shape[:-2] + (nodes.shape[-1],)
        return torch.as_tensor(v, dtype=nodes.dtype, device=nodes.device).expand(shape)

    def rms(self, nodes: Array) -> Array:
        return self._per_node(nodes, self._frame(nodes, 0.0), self._frame(nodes, 1.0))

    def cms(self, nodes: Array, mean: Array) -> Array:
        return self._per_node(nodes, self._frame(nodes, mean), self._frame(nodes, 1.0))

    def scms(self, nodes: Array, mean: Array, scale: Array) -> Array:
        return self._per_node(nodes, self._frame(nodes, mean), self._frame(nodes, scale))

    def mean(self, nodes: Array) -> Array:
        """Conditional mean per node (..., n, d)."""
        d = nodes.shape[-1]
        out = self.tower_t(
            self.frame_coefs(self._frame(nodes, 0.0), self._frame(nodes, 1.0))[..., None, :],
            monomials_nd(nodes, self.mis_ext))
        return out[..., self._ranks(np.eye(d, dtype=np.int64), nodes.device)]

    def mean_var(self, nodes: Array) -> Tuple[Array, Array]:
        """Conditional mean and variance diagonal per node, with the
        consistently truncated covariance (not E[U²]−E[U]², whose
        truncation injects spurious O(dt²) cross terms)."""
        unit = np.eye(nodes.shape[-1], dtype=np.int64)
        m_ranks = self._ranks(unit, nodes.device)
        sq_ranks = self._ranks(2 * unit, nodes.device)
        coefs = self.frame_coefs(self._frame(nodes, 0.0), self._frame(nodes, 1.0))[..., None, :]
        terms = [monomials_nd(nodes, self.mis_ext)]  # (L^k mono_ext)(node), raw frame
        for _ in range(self.order):
            terms.append(self.apply_gen_t(coefs, terms[-1]))
        ids = [t[..., m_ranks] for t in terms]
        sqs = [t[..., sq_ranks] for t in terms]

        mean = ids[0]
        var = torch.zeros_like(mean)
        coeff = 1.0
        for r in range(1, self.order + 1):
            coeff = coeff * self.dt / r
            mean = mean + coeff * ids[r]
            inner = sqs[r]
            for k in range(r + 1):
                inner = inner - math.comb(r, k) * ids[k] * ids[r - k]
            var = var + coeff * inner
        return mean, var


@span("mfs.build.transition")
def poly_tme_nd(
    drift: Callable,
    dispersion: Callable,
    dt: FloatScalar,
    tme_order: int,
    multi_indices: np.ndarray,
    drift_deg: int,
    dispersion_deg: int,
    device=None,
) -> PolyTME:
    """Build the polynomial-TME machinery for ``device`` (``None``: cuda).

    ``drift: (..., d) -> (..., d)`` and ``dispersion: (..., d) ->
    (..., d, d)`` must be polynomials of the declared total degrees
    (checked numerically on the CPU).
    """
    device = default_device(device)
    mi = np.asarray(multi_indices, dtype=np.int64)
    d = mi.shape[-1]
    deg_phi = int(mi.sum(axis=-1).max())
    bbt_deg = 2 * dispersion_deg
    rise = max(drift_deg - 1, bbt_deg - 2, 0)
    # Extended degree: enough for the φ towers AND for products of two
    # coordinate towers (predict_scms' bilinear forms reach 2·(1 + order·rise)).
    small_deg = 1 + tme_order * rise
    deg_ext = max(deg_phi + tme_order * rise, 2 * small_deg)
    mis_ext = generate_graded_lexico_multi_indices(d, deg_ext)
    mis_small = generate_graded_lexico_multi_indices(d, small_deg)
    small_z = mis_small.shape[0]
    pair_rank = np.zeros((small_z, small_z), dtype=np.int64)
    for i_a, alpha in enumerate(mis_small):
        for i_b, beta in enumerate(mis_small):
            pair_rank[i_a, i_b] = _rank(mis_ext, alpha + beta)

    a_coefs, mis_a = poly_coefficients(drift, d, drift_deg)
    _check_poly(drift, a_coefs, mis_a)

    def bbt_flat(x):
        b = dispersion(x)
        return (b @ b.mT).flatten(-2)

    bbt_c, mis_b = poly_coefficients(bbt_flat, d, bbt_deg)
    _check_poly(bbt_flat, bbt_c, mis_b)
    bbt_coefs = bbt_c.reshape(d, d, -1)

    # One constant operator per (γ, i) drift term and per (γ, i, j)
    # diffusion term, numbered in that order (frame_coefs relies on it).
    ops = []
    Ds = [_diff_matrix(mis_ext, i) for i in range(d)]
    a_slots = np.zeros((d, mis_a.shape[0]), dtype=np.int64)
    for i in range(d):
        for g, gamma in enumerate(mis_a):
            ops.append(_mul_matrix(mis_ext, gamma) @ Ds[i])
            a_slots[i, g] = len(ops) - 1
    b_slots = np.zeros((d, d, mis_b.shape[0]), dtype=np.int64)
    for i in range(d):
        for j in range(d):
            for g, gamma in enumerate(mis_b):
                ops.append(0.5 * _mul_matrix(mis_ext, gamma) @ Ds[i] @ Ds[j])
                b_slots[i, j, g] = len(ops) - 1

    ops_t = np.stack([o.T for o in ops])  # (n_ops, z_ext, z_ext)
    as_dev = lambda a: torch.as_tensor(a, dtype=DTYPE, device=device)
    return PolyTME(
        dt=float(dt),
        order=int(tme_order),
        mis=mi,
        mis_ext=np.asarray(mis_ext, dtype=np.int64),
        ops_t=as_dev(ops_t),
        ops_mat=as_dev(np.ascontiguousarray(ops_t.transpose(2, 0, 1).reshape(ops_t.shape[2], -1))),
        a_coefs=as_dev(a_coefs),
        bbt_coefs=as_dev(bbt_coefs),
        a_table=_shift_table(mis_a, device),
        b_table=_shift_table(mis_b, device),
        a_slots=a_slots,
        b_slots=b_slots,
        small_z=small_z,
        pair_rank=pair_rank,
    )
