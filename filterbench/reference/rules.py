"""Moment-matched Gauss rules in plain torch, for the references.

In 1D, Golub-Welsch from an equilibrated LDL^T of the Hankel Gram whose
non-positive pivots are completed (``gauss_rule_1d``).  In 2D, the Gram
matrix G of the monomial basis, its Cholesky factor R (after a symmetric
diagonal equilibration, which leaves the rule unchanged), the
multiplication operators K_m = R^-1 H_m R^-T and their eigenpairs; a
trial whose Gram is not positive definite gets NaN.  Nothing here
depends on the code under test.
"""
import torch

PIVOT_COMPLETION = 1e-8  # times n: the configured quadrature's completion of a pivot <= 0


def normal_moments(mu, var, P):
    """E[Y^p], p < P, of Y ~ N(mu, var), on a new last axis."""
    ms = [torch.ones_like(mu), mu]
    for p in range(2, P):
        ms.append(mu * ms[-1] + (p - 1) * var * ms[-2])
    return torch.stack(ms[:P], dim=-1)


def _cholesky_or_nan(G):
    R, info = torch.linalg.cholesky_ex(G)
    return torch.where((info != 0)[..., None, None], torch.nan, R)


def _operators(G, Hs):
    """Equilibrated Cholesky of G (..., s, s) and K_m for each H_m in Hs
    (..., d, s, s); returns K (..., d, s, s)."""
    c = torch.rsqrt(torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(torch.finfo(G.dtype).tiny))
    scale = c[..., :, None] * c[..., None, :]
    R = _cholesky_or_nan(G * scale)[..., None, :, :]
    X = torch.linalg.solve_triangular(R, Hs * scale[..., None, :, :], upper=False)
    K = torch.linalg.solve_triangular(R.mT, X, upper=True, left=False)
    return 0.5 * (K + K.mT)


def _eigh_or_nan(K):
    bad = ~torch.isfinite(K).flatten(-2).all(-1)
    vals, vecs = torch.linalg.eigh(torch.where(bad[..., None, None], 0.0, K))
    vals = torch.where(bad[..., None], torch.nan, vals)
    return vals, torch.where(bad[..., None, None], torch.nan, vecs)


def gauss_rule_1d(ms, mean, jitter=None):
    """Weights and nodes (..., n) of the n-point rule of ``ms (..., 2n)``
    (central moments about ``mean (...)``, m_0 = mass), by Golub-Welsch:

    - the Hankel Gram G[i, j] = m_{i+j}, equilibrated to unit diagonal
      (van der Sluis, c_i = m_{2i}^{-1/2}), plus ``jitter (...)`` times
      the identity where given (the rescue's Gram regularisation);
    - its LDL^T without pivoting; a pivot d_j <= 0 (the Gram numerically
      singular) is completed: the factor's diagonal entry becomes
      ``PIVOT_COMPLETION * n`` in place of sqrt(d_j), and L keeps the column
      divided by d_j;
    - the three-term recurrence of the orthonormal polynomials from the
      factor R = C^-1 L diag(r): alpha_k = R[k+1, k] / R[k, k] -
      R[k, k-1] / R[k-1, k-1], beta_k = R[k, k] / R[k-1, k-1], and the
      last alpha as u^T H u with R^T u = e_{n-1}, H[i, j] = m_{i+j+1};
    - nodes the eigenvalues of the Jacobi matrix, weights m_0 times the
      squared first components of its eigenvectors (m_0 (1 + jitter),
      the jittered Gram's mass, with a jitter).
    """
    n = ms.shape[-1] // 2
    idx = torch.arange(n, device=ms.device)
    hank = idx[:, None] + idx[None, :]
    sq = torch.sqrt(ms[..., 0::2].clamp_min(1e-30))  # (..., n): m_{2i}^{1/2}
    c = 1.0 / sq
    G = ms[..., hank] * c[..., :, None] * c[..., None, :]
    if jitter is not None:
        G = G + jitter[..., None, None] * torch.eye(n, dtype=G.dtype, device=G.device)
    L = torch.zeros_like(G)
    d = torch.zeros_like(G[..., 0])
    r = torch.zeros_like(G[..., 0])
    for j in range(n):
        acc = G[..., :, j] - (L[..., :, :j] * (d[..., None, :j] * L[..., j:j + 1, :j])).sum(-1)
        dj = acc[..., j]
        bad = dj <= 0
        dj = torch.where(dj.abs() < 1e-35, torch.where(dj < 0, -1e-35, 1e-35), dj)
        d[..., j] = dj
        r[..., j] = torch.where(bad, PIVOT_COMPLETION * n, torch.sqrt(torch.where(bad, 1.0, dj)))
        col = torch.where(idx > j, acc / dj[..., None], (idx == j).to(acc.dtype))
        L[..., :, j] = col
    rs = sq[..., 1:] / sq[..., :-1]
    sub = rs * torch.diagonal(L, offset=-1, dim1=-2, dim2=-1)  # R[k+1, k] / R[k, k]
    beta = rs * r[..., 1:] / r[..., :-1]
    # R^T u = e_{n-1} with R = C^-1 L diag(r): u = C L^-T diag(r)^-1 e_{n-1}
    e = torch.zeros_like(r)
    e[..., n - 1] = 1.0 / r[..., n - 1]
    v = torch.linalg.solve_triangular(L.mT, e[..., None], upper=True, unitriangular=True)[..., 0]
    u = c * v
    alpha_last = (u[..., :, None] * ms[..., hank + 1] * u[..., None, :]).sum((-2, -1))
    alpha = torch.cat([sub[..., :1], sub[..., 1:] - sub[..., :-1], alpha_last[..., None]], -1)
    J = torch.diag_embed(alpha) + torch.diag_embed(beta, 1) + torch.diag_embed(beta, -1)
    vals, vecs = _eigh_or_nan(J)
    mass = ms[..., :1] if jitter is None else ms[..., :1] * (1.0 + jitter[..., None])
    return mass * vecs[..., 0, :] ** 2, vals + mean[..., None]


def gauss_rule_2d(M, mean, basis):
    """Weights (..., s*s) and nodes (..., s*s, 2) of the rule of the 2D
    moment array ``M (..., D, D)`` (``M[a, b] = E[(X1-m1)^a (X2-m2)^b]``)
    over ``basis (s, 2)``, the exponents of degree <= N-1 with (0, 0)
    first; ``mean (..., 2)``."""
    pa = basis[:, 0][:, None] + basis[:, 0][None, :]
    pb = basis[:, 1][:, None] + basis[:, 1][None, :]
    G = M[..., pa, pb]
    Hs = torch.stack([M[..., pa + 1, pb], M[..., pa, pb + 1]], dim=-3)
    vals, vecs = _eigh_or_nan(_operators(G, Hs))  # (..., 2, s), (..., 2, s, s)
    s = basis.shape[0]
    v0, v1 = vecs[..., 0, :, :], vecs[..., 1, :, :]
    cross = v0.mT @ v1  # (..., s, s): <v0(i), v1(j)>
    w = v0[..., 0, :, None] * cross * v1[..., 0, None, :] * M[..., :1, :1]
    nodes = torch.stack([vals[..., 0, :, None].expand(vals.shape[:-2] + (s, s)),
                         vals[..., 1, None, :].expand(vals.shape[:-2] + (s, s))], dim=-1)
    return w.flatten(-2), nodes.flatten(-3, -2) + mean[..., None, :]
