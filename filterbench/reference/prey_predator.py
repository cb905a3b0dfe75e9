"""Plain reference for ``prey_predator``: the 2D central-moment filter of
the configuration, written from the model's equations.

Moments are kept as arrays M[a, b] = E[(X1 - m1)^a (X2 - m2)^b].

- Prediction: TME of order 2, E[phi(X')] ~ phi + dt L phi + dt^2/2 L^2 phi,
  with the generator L f = a . grad f + 1/2 sum_i (sigma x_i)^2 d_ii f of
  the Lotka-Volterra drift a.  The predicted mean is the rule's average
  of x + dt a(x) + dt^2/2 (L a)(x).  For the central moments about it,
  in the frame v = x - m', L maps v^(a,b) to eight monomials with
  coefficients in m' (written out in ``_gen_dual``), so the rule's
  averages of L^k v^alpha follow from its power sums Q[a, b] =
  sum_n w_n v1^a v2^b by applying the dual of L k times.
- Quadrature: ``rules.gauss_rule_2d`` (Cholesky, two eigh, the chained
  inner products of the eigenvectors).
- Update: Bernoulli likelihood of the prey at the nodes, normalised
  posterior central moments, nell -= log p(y_k | y_1:k-1).

A trial whose rule fails goes on with NaN and is reported as not finite.
Runs in the dtype it is given: float64 is the reference, float32 the
control.
"""
import torch

from reference.compare import ANSWERS, NUMBERS, finite, numbers, spread  # noqa: F401
from reference.rules import gauss_rule_2d, normal_moments

CONTROLS = {"float32": {"dtype": torch.float32}}


def basis(degree: int, device) -> torch.Tensor:
    """Exponents (a, b) with a + b <= degree, by degree, (0, 0) first."""
    rows = [(a, t - a) for t in range(degree + 1) for a in range(t + 1)]
    return torch.tensor(rows, device=device)


def _power_sums(w, v, D):
    """Q[..., a, b] = sum_n w_n v1^a v2^b for a, b < D."""
    orders = torch.arange(D, device=v.device, dtype=v.dtype)
    p1 = v[..., 0, None] ** orders  # (..., n, D)
    p2 = v[..., 1, None] ** orders
    return (w[..., None] * p1).mT @ p2


def _gen_dual(Q, c, p):
    """(L* Q)[a, b] = sum_n w_n (L v^(a,b))(v_n) in the frame v = x - c."""
    al, be, de, ga, s2 = p["alpha"], p["beta"], p["delta"], p["gamma"], p["sigma"] ** 2
    D = Q.shape[-1]
    P = torch.nn.functional.pad(Q, (2, 2, 2, 2))
    at = lambda da, db: P[..., 2 + da:2 + da + D, 2 + db:2 + db + D]
    a = torch.arange(D, device=Q.device, dtype=Q.dtype)[:, None]
    b = torch.arange(D, device=Q.device, dtype=Q.dtype)[None, :]
    c1, c2 = c[..., 0, None, None], c[..., 1, None, None]
    A1, A2 = al - be * c2, de * c1 - ga
    return (a * (A1 * at(0, 0) - be * at(0, 1) + c1 * A1 * at(-1, 0) - be * c1 * at(-1, 1))
            + b * (A2 * at(0, 0) + de * at(1, 0) + c2 * A2 * at(0, -1) + de * c2 * at(1, -1))
            + 0.5 * s2 * a * (a - 1) * (at(0, 0) + 2 * c1 * at(-1, 0) + c1 * c1 * at(-2, 0))
            + 0.5 * s2 * b * (b - 1) * (at(0, 0) + 2 * c2 * at(0, -1) + c2 * c2 * at(0, -2)))


def _drift(x, p):
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([x1 * (p["alpha"] - p["beta"] * x2),
                        x2 * (p["delta"] * x1 - p["gamma"])], dim=-1)


def _drift_gen(x, p):
    """(L a)(x): the generator of each drift component (no second
    derivatives: each is bilinear)."""
    x1, x2 = x[..., 0], x[..., 1]
    a = _drift(x, p)
    return torch.stack([a[..., 0] * (p["alpha"] - p["beta"] * x2) - a[..., 1] * p["beta"] * x1,
                        a[..., 0] * p["delta"] * x2 + a[..., 1] * (p["delta"] * x1 - p["gamma"])],
                       dim=-1)


def initial(model: dict, D: int, B: int, dtype, device):
    init = model["init"]
    w = torch.tensor(init["weights"], dtype=dtype, device=device)
    mu = torch.tensor(init["means"], dtype=dtype, device=device)
    cov = torch.tensor(init["covs"], dtype=dtype, device=device)
    if (cov - torch.diag_embed(torch.diagonal(cov, dim1=-2, dim2=-1))).abs().max() > 0:
        raise ValueError("the reference takes diagonal initial covariances")
    mean = (w[:, None] * mu).sum(0)
    var = torch.diagonal(cov, dim1=-2, dim2=-1)
    m1 = normal_moments(mu[:, 0] - mean[0], var[:, 0], D)  # (c, D)
    m2 = normal_moments(mu[:, 1] - mean[1], var[:, 1], D)
    M = (w[:, None, None] * m1[:, :, None] * m2[:, None, :]).sum(0)
    return M.expand(B, D, D).clone(), mean.expand(B, 2).clone()


def run(config: dict, traffic: dict, ys: torch.Tensor, dtype) -> dict:
    """Filter ``ys (T, B, 1)``; returns ``nell (B,)`` and ``mean (B, 2)``
    at the last step, in ``dtype``, and ``finite (B,)``."""
    model = config["model"]
    N, dt, p = int(traffic["N"]), float(model["dt"]), model["params"]
    ys = ys.to(dtype)
    D = 2 * N  # moment orders kept: a, b < 2N (the filter reads a + b <= 2N - 1)
    M, mean = initial(model, D, ys.shape[1], dtype, ys.device)
    nell = torch.zeros(ys.shape[1], dtype=dtype, device=ys.device)
    base = basis(N - 1, ys.device)
    for y in ys:
        w, x = gauss_rule_2d(M, mean, base)
        mean = (w[..., None] * (x + dt * _drift(x, p) + 0.5 * dt * dt * _drift_gen(x, p))).sum(-2)
        Q = _power_sums(w, x - mean[..., None, :], D + 2)
        L1 = _gen_dual(Q, mean, p)
        L2 = _gen_dual(L1, mean, p)
        M = (Q + dt * L1 + 0.5 * dt * dt * L2)[..., :D, :D]

        w, x = gauss_rule_2d(M, mean, base)
        pr = torch.sigmoid(x[..., 0] ** 3 - 1.0)
        wp = torch.where(y[..., None, 0] == 1, pr, 1.0 - pr) * w
        pdf_y = wp.sum(-1)
        mean = (wp[..., None] * x).sum(-2) / pdf_y[..., None]
        M = _power_sums(wp, x - mean[..., None, :], D) / pdf_y[..., None, None]
        nell = nell - torch.log(pdf_y)
    return {"nell": nell, "mean": mean, "finite": finite(nell, mean)}

