"""Plain reference for ``benes_bernoulli``: the central-moment filter of
the configuration, written from the model's equations.

- Transition: TME of order 2 of the Beneš SDE in closed form.  With the
  generator A f = tanh(x) f' + f''/2, A x = tanh x and A^2 x = 0, so
  the mean is x + dt tanh x; the consistently truncated variance is
  dt (A x^2 - 2 x A x) + dt^2/2 (A^2 x^2 - 2 (A x)^2) = dt + dt^2 sech^2 x.
  The higher conditional moments close with a Normal law.
- Quadrature: ``rules.gauss_rule_1d`` (equilibrated LDL^T with pivot
  completion, Golub-Welsch).  A trial that the program answered from its
  first rescue tier (``tier`` 1, one of the program's answers, read as a
  served model's tokens are) is recomputed with that tier's Gram jitter;
  the configuration's second tier, the f64 ``stable`` route, is not
  modelled apart: its trials are judged by the plain rule.
- Update: Bernoulli likelihood at the nodes, normalised posterior
  central moments, nell -= log p(y_k | y_1:k-1).

A trial whose rule fails (Gram not positive definite) goes on with NaN
and is reported as not finite.  Runs in the dtype it is given: float64
is the reference.  Two controls: float32 throughout, which loses nearly
every trial at N=15 (a Gram of moments rounded to float32 is far from
positive definite), and float64 with the rule's nodes and weights
rounded to float32, which keeps the moments those of a positive measure,
keeps the trials and so gives the gaps a reading.
"""
import torch

from reference.compare import ANSWERS, NUMBERS, finite, numbers, spread  # noqa: F401
from reference.rules import gauss_rule_1d, normal_moments

ANSWERS = ANSWERS + ("tier",)
INPUTS = ("tier",)  # the rescue tier that answered each trial

CONTROLS = {"float32": {"dtype": torch.float32},
            "float64.rule32": {"dtype": torch.float64, "rule_round": torch.float32}}


def initial(model: dict, N: int, B: int, dtype, device):
    init = model["init"]
    w = torch.tensor(init["weights"], dtype=dtype, device=device)
    mu = torch.tensor(init["means"], dtype=dtype, device=device)
    var = torch.tensor(init["variances"], dtype=dtype, device=device)
    mean = (w * mu).sum()
    cms = (w[:, None] * normal_moments(mu - mean, var, 2 * N)).sum(0)
    return cms.expand(B, 2 * N).clone(), mean.expand(B).clone()


def run(config: dict, traffic: dict, ys: torch.Tensor, dtype, rule_round=None,
        tier=None) -> dict:
    """Filter ``ys (T, B)``; returns ``nell (B,)``, ``mean (B,)`` at the
    last step, in ``dtype``, and ``finite (B,)``.  The rule's nodes and
    weights are rounded to ``rule_round``, where given; a trial whose
    ``tier (B,)`` is 1 gets the configuration's first rescue tier's Gram
    jitter."""
    model = config["model"]
    N, dt = int(traffic["N"]), float(model["dt"])
    jitter = None
    if tier is not None:
        tier1 = config["filter"]["rescue"]["tiers"][0].get("quad_jitter", 0.0)
        jitter = torch.where(tier.to(ys.device) == 1, tier1, 0.0).to(dtype)

    def rule(cms, mean):
        w, x = gauss_rule_1d(cms, mean, jitter)
        if rule_round is None:
            return w, x
        return w.to(rule_round).to(dtype), x.to(rule_round).to(dtype)

    div = float(model["emission_divisor"])
    ys = ys.to(dtype)
    cms, mean = initial(model, N, ys.shape[1], dtype, ys.device)
    nell = torch.zeros_like(mean)
    orders = torch.arange(2 * N, device=ys.device)
    for y in ys:
        w, x = rule(cms, mean)
        th = torch.tanh(x)
        m_c, v_c = x + dt * th, dt + dt * dt * (1.0 - th * th)
        mean = (w * m_c).sum(-1)
        cms = (w[..., None] * normal_moments(m_c - mean[..., None], v_c, 2 * N)).sum(-2)

        w, x = rule(cms, mean)
        p = torch.sigmoid(x**3 / div)
        wp = torch.where(y[..., None] == 1, p, 1.0 - p) * w
        pdf_y = wp.sum(-1)
        mean = (wp * x).sum(-1) / pdf_y
        cms = (wp[..., None] * (x - mean[..., None])[..., None] ** orders).sum(-2) / pdf_y[..., None]
        nell = nell - torch.log(pdf_y)
    return {"nell": nell, "mean": mean, "finite": finite(nell, mean)}
