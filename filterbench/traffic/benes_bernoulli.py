"""Observations of the Beneš–Bernoulli model, sampled from the seed.

    dX = tanh(X) dt + dW,   Y_k ~ Bernoulli(logistic(X_k^3 / 5)),

from the two-component initial mixture of the configuration.  The Beneš
SDE has a closed-form transition: over a step dt the law of X_{t+dt}
given X_t = x is the mixture of N(x + dt, dt) and N(x - dt, dt) with
weights (1 + tanh x) / 2 and (1 - tanh x) / 2 (the density
cosh(x') / cosh(x) e^{-dt/2} N(x'; x, dt)).  So every path is sampled
exactly, with no Euler or TME sub-steps.  Plain torch, in f64, on the
device of the generator.
"""
import torch


def generate(model: dict, traffic: dict, generator: torch.Generator) -> dict:
    """``xs`` and ``ys`` of shape (T, B), T from the model and B from the
    traffic."""
    B, T, dt = int(traffic["B"]), int(model["T"]), float(model["dt"])
    dev, f64 = generator.device, torch.float64
    init = model["init"]
    means = torch.tensor(init["means"], dtype=f64, device=dev)
    sds = torch.tensor(init["variances"], dtype=f64, device=dev).sqrt()
    cum = torch.cumsum(torch.tensor(init["weights"], dtype=f64, device=dev), 0)
    comp = torch.searchsorted(cum, torch.rand(B, generator=generator, dtype=f64, device=dev))
    comp = comp.clamp_max(means.shape[0] - 1)
    x = means[comp] + sds[comp] * torch.randn(B, generator=generator, dtype=f64, device=dev)
    xs, ys = [], []
    for _ in range(T):
        up = torch.rand(B, generator=generator, dtype=f64, device=dev) < 0.5 * (1.0 + torch.tanh(x))
        eps = torch.randn(B, generator=generator, dtype=f64, device=dev)
        x = x + torch.where(up, dt, -dt) + dt**0.5 * eps
        p = torch.sigmoid(x**3 / float(model["emission_divisor"]))
        ys.append((torch.rand(B, generator=generator, dtype=f64, device=dev) < p).to(f64))
        xs.append(x)
    return {"xs": torch.stack(xs), "ys": torch.stack(ys)}
