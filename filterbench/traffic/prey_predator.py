"""Observations of the 2D stochastic Lotka–Volterra (prey–predator)
model, sampled from the seed:

    dX_1 = X_1 (alpha - beta X_2) dt + sigma X_1 dW_1,
    dX_2 = X_2 (delta X_1 - gamma) dt + sigma X_2 dW_2,
    Y_k ~ Bernoulli(logistic(X_1^3 - 1)),

from the configuration's initial Gaussian mixture, by the diagonal-noise
Milstein scheme with the configuration's sub-steps per observation
interval.  Plain torch, in f64, on the device of the generator.
"""
import torch


def generate(model: dict, traffic: dict, generator: torch.Generator) -> dict:
    """``xs`` (T, B, 2) and ``ys`` (T, B, 1), T from the model and B
    from the traffic."""
    B, T = int(traffic["B"]), int(model["T"])
    sub = int(model["substeps"])
    dt = float(model["dt"]) / sub
    p = model["params"]
    dev, f64 = generator.device, torch.float64
    init = model["init"]
    means = torch.tensor(init["means"], dtype=f64, device=dev)
    chols = torch.linalg.cholesky(torch.tensor(init["covs"], dtype=f64, device=dev))
    cum = torch.cumsum(torch.tensor(init["weights"], dtype=f64, device=dev), 0)
    comp = torch.searchsorted(cum, torch.rand(B, generator=generator, dtype=f64, device=dev))
    comp = comp.clamp_max(means.shape[0] - 1)
    eps = torch.randn((B, 2), generator=generator, dtype=f64, device=dev)
    x = means[comp] + torch.einsum("bij,bj->bi", chols[comp], eps)
    rates = torch.tensor([-p["beta"], p["delta"]], dtype=f64, device=dev)
    offsets = torch.tensor([p["alpha"], -p["gamma"]], dtype=f64, device=dev)
    sigma = float(p["sigma"])
    xs = []
    for _ in range(T):
        dws = dt**0.5 * torch.randn((sub, B, 2), generator=generator, dtype=f64, device=dev)
        for dw in dws:
            drift = x * (x.flip(-1) * rates + offsets)
            x = x + drift * dt + sigma * x * dw + 0.5 * sigma**2 * x * (dw * dw - dt)
        xs.append(x)
    xs = torch.stack(xs)
    u = torch.rand(xs.shape[:-1], generator=generator, dtype=f64, device=dev)
    ys = (u < torch.sigmoid(xs[..., 0] ** 3 - 1.0)).to(f64)
    return {"xs": xs, "ys": ys[..., None]}
