"""The system under test for ``prey_predator``: the port's ND central
moment filter (``moment_filter_nd_cms``) with the polynomial TME's fused
prediction (``poly_tme_nd(...).predict_cms``) and the quadrature routed
by ``eigh_impl="auto"`` (K2 for s <= 10, nd_ldl + nd_ksolve + f64 eigh
above).  Only the port's public functions are called.
"""
import torch

import mfs_tpu_torch as port
import mfs_tpu_torch.multi_dims.filtering as filtering
from mfs_tpu_torch.multi_dims import (
    generate_graded_lexico_multi_indices,
    gram_and_hankel_indices_graded_lexico,
)

from roofline.work import quadrature_nd_work

D = 2


def _config_drift(x, p):
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([x1 * (p["alpha"] - p["beta"] * x2),
                        x2 * (p["delta"] * x1 - p["gamma"])], dim=-1)


class System:
    """One pass filters every trial of ``ys (T, B, 1)`` over all T steps."""

    def __init__(self, config: dict, traffic: dict, device, probes):
        model_cfg, filt = config["model"], config["filter"]
        self.N = int(traffic["N"])
        self.mis = generate_graded_lexico_multi_indices(D, 2 * self.N - 1)
        self.inds = gram_and_hankel_indices_graded_lexico(self.N, D)
        self.model = port.prey_predator(self.mis, device=device)
        probe = torch.tensor([[0.7, 1.3], [1.1, 0.9]], dtype=torch.float64, device=device)
        sigma = model_cfg["params"]["sigma"]
        if (self.model.dt != model_cfg["dt"]
                or not torch.allclose(self.model.drift(probe),
                                      _config_drift(probe, model_cfg["params"]), rtol=1e-15)
                or not torch.allclose(self.model.dispersion(probe),
                                      torch.diag_embed(sigma * probe), rtol=1e-15)):
            raise ValueError("the port's prey_predator differs from the configuration")
        self.poly = port.poly_tme_nd(self.model.drift, self.model.dispersion, self.model.dt,
                                     int(filt["tme_order"]), self.mis, 2, 1, device=device)
        self.eigh_impl = filt["eigh_impl"]
        self.probes = probes
        self.predict = probes.transition(self.poly.predict_cms)
        s = self.inds.shape[1]
        self.quadrature_site = (filtering, "moment_quadrature_nd",
                                lambda ms, *a, **k: quadrature_nd_work(
                                    s, D, ms.shape[-1], ms[..., 0].numel()))

    def _filter(self, ys):
        ic = self.model.init_cond
        b = ys.shape[1]
        cmss, means, nell = port.moment_filter_nd_cms(
            self.poly.cms, self.poly.mean, self.model.measurement_cond_pdf, ys,
            (self.mis, self.inds), ic.cms.expand(b, -1), ic.mean.expand(b, -1),
            eigh_impl=self.eigh_impl, predict_fn=self.predict)
        self.probes.count("filter_steps", ys.shape[0])
        return cmss[-1], means[-1], nell

    def run_pass(self, ys: torch.Tensor) -> dict:
        """``nell (B,)``, ``mean (B, 2)`` at the last step and ``finite
        (B,)``, every output of the trial finite."""
        cms, mean, nell = self._filter(ys)
        finite = (torch.isfinite(nell) & torch.isfinite(mean).all(-1)
                  & torch.isfinite(cms).all(-1))
        return {"nell": nell, "mean": mean, "finite": finite, "rerun": 0}

    def warm_up(self, ys: torch.Tensor, steps: int) -> None:
        self._filter(ys[:steps])
