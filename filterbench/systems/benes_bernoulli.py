"""The system under test for ``benes_bernoulli``: the port's central
moment filter (``moment_filter_cms``, TME Normal-closure transitions,
K1 through ``eigh_impl="auto"``) inside its divergence rescue
(``rescue_diverged``: tier 0 over the whole batch, then the
configuration's tiers on the trials still diverged, ``bucket`` trials a
call).  Only the port's public functions are called.
"""
import torch

import mfs_tpu_torch as port
import mfs_tpu_torch.one_dim.filtering as filtering

from roofline.work import quadrature_1d_work

OUTPUT_AXES = {"cms_last": 0, "mean_last": 0, "nell": 0}


def _finite(out):
    return (torch.isfinite(out["cms_last"]).all(-1) & torch.isfinite(out["mean_last"])
            & torch.isfinite(out["nell"]))


class System:
    """One pass filters every trial of ``ys (T, B)`` over all T steps."""

    def __init__(self, config: dict, traffic: dict, device, probes):
        model_cfg, filt = config["model"], config["filter"]
        self.N = int(traffic["N"])
        self.model = port.benes_bernoulli(N=self.N, device=device)
        if self.model.dt != model_cfg["dt"]:
            raise ValueError("the port's benes_bernoulli differs from the configuration")
        self.trans = port.sde_cond_moments_tme_normal(
            self.model.drift, self.model.dispersion, self.model.dt, int(filt["tme_order"]),
            self.N)
        self.probes = probes
        self.tier0 = self._runner(eigh_impl=filt["eigh_impl"])
        self.tiers = [self._runner(**tier) for tier in filt["rescue"]["tiers"]]
        self.bucket = int(filt["rescue"]["bucket"])
        # the module-level quadrature the filter loop calls, for the traced run's range
        self.quadrature_site = (filtering, "moment_quadrature",
                                lambda ms, *a, **k: quadrature_1d_work(ms.shape[-1] // 2,
                                                                       ms[..., 0].numel()))

    def _runner(self, **quad):
        ic, trans, probes = self.model.init_cond, self.trans, self.probes
        cms_fn, mean_fn = probes.transition(trans.cms), probes.transition(trans.mean)

        def run(y):
            b = y.shape[1]
            cmss, means, nell = port.moment_filter_cms(
                cms_fn, mean_fn, self.model.measurement_cond_pdf,
                ic.cms.expand(b, 2 * self.N), ic.mean.expand(b), y, **quad)
            probes.count("filter_steps", y.shape[0])
            return {"cms_last": cmss[-1], "mean_last": means[-1], "nell": nell}
        return run

    def run_pass(self, ys: torch.Tensor) -> dict:
        """``nell (B,)``, ``mean (B,)``, ``finite (B,)`` after the rescue;
        ``tier (B,)``, the tier that answered each trial (-1 where none
        kept it); ``rerun``, the trials handed to the rescue tiers; and
        ``rerun_idx``, the first bucket of those tier 1 took."""
        masks = []

        def finite_fn(out):
            mask = _finite(out)
            masks.append(mask)
            return mask

        merged, finite, _ = port.rescue_diverged(self.tier0, self.tiers, ys, finite_fn,
                                                 OUTPUT_AXES, bucket=self.bucket)
        tier = torch.where(masks[0], 0, -1)
        left, rerun = torch.nonzero(~masks[0])[:, 0], 0
        rerun_idx = left[:self.bucket].tolist()
        for k, mask in enumerate(masks[1:], start=1):
            rerun += left.numel()
            kept = mask[:left.numel()]
            tier[left[kept]] = k
            left = left[~kept]
        return {"nell": merged["nell"], "mean": merged["mean_last"],
                "finite": torch.as_tensor(finite, device=ys.device), "tier": tier,
                "rerun": rerun, "rerun_idx": rerun_idx}

    def warm_up(self, ys: torch.Tensor, steps: int) -> None:
        """The cell's own shapes: tier 0 on ``steps`` steps of the whole
        batch, each rescue tier on ``steps`` steps of one bucket."""
        self.tier0(ys[:steps])
        for tier in self.tiers:
            tier(ys[:steps, :self.bucket])
