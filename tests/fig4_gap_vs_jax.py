"""Fig 4's moment filter at N=15: port and JAX package on the same trials.

``chip_smoke.py``'s Fig-4 phase scores the port's N=15 central filter
(TME-3, K1, rescued) against the port's grid truth on trials from the
port's ``simulate_trials``, and holds it against the JAX package's row
in ``experiments/SUMMARY_benes_bernoulli.json``, which came from other
trials (JAX's PRNG, 100 simulation sub-steps, 55 rescued trials).  This
script asks whether a gap between the two rows is the data's or the
port's.  On the CPU and from the same numpy observations it runs:

1. both packages' grid truths (2,000 points on [-6, 6], Chapman TME-3,
   100 substeps, as the smoke run and ``experiments/compute_errors.py``);
2. the port's filter as the card runs it (``eigh_impl="pallas"``: K1's
   plain version here, rescued by the jittered and the f64 tiers), the
   port's f64 ``"refined"`` route, and the JAX package's f64
   ``"refined"`` route (its CPU route: the Pallas kernel's interpret
   mode is too slow at N=15);
3. each filter scored against its own package's truth: the mean's
   absolute error and the CF's sup distance on z in [-2, 2], over the
   trials finite in both packages' filters and every step.

It prints one JSON line per filter and a summary line with the relative
gaps of the port's rows to JAX's.  It imports both packages, like the
tests; it is not collected by pytest (about 3 minutes at the
smoke run's 1,000 trials on 4 CPU threads).

    JAX_PLATFORMS=cpu python tests/fig4_gap_vs_jax.py --trials 1000
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from experiments.compute_errors import brute_force_truth as j_truth  # noqa: E402
from experiments.compute_errors import cf_errors_chunked as j_cf_errors  # noqa: E402
from mfs_tpu.models import benes_bernoulli as j_benes_bernoulli  # noqa: E402
from mfs_tpu.one_dim.filtering import moment_filter_cms as j_filter_cms  # noqa: E402
from mfs_tpu.sde import sde_cond_moments_tme_normal as j_tme_normal  # noqa: E402
from mfs_tpu_torch.models.one_dim import benes_bernoulli  # noqa: E402
from mfs_tpu_torch.parallel.ensemble import rescue_diverged  # noqa: E402

N = 15


def observations(trials, substeps):
    """The smoke run's Fig-4 data on the CPU: ``simulate_trials`` (seed
    ``FIG4_SEED``) and ``fig4_measurements``; ys (T, B) as numpy."""
    model = benes_bernoulli(N=2, device="cpu")
    ids = np.arange(trials)
    xss = model.simulate_trials(chip_smoke.FIG4_SEED, ids, substeps)
    return chip_smoke.fig4_measurements(chip_smoke.FIG4_SEED, ids, model.emission(xss)).T.numpy()


def port_moment(ys, impl):
    """The port's central filter at N=15, TME-3; "pallas" rescued as on
    the card.  Returns (cmss (T, B, 2N), means (T, B), finite (B,))."""
    model, trans = chip_smoke.fig4_moment_setup(N, "cpu")
    y = torch.as_tensor(ys)
    if impl == "pallas":
        tiers = [chip_smoke.fig4_runner(model, trans, eigh_impl="pallas",
                                        quad_jitter=chip_smoke.TIER1_JITTER),
                 chip_smoke.fig4_runner(model, trans, stable=True, eigh_impl="xla")]
        out, finite, _ = rescue_diverged(
            chip_smoke.fig4_runner(model, trans, eigh_impl="pallas"), tiers, y,
            chip_smoke.fig4_finite, {"cmss": 1, "means": 1, "nell": 0},
            bucket=chip_smoke.TIER1_BUCKET)
    else:
        out = chip_smoke.fig4_runner(model, trans, stable=True, eigh_impl=impl)(y)
        finite = chip_smoke.fig4_finite(out).numpy()
    return out["cmss"], out["means"], np.asarray(finite)


def jax_moment(ys):
    """The JAX package's central filter at N=15, TME-3, f64 "refined"."""
    model = j_benes_bernoulli(N=N)
    trans = j_tme_normal(model.drift, model.dispersion, model.dt, chip_smoke.FIG4_TME_ORDER, N)
    ic = model.init_cond
    B = ys.shape[1]
    run = jax.jit(lambda c0, y: j_filter_cms(
        trans.cms, trans.mean, model.measurement_cond_pdf, c0, ic.mean * jnp.ones(B), y,
        stable=True, eigh_impl="refined"))
    cmss, means, nell = run(jnp.broadcast_to(ic.cms, (B, 2 * N)), jnp.asarray(ys))
    cmss, means = np.asarray(cmss), np.asarray(means)
    finite = np.isfinite(cmss).all(axis=(0, 2)) & np.isfinite(means).all(0) & np.isfinite(
        np.asarray(nell))
    return cmss, means, finite


def scores(sup, est_means, true_means, keep):
    """Mean CF sup distance and mean absolute mean error over the kept
    trials and every step; ``sup``, means (B, T)."""
    return dict(cf_sup=float(np.mean(sup[keep])),
                mean_abs_err=float(np.mean(np.abs(est_means - true_means)[keep])))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=chip_smoke.FIG4_B)
    p.add_argument("--substeps", type=int, default=chip_smoke.FIG4_SUBSTEPS,
                   help="TME-3 sub-steps of the simulation (the smoke run's)")
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    ys = observations(args.trials, args.substeps)
    zs = np.linspace(-2.0, 2.0, chip_smoke.FIG4_Z)
    zs_t = torch.as_tensor(zs)

    pss, xs_grid = chip_smoke.fig4_truth(torch.as_tensor(ys))  # (T, B, grid)
    re_t, im_t, means_t = (a.transpose(0, 1) for a in chip_smoke.true_cf(pss, xs_grid, zs_t))
    j_pss, j_xs = j_truth(jnp.asarray(ys.T), grid_n=chip_smoke.FIG4_GRID,
                         substeps=chip_smoke.FIG4_GRID_SUBSTEPS)  # (B, T, grid)
    tw = np.full(j_xs.shape, float(j_xs[1] - j_xs[0]))
    tw[[0, -1]] *= 0.5
    j_means_t = np.einsum("btg,g->bt", np.asarray(j_pss), np.asarray(j_xs) * tw)
    truth_gap = float(np.abs(j_means_t - means_t.numpy()).max())
    print(json.dumps({"truth": "grid", "trials": args.trials, "max_abs_gap_means": truth_gap,
                      "seconds": time.perf_counter() - t0}), flush=True)

    rows, finite = {}, {}
    for impl in ("pallas", "refined"):
        t1 = time.perf_counter()
        cmss, means, fin = port_moment(ys, impl)
        sup = chip_smoke.cf_distances(chip_smoke.moment_cf(cmss, zs_t, means), (re_t, im_t),
                                      zs_t)[0]
        rows[f"port_{impl}"] = (sup.numpy(), means.T.numpy(), means_t.numpy(),
                                time.perf_counter() - t1)
        finite[f"port_{impl}"] = fin
    t1 = time.perf_counter()
    cmss, means, fin = jax_moment(ys)
    sup = np.asarray(j_cf_errors(jnp.asarray(cmss), j_pss, j_xs, jnp.asarray(zs),
                                 mean=jnp.asarray(means))[0])
    rows["jax_refined"] = (sup, means.T, j_means_t, time.perf_counter() - t1)
    finite["jax_refined"] = fin

    keep = np.logical_and.reduce(list(finite.values()))
    out = {}
    for name, (sup, est, true, secs) in rows.items():
        out[name] = scores(sup, est, true, keep)
        print(json.dumps({"filter": name, "N": N, "trials_finite": int(finite[name].sum()),
                          "trials_scored": int(keep.sum()), **out[name], "seconds": secs}),
              flush=True)
    rel = {f"{name}_vs_jax_{k}": out[name][k] / out["jax_refined"][k] - 1
           for name in ("port_pallas", "port_refined") for k in ("mean_abs_err", "cf_sup")}
    print(json.dumps({"summary": "fig4_N15_same_trials", "trials": args.trials,
                      "substeps": args.substeps, **rel,
                      "within_5_percent": all(abs(v) <= 0.05 for v in rel.values()),
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
