"""Do the JAX package's f64 filter and the port lose the same trials?

The 2D prey–predator central-moment filter with the polynomial TME-2 at
order N over the model's full T=2000 steps loses some trials (their
moment vectors stop being realisable and the filter turns NaN).  This
script runs, on the CPU and from the same numpy observations:

1. the port's "fused" route (K3's or K2's plain version + f64 eigh) on
   every trial, to find the trials it loses and the step where each is
   lost;
2. on ``--pick`` lost and ``--pick`` kept trials: the JAX package's f64
   ``eigh_impl="refined"`` filter and the port's own "refined" route.

It prints one JSON line per trial and a summary line.  It imports both
packages, like the tests; it is not collected by pytest (a few minutes
of CPU at N=7).

    JAX_PLATFORMS=cpu python tests/nd_divergence_vs_jax.py --N 7 --trials 32 --pick 4

With ``--card`` it takes a GPU run's pass instead: the observations and
the trials the card kept, from the ``nd_fates_N7.npz`` that
``chip_smoke.py`` writes under ``chiprun_out/``.  Step 1 then runs on every
trial of that pass, and step 2 on the trials whose fate differs between
the card's kernel route and the CPU plain route (and ``--pick`` lost and
kept trials where both agree), to show whether JAX's f64 filter loses
them too (about half an hour of CPU at N=7, B=1024):

    JAX_PLATFORMS=cpu python tests/nd_divergence_vs_jax.py --card chiprun_out/nd_fates_N7.npz
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from mfs_tpu.models.multi_dims import prey_predator as j_prey_predator  # noqa: E402
from mfs_tpu.multi_dims import filtering as j_filtering  # noqa: E402
from mfs_tpu.multi_dims.multi_indices import (  # noqa: E402
    generate_graded_lexico_multi_indices as j_generate,
    gram_and_hankel_indices_graded_lexico as j_gram_inds,
)
from mfs_tpu.multi_dims.poly_tme import poly_tme_nd as j_poly_tme_nd  # noqa: E402
from mfs_tpu_torch.interop import nd_filter_inputs_from_numpy  # noqa: E402
from mfs_tpu_torch.models.multi_dims import prey_predator  # noqa: E402
from mfs_tpu_torch.multi_dims.filtering import moment_filter_nd_cms  # noqa: E402
from mfs_tpu_torch.multi_dims.poly_tme import poly_tme_nd  # noqa: E402


def first_nonfinite(means):
    """Per trial, the first step whose filtering mean is not finite
    (None if every step is finite): ``means (T, B, 2)``."""
    bad = ~np.isfinite(means).all(-1)
    return [int(np.argmax(bad[:, b])) if bad[:, b].any() else None for b in range(bad.shape[1])]


def port_filter(N, mis, inds, cms0, mean0, ys, impl):
    tm = prey_predator(mis, device="cpu")
    tp = poly_tme_nd(tm.drift, tm.dispersion, tm.dt, 2, mis, 2, 1, device="cpu")
    c0, m0, y = nd_filter_inputs_from_numpy(cms0, mean0, ys, device="cpu")
    _, means, nell = moment_filter_nd_cms(tp.cms, tp.mean, tm.measurement_cond_pdf, y,
                                          (mis, inds), c0, m0, eigh_impl=impl,
                                          predict_fn=tp.predict_cms)
    return means.numpy(), nell.numpy()


def jax_filter(mis, inds, cms0, mean0, ys):
    jm = j_prey_predator(mis)
    jp = j_poly_tme_nd(jm.drift, jm.dispersion, jm.dt, 2, mis, 2, 1)
    run = jax.jit(lambda c, m, y: j_filtering.moment_filter_nd_cms(
        jp.cms, jp.mean, jm.measurement_cond_pdf, y, (mis, inds), c, m,
        eigh_impl="refined", predict_fn=jp.predict_cms))
    _, means, nell = run(cms0, mean0, ys)
    return np.asarray(means), np.asarray(nell)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=7)
    ap.add_argument("--T", type=int, default=2000)
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--pick", type=int, default=4)
    ap.add_argument("--substeps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--card", help="a chip_smoke.py nd_fates_N<N>.npz: its pass, not a "
                                   "simulated one")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    card_kept = None
    if args.card:
        run = np.load(args.card)
        card_kept = run["kept"]
        args.N, args.substeps, args.seed = int(run["N"]), int(run["substeps"]), None
        ys = run["ys"][:args.T, :, None].astype(np.float64)
        args.T, args.trials = ys.shape[:2]
    N, B = args.N, args.trials

    mis = j_generate(2, 2 * N - 1)
    inds = np.asarray(j_gram_inds(N, 2))
    model = prey_predator(mis, device="cpu")
    if card_kept is None:
        _, xss, yss = model.simulate(torch.Generator().manual_seed(args.seed), B, args.substeps)
        ys = yss[:args.T].numpy()
    z = mis.shape[0]
    cms0 = np.broadcast_to(model.init_cond.cms.numpy(), (B, z)).copy()
    mean0 = np.broadcast_to(model.init_cond.mean.numpy(), (B, 2)).copy()

    t0 = time.perf_counter()
    f_means, f_nell = port_filter(N, mis, inds, cms0, mean0, ys, "fused")
    fused_s = time.perf_counter() - t0
    f_first = first_nonfinite(f_means)
    lost = [b for b in range(B) if f_first[b] is not None or not np.isfinite(f_nell[b])]
    kept = [b for b in range(B) if b not in lost]
    lost_all = list(lost)
    differ = []
    if card_kept is not None:
        differ = [b for b in range(B) if bool(card_kept[b]) == (b in lost)]
        lost = [b for b in lost if b not in differ]
        kept = [b for b in kept if b not in differ]
    sel = differ + lost[:args.pick] + kept[:args.pick]

    t0 = time.perf_counter()
    r_means, r_nell = port_filter(N, mis, inds, cms0[sel], mean0[sel], ys[:, sel], "refined")
    refined_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    j_means, j_nell = jax_filter(mis, inds, cms0[sel], mean0[sel], ys[:, sel])
    jax_s = time.perf_counter() - t0
    r_first, j_first = first_nonfinite(r_means), first_nonfinite(j_means)

    agree = 0
    for i, b in enumerate(sel):
        same = (f_first[b] is None) == (j_first[i] is None)
        agree += same
        rel = abs(f_nell[b] - j_nell[i]) / abs(j_nell[i]) if np.isfinite(j_nell[i]) else None
        card = {} if card_kept is None else {"card_kept": bool(card_kept[b]),
                                                 "card_and_plain_differ": b in differ}
        print(json.dumps({"trial": b, **card, "port_fused_lost_at": f_first[b],
                          "port_refined_lost_at": r_first[i], "jax_refined_lost_at": j_first[i],
                          "port_fused_nell": float(f_nell[b]), "jax_nell": float(j_nell[i]),
                          "nell_rel_gap": rel, "same_fate": bool(same)}), flush=True)
    card = {} if card_kept is None else {
        "card": args.card, "card_kept": int(card_kept.sum()), "card_and_plain_differ": differ,
        "differ_lost_in_jax": [b for i, b in enumerate(sel) if b in differ and j_first[i] is not None]}
    print(json.dumps({"N": N, "T": args.T, "trials": B, "substeps": args.substeps,
                      "seed": args.seed, **card,
                      "port_fused_finite_frac": (B - len(lost_all)) / B,
                      "lost_steps": sorted(f_first[b] for b in lost_all if f_first[b] is not None),
                      "checked": len(sel), "same_fate_in_jax": agree,
                      "seconds": {"port_fused": fused_s, "port_refined": refined_s,
                                  "jax_refined": jax_s}}), flush=True)


if __name__ == "__main__":
    main()
