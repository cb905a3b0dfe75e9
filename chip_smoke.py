"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths and holds every CUDA kernel on them against its
plain PyTorch version:

- 1D: the Beneš–Bernoulli N=15 central-moment filter, T=100, B=4096,
  TME-2 Normal-closure transitions, with the divergence rescue (tier 1:
  the same filter with Gram jitter 1e-8 in 512-trial buckets; tier 2:
  the f64 ``stable=True`` LAPACK path on the card), through K1
  (``csrc/quadrature_1d.cu``) and the Bayes update's kernel
  (``csrc/posterior_1d.cu``, timed at n = 15, B = 524,288);
- ND: the 2D prey–predator central-moment filter with the polynomial
  TME-2, B=1024, at N=7 (T=2000) and N=11 (T=25) through nd_ldl +
  nd_ksolve + cuSOLVER eigh and at N=3 (T=2000) through K2
  (``csrc/quadrature_nd.cu``), with 64, 64 and 16 trials re-run
  on the CPU through the plain versions in worker processes;
- the scaled-central filters: the 1D main path's data through
  ``moment_filter_scms`` (K1) and prey–predator through
  ``moment_filter_nd_scms`` at N=3 (K2) and N=7 (the pair), each beside
  the central filter and re-run in part on the CPU;
- the 3D food chain (``experiments/lotka_volterra_3d.py``): the central
  filter at N=2, 3 (K2 at d=3) and N=4 (the pair at d=3, s=20), B=1024,
  through "auto" and "refined", beside the Gauss–Hermite filter and the
  EKF on the same trials, with 16 trials re-run on the CPU;
- MLE: the Well–Poisson maximum likelihood of
  ``experiments/parameter_estimation.py`` (N=4, B=1000 trials, T=1000):
  one batched gradient through K1's forward and its implicit-function
  backward, and ``lbfgs_batched`` steps at full width, with 8 trials
  re-run on the CPU through the plain version in a worker process;
- trial sharding, FLOP accounting and profiling: the 1D main path's
  tier 0 through ``run_ensemble_filter`` and the MLE gradient through
  ``sharded_nell_grad`` on a one-rank NCCL mesh, each held against its
  unsharded result; ``count_flops`` of a main-path pass and of two ND
  steps at N=3 and N=7, each kernel's count held to its launches; and
  ``timed`` and ``trace`` around the main path;
- Fig 4: the paper's method comparison on 1,000 Beneš–Bernoulli trials
  (``experiments/method_comparison.py``, ``compute_errors.py``): the
  grid truth, K1's moment filter at N = 3, 5, 8, 11, 15 (TME-3,
  rescued), the Gauss–Hermite filter and the bootstrap particle filter
  (``mfs_tpu_torch.filters``), each scored against the truth, with the
  truth, the moment filters and the GHF re-run on the CPU for a few
  trials;
- the convergence study (``experiments/convergence.py``): 10,000 OU /
  Matérn-1/2 trials, K1's central and raw filters at N = 2, ..., 15
  against the exact Kalman filter, the central filter through the
  in-repo Jacobi eigensolver and the quadrature-free Taylor filter, the
  particle-filter foil at 100, 1,000 and 10,000 particles, and the
  posterior Cramér–Rao bound, with 64 trials re-run on the CPU;
- the density recovery (``examples/benes_bernoulli_demo.py``): Fig 4's
  N=8 and N=15 filter states at ten steps turned into Gram–Charlier,
  Edgeworth, saddle-point and inverse-Fourier densities, scored against
  the grid truth, with 8 trials' densities re-run on the CPU.

    python3 chip_smoke.py

The first line is the card's name and power limit as ``nvidia-smi``
gives them; then each phase prints one JSON line, and any failure raises
and exits non-zero.  The line before the last lists the kernels, the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU and ``nvcc``
(``/usr/local/cuda/bin`` or on ``PATH``); imports nothing of JAX.
"""
import contextlib
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mfs_tpu_torch.ops.flops import k1_flops, k2_flops, ksolve_flops, ldl_flops, post1d_flops
from mfs_tpu_torch.utils import profiling

N = 15
T = 100
BATCH = 4096
TIER1_BUCKET = 512
TIER1_JITTER = 1e-8
CPU_SUBSET = 256
FORCED_LOST = 600  # > one tier-1 bucket: the forced rescue runs two
# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; FP64 at 34 TFLOP/s
# outside the tensor cores and 67 TFLOP/s on them (an FMA counts as two
# operations).  K1 (scalar recurrences) and K2 (2x2 rotations) are held
# to the first rate.  The K-builder pair (nd_ldl, nd_ksolve) is held to
# the second: a blocked LDL and blocked triangular solves put nearly all
# their operations in FP64 matrix products, which the tensor cores run.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12
FP64_TC_FLOP_PER_S = 67e12
SPIN_CYCLES = 200_000_000  # ~0.1 s at the H100's ~1.98 GHz boost clock


# The registry's launch counter of each hand-written kernel, by the name
# the smoke's lines give it.
KERNEL_COUNTERS = {"K1": "k1", "K2": "nd_eigh", "nd_ldl": "nd_ldl", "nd_ksolve": "nd_ksolve",
                   "post1d": "post1d"}
POST1D_BATCH = 524_288  # the benchmark's Beneš cell


def emit(phase, **fields):
    """One JSON line.  ``eigh_masked``: matrices the f64 eigh route
    (``ops/eigh.py``, behind "xla"/"refined", rescue tier 2 and the ND
    routes after the K-builder) returned NaN because cuSOLVER did not
    converge on them, since the smoke started (the counter
    ``eigh.nonconverged``)."""
    masked = profiling.counters().get("eigh.nonconverged", 0)
    print(json.dumps({"phase": phase, **fields, "eigh_masked": masked}), flush=True)


def kernel_launches(before=None):
    """Launches of each hand-written kernel (``KERNEL_COUNTERS``) counted by
    the registry, less ``before``'s (an earlier return of this function)."""
    counts = profiling.counters()
    now = {k: counts.get("kernel.launches." + c, 0) for k, c in KERNEL_COUNTERS.items()}
    return now if before is None else {k: v - before[k] for k, v in now.items()}


def cuda_ms(fn, reps, warmup=2):
    """Mean device time per call, by CUDA events around ``reps`` calls.
    A spin kernel (~0.1 s) queued before the start event keeps the card
    busy while the calls are enqueued, so a kernel shorter than its
    wrapper's host time is timed back to back, not at the host's enqueue
    rate (a host-bound version is still timed at its own pace)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mixture_moments(n, B, rng, regime, device):
    from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    if regime == "raw":
        m, v = t(rng.randn(B) * 0.3), t(0.5 + rng.rand(B))
        return 0.6 * normal_raw_moments_all(m, v, 2 * n) + 0.4 * normal_raw_moments_all(
            m + 0.3, v * 0.8, 2 * n)
    # the filter's regime: central moments of a symmetric two-Gaussian
    # mixture of unit variance
    a = t(0.3 + 0.2 * rng.rand(B))
    return 0.5 * normal_raw_moments_all(-a, 1 - a * a, 2 * n) + 0.5 * normal_raw_moments_all(
        a, 1 - a * a, 2 * n)


def moment_residual(w, x, ms, mean, scale):
    """Per trial: max over orders p of |sum_k w_k lam_k^p - m_p| relative
    to sum_k w_k |lam_k|^p, in the rule's own frame lam = (x - mean)/scale."""
    lam = (x - mean[:, None]) / scale[:, None]
    powers = lam[..., None] ** torch.arange(ms.shape[-1], device=lam.device)
    got = torch.einsum("bk,bkp->bp", w, powers)
    denom = torch.einsum("bk,bkp->bp", w.abs(), powers.abs())
    return ((got - ms).abs() / denom).amax(-1)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: this run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def _ptxas(log):
    return [ln.strip() for ln in log.splitlines()
            if "Function properties" in ln or "Used" in ln or "stack" in ln]


def phase_build():
    """The three kernel sources, one nvcc each, started together; a library
    already built from the same source is reused, and its ptxas report
    (each kernel's registers, stack, spills and static shared memory) is
    read from the log saved beside it.  nd_ksolve's shared memory is
    dynamic: ``nd_timing`` gives its layout and occupancy."""
    from mfs_tpu_torch.ops import build
    names = ("quadrature_1d", "posterior_1d", "quadrature_nd")
    t0 = time.perf_counter()
    logs = build.build(names)
    seconds = time.perf_counter() - t0
    emit("build", seconds=seconds, cached=[n for n in names if n not in logs],
         ptxas={n: _ptxas(logs.get(n) or build.saved_log(n)) for n in names})


def phase_eigh_batch_limit():
    """cuSOLVER's batched f64 eigh (``torch.linalg.eigh``) on ``EIGH_CHUNK``
    and on twice as many random symmetric 15 x 15 matrices: the first must
    go through in one call, since the port's f64 route
    (``ops/eigh.py::_eigh_f64``) cuts every batch to that size; whether
    the library takes the second is reported."""
    from mfs_tpu_torch.ops.eigh import EIGH_CHUNK
    gen = torch.Generator(device="cuda").manual_seed(0)
    taken = {}
    for B in (EIGH_CHUNK, 2 * EIGH_CHUNK):
        a = torch.randn(B, 15, 15, generator=gen, dtype=torch.float64, device="cuda")
        try:
            torch.linalg.eigh(a + a.mT)
            taken[B] = True
        except torch.linalg.LinAlgError as e:
            taken[B] = str(e)[:160]
    emit("eigh_batch_limit", n=15, **{f"B_{B}": v for B, v in taken.items()})
    if taken[EIGH_CHUNK] is not True:
        raise AssertionError(f"cuSOLVER refuses EIGH_CHUNK = {EIGH_CHUNK} matrices a call")


def phase_kernel_vs_plain():
    """K1 against its plain version on the card, at n in {3, 8, 15, 32},
    B in {1, 513, 4096} (513: the ragged block edge), jitter in {0, 1e-8}.

    Bounds (max abs over both-finite trials):
    - n <= 8, well conditioned: nodes 5e-12, weights 5e-8 — the JAX
      kernel tests' bounds against the f64 path (upper bounds here).
    - n = 15, the filter's regime: nodes 1e-9, weights 1e-10.  The
      kernel contracts a*b+c to FMA and the plain version does not; the
      equilibrated Hankel's conditioning (~1e4 here) amplifies that
      last-bit difference through 32 bisection + 8 Newton steps.
    - n = 32 with jitter 1e-8: nodes 1e-6, weights 1e-7 (the jitter
      bounds the equilibrated Gram's condition near 1e8).
    - n = 32 without jitter: the Gram's condition exceeds 1/eps(f64),
      so the rule is not determined by the data to better than ~1e-3
      and the two versions' node gap is reported, not bounded.  Both
      rules must then reproduce the moments equally well: kernel
      residual <= 10 x plain residual + 1e-12.
    In every case at least 99% of trials must agree on finiteness.
    """
    from mfs_tpu_torch.ops import quadrature_kernel as qk
    rng = np.random.RandomState(0)
    dev = "cuda"
    for n in (3, 8, 15, 32):
        for B in (1, 513, 4096):
            ms = mixture_moments(n, B, rng, "raw" if n <= 8 else "filter", dev)
            mean = torch.as_tensor(rng.randn(B), device=dev)
            scale = torch.as_tensor(0.5 + rng.rand(B), device=dev)
            for jitter in (0.0, 1e-8):
                w, x = qk.moment_quadrature_fused(ms, mean, scale, jitter)
                torch.cuda.synchronize()
                wp, xp = qk.moment_quadrature_fused_plain(ms, mean, scale, jitter)
                fin = torch.isfinite(w).all(-1) & torch.isfinite(x).all(-1)
                finp = torch.isfinite(wp).all(-1) & torch.isfinite(xp).all(-1)
                both = fin & finp
                disagree = (fin != finp).double().mean().item()
                dx = (x - xp)[both].abs().max().item() if both.any() else 0.0
                dw = (w - wp)[both].abs().max().item() if both.any() else 0.0
                res_k = moment_residual(w, x, ms, mean, scale)[both].max().item()
                res_p = moment_residual(wp, xp, ms, mean, scale)[both].max().item()
                emit("kernel_vs_plain", n=n, B=B, jitter=jitter, max_node_err=dx,
                     max_weight_err=dw, moment_residual_kernel=res_k,
                     moment_residual_plain=res_p, finite_disagree_frac=disagree,
                     finite_frac=fin.double().mean().item())
                if n <= 8:
                    ok = dx < 5e-12 and dw < 5e-8
                elif n == 15:
                    ok = dx < 1e-9 and dw < 1e-10
                elif jitter:
                    ok = dx < 1e-6 and dw < 1e-7
                else:
                    ok = res_k <= 10 * res_p + 1e-12
                if not (ok and disagree <= 0.01):
                    raise AssertionError(f"K1 disagrees with its plain version at n={n} "
                                         f"B={B} jitter={jitter}")


def main_path_inputs(model, trans):
    """Moment vectors the main path hands K1: the filter state after 10
    of its steps at B = 4096 (central moments, their means)."""
    from mfs_tpu_torch.one_dim.filtering import moment_filter_cms
    gen = torch.Generator(device="cuda").manual_seed(1)
    ys = torch.bernoulli(torch.full((10, BATCH), 0.5, dtype=torch.float64, device="cuda"),
                         generator=gen)
    ic = model.init_cond
    cmss, means, _ = moment_filter_cms(
        trans.cms, trans.mean, model.measurement_cond_pdf,
        ic.cms.expand(BATCH, 2 * N), ic.mean.expand(BATCH), ys, eigh_impl="fused")
    ok = torch.isfinite(cmss[-1]).all(-1) & torch.isfinite(means[-1])
    return cmss[-1][ok].contiguous(), means[-1][ok].contiguous()


def phase_timing(model, trans):
    """K1 at the main path's shape (n = 15, B = 4096) and at a rescue
    bucket's (B = 512, the first 512 of the same inputs) against its
    plain version and the f64 library pipeline, on the same inputs.
    Returns the rows by batch, the main path's first."""
    ms, mean = main_path_inputs(model, trans)
    return [k1_timing(ms[:B], mean[:B]) for B in (BATCH, TIER1_BUCKET)]


def k1_timing(ms, mean, zs=None):
    """K1 against its plain version and the f64 library yardstick on the
    same inputs, with its bound.  The two versions' nodes and weights
    must agree to 1e-9; with ``zs`` (Fig 4's scoring inputs and the
    convergence study's N=15 states, where a rule may carry nodes of tiny
    weight that the moments do not place, so those nodes and the nodes'
    order can differ) the rules are held as measures instead: their
    characteristic functions on ``zs`` within 1e-12, the elementwise gap
    reported."""
    from mfs_tpu_torch.ops import quadrature_kernel as qk
    B, n = ms.shape[0], ms.shape[-1] // 2
    scale = torch.ones_like(mean)
    w, x = qk.moment_quadrature_fused(ms, mean, scale)
    torch.cuda.synchronize()
    wp, xp = qk.moment_quadrature_fused_plain(ms, mean, scale)
    both = torch.isfinite(w).all(-1) & torch.isfinite(x).all(-1) & \
        torch.isfinite(wp).all(-1) & torch.isfinite(xp).all(-1)
    err = max((x - xp)[both].abs().max().item(), (w - wp)[both].abs().max().item())
    extra = {}
    if zs is None:
        if not err < 1e-9:
            raise AssertionError(f"K1 disagrees with its plain version on main-path inputs: {err}")
    else:
        gap = ((x - xp).abs().amax(-1) > 1e-9) | ((w - wp).abs().amax(-1) > 1e-10)
        sup = cf_distances(rule_cf(w[both], x[both], zs), rule_cf(wp[both], xp[both], zs), zs)[0]
        extra = dict(max_abs_err_cf=sup.max().item(), trials_beyond_1e_9=int((gap & both).sum()))
        if not extra["max_abs_err_cf"] <= 1e-12:
            raise AssertionError(f"K1's rules differ from its plain version's as measures: {extra}")

    ms_k = cuda_ms(lambda: qk.moment_quadrature_fused(ms, mean, scale), reps=20)
    plain_k = cuda_ms(lambda: qk.moment_quadrature_fused_plain(ms, mean, scale), reps=3, warmup=1)

    g = torch.as_tensor(np.add.outer(np.arange(n), np.arange(n)), device="cuda")

    def library_path():
        # cholesky + 2 triangular solves + eigh: a multi-call yardstick,
        # no single PyTorch call computes K1's function.  The eigh is the
        # port's f64 route (``eigh_xla``), which takes any batch.
        from mfs_tpu_torch.ops.eigh import eigh_xla
        R, _ = torch.linalg.cholesky_ex(ms[:, g])
        X = torch.linalg.solve_triangular(R, ms[:, g + 1], upper=False)
        K = torch.linalg.solve_triangular(R.mT, X, upper=True, left=False)
        return eigh_xla(0.5 * (K + K.mT))
    lib_k = cuda_ms(library_path, reps=3, warmup=1)

    ops, divs = k1_flops(n)
    nbytes = (4 * n + 2) * 8 * B
    bound = max(nbytes / HBM_BYTES_PER_S, ops * B / FP64_FLOP_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S > ops * B / FP64_FLOP_PER_S else "operations"
    emit("timing", n=n, B=B, kernel_ms=ms_k, plain_ms=plain_k, f64_library_path_ms=lib_k,
         f64_library_path_note="cholesky_ex + 2 solve_triangular + eigh, multi-call yardstick",
         bound_ms=bound, bound_by=bound_by, fp64_ops_per_trial=ops,
         fp64_divisions_per_trial=divs, bytes=nbytes, max_abs_err=err, **extra)
    return dict(n=n, B=B, ms=ms_k, plain_ms=plain_k, bound_ms=bound, bound_by=bound_by,
                max_abs_err=err, **extra)


def phase_post1d_timing(model, trans):
    """The 1D Bayes update's kernel (``csrc/posterior_1d.cu``, central
    mode) at n = 15, B = 524,288: K1's rule of the main path's states,
    tiled, in K1's layout, and the likelihood at its nodes.  Against its
    plain version on the same inputs: every output finite where the
    plain one is, and within 1e-12 of the size of the terms it sums:
    moment j of sum_k |u_k|^j wp_k / pdf_y, the mean of sum_k |x_k| wp_k
    / pdf_y, pdf_y of itself.  Bound: its bytes, 3 n doubles read and 2N + 2
    written a trial."""
    from mfs_tpu_torch.ops import posterior_kernel as pk
    from mfs_tpu_torch.ops import quadrature_kernel as qk
    ms, mean = main_path_inputs(model, trans)
    reps = -(-POST1D_BATCH // ms.shape[0])
    ms, mean = ms.repeat(reps, 1)[:POST1D_BATCH], mean.repeat(reps)[:POST1D_BATCH]
    w, x = qk.moment_quadrature_fused(ms, mean, 1.0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    ys = torch.bernoulli(torch.full((POST1D_BATCH,), 0.5, dtype=torch.float64, device="cuda"),
                         generator=gen)
    p = model.measurement_cond_pdf(ys[:, None], x)
    B, n = x.shape
    launched_before = kernel_launches()
    got = pk.posterior_moments_1d(x, w, p, "central")
    torch.cuda.synchronize()
    want = pk.posterior_moments_1d_plain(x, w, p, "central", 2 * n)
    sizes = [pk.posterior_moments_1d_plain((x - want[1][:, None]).abs(), w, p, "raw", 2 * n)[0],
             pk.posterior_moments_1d_plain(x.abs(), w, p, "raw", 2)[0][:, 1], want[2].abs()]
    if not all(torch.equal(torch.isfinite(g), torch.isfinite(h)) for g, h in zip(got, want)):
        raise AssertionError("the posterior kernel's finite outputs differ from the plain version's")
    err = max(((g - h).abs() / z.clamp_min(1e-300))[torch.isfinite(h)].max().item()
              for g, h, z in zip(got, want, sizes))
    if not err <= 1e-12:
        raise AssertionError(f"the posterior kernel disagrees with its plain version: {err}")
    kernel_ms = cuda_ms(lambda: pk.posterior_moments_1d(x, w, p, "central"), reps=20)
    plain_ms = cuda_ms(lambda: pk.posterior_moments_1d_plain(x, w, p, "central", 2 * n), reps=3,
                       warmup=1)
    timed_launches = kernel_launches(launched_before)["post1d"]
    nbytes = (3 * n + 2 * n + 2) * 8 * B
    ops = post1d_flops(n, 2 * n, "central")
    bound = max(nbytes / HBM_BYTES_PER_S, ops * B / FP64_FLOP_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S > ops * B / FP64_FLOP_PER_S else "operations"
    emit("post1d_timing", n=n, B=B, mode="central", kernel_ms=kernel_ms, plain_ms=plain_ms,
         bound_ms=bound, bound_by=bound_by, bound_share=bound / kernel_ms, bytes=nbytes,
         fp64_ops_per_trial=ops, max_rel_err=err, launches=timed_launches)
    return dict(n=n, B=B, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                max_abs_err=err, timed_launches=timed_launches)


def make_runners(model, trans):
    """The rescue pipeline's three filter runners: ys (T, b) -> outputs."""
    from mfs_tpu_torch.one_dim.filtering import moment_filter_cms
    ic = model.init_cond

    def runner(**kw):
        def run(y):
            b = y.shape[1]
            cmss, _, nell = moment_filter_cms(
                trans.cms, trans.mean, model.measurement_cond_pdf,
                ic.cms.expand(b, 2 * N), ic.mean.expand(b), y, **kw)
            return {"cms_last": cmss[-1], "nell": nell}
        return run

    return (runner(eigh_impl="fused"),
            runner(eigh_impl="fused", quad_jitter=TIER1_JITTER),
            runner(stable=True, eigh_impl="xla"))


def finite_mask(out):
    return torch.isfinite(out["cms_last"]).all(-1) & torch.isfinite(out["nell"])


def phase_main_path(model, trans, smi):
    """The rescued N=15 pipeline on the card, counted launches and all."""
    from mfs_tpu_torch.parallel.ensemble import rescue_diverged

    # Measurements from 8 simulated paths tiled over the batch, as the
    # JAX package's benchmark makes them.  TME-3 over dt = 0.01 needs no
    # sub-stepping, and each eager TME-3 step costs ~0.2 s of host time,
    # so the paths are simulated with one sub-step, not 100.
    gen = torch.Generator(device="cuda").manual_seed(0)
    xss = model.simulate(gen, 8, integration_steps=1)  # (8, T)
    probs = model.emission(xss.repeat(BATCH // 8 + 1, 1)[:BATCH])
    ys = torch.bernoulli(probs, generator=gen).T.contiguous()  # (T, BATCH)
    tier0, tier1, tier2 = make_runners(model, trans)
    masks, tier0_out = [], {}

    def run_fast(y):
        out = tier0(y)
        tier0_out.update(out)
        return out

    def finite_fn(out):
        mask = finite_mask(out)
        masks.append(mask.cpu().numpy())
        return mask

    launched_before = kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged, finite, rescued = rescue_diverged(
        run_fast, [tier1, tier2], ys, finite_fn, {"cms_last": 0, "nell": 0},
        bucket=TIER1_BUCKET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = kernel_launches(launched_before)
    launches, post1d_launches = launched["K1"], launched["post1d"]

    lost = int((~masks[0]).sum())
    per_tier = []
    for mask in masks[1:]:
        per_tier.append(int(mask[:lost].sum()))
        lost -= per_tier[-1]
    buckets1 = -(-int((~masks[0]).sum()) // TIER1_BUCKET)
    # Tier 2 runs, in buckets, on what tier 1 lost; it takes no K1.
    buckets2 = -(-(int((~masks[0]).sum()) - per_tier[0]) // TIER1_BUCKET) if len(masks) > 2 else 0
    finite0 = float(masks[0].mean())
    final = float(finite.mean())
    emit("main_path", N=N, T=T, B=BATCH, finite_frac_tier0=finite0,
         finite_frac_rescued=final, rescued_tier1=per_tier[0] if per_tier else 0,
         rescued_tier2=per_tier[1] if len(per_tier) > 1 else 0, rescued_total=rescued,
         tier1_buckets=buckets1, tier2_buckets=buckets2, k1_launches=launches,
         post1d_launches=post1d_launches, wall_s=wall, trials_per_s=BATCH / wall, card=smi)
    if launches != 2 * T * (1 + buckets1) or launches == 0:
        raise AssertionError(f"K1 launched {launches} times, expected {2 * T * (1 + buckets1)}")
    # One Bayes update a filter step, in every tier.
    if post1d_launches != T * (1 + buckets1 + buckets2):
        raise AssertionError(f"the posterior kernel launched {post1d_launches} times, expected "
                             f"{T * (1 + buckets1 + buckets2)}")
    if merged["nell"].shape != (BATCH,) or merged["cms_last"].shape != (BATCH, 2 * N):
        raise AssertionError("main-path outputs have the wrong shape")
    if not (final > 0.93 and final >= finite0):
        raise AssertionError(f"finite_frac {final} (tier 0: {finite0})")
    return launches, post1d_launches, ys, tier0_out


def phase_rescue_tiers(model, trans, ys, tier0_out):
    """Both rescue tiers on the card on one 512-trial bucket (the first
    trials), whether or not tier 0 lost any, held against tier 0's nell.

    Tier 2 (f64 Cholesky/LDL + cuSOLVER eigh, no jitter) computes the
    same filter as tier 0 by another route: nell within 1e-6 relative
    on >= 99% of the trials finite in both.  Tier 1's jitter changes the
    rule by O(1e-8 x conditioning), so its gap is reported, and it must
    keep every trial tier 0 keeps."""
    _, tier1, tier2 = make_runners(model, trans)
    sub = ys[:, :TIER1_BUCKET]
    ref = tier0_out["nell"][:TIER1_BUCKET]
    fin0 = torch.isfinite(ref)
    fields, kept = {}, {}
    for name, tier in (("tier1", tier1), ("tier2", tier2)):
        t0 = time.perf_counter()
        out = tier(sub)
        torch.cuda.synchronize()
        fin = kept[name] = finite_mask(out)
        both = fin & fin0
        rel = ((out["nell"] - ref).abs() / ref.abs())[both]
        fields[name] = dict(seconds=time.perf_counter() - t0,
                            finite_frac=fin.double().mean().item(),
                            max_rel_gap=rel.max().item(),
                            median_rel_gap=rel.median().item(),
                            share_below_1e_6=(rel < 1e-6).double().mean().item())
    emit("rescue_tiers", trials=TIER1_BUCKET, tier0_finite_frac=fin0.double().mean().item(),
         **fields)
    if not bool((kept["tier1"] | ~fin0).all()):
        raise AssertionError("tier 1 lost a trial that tier 0 keeps")
    if fields["tier2"]["share_below_1e_6"] < 0.99:
        raise AssertionError("tier 2 and tier 0 disagree on nell")


def phase_forced_rescue(model, trans, ys):
    """``rescue_diverged`` on the card with the main path's runners and
    the first FORCED_LOST trials of tier 0 marked lost, so that tier 1
    runs in two 512-trial buckets: K1 must launch 2T x (1 + 2) times, the
    spliced nell must be tier 1's own and every other trial tier 0's."""
    from mfs_tpu_torch.parallel.ensemble import rescue_diverged
    tier0, tier1, tier2 = make_runners(model, trans)
    outs = []

    def finite_fn(out):
        mask = finite_mask(out)
        if not outs:  # tier 0's output
            mask = mask.clone()
            mask[:FORCED_LOST] = False
        outs.append(out)
        return mask

    launched_before = kernel_launches()
    t0 = time.perf_counter()
    merged, finite, rescued = rescue_diverged(
        tier0, [tier1, tier2], ys, finite_fn, {"cms_last": 0, "nell": 0},
        bucket=TIER1_BUCKET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(launched_before)["K1"]
    buckets1 = -(-FORCED_LOST // TIER1_BUCKET)
    out0, out1 = outs[0], outs[1]
    kept1 = finite_mask(out1)[:FORCED_LOST]
    lost = torch.arange(BATCH, device=ys.device) < FORCED_LOST
    spliced = torch.zeros_like(lost)
    spliced[:FORCED_LOST] = kept1
    same = lambda a, b: bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    spliced_ok = all(same(merged[k][spliced], out1[k][:FORCED_LOST][kept1])
                     for k in ("nell", "cms_last"))
    kept_ok = all(same(merged[k][~lost], out0[k][~lost]) for k in ("nell", "cms_last"))
    emit("forced_rescue", lost=FORCED_LOST, tier1_buckets=buckets1, k1_launches=launches,
         k1_launches_expected=2 * T * (1 + buckets1), rescued_tier1=int(kept1.sum()),
         rescued_total=rescued, finite_frac=float(finite.mean()), wall_s=wall,
         trials_per_s=BATCH / wall, spliced_equal_tier1=spliced_ok, others_equal_tier0=kept_ok)
    if launches != 2 * T * (1 + buckets1):
        raise AssertionError(f"K1 launched {launches} times, expected {2 * T * (1 + buckets1)}")
    if not (spliced_ok and kept_ok and rescued >= int(kept1.sum()) > 0):
        raise AssertionError("rescue_diverged spliced the wrong trials")


def phase_cpu_reference(model, trans, ys, tier0_out):
    """The same N=15 fused filter on a 256-trial subset copied to the
    CPU, where the wrapper runs K1's plain version: nell must agree with
    the card's tier-0 nell to 1e-6 relative on >= 99% of the trials
    finite in both (the JAX package's own hardware bound for this)."""
    from mfs_tpu_torch.one_dim.filtering import moment_filter_cms
    ic = model.init_cond
    cms0 = ic.cms.expand(CPU_SUBSET, 2 * N).cpu()
    mean0 = ic.mean.expand(CPU_SUBSET).cpu()
    y = ys[:, :CPU_SUBSET].cpu()
    t0 = time.perf_counter()
    _, _, nell = moment_filter_cms(trans.cms, trans.mean, model.measurement_cond_pdf,
                                   cms0, mean0, y, eigh_impl="fused")
    cpu_s = time.perf_counter() - t0
    card = tier0_out["nell"][:CPU_SUBSET].cpu()
    both = torch.isfinite(nell) & torch.isfinite(card)
    rel = ((nell - card).abs() / card.abs())[both]
    share = (rel < 1e-6).double().mean().item()
    emit("kernel_path_vs_plain_path", trials=CPU_SUBSET, finite_in_both=int(both.sum()),
         max_rel_gap=rel.max().item(), median_rel_gap=rel.median().item(),
         share_below_1e_6=share, cpu_seconds=cpu_s)
    if not (both.sum() > 0.9 * CPU_SUBSET and share >= 0.99):
        raise AssertionError("kernel path and plain path disagree on nell")


def phase_profile(model, trans):
    """Device busy share over two fused filter steps at B = 4096."""
    from torch.profiler import ProfilerActivity, profile
    from mfs_tpu_torch.one_dim.filtering import moment_filter_cms
    ic = model.init_cond
    ys = torch.ones((2, BATCH), dtype=torch.float64, device="cuda")
    run = lambda: moment_filter_cms(trans.cms, trans.mean, model.measurement_cond_pdf,
                                    ic.cms.expand(BATCH, 2 * N), ic.mean.expand(BATCH), ys,
                                    eigh_impl="fused")
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    emit("profile", steps=2, B=BATCH, wall_ms=wall * 1e3, device_kernels=len(kernels),
         device_busy_ms=busy_us / 1e3,
         device_idle_share=(1 - busy_us / 1e3 / (wall * 1e3)) if kernels else None,
         top_kernels_ms=[[k[:60], v / 1e3] for k, v in top])


# ---------------------------------------------------------------------------
# The ND path: 2D prey–predator, central moments, polynomial TME-2
# ---------------------------------------------------------------------------

ND_B = 1024
# Steps of each order's pass.  N=7 (s=28, nd_ldl + nd_ksolve + f64 eigh)
# and N=3 (s=6, K2) run the model's own T=2000.  N=11 (s=66, nd_ldl + nd_ksolve + f64
# eigh) is cut below the JAX experiments' T=200: cuSOLVER's eigh loops
# over the 2,048 66x66 matrices one by one (~1.9 s a call, two calls a
# step on an H100), so T=200 alone would take ~800 s of the run's
# 1,200 s limit.  T=25 (from T=50) pays for the 3D food chain's and the
# scaled filters' phases; every step of the pass is the same work.
ND_T = {7: 2000, 3: 2000, 11: 25}
ND_ORDERS = tuple(ND_T)
ND_SUBSTEPS = 10  # Milstein sub-steps per observation (the model's own 100 is cut)
ND_CPU_SUBSET = {7: 64, 3: 64, 11: 16}
# The least finite share each order must keep, just below the card's
# reading over T=2000 (0.540 at N=7, 0.976 at N=3).  The JAX package's
# f64 filter loses the same trials at the same steps on the CPU
# (tests/nd_divergence_vs_jax.py), so these losses are the f64 filter's,
# not the port's.  At N=11 the JAX experiments kept every trial over
# T=200 (experiments/SUMMARY_prey_predator.json).
ND_FINITE_MIN = {7: 0.53, 3: 0.96, 11: 1.0}
# Above this, 10 eps cond(G') says the equilibrated Gram's factor is not
# determined to 1% by the data: kernel and plain version are then held by
# the rules' moment reproduction, not by their factors.
ILL_CONDITIONED = 1e-2
EPS = 2.2e-16


def nd_mixture_moments(N, d, B, rng, device):
    """The filter's regime: central moments (orders <= 2N-1) of equal
    two-Gaussian mixtures with means +-a (|a| ~ 0.03) and covariances of
    order 1e-3, one mixture per trial."""
    from mfs_tpu_torch.multi_dims import multi_indices as nd_mi
    from mfs_tpu_torch.multi_dims.moments import raw_moments_mvn_kan_all
    mis = nd_mi.generate_graded_lexico_multi_indices(d, 2 * N - 1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    a = t(0.03 * rng.randn(B, d))
    ms = 0
    for sign in (-1.0, 1.0):
        L = t(0.02 * rng.randn(B, d, d)) + t(0.03 * (1 + rng.rand(B, d))).diag_embed()
        ms = ms + 0.5 * raw_moments_mvn_kan_all(sign * a, L @ L.mT, mis)
    return ms, mis, nd_mi.gram_and_hankel_indices_graded_lexico(N, d)


def _rel_reproduction(w, x, ms, mis):
    """Per trial: max over moments of |sum_k w_k x_k^a - m_a| relative to
    sum_k |w_k x_k^a|."""
    from mfs_tpu_torch.multi_dims.moments import monomials_nd
    mono = monomials_nd(x, mis)
    got = torch.einsum("bmz,bm->bz", mono, w)
    denom = torch.einsum("bmz,bm->bz", mono.abs(), w.abs())
    return ((got - ms).abs() / denom).amax(-1)


def equilibrated_gram_cond(ms, inds):
    """Per trial: the 2-norm condition number of the equilibrated Gram
    c_i G_ij c_j, c_j = 1/sqrt(G_jj), that both kernels factorise."""
    G = ms[:, torch.as_tensor(inds[0], device=ms.device)]
    c = torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(1e-30).rsqrt()
    return torch.linalg.cond(c[:, :, None] * G * c[:, None, :])


def conditioned_tol(ms, inds, K):
    """Per trial, the gap allowed between a kernel and its plain version:
    max|K| (1e-13 + 10 eps cond(G')).  The kernels contract a*b+c to FMA
    and the plain versions do not; the factorisation amplifies that
    last-bit difference by the equilibrated Gram's conditioning, which in
    the filter's regime reaches ~1e7 at s=10 and ~1e10 at s=28."""
    kmax = K.flatten(1).abs().amax(-1)
    return kmax * (1e-13 + 10 * EPS * equilibrated_gram_cond(ms, inds))


def pair_checks(ms, mis, inds):
    """nd_ldl and nd_ksolve against their plain versions on the same card
    inputs, nd_ksolve also alone (fed the plain factor).  Per trial:
    - finite in both, with 10 eps cond(G') <= ILL_CONDITIONED: Lu, the
      pivots, 1/scale and K within ``conditioned_tol`` (scaled by each
      quantity's own max), c to 1e-15 relative (the same IEEE operations);
    - finite in both but worse conditioned: the rule of the kernel route
      ("fused": the pair + f64 eigh) reproduces the moments no worse than
      10x the f64 "refined" route's rule + 1e-12 (relative, per moment;
      where Cholesky fails and "refined" is NaN, 10x the plain versions'
      rule on the CPU);
    - the kernels and the plain versions agree on which trials are finite.
    Returns (fields, ok, factor), ``factor`` the kernel's (Lu, c, 1/scale)."""
    from mfs_tpu_torch.multi_dims.quadrature import moment_quadrature_nd
    from mfs_tpu_torch.ops import quadrature_nd_kernel as qnd
    Lu, piv, c, isc = qnd.nd_ldl_fused(ms, inds)
    K = qnd.nd_ksolve_fused(ms, inds, Lu, c, isc)
    torch.cuda.synchronize()
    Lup, pivp, cp, iscp = qnd.nd_ldl_plain(ms, inds)
    Kp = qnd.nd_ksolve_plain(ms, inds, Lup, cp, iscp)
    K_alone = qnd.nd_ksolve_fused(ms, inds, Lup, cp, iscp)
    torch.cuda.synchronize()
    trial_finite = lambda X: torch.isfinite(X).flatten(1).all(-1)
    fin, finp = trial_finite(K), trial_finite(Kp)
    both = fin & finp
    cond = torch.full_like(ms[:, 0], float("inf"))
    cond[both] = equilibrated_gram_cond(ms[both], inds)
    well = both & (10 * EPS * cond <= ILL_CONDITIONED)
    ill = both & ~well
    tol = 1e-13 + 10 * EPS * cond[well]

    def gap(X, Xp):
        if not well.any():
            return 0.0, 0.0
        d = (X - Xp)[well].flatten(1).abs().amax(-1)
        return d.max().item(), (d / (Xp[well].flatten(1).abs().amax(-1) * tol)).max().item()

    fields = dict(trials=ms.shape[0], well_conditioned=int(well.sum()), ill_conditioned=int(ill.sum()),
                  max_gram_cond=cond[both].max().item(),
                  nonpositive_pivot_trials=int(((pivp <= 0).any(-1) & both).sum()),
                  finite_agree=bool((fin == finp).all()),
                  c_max_rel_gap=((c - cp)[both].abs() / cp[both].abs()).max().item())
    over = []
    for name, X, Xp in (("Lu", Lu, Lup), ("piv", piv, pivp), ("inv_scale", isc, iscp),
                        ("K", K, Kp), ("K_ksolve_alone", K_alone, Kp)):
        g, o = gap(X, Xp)
        fields[f"{name}_max_abs_gap"], fields[f"{name}_max_gap_over_tol"] = g, o
        over.append(o)
    ill_ok = True
    if ill.any():
        sub = ms[ill]
        res = {}
        for route, (m, impl) in (("fused", (sub, "fused")), ("refined", (sub, "refined")),
                                 ("plain", (sub.cpu(), "fused"))):
            w, x = moment_quadrature_nd(m, inds, eigh_impl=impl)
            res[route] = _rel_reproduction(w, x, m, mis).to(ms.device)
        ref = torch.where(torch.isfinite(res["refined"]), res["refined"], res["plain"])
        ill_ok = bool((res["fused"] <= 10 * ref + 1e-12).all())
        fields.update(ill_moment_residual_max=res["fused"].max().item(),
                      ill_refined_residual_max=res["refined"].nan_to_num(-1.0).max().item(),
                      ill_refined_nan=int((~torch.isfinite(res["refined"])).sum()),
                      ill_plain_residual_max=res["plain"].max().item(),
                      ill_worst_over_ref=(res["fused"] / (10 * ref + 1e-12)).max().item())
    ok = (max(over) <= 1.0 and fields["c_max_rel_gap"] <= 1e-15 and ill_ok
          and fields["finite_agree"])
    fields.update(max_gap_over_tol=max(over))
    return fields, ok, (Lu, c, isc)


def k2_checks(ms, mis, inds, vals, vecs, vals_plain):
    """K2's rotation-free checks against its plain version, per trial
    finite in both: sorted eigenvalue gap and residual ||K V - V diag(vals)||
    (K from the plain version, in K2's order of the solves) over the
    conditioned tolerance, the orthonormality of V, and the rule's moment
    reproduction."""
    from mfs_tpu_torch.multi_dims.quadrature import moment_quadrature_nd
    from mfs_tpu_torch.ops import quadrature_nd_kernel as qnd
    s = inds.shape[1]
    K = qnd.nd_eigh_operators_plain(ms, inds)
    ok = (torch.isfinite(K).flatten(1).all(-1) & torch.isfinite(vals).flatten(1).all(-1)
          & torch.isfinite(vals_plain).flatten(1).all(-1))
    tol = conditioned_tol(ms[ok], inds, K[ok])[:, None]
    eye = torch.eye(s, dtype=torch.float64, device=ms.device)
    gap = (vals.sort(-1)[0] - vals_plain.sort(-1)[0])[ok].flatten(1).abs().amax(-1)
    resid = (K @ vecs - vecs * vals[..., None, :])[ok].flatten(1).abs().amax(-1)
    w, x = moment_quadrature_nd(ms, inds, eigh_impl="fused")
    return ok, dict(
        max_eigenvalue_gap=gap.max().item(), max_eigenvalue_gap_over_tol=(gap / tol[:, 0]).max().item(),
        max_residual=resid.max().item(), max_residual_over_tol=(resid / tol[:, 0]).max().item(),
        max_orthonormality_gap=(vecs.mT @ vecs - eye)[ok].abs().max().item(),
        moment_residual=_rel_reproduction(w, x, ms, mis)[ok].max().item(),
        max_abs_K=K[ok].abs().max().item(),
        max_gram_cond=equilibrated_gram_cond(ms[ok], inds).max().item())


def phase_nd_kernels_vs_plain():
    """K2 at d=2, s in {3, 6, 10} and d=3, s=10, each at B=1024 and at the
    ragged B=1021, on mixture central moments, with one trial NaN.  Per
    trial finite in both: sorted eigenvalues and the residual against the
    plain K within the conditioned tolerance max|K| (1e-13 + 10 eps
    cond(G')) (``conditioned_tol``; Weyl: an eigenvalue moves no more than
    K does), orthonormality 1e-13, moment reproduction <= 10x the plain
    rule's + 1e-12; the NaN trial comes out NaN, and the finite trials
    agree."""
    from mfs_tpu_torch.multi_dims.quadrature import moment_quadrature_nd
    from mfs_tpu_torch.ops import quadrature_nd_kernel as qnd
    rng = np.random.RandomState(1)
    for N, d in ((2, 2), (3, 2), (4, 2), (3, 3)):
        for B in (ND_B, ND_B - 3):
            ms, mis, inds = nd_mixture_moments(N, d, B, rng, "cuda")
            ms[B // 2] = float("nan")
            fields = dict(kernel="K2", N=N, d=d, s=inds.shape[1], B=B)
            vals, vecs = qnd.nd_eigh_fused(ms, inds)
            torch.cuda.synchronize()
            vp, Vp = qnd.nd_eigh_fused_plain(ms, inds)
            both, checks = k2_checks(ms, mis, inds, vals, vecs, vp)
            wp_, xp_ = moment_quadrature_nd(ms.cpu(), inds, eigh_impl="fused")
            plain_res = _rel_reproduction(wp_, xp_, ms.cpu(), mis)[both.cpu()].max().item()
            fin = torch.isfinite(vals).flatten(1).all(-1)
            finp = torch.isfinite(vp).flatten(1).all(-1)
            fields.update(checks, moment_residual_plain=plain_res,
                          finite_agree=bool((fin == finp).all()),
                          nan_trial_nan=bool(torch.isnan(vals[B // 2]).all()
                                             and torch.isnan(vecs[B // 2]).all()))
            ok = (checks["max_eigenvalue_gap_over_tol"] <= 1.0
                  and checks["max_residual_over_tol"] <= 1.0
                  and checks["max_orthonormality_gap"] <= 1e-13
                  and checks["moment_residual"] <= 10 * plain_res + 1e-12)
            emit("nd_kernels_vs_plain", **fields)
            if not (ok and fields["finite_agree"] and fields["nan_trial_nan"]):
                raise AssertionError(f"K2 disagrees with its plain version: {fields}")


def phase_nd_k_vs_plain():
    """nd_ldl and nd_ksolve, d=2, at s=15, 21, 28 (N=5, 6, 7; B=1024 and
    the ragged 1021) and s=36, 66 (N=8, 11; B=1024), on mixture central
    moments with one trial NaN (``pair_checks``): the NaN trial comes out
    NaN, and each kernel agrees with its plain version."""
    rng = np.random.RandomState(2)
    for N, B in ((5, ND_B), (5, ND_B - 3), (6, ND_B), (6, ND_B - 3), (7, ND_B), (7, ND_B - 3),
                 (8, ND_B), (11, ND_B)):
        ms, mis, inds = nd_mixture_moments(N, 2, B, rng, "cuda")
        ms[B // 2] = float("nan")
        fields, ok, (Lu, _, _) = pair_checks(ms, mis, inds)
        fields.update(N=N, d=2, s=inds.shape[1], B=B,
                      nan_trial_nan=bool(torch.isnan(Lu[B // 2]).any()))
        emit("nd_k_vs_plain", **fields)
        if not (ok and fields["nan_trial_nan"]):
            raise AssertionError(f"nd_ldl / nd_ksolve disagree with their plain versions: {fields}")


def nd_setup(N, device, d=2):
    """Prey–predator (d=2) or the 3D food chain (d=3) at order N: (mis,
    inds, model, poly TME-2)."""
    from mfs_tpu_torch.models.multi_dims import lotka_volterra_3d, prey_predator
    from mfs_tpu_torch.multi_dims import multi_indices as nd_mi
    from mfs_tpu_torch.multi_dims.poly_tme import poly_tme_nd
    mis = nd_mi.generate_graded_lexico_multi_indices(d, 2 * N - 1)
    inds = nd_mi.gram_and_hankel_indices_graded_lexico(N, d)
    model = (prey_predator if d == 2 else lotka_volterra_3d)(mis, device=device)
    poly = poly_tme_nd(model.drift, model.dispersion, model.dt, 2, mis, 2, 1, device=device)
    return mis, inds, model, poly


def run_nd_filter(setup, ys, eigh_impl):
    from mfs_tpu_torch.multi_dims.filtering import moment_filter_nd_cms
    mis, inds, model, poly = setup
    ic = model.init_cond
    B = ys.shape[1]
    return moment_filter_nd_cms(poly.cms, poly.mean, model.measurement_cond_pdf, ys, (mis, inds),
                                ic.cms.expand(B, -1), ic.mean.expand(B, -1), eigh_impl=eigh_impl,
                                predict_fn=poly.predict_cms)


def run_nd_scms_filter(setup, ys, eigh_impl):
    """The scaled-central ND filter with the poly TME's fused
    ``predict_scms``, from the initial condition's moments scaled by its
    standard deviations: (scmss, means, scales, nell)."""
    from mfs_tpu_torch.multi_dims.filtering import moment_filter_nd_scms
    from mfs_tpu_torch.multi_dims.moments import monomials_nd
    mis, inds, model, poly = setup
    ic = model.init_cond
    B = ys.shape[1]
    scale0 = torch.sqrt(torch.diagonal(ic.cov))
    return moment_filter_nd_scms(poly.scms, poly.mean_var, model.measurement_cond_pdf, ys,
                                 (mis, inds), (ic.cms / monomials_nd(scale0, mis)).expand(B, -1),
                                 ic.mean.expand(B, -1), scale0.expand(B, -1), eigh_impl=eigh_impl,
                                 predict_fn=poly.predict_scms)


def phase_nd_data():
    """One ensemble of B=1024 prey–predator paths and their Bernoulli
    observations, simulated on the card from a seed."""
    from mfs_tpu_torch.models.multi_dims import prey_predator
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = prey_predator(np.zeros((1, 2), dtype=np.int64), device="cuda")
    _, xss, yss = model.simulate(gen, ND_B, ND_SUBSTEPS)
    T = max(ND_T.values())
    xss, yss = xss[:T], yss[:T]
    torch.cuda.synchronize()
    emit("nd_data", B=ND_B, T=T, substeps=ND_SUBSTEPS, seconds=time.perf_counter() - t0,
         state_range=[xss.min().item(), xss.max().item()], y_mean=yss.mean().item())
    return xss, yss


def nd_cpu_filter(N, ys, threads, d=2, scaled=False):
    """The ND filter at order N in d dimensions (central, or scaled-central
    with ``scaled``) on CPU tensors, where the fused wrappers run the plain
    versions of K2, nd_ldl and nd_ksolve; run in a worker process.
    Returns (nell, seconds)."""
    torch.set_num_threads(threads)
    setup = nd_setup(N, "cpu", d)
    t0 = time.perf_counter()
    run = run_nd_scms_filter if scaled else run_nd_filter
    nell = run(setup, torch.as_tensor(ys), "fused")[-1]
    return nell.numpy(), time.perf_counter() - t0


def start_nd_cpu_reference(pool, yss):
    """Start the CPU reference on each order's first ``ND_CPU_SUBSET``
    trials in the worker pool, after the timed phases, so that it runs
    while the card does the kernel checks: N=7 and N=3 in two halves, one
    process each (2 and 1 threads), N=11 in one process (2 threads)."""
    jobs = {}
    for N in ND_ORDERS:
        n = ND_CPU_SUBSET[N]
        ys = yss[:ND_T[N], :n].cpu().numpy()
        parts = (0, n // 2) if N != 11 else (0,)
        step = n // len(parts)
        jobs[N] = [pool.apply_async(nd_cpu_filter, (N, ys[:, lo:lo + step], 1 if N == 3 else 2))
                   for lo in parts]
    return jobs


ND_ROUTE_KERNELS = {"nd_eigh": ("K2",), "nd_k": ("nd_ldl", "nd_ksolve")}


def phase_nd_main_path(smi, xss, yss):
    """Prey–predator central filter, poly TME-2, B=1024, through "auto",
    T=``ND_T[N]``: at N=7 and N=11 every quadrature is one nd_ldl and one
    nd_ksolve launch (+ cuSOLVER eigh), at N=3 one K2 launch.  Each pass
    runs with every count set to 0 just before and read just after:
    exactly 2*T launches of each of its kernels and none of the others.
    Returns the setups, the outputs and each pass's record (``nd_pass``).
    Outputs are checked for shape, a
    finite share of at least ``ND_FINITE_MIN[N]`` (in f64 some trials lose
    a realisable moment vector after step ~600, in the JAX package's
    filter as well) and a mean absolute error of the filtering mean below
    0.2 (the state is ~1)."""
    from mfs_tpu_torch.ops.dispatch import fused_nd_kernel
    setups, outs, passes = {}, {}, []
    for N in ND_ORDERS:
        T = ND_T[N]
        setups[N] = setup = nd_setup(N, "cuda")
        s = setup[1].shape[1]
        kernels = ND_ROUTE_KERNELS[fused_nd_kernel(s, 2)]
        torch.cuda.reset_peak_memory_stats()
        launched_before = kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cmss, means, nell = run_nd_filter(setup, yss[:T], "auto")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_launches(launched_before)
        passes.append(nd_pass("prey_predator", N, setup, counts, kernels))
        finite = torch.isfinite(nell) & torch.isfinite(means).all(-1).all(0)
        err = (means - xss[:T])[:, finite].abs().mean().item() if finite.any() else float("nan")
        outs[N] = dict(cmss=cmss, means=means, nell=nell, finite=finite,
                       ms_per_step=wall / T * 1e3)
        z = setup[0].shape[0]
        emit("nd_main_path", N=N, s=s, z=z, nodes=s * s, T=T, B=ND_B,
             kernels=list(kernels), launches=counts, wall_s=wall, trials_per_s=ND_B / wall,
             ms_per_step=wall / T * 1e3, finite_frac=finite.double().mean().item(),
             mean_abs_err=err, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
        if N == 7:
            save_nd_fates(N, yss[:T], finite)
        expected = {k: 2 * T if k in kernels else 0 for k in counts}
        if counts != expected:
            raise AssertionError(f"N={N}: launches {counts}, expected {expected}")
        if cmss.shape != (T, ND_B, z) or means.shape != (T, ND_B, 2):
            raise AssertionError("ND main-path outputs have the wrong shape")
        if not (finite.double().mean().item() >= ND_FINITE_MIN[N] and err < 0.2):
            raise AssertionError(f"N={N}: finite_frac {finite.double().mean().item()}, "
                                 f"mean abs error {err}")
    return setups, outs, passes


def nd_pass(label, N, setup, counts, kernels):
    """One ND pass's record for the kernels line: its model, order, basis
    and the launches of each kernel of its route."""
    inds = setup[1]
    return dict(model=label, N=N, d=inds.shape[0] - 1, s=inds.shape[1],
                launches={k: counts[k] for k in kernels})


def save_nd_fates(N, ys, finite):
    """The pass's observations (T, B) and the trials the card kept, in
    ``chiprun_out/nd_fates_N{N}.npz``: ``tests/nd_divergence_vs_jax.py
    --card`` re-runs on the CPU the trials whose fate differs there."""
    out = Path(__file__).resolve().parent / "chiprun_out" / f"nd_fates_N{N}.npz"
    out.parent.mkdir(exist_ok=True)
    np.savez_compressed(out, ys=ys[..., 0].cpu().numpy().astype(np.uint8),
                        kept=finite.cpu().numpy(), N=N, substeps=ND_SUBSTEPS)


def pair_timing(label, N, ms, mis, inds, ms_per_step):
    """nd_ldl and nd_ksolve on the main path's inputs: ``pair_checks``,
    each kernel and its plain version by CUDA events (20 and 3 launches),
    the bounds from ldl_flops/ksolve_flops and the bytes (each input read
    once, each output written once), the library yardsticks (cholesky_ex
    of G for nd_ldl; the two solve_triangular calls per dimension for
    nd_ksolve), and cuSOLVER's f64 eigh of the K_m, the step's other
    quadrature call, with its share of the step."""
    from mfs_tpu_torch.ops import quadrature_nd_kernel as qnd
    d, s = inds.shape[0] - 1, inds.shape[1]
    B, z = ms.shape
    fields, ok, (Lu, c, isc) = pair_checks(ms, mis, inds)
    if not ok:
        raise AssertionError(f"nd_ldl / nd_ksolve disagree with their plain versions on "
                             f"{label} N={N} inputs: {fields}")
    idx = torch.as_tensor(inds, device="cuda")
    G, H = ms[:, idx[0]], ms[:, idx[1:]]
    R = torch.linalg.cholesky_ex(G)[0][:, None]
    K = qnd.nd_ksolve_fused(ms, inds, Lu, c, isc)

    def solves():
        X = torch.linalg.solve_triangular(R, H, upper=False)
        return torch.linalg.solve_triangular(R.mT, X, upper=True, left=False)

    ldl_bytes = (B * z + B * s * s + 3 * B * s) * 8 + s * s * 4
    ksolve_bytes = (B * z + B * s * s + 2 * B * s + B * d * s * s) * 8 + d * s * s * 4
    runs = {
        "nd_ldl": (lambda: qnd.nd_ldl_fused(ms, inds), lambda: qnd.nd_ldl_plain(ms, inds),
                   lambda: torch.linalg.cholesky_ex(G), "cholesky_ex of G",
                   ldl_flops(s) * B, ldl_bytes, fields["Lu_max_abs_gap"]),
        "nd_ksolve": (lambda: qnd.nd_ksolve_fused(ms, inds, Lu, c, isc),
                      lambda: qnd.nd_ksolve_plain(ms, inds, Lu, c, isc), solves,
                      "2 solve_triangular, batched over the d dimensions",
                      ksolve_flops(s, d) * B, ksolve_bytes, fields["K_ksolve_alone_max_abs_gap"]),
    }
    rows = {}
    for name, (run, plain, lib, lib_note, ops, nbytes, err) in runs.items():
        kernel_ms = cuda_ms(run, reps=20)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        library_path_ms = cuda_ms(lib, reps=3, warmup=1)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_TC_FLOP_PER_S
        rows[name] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                          bound_by="bytes" if t_bytes > t_ops else "operations", max_abs_err=err,
                          f64_library_path_ms=library_path_ms, B=B)
        emit("nd_timing", model=label, kernel=name, N=N, s=s, d=d, B=B, kernel_ms=kernel_ms,
             plain_ms=plain_ms,
             f64_library_path_ms=library_path_ms,
             f64_library_path_note=lib_note + "; multi-call yardstick",
             bound_ms=rows[name]["bound_ms"], bound_by=rows[name]["bound_by"], fp64_ops=ops,
             bytes=nbytes, max_abs_err=err,
             **({"layout": qnd.ksolve_layout(s, d)} if name == "nd_ksolve" else {}))
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(K), reps=2, warmup=1)
    pair_ms = rows["nd_ldl"]["ms"] + rows["nd_ksolve"]["ms"]
    emit("nd_timing_checks", model=label, N=N, **fields)
    emit("nd_timing_eigh", model=label, N=N, matrices=B * d, s=s, eigh_ms=eigh_ms, pair_ms=pair_ms,
         ms_per_step=ms_per_step, eigh_share_of_step=2 * eigh_ms / ms_per_step,
         pair_share_of_step=2 * pair_ms / ms_per_step)
    return rows


def phase_nd_timing(label, setups, outs, steps):
    """Each order's kernels on its filter's own inputs: the moment vectors
    of step ``steps[N] // 2``, the trials still finite
    (``nd_route_timing``).  Returns the rows by (kernel, label, N)."""
    rows = {}
    for N, setup in setups.items():
        mis, inds = setup[0], setup[1]
        ms = outs[N]["cmss"][steps[N] // 2]
        for name, row in nd_route_timing(label, N, ms, mis, inds,
                                         outs[N]["ms_per_step"]).items():
            rows[name, label, N] = row
    return rows


def nd_route_timing(label, N, ms, mis, inds, ms_per_step):
    """The kernels of ``ops/dispatch.py``'s route for one filter's moment
    vectors ``ms (B, z)`` (the trials still finite are kept).  nd_ldl and
    nd_ksolve: ``pair_timing``.  K2: kernel and plain version by CUDA
    events (20 and 3 launches); the bound from k2_flops with this input's
    Jacobi sweeps and the bytes; the multi-call library yardstick
    cholesky_ex + 2 solve_triangular per dimension + eigh.  No single
    PyTorch call computes any of these functions, so ``library_ms`` is
    null.  Returns the rows by kernel name."""
    from mfs_tpu_torch.ops import quadrature_nd_kernel as qnd
    from mfs_tpu_torch.ops.dispatch import fused_nd_kernel
    d, s = inds.shape[0] - 1, inds.shape[1]
    ms = ms[torch.isfinite(ms).all(-1)].contiguous()
    B, z = ms.shape
    if fused_nd_kernel(s, d) == "nd_k":
        return pair_timing(label, N, ms, mis, inds, ms_per_step)
    idx = torch.as_tensor(inds, device="cuda")

    def library():
        R, _ = torch.linalg.cholesky_ex(ms[:, idx[0]])
        R = R[:, None]
        X = torch.linalg.solve_triangular(R, ms[:, idx[1:]], upper=False)
        return torch.linalg.eigh(torch.linalg.solve_triangular(R.mT, X, upper=True,
                                                               left=False))

    run = lambda: qnd.nd_eigh_fused(ms, inds)
    plain = lambda: qnd.nd_eigh_fused_plain(ms, inds)
    vals, vecs = run()
    torch.cuda.synchronize()
    # the plain version stops each Jacobi run on the kernel's test
    vp, _, sweeps = qnd.nd_eigh_fused_plain(ms, inds, return_sweeps=True)
    _, checks = k2_checks(ms, mis, inds, vals, vecs, vp)
    err = checks["max_eigenvalue_gap"]
    over = max(checks["max_eigenvalue_gap_over_tol"], checks["max_residual_over_tol"])
    sw = sweeps.cpu().numpy()
    ops = sum(k2_flops(s, d, [int(n) for n in row]) for row in sw)
    if not over <= 1.0:
        raise AssertionError(f"K2 disagrees with its plain version on {label} N={N} inputs")
    # ms in, vals + vecs out, and the int32 index tables
    nbytes = (B * z + B * d * s * s + B * d * s) * 8 + (d + 1) * s * s * 4
    kernel_ms = cuda_ms(run, reps=20)
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    library_path_ms = cuda_ms(library, reps=3, warmup=1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_FLOP_PER_S
    row = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes > t_ops else "operations", max_abs_err=err,
               f64_library_path_ms=library_path_ms, B=B)
    emit("nd_timing", model=label, kernel="K2", N=N, s=s, d=d, B=B, kernel_ms=kernel_ms,
         plain_ms=plain_ms, f64_library_path_ms=library_path_ms,
         f64_library_path_note="cholesky_ex + 2 solve_triangular + eigh, batched over the d "
                               "dimensions; multi-call yardstick",
         bound_ms=row["bound_ms"], bound_by=row["bound_by"],
         fp64_ops=ops, bytes=nbytes, max_abs_err=err, max_gap_over_tol=over, **checks,
         sweeps_mean=float(sw.mean()), sweeps_max=int(sw.max()))
    return {"K2": row}


def nd_cpu_gap(parts, card_nell):
    """A CPU re-run's nell (its worker parts, each (nell, seconds),
    concatenated) against the card's on the same leading trials: the
    fields to print, and whether every trial agrees to rtol 1e-8 with the
    same trials finite."""
    nell = torch.as_tensor(np.concatenate([p[0] for p in parts]))
    card = card_nell[:nell.shape[0]].cpu()
    fin, fin_card = torch.isfinite(nell), torch.isfinite(card)
    both = fin & fin_card
    gap = nell_gap(nell, card, both)
    agree = bool((fin == fin_card).all())
    return (dict(trials=nell.shape[0], finite_in_both=int(both.sum()), finite_agree=agree,
                 max_rel_gap=gap[0], median_rel_gap=gap[1],
                 cpu_seconds=max(p[1] for p in parts)),
            agree and bool(both.any()) and gap[0] < 1e-8)


def nell_gap(nell, ref, keep):
    """(max, median) of |nell - ref| / |ref| over the trials ``keep``."""
    rel = ((nell - ref).abs() / ref.abs())[keep]
    return (rel.max().item(), rel.median().item()) if rel.numel() else (float("nan"),) * 2


def phase_nd_cpu_reference(outs, pending):
    """The same filters on each order's first ``ND_CPU_SUBSET`` trials
    copied to the CPU, where the fused wrappers run the plain versions of
    K2, nd_ldl and nd_ksolve (in worker processes started after the
    timed phases; ``cpu_seconds`` is the slowest part's): nell agrees with
    the card's to rtol 1e-8 on every trial, and both keep the same trials."""
    for N in ND_ORDERS:
        fields, ok = nd_cpu_gap([job.get() for job in pending[N]], outs[N]["nell"])
        emit("nd_cpu_reference", N=N, T=ND_T[N], **fields)
        if not ok:
            raise AssertionError(f"N={N}: kernel path and plain path disagree on nell")


def phase_nd_profile(setups):
    """Device busy share over two ND filter steps at B=1024, at N=7 and
    N=3.  N=11 is not profiled: cuSOLVER's eigh there decomposes the
    2,048 matrices one at a time, each by a sequence of small kernels, and
    the profiler's processing of so many events takes minutes;
    ``nd_timing_eigh`` gives that step's breakdown instead."""
    from torch.profiler import ProfilerActivity, profile
    ys = torch.ones((2, ND_B, 1), dtype=torch.float64, device="cuda")
    for N in (7, 3):
        run_nd_filter(setups[N], ys, "auto")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_nd_filter(setups[N], ys, "auto")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        ours = {k: sum(v for name, v in by_name.items() if name.startswith(k + "("))
                for k in ("nd_eigh_kernel", "nd_ldl_kernel", "nd_ksolve_kernel")}
        emit("nd_profile", N=N, steps=2, B=ND_B, wall_ms=wall * 1e3, device_kernels=len(kernels),
             device_busy_ms=busy_us / 1e3,
             device_idle_share=(1 - busy_us / 1e3 / (wall * 1e3)) if kernels else None,
             top_kernels_ms=[[k[:60], v / 1e3] for k, v in top],
             port_kernels_share_of_busy={k: v / busy_us for k, v in ours.items() if v}
             if busy_us else None)


# ---------------------------------------------------------------------------
# The scaled-central filters: 1D on the main path, ND on prey–predator
# ---------------------------------------------------------------------------

SCMS_ND_ORDERS = (3, 7)  # K2 (s=6) and nd_ldl + nd_ksolve + f64 eigh (s=28)
SCMS_ND_T = 200  # the first 200 steps of the ND phase's observations
SCMS_ND_CPU_SUBSET = 16


def phase_scms_1d(model, trans, ys, tier0_out, smi):
    """``moment_filter_scms`` on the main path's data and transition
    (Beneš–Bernoulli N=15, T=100, B=4096, TME-2 Normal closure) through
    K1 ("fused", scaled moments, each trial's running mean and scale
    handed to the kernel): exactly 2T K1 launches, counted from 0 around
    the pass.  Its finite share is printed beside tier 0's, and its nell
    and means beside the central filter's (re-run, uncounted, on the same
    data) on the trials finite in both: measures, not limits.  Returns
    its nell and K1's launches."""
    from mfs_tpu_torch.one_dim.filtering import moment_filter_cms, moment_filter_scms
    ic = model.init_cond
    launched_before = kernel_launches()
    (scmss, means, scales, nell), wall, peak = on_card(lambda: moment_filter_scms(
        trans.scms, trans.mean_var, model.measurement_cond_pdf, ic.scms.expand(BATCH, 2 * N),
        ic.mean.expand(BATCH), torch.sqrt(ic.variance).expand(BATCH), ys, eigh_impl="fused"))
    launches = kernel_launches(launched_before)["K1"]
    _, cmeans, cnell = moment_filter_cms(
        trans.cms, trans.mean, model.measurement_cond_pdf, ic.cms.expand(BATCH, 2 * N),
        ic.mean.expand(BATCH), ys, eigh_impl="fused")
    finite = (torch.isfinite(scmss[-1]).all(-1) & torch.isfinite(nell)
              & torch.isfinite(means).all(0) & torch.isfinite(scales).all(0))
    cfinite = torch.isfinite(cnell) & torch.isfinite(cmeans).all(0)
    both = finite & cfinite
    gap = nell_gap(nell, cnell, both)
    emit("scms_1d", N=N, T=T, B=BATCH, tme_order=2, wall_s=wall, trials_per_s=BATCH / wall,
         peak_mem_added_gb=peak, k1_launches=launches, k1_launches_expected=2 * T,
         finite_frac=finite.double().mean().item(),
         finite_frac_tier0=finite_mask(tier0_out).double().mean().item(),
         finite_frac_central_rerun=cfinite.double().mean().item(), finite_in_both=int(both.sum()),
         nell_max_rel_gap_to_central=gap[0], nell_median_rel_gap_to_central=gap[1],
         means_max_abs_gap_to_central=(means - cmeans)[:, both].abs().max().item(),
         central_rerun_equals_tier0=bool(torch.equal(cnell.nan_to_num(),
                                                     tier0_out["nell"].nan_to_num())), card=smi)
    if launches != 2 * T:
        raise AssertionError(f"K1 launched {launches} times in the scaled pass, expected {2 * T}")
    if scmss.shape != (T, BATCH, 2 * N) or scales.shape != (T, BATCH) or not finite.any():
        raise AssertionError("the scaled filter's outputs have the wrong shape, or none is finite")
    return nell, launches


def phase_scms_nd(setups, outs, yss, smi):
    """Prey–predator ``moment_filter_nd_scms`` with ``poly.predict_scms``
    at N=3 (K2, s=6) and N=7 (nd_ldl + nd_ksolve + f64 eigh, s=28),
    B=1024, on the first ``SCMS_ND_T`` steps of the ND phase's data,
    through "auto": exactly 2T launches of each of the route's kernels
    and none of the others, counted from 0 around each pass.  The gap to
    the central filter of the same N over the same steps (its nell from
    an uncounted re-run, its means from ``nd_main_path``) and both finite
    shares are printed: measures.  Then the route's kernels on the
    scaled moments of step T/2 (``nd_route_timing``).  Returns, by N, the
    nell, the pass's record and the timing rows."""
    from mfs_tpu_torch.ops.dispatch import fused_nd_kernel
    T = SCMS_ND_T
    out = {}
    for N in SCMS_ND_ORDERS:
        setup = setups[N]
        mis, inds = setup[0], setup[1]
        s = inds.shape[1]
        kernels = ND_ROUTE_KERNELS[fused_nd_kernel(s, 2)]
        launched_before = kernel_launches()
        (scmss, means, scales, nell), wall, peak = on_card(
            lambda: run_nd_scms_filter(setup, yss[:T], "auto"))
        counts = kernel_launches(launched_before)
        _, _, cnell = run_nd_filter(setup, yss[:T], "auto")
        cmeans = outs[N]["means"][:T]
        finite = torch.isfinite(nell) & torch.isfinite(means).all(-1).all(0)
        cfinite = torch.isfinite(cnell) & torch.isfinite(cmeans).all(-1).all(0)
        both = finite & cfinite
        gap = nell_gap(nell, cnell, both)
        emit("scms_nd", N=N, s=s, T=T, B=ND_B, kernels=list(kernels), launches=counts,
             wall_s=wall, ms_per_step=wall / T * 1e3, peak_mem_added_gb=peak,
             finite_frac=finite.double().mean().item(),
             finite_frac_central=cfinite.double().mean().item(), finite_in_both=int(both.sum()),
             nell_max_rel_gap_to_central=gap[0], nell_median_rel_gap_to_central=gap[1],
             means_max_abs_gap_to_central=(means - cmeans)[:, both].abs().max().item(), card=smi)
        expected = {k: 2 * T if k in kernels else 0 for k in counts}
        if counts != expected:
            raise AssertionError(f"scaled N={N}: launches {counts}, expected {expected}")
        if scmss.shape != (T, ND_B, mis.shape[0]) or scales.shape != (T, ND_B, 2) \
                or not finite.any():
            raise AssertionError("the scaled ND filter's outputs have the wrong shape")
        rows = nd_route_timing("prey_predator_scaled", N, scmss[T // 2], mis, inds,
                               wall / T * 1e3)
        out[N] = dict(nell=nell, record=nd_pass("prey_predator_scaled", N, setup, counts, kernels),
                      rows=rows)
    return out


def scms_1d_cpu(ys, threads):
    """The main path's scaled filter on CPU tensors (K1's plain version);
    run in a worker.  Returns (nell, seconds)."""
    from mfs_tpu_torch.models.one_dim import benes_bernoulli
    from mfs_tpu_torch.one_dim.filtering import moment_filter_scms
    from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme_normal
    torch.set_num_threads(threads)
    model = benes_bernoulli(N=N, device="cpu")
    trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
    ic, b = model.init_cond, ys.shape[1]
    t0 = time.perf_counter()
    nell = moment_filter_scms(trans.scms, trans.mean_var, model.measurement_cond_pdf,
                              ic.scms.expand(b, 2 * N), ic.mean.expand(b),
                              torch.sqrt(ic.variance).expand(b), torch.as_tensor(ys),
                              eigh_impl="fused")[-1]
    return nell.numpy(), time.perf_counter() - t0


def start_scms_cpu_reference(pool, ys, yss):
    """The 1D scaled filter's first ``CPU_SUBSET`` trials and each scaled
    ND order's first ``SCMS_ND_CPU_SUBSET``, in the worker pool."""
    pending = {N: pool.apply_async(nd_cpu_filter, (
        N, yss[:SCMS_ND_T, :SCMS_ND_CPU_SUBSET].cpu().numpy(), 1, 2, True))
        for N in SCMS_ND_ORDERS}
    pending["d1"] = pool.apply_async(scms_1d_cpu, (ys[:, :CPU_SUBSET].cpu().numpy(), 1))
    return pending


def phase_scms_cpu_reference(scms_1d_nell, scms_nd, pending):
    """The scaled filters re-run on the CPU through the plain versions,
    at the central modes' limits: in 1D nell within rtol 1e-6 on >= 99%
    of the trials finite in both, as ``kernel_path_vs_plain_path``; in ND
    rtol 1e-8 on every trial and the same trials finite, as
    ``nd_cpu_reference``."""
    bad = []
    nell, cpu_s = pending["d1"].get()
    card = scms_1d_nell[:CPU_SUBSET].cpu()
    nell = torch.as_tensor(nell)
    both = torch.isfinite(nell) & torch.isfinite(card)
    rel = ((nell - card).abs() / card.abs())[both]
    share = (rel < 1e-6).double().mean().item()
    emit("scms_cpu_reference", d=1, N=N, trials=CPU_SUBSET, T=T, finite_in_both=int(both.sum()),
         max_rel_gap=rel.max().item(), median_rel_gap=rel.median().item(),
         share_below_1e_6=share, cpu_seconds=cpu_s)
    if not (both.sum() > 0.9 * CPU_SUBSET and share >= 0.99):
        bad.append("1D")
    for order in SCMS_ND_ORDERS:
        fields, ok = nd_cpu_gap([pending[order].get()], scms_nd[order]["nell"])
        emit("scms_cpu_reference", d=2, N=order, T=SCMS_ND_T, **fields)
        if not ok:
            bad.append(f"ND N={order}")
    if bad:
        raise AssertionError(f"the scaled filters on the card disagree with the CPU: {bad}")


# ---------------------------------------------------------------------------
# The 3D food chain (experiments/lotka_volterra_3d.py): d = 3, central
# moments, poly TME-2, the moment filter against the Gauss–Hermite filter
# and the EKF on the same trials
# ---------------------------------------------------------------------------

LV3D_ORDERS = (2, 3, 4)  # K2 at s=4 and s=10; nd_ldl + nd_ksolve + f64 eigh at s=20
# One ensemble of 1,024 trials at every N.  N=4 ran first at B=256 (JAX ran
# 32 trials): its pass peaked at 5.8 GB and took 1.7 s on an H100 (700 W),
# which leaves room for the whole ensemble.
LV3D_B = 1024
LV3D_T = {2: 200, 3: 200, 4: 100}  # as the JAX rows of SUMMARY_lotka_volterra_3d.json
LV3D_SUBSTEPS = 10  # Milstein sub-steps per observation (the model's own 100 is cut)
LV3D_SEED = 4
LV3D_GH = 7  # 343 sigma points
LV3D_FINITE_MIN = 0.98  # JAX lost none of 64 trials (32 at N=4)
LV3D_JAX_FACTOR = 1.5
LV3D_NELL_RTOL = 1e-8  # "auto" against "refined"; ``nd_cpu_gap`` holds the CPU subset to it too
LV3D_CPU_SUBSET = 16


def lv3d_jax_rows():
    """JAX's rows of ``experiments/SUMMARY_lotka_volterra_3d.json``: the
    moment filter's "auto" rows by N and the baselines by method."""
    rows = json.loads((ROOT / "experiments/SUMMARY_lotka_volterra_3d.json").read_text())["rows"]
    return ({r["N"]: r for r in rows if r.get("eigh_impl") == "auto"},
            {r["method"]: r for r in rows if "method" in r})


def lv3d_scores(means, xs):
    """Finite trials (every mean finite) and the mean absolute error of
    the filtering means against the simulated paths over them and T."""
    finite = torch.isfinite(means).all(-1).all(0)
    err = (means - xs)[:, finite].abs().mean().item() if finite.any() else float("nan")
    return finite, err


def phase_lv3d_data(smi):
    """One ensemble of ``LV3D_B`` food-chain paths and their Bernoulli
    prey observations, simulated on the card from a seeded generator
    (``LV3D_SUBSTEPS`` Milstein sub-steps an observation)."""
    from mfs_tpu_torch.models.multi_dims import lotka_volterra_3d
    B, T_ = LV3D_B, max(LV3D_T.values())
    model = lotka_volterra_3d(np.zeros((1, 3), dtype=np.int64), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(LV3D_SEED)
    (_, xss, yss), wall, peak = on_card(lambda: model.simulate(gen, B, LV3D_SUBSTEPS))
    xss, yss = xss[:T_], yss[:T_]
    emit("lv3d_data", B=B, T=T_, substeps=LV3D_SUBSTEPS, simulated_T=model.T, wall_s=wall,
         peak_mem_added_gb=peak, state_range=[xss.min().item(), xss.max().item()],
         y_mean=yss.mean().item(), card=smi)
    if xss.shape != (T_, B, 3) or not bool(torch.isfinite(xss).all()):
        raise AssertionError("the food-chain paths have the wrong shape or are not finite")
    return xss, yss


def phase_lv3d_moment(xss, yss, smi):
    """The food chain's central filter (poly TME-2) at each N of
    ``LV3D_ORDERS`` on the ensemble's ``LV3D_B`` trials and ``LV3D_T[N]``
    steps, through "auto" (K2 at s=4 and s=10: 3 warps a trial; at s=20
    nd_ldl + nd_ksolve, then cuSOLVER eigh of 3B 20x20 matrices) and
    through "refined" (f64 Cholesky, solves, cuSOLVER eigh).  Each pass
    runs with every count set to 0 just before and read just after:
    "auto" launches each of its route's kernels exactly 2T times and no
    other, "refined" none.  Per row: divergent trials, the mean absolute
    error of the filtering means against the paths over the finite
    trials, wall, peak memory.  Checks: "auto" keeps >= 98% of the
    trials, its error is within 1.5x JAX's row at the same T, and its
    nell agrees with "refined"'s to rtol 1e-8 on the trials finite in
    both.  Returns the setups, the "auto" outputs and the passes'
    records."""
    from mfs_tpu_torch.ops.dispatch import fused_nd_kernel
    jax_mf, _ = lv3d_jax_rows()
    setups, outs, passes, bad = {}, {}, [], []
    for N in LV3D_ORDERS:
        B, T_ = LV3D_B, LV3D_T[N]
        setups[N] = setup = nd_setup(N, "cuda", d=3)
        z, s = setup[0].shape[0], setup[1].shape[1]
        kernels = ND_ROUTE_KERNELS[fused_nd_kernel(s, 3)]
        ys, xs = yss[:T_], xss[:T_]
        nells = {}
        for impl in ("auto", "refined"):
            launched_before = kernel_launches()
            (cmss, means, nell), wall, _ = on_card(lambda: run_nd_filter(setup, ys, impl))
            peak = torch.cuda.max_memory_allocated() / 1e9
            counts = kernel_launches(launched_before)
            finite, err = lv3d_scores(means, xs)
            nells[impl] = torch.where(finite & torch.isfinite(nell), nell, float("nan"))
            jax_row = jax_mf[N]
            emit("lv3d_moment", N=N, s=s, z=z, nodes=s**3, T=T_, B=B, eigh_impl=impl,
                 kernels=list(kernels) if impl == "auto" else [], launches=counts, wall_s=wall,
                 trials_per_s=B / wall, ms_per_step=wall / T_ * 1e3,
                 finite_frac=finite.double().mean().item(), divergent=int((~finite).sum()),
                 mean_abs_err=err, jax_mean_abs_err=jax_row["mean_abs_err"], jax_T=jax_row["T"],
                 jax_trials=jax_row["trials"], peak_mem_gb=peak, card=smi)
            expected = {k: 2 * T_ if impl == "auto" and k in kernels else 0 for k in counts}
            if counts != expected:
                raise AssertionError(f"LV3D N={N} {impl}: launches {counts}, expected {expected}")
            if cmss.shape != (T_, B, z) or means.shape != (T_, B, 3):
                raise AssertionError("the food chain's outputs have the wrong shape")
            if impl == "auto":
                passes.append(nd_pass("lotka_volterra_3d", N, setup, counts, kernels))
                outs[N] = dict(cmss=cmss, nell=nell, ms_per_step=wall / T_ * 1e3)
                if finite.double().mean().item() < LV3D_FINITE_MIN:
                    bad.append(f"N={N} finite_frac {finite.double().mean().item()}")
                if jax_row["T"] != T_ or not err <= LV3D_JAX_FACTOR * jax_row["mean_abs_err"]:
                    bad.append(f"N={N} mean_abs_err {err} (JAX {jax_row['mean_abs_err']}, "
                               f"T={jax_row['T']})")
        both = torch.isfinite(nells["auto"]) & torch.isfinite(nells["refined"])
        gap = nell_gap(nells["auto"], nells["refined"], both)
        emit("lv3d_nell_agreement", N=N, routes="auto vs refined", finite_in_both=int(both.sum()),
             max_rel_gap=gap[0], median_rel_gap=gap[1],
             max_abs_gap=(nells["auto"] - nells["refined"])[both].abs().max().item(),
             rtol=LV3D_NELL_RTOL)
        if not (both.any() and gap[0] <= LV3D_NELL_RTOL):
            bad.append(f"N={N} auto vs refined nell {gap[0]}")
    if bad:
        raise AssertionError(f"3D food-chain checks failed: {bad}")
    return setups, outs, passes


def lv3d_baseline(method, ys):
    """The GHF (``LV3D_GH``^3 points) or the EKF of
    ``experiments/lotka_volterra_3d.py`` (Euler transition, Bernoulli prey
    sensor), batch-first on ys (T, B, 1): means (T, B, 3)."""
    from mfs_tpu_torch.filters.gaussian import ekf, sgp_filter
    from mfs_tpu_torch.filters.sigma_points import SigmaPoints
    from mfs_tpu_torch.models.multi_dims import lotka_volterra_3d
    model = lotka_volterra_3d(np.zeros((1, 3), dtype=np.int64), device=ys.device)
    ic, B = model.init_cond, ys.shape[1]

    def cond(x, dt):
        return x + model.drift(x) * dt, model.dispersion(x) ** 2 * dt

    def meas(x):
        p = model.emission(x[..., 0])
        return p[..., None], (p * (1 - p))[..., None, None]

    m0, v0 = ic.mean.expand(B, 3), ic.cov.expand(B, 3, 3)
    if method == "ghf":
        sgps = SigmaPoints.gauss_hermite(3, LV3D_GH, device=ys.device)
        return sgp_filter(cond, meas, sgps, m0, v0, model.dt, ys)[0]
    return ekf(cond, meas, m0, v0, model.dt, ys)[0]


def phase_lv3d_gaussian(xss, yss, smi):
    """The GHF and the EKF on the moment filter's trials (B=1024, T=200),
    scored as the moment filter: each ``mean_abs_err`` within 1.5x JAX's
    row."""
    _, jax_base = lv3d_jax_rows()
    B, T_ = LV3D_B, LV3D_T[2]
    bad = []
    for method in ("ghf", "ekf"):
        means, wall, peak = on_card(lambda: lv3d_baseline(method, yss[:T_]))
        finite, err = lv3d_scores(means, xss[:T_])
        jax_row = jax_base[method]
        emit("lv3d_gaussian", method=method, gh_order=LV3D_GH if method == "ghf" else None,
             T=T_, B=B, wall_s=wall, peak_mem_added_gb=peak, divergent=int((~finite).sum()),
             mean_abs_err=err, jax_mean_abs_err=jax_row["mean_abs_err"], jax_T=jax_row["T"],
             card=smi)
        if jax_row["T"] != T_ or not err <= LV3D_JAX_FACTOR * jax_row["mean_abs_err"]:
            bad.append(f"{method} mean_abs_err {err}")
    if bad:
        raise AssertionError(f"3D food-chain baselines beyond 1.5 x JAX's rows: {bad}")


def start_lv3d_cpu_reference(pool, yss):
    """Each order's first ``LV3D_CPU_SUBSET`` trials through the plain
    versions, one worker an order."""
    return {N: pool.apply_async(nd_cpu_filter, (
        N, yss[:LV3D_T[N], :LV3D_CPU_SUBSET].cpu().numpy(), 1, 3)) for N in LV3D_ORDERS}


def phase_lv3d_cpu_reference(outs, pending):
    """The CPU re-run against the card's "auto" pass: nell within rtol
    1e-8 on every trial and the same trials finite."""
    bad = []
    for N in LV3D_ORDERS:
        fields, ok = nd_cpu_gap([pending[N].get()], outs[N]["nell"])
        emit("lv3d_cpu_reference", N=N, T=LV3D_T[N], **fields)
        if not ok:
            bad.append(N)
    if bad:
        raise AssertionError(f"the food chain on the card disagrees with the CPU at N={bad}")


# ---------------------------------------------------------------------------
# The MLE path: Well–Poisson maximum likelihood (experiments/parameter_estimation.py)
# ---------------------------------------------------------------------------

MLE_N = 4
MLE_B = 1000
MLE_T = 1000
MLE_TRUE = 3.0  # the true (p1, p2) = (3, 3)
MLE_SUBSTEPS = 1  # TME-3 sub-steps per observation in the simulation (JAX: 20)
# 10 L-BFGS steps took 247.6 s (125 objective evaluations) in a run of
# this script on an NVIDIA H100 80GB HBM3 at 700 W, and 8 steps 207-266 s
# (95 evaluations); 6 pay for the trial-sharding, FLOP-count and
# profiling phases.
MLE_STEPS = 6
MLE_CPU_TRIALS = 8
# The CPU re-run follows the card's first MLE_CPU_STEPS steps: one objective
# evaluation of the plain route takes ~20 s at T=1000 on one CPU core.
MLE_CPU_STEPS = 2
MLE_GRAD_RTOL = 1e-6


def mle_objective(ys, impl):
    """Per-trial Well–Poisson nell, P (B, 2) -> (B,), for observations
    ``ys (T, B)``: softplus parameters (p1, p2) = log(1 + e^P), Euler
    transitions with Normal closure, the central-moment filter at N=4,
    as ``experiments/parameter_estimation.py`` builds it."""
    from mfs_tpu_torch.models.one_dim import well_poisson
    from mfs_tpu_torch.one_dim.filtering import moment_filter_cms
    from mfs_tpu_torch.sde.transitions import sde_cond_moments_euler
    dt, _, _, ic, drift, disp, _, pmf, _ = well_poisson(MLE_TRUE, N=MLE_N, device=ys.device)
    B = ys.shape[1]
    softplus = lambda z: torch.logaddexp(torch.zeros((), dtype=z.dtype, device=z.device), z)

    def nell(P):
        p1, p2 = softplus(P[:, 0])[:, None], softplus(P[:, 1])[:, None]
        trans = sde_cond_moments_euler(lambda u: drift(u, p1), disp, dt, MLE_N)
        return moment_filter_cms(trans.cms, trans.mean, lambda y, u: pmf(y, u, p2),
                                 ic.cms.expand(B, 2 * MLE_N), ic.mean.expand(B), ys,
                                 eigh_impl=impl)[2]

    return nell


def mle_value_and_grad(nell, P):
    """Per-trial values and gradients: the VJP of the block-separable
    objective against ones, as ``lbfgs_batched`` takes it."""
    P = P.detach().requires_grad_(True)
    vals = nell(P)
    (g,) = torch.autograd.grad(vals, P, torch.ones_like(vals))
    return vals.detach(), g


def mle_p0(B, device):
    return torch.full((B, 2), 0.5, dtype=torch.float64, device=device)


def phase_mle_data():
    """B=1000 Well–Poisson paths at (p1, p2) = (3, 3) simulated on the card
    (TME-3, ``MLE_SUBSTEPS`` sub-steps) from a seed, and their Poisson
    counts by ``torch.poisson``: ys (T, B)."""
    from mfs_tpu_torch.models.one_dim import well_poisson
    t0 = time.perf_counter()
    *_, emission, _, simulate = well_poisson(MLE_TRUE, N=MLE_N, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    xss = simulate(gen, MLE_B, MLE_SUBSTEPS)[:, :MLE_T]  # (B, T)
    ys = torch.poisson(emission(xss, MLE_TRUE), generator=gen).T.contiguous()
    torch.cuda.synchronize()
    emit("mle_data", N=MLE_N, B=MLE_B, T=MLE_T, substeps=MLE_SUBSTEPS,
         seconds=time.perf_counter() - t0, state_range=[xss.min().item(), xss.max().item()],
         y_mean=ys.mean().item(), y_max=ys.max().item())
    if ys.shape != (MLE_T, MLE_B) or not bool(torch.isfinite(xss).all()):
        raise AssertionError("Well–Poisson data have the wrong shape or are not finite")
    return ys


def phase_mle_grad(ys, smi):
    """One batched gradient of the per-trial nell at P = 0.5 through the
    kernel route ("fused": K1 forward, the implicit-function backward) and
    through "refined" (cuSOLVER eigh + its autograd), B=1000, T=1000.  K1
    launches exactly 2T times on "fused" and never on "refined"; per trial
    finite in both, the gradients agree to rtol 1e-6.  Returns the
    kernel route's (values, gradients)."""
    out, fields = {}, {}
    for impl in ("fused", "refined"):
        nell = mle_objective(ys, impl)
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        launched_before = kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, g = mle_value_and_grad(nell, mle_p0(MLE_B, "cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[impl] = (vals, g)
        finite = torch.isfinite(vals) & torch.isfinite(g).all(-1)
        fields[impl] = dict(wall_s=wall, grad_trials_per_s=MLE_B / wall, k1_launches=kernel_launches(launched_before)["K1"],
                            finite_trials=int(finite.sum()),
                            peak_mem_added_gb=(torch.cuda.max_memory_allocated() - mem0) / 1e9)
    (vf, gf), (vr, gr) = out["fused"], out["refined"]
    both = torch.isfinite(vf) & torch.isfinite(gf).all(-1) & torch.isfinite(vr) & \
        torch.isfinite(gr).all(-1)
    rel = ((gf - gr).norm(dim=-1) / gr.norm(dim=-1))[both]
    nell_rel = ((vf - vr).abs() / vr.abs())[both]
    emit("mle_grad", N=MLE_N, B=MLE_B, T=MLE_T, P=0.5, **fields, finite_in_both=int(both.sum()),
         grad_max_rel_gap=rel.max().item(), grad_median_rel_gap=rel.median().item(),
         nell_max_rel_gap=nell_rel.max().item(), card=smi)
    if fields["fused"]["k1_launches"] != 2 * MLE_T or fields["refined"]["k1_launches"] != 0:
        raise AssertionError(f"K1 launches {fields['fused']['k1_launches']} (fused), "
                             f"{fields['refined']['k1_launches']} (refined); expected "
                             f"{2 * MLE_T} and 0")
    if not (both.sum() > 0.9 * MLE_B and rel.max().item() <= MLE_GRAD_RTOL):
        raise AssertionError("the kernel route's gradient disagrees with the refined route's")
    return vf, gf


def phase_mle(ys, smi):
    """``lbfgs_batched`` at full width (B=1000 trials, each its own (p1,
    p2)), ``MLE_STEPS`` steps from P = 0.5, through the kernel route.
    Objective evaluations are counted here; K1 launches exactly 2T times
    per evaluation (the backward launches none), and no trial whose nell
    stays finite sees it rise from one step to the next (Armijo).
    Returns each step's parameters of the first ``MLE_CPU_TRIALS`` trials."""
    from mfs_tpu_torch.estimation import lbfgs_batched
    nell = mle_objective(ys, "fused")
    evals, first, per_step, trace_f, trace_p = [0], [], [], [], []

    def objective(P):
        evals[0] += 1
        out = nell(P)
        if not first:
            first.append(out.detach().clone())
        return out

    def callback(P, f):
        per_step.append(evals[0])
        trace_f.append(f.clone())
        trace_p.append(P[:MLE_CPU_TRIALS].clone())

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    launched_before = kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P, info = lbfgs_batched(objective, mle_p0(MLE_B, "cuda"), max_steps=MLE_STEPS,
                            chunk_steps=MLE_STEPS, callback=callback)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(launched_before)["K1"]
    f = torch.stack(first + trace_f)  # (steps + 1, B)
    kept = torch.isfinite(f[1:]) & torch.isfinite(f[:-1])
    rises = (f[1:] > f[:-1]) & kept
    finite = torch.isfinite(info["nell"]) & torch.isfinite(P).all(-1)
    p_hat = torch.logaddexp(torch.zeros((), dtype=P.dtype, device=P.device), P)[finite]
    steps = info["steps"]
    evals_per_step = np.diff([1] + per_step).tolist()  # the first evaluation precedes step 1
    emit("mle", N=MLE_N, B=MLE_B, T=MLE_T, max_steps=MLE_STEPS, wall_s=wall,
         steps_wall_s=info["wall_s"], steps_total=int(steps.sum()),
         step_trials_per_s=int(steps.sum()) / info["wall_s"], median_steps=int(steps.median()),
         converged=int(info["converged"].sum()), divergent=int((~finite).sum()),
         objective_evaluations=evals[0], evaluations_per_step=evals_per_step,
         k1_launches=launches, k1_launches_expected=2 * MLE_T * evals[0],
         nell_rises=int(rises.sum()), p1_mean=p_hat[:, 0].mean().item(),
         p1_std=p_hat[:, 0].std().item(), p2_mean=p_hat[:, 1].mean().item(),
         p2_std=p_hat[:, 1].std().item(),
         peak_mem_added_gb=(torch.cuda.max_memory_allocated() - mem0) / 1e9, card=smi)
    if launches != 2 * MLE_T * evals[0] or launches == 0:
        raise AssertionError(f"K1 launched {launches} times over {evals[0]} evaluations")
    if rises.any():
        raise AssertionError(f"nell rose between steps in {int(rises.any(0).sum())} trials")
    if P.shape != (MLE_B, 2) or steps.shape != (MLE_B,) or int(steps.max()) == 0:
        raise AssertionError("lbfgs_batched's outputs have the wrong shape, or it took no step")
    return trace_p, launches


def phase_mle_profile(ys):
    """Device busy share over one forward + backward of the kernel route's
    objective over two filter steps at B=1000; the top device ops, K1's
    time, and the backward's LU: the device time under its two aten calls
    (``lu_factor_ex``, ``lu_solve``), and its getrf/getrs kernels by name."""
    from torch.profiler import ProfilerActivity, profile
    nell = mle_objective(ys[:2], "fused")
    run = lambda: mle_value_and_grad(nell, mle_p0(MLE_B, "cuda"))
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    lu = {k: v for k, v in by_name.items() if "getr" in k}
    # the LU's whole device time: every kernel the two aten calls launched
    lu_us = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
                if e.key in ("aten::linalg_lu_factor_ex", "aten::linalg_lu_solve"))
    emit("mle_profile", steps=2, B=MLE_B, wall_ms=wall * 1e3, device_kernels=len(kernels),
         device_busy_ms=busy_us / 1e3,
         device_idle_share=(1 - busy_us / 1e3 / (wall * 1e3)) if kernels else None,
         top_kernels_ms=[[k[:60], v / 1e3] for k, v in top],
         k1_ms=sum(v for k, v in by_name.items() if "quadrature_1d_kernel" in k) / 1e3,
         lu_ms=lu_us / 1e3, lu_share_of_busy=lu_us / busy_us if busy_us else None,
         getr_kernels_ms=[[k[:60], v / 1e3] for k, v in lu.items()])


def phase_mle_k1_timing(ys):
    """K1 on the MLE path's own inputs (the filter state after 10 steps at
    P = 0.5, n=4, B=1000): ``k1_timing``; and its gradient there, by CUDA
    events: the Function's backward alone (20 calls on one graph), and
    the backward's f64 LU (``lu_factor_ex`` + ``lu_solve`` of the (8 x 8)
    systems), the library part of the gradient."""
    from mfs_tpu_torch.ops import quadrature_kernel as qk
    from mfs_tpu_torch.models.one_dim import well_poisson
    from mfs_tpu_torch.one_dim.filtering import moment_filter_cms
    from mfs_tpu_torch.sde.transitions import sde_cond_moments_euler
    dt, _, _, ic, drift, disp, _, pmf, _ = well_poisson(MLE_TRUE, N=MLE_N, device="cuda")
    p = float(np.logaddexp(0.0, 0.5))
    trans = sde_cond_moments_euler(lambda u: drift(u, p), disp, dt, MLE_N)
    cmss, means, _ = moment_filter_cms(trans.cms, trans.mean, lambda y, u: pmf(y, u, p),
                                       ic.cms.expand(MLE_B, 2 * MLE_N), ic.mean.expand(MLE_B),
                                       ys[:10], eigh_impl="fused")
    ok = torch.isfinite(cmss[-1]).all(-1) & torch.isfinite(means[-1])
    ms, mean = cmss[-1][ok].contiguous(), means[-1][ok].contiguous()
    row = k1_timing(ms, mean)
    msg, meang = ms.clone().requires_grad_(True), mean.clone().requires_grad_(True)
    w, x = qk.moment_quadrature_fused(msg, meang, 1.0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    gw, gx = (torch.randn(w.shape, generator=gen, dtype=w.dtype, device="cuda") for _ in range(2))
    grad_ms = cuda_ms(lambda: torch.autograd.grad((w, x), (msg, meang), (gw, gx),
                                                  retain_graph=True), reps=20)
    A = qk._vdm_frame(w.detach(), x.detach() - mean[:, None], ms)[0]
    b = torch.cat([gw, gx], dim=-1)[..., None]

    def lu():
        f, piv, _ = torch.linalg.lu_factor_ex(A)
        return torch.linalg.lu_solve(f, piv, b, adjoint=True)
    lu_ms = cuda_ms(lu, reps=20)
    row.update(grad_ms=grad_ms, grad_lu_ms=lu_ms)
    emit("mle_k1_timing", n=MLE_N, B=ms.shape[0], grad_ms=grad_ms, grad_lu_ms=lu_ms,
         grad_note="the Function's backward alone; its lu_factor_ex + lu_solve (8 x 8, f64)")
    return row


def phase_k1_grad_vs_plain():
    """K1's gradient on the card, at n=4 (raw mixture moments, m0 = 1.3)
    and n=15 (the 1D main path's central regime), B=1000.

    - The Jacobian of (w, x) in (ms, mean, scale), from one VJP per
      output through the kernel route, against the same through the plain
      route (the Function on CPU copies): max |dJ| / max |J| per trial.
      Bound at n=4: 1e-6.  At n=15 the confluent Vandermonde system has
      condition ~1e28 (JAX's note), so no bound is promised: reported.
    - J d against central differences (step 1e-6) of the kernel primal
      along a random d (dms = 0.1 |ms| randn): atol 1e-6 at n=4 (JAX's
      bound for its JVP); reported at n=15."""
    from mfs_tpu_torch.ops import quadrature_kernel as qk
    rng = np.random.RandomState(4)
    B = MLE_B
    for n in (4, 15):
        ms = mixture_moments(n, B, rng, "raw" if n == 4 else "filter", "cuda")
        ms = ms * (1.3 if n == 4 else 1.0)
        mean = torch.as_tensor(rng.randn(B) * 0.1, device="cuda")
        scale = torch.as_tensor(1.0 + 0.2 * rng.rand(B), device="cuda")

        def jacobian(device):
            args = [a.to(device).clone().requires_grad_(True) for a in (ms, mean, scale)]
            w, x = qk.moment_quadrature_fused(*args)
            rows = []
            for k in range(2 * n):
                g = torch.zeros((B, 2 * n), dtype=torch.float64, device=device)
                g[:, k] = 1.0
                grads = torch.autograd.grad((w, x), args, (g[:, :n], g[:, n:]), retain_graph=True)
                rows.append(torch.cat([grads[0], grads[1][:, None], grads[2][:, None]], -1))
            return torch.stack(rows, 1).to("cuda")  # (B, 2n, 2n + 2)

        before = kernel_launches()
        J = jacobian("cuda")
        launched = kernel_launches(before)["K1"]
        Jp = jacobian("cpu")
        both = torch.isfinite(J).flatten(1).all(-1) & torch.isfinite(Jp).flatten(1).all(-1)
        gap = ((J - Jp).flatten(1).abs().amax(-1) / Jp.flatten(1).abs().amax(-1))[both]
        d = torch.cat([ms * 0.1 * torch.as_tensor(rng.randn(B, 2 * n), device="cuda"),
                       torch.as_tensor(rng.randn(B, 2), device="cuda") * 0.1], -1)
        eps = 1e-6
        f = lambda s: torch.cat(qk.moment_quadrature_fused(ms + s * d[:, :2 * n],
                                                           mean + s * d[:, 2 * n],
                                                           scale + s * d[:, 2 * n + 1]), -1)
        fd = (f(eps) - f(-eps)) / (2 * eps)
        jd = torch.einsum("bki,bi->bk", J, d)
        ok_fd = both & torch.isfinite(fd).all(-1)
        fd_gap = (jd - fd)[ok_fd].abs().max().item()
        bound_plain, bound_fd = (MLE_GRAD_RTOL, 1e-6) if n == 4 else (None, None)
        emit("k1_grad_vs_plain", n=n, B=B, kernel_launches=launched,
             finite_in_both=int(both.sum()), jacobian_max_rel_gap=gap.max().item(),
             jacobian_median_rel_gap=gap.median().item(), jacobian_bound=bound_plain,
             fd_max_abs_gap=fd_gap, fd_bound=bound_fd, max_abs_jacobian=J[both].abs().max().item())
        if launched != 1:
            raise AssertionError("the kernel route's gradient did not launch K1 once")
        if n == 4 and not (both.sum() >= 0.99 * B and gap.max().item() <= bound_plain
                           and fd_gap <= bound_fd):
            raise AssertionError(f"K1's gradient disagrees at n={n}")


def mle_cpu_rerun(ys, threads):
    """The first ``MLE_CPU_TRIALS`` trials on CPU tensors (the plain K1
    under the same Function): the gradient at P = 0.5 and
    ``lbfgs_batched`` for ``MLE_CPU_STEPS`` steps; run in a worker.
    Returns (gradients, parameters, steps, seconds)."""
    from mfs_tpu_torch.estimation import lbfgs_batched
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    ys = torch.as_tensor(ys)
    nell = mle_objective(ys, "fused")
    _, g = mle_value_and_grad(nell, mle_p0(ys.shape[1], "cpu"))
    P, info = lbfgs_batched(nell, mle_p0(ys.shape[1], "cpu"), max_steps=MLE_CPU_STEPS,
                            chunk_steps=MLE_CPU_STEPS)
    return g.numpy(), P.numpy(), info["steps"].numpy(), time.perf_counter() - t0


def phase_mle_cpu_reference(grad, trace_p, pending):
    """The CPU re-run against the card: gradients at P = 0.5 rtol 1e-6 per
    trial finite in both (the kernel route against the plain route), and
    the parameters after step ``MLE_CPU_STEPS`` (the card's from the same
    steps of its full-width run: each trial's iteration is its own)."""
    g_cpu, p_cpu, steps, cpu_s = pending.get()
    g_card = grad[:MLE_CPU_TRIALS].cpu().numpy()
    p_card = trace_p[MLE_CPU_STEPS - 1].cpu().numpy()
    fin = np.isfinite(g_cpu).all(-1) & np.isfinite(g_card).all(-1)
    g_rel = np.linalg.norm(g_cpu - g_card, axis=-1) / np.linalg.norm(g_cpu, axis=-1)
    finp = np.isfinite(p_cpu).all(-1) & np.isfinite(p_card).all(-1)
    p_rel = np.abs(p_cpu - p_card).max(-1) / np.abs(p_cpu).max(-1)
    emit("mle_cpu_reference", trials=MLE_CPU_TRIALS, T=MLE_T, steps=MLE_CPU_STEPS,
         cpu_steps=steps.tolist(), finite_in_both=int(fin.sum()),
         grad_max_rel_gap=float(g_rel[fin].max()), params_finite_in_both=int(finp.sum()),
         params_max_rel_gap=float(p_rel[finp].max()), cpu_seconds=cpu_s)
    if not (fin.all() and g_rel.max() <= MLE_GRAD_RTOL and finp.all()
            and p_rel.max() <= MLE_GRAD_RTOL):
        raise AssertionError("the card's MLE disagrees with the CPU plain route")



# ---------------------------------------------------------------------------
# Trial sharding on a one-rank NCCL world, FLOP accounting, profiling
# ---------------------------------------------------------------------------

ENSEMBLE_RTOL = 1e-12  # sharded against unsharded, as tests/test_parallel.py
SHARDED_LOSS_RTOL = 1e-12
SHARDED_GRAD_RTOL = 1e-10
FLOPS_ND_STEPS = 2
TRACE_STEPS = 2


@contextlib.contextmanager
def nccl_world():
    """A one-rank NCCL process group on card 0, rendezvous through a
    ``FileStore`` in a temporary directory, and the trial mesh over it:
    yields (mesh, seconds to start both).  The group is destroyed on exit."""
    import torch.distributed as dist
    from mfs_tpu_torch.parallel import trial_mesh
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            mesh = trial_mesh(device_type="cuda")
            yield mesh, time.perf_counter() - t0
        finally:
            dist.destroy_process_group()


def rtol_violations(a, b, keep, rtol):
    """(entries of the kept trials where |a - b| > rtol |b|, their largest
    |a - b| / |b|) for outputs whose trial axis leads."""
    a, b = a[keep], b[keep]
    gap = (a - b).abs()
    rel = (gap / b.abs())[gap > 0]
    return int((gap > rtol * b.abs()).sum()), rel.max().item() if rel.numel() else 0.0


def phase_ensemble(model, trans, ys, tier0_out, mesh, world_s, smi):
    """``run_ensemble_filter`` on the main path (N=15, T=100, B=4096,
    TME-2, tier 0 through K1) with the trials sharded over the one-rank
    NCCL mesh: K1 launches exactly 2T times, the outputs are DTensors
    sharded on their trial axes, and they equal ``main_path``'s unsharded
    tier 0 to rtol 1e-12 on the trials finite in both, whose finite masks
    are equal.  Returns K1's launches."""
    from torch.distributed.tensor import Shard
    from mfs_tpu_torch.one_dim.filtering import moment_filter_cms
    from mfs_tpu_torch.parallel import run_ensemble_filter
    ic = model.init_cond

    def filter_fn(init, y):
        return moment_filter_cms(trans.cms, trans.mean, model.measurement_cond_pdf, init[0],
                                 init[1], y, eigh_impl="fused")

    init = (ic.cms.expand(BATCH, 2 * N).contiguous(), ic.mean.expand(BATCH).contiguous())
    launched_before = kernel_launches()
    (cmss, means, nell), wall, peak = on_card(
        lambda: run_ensemble_filter(filter_fn, init, ys, mesh))
    launches = kernel_launches(launched_before)["K1"]
    out = {"cms_last": cmss.to_local()[-1], "nell": nell.to_local()}
    fin, fin0 = finite_mask(out), finite_mask(tier0_out)
    both = fin & fin0
    gaps = {k: rtol_violations(out[k], tier0_out[k], both, ENSEMBLE_RTOL) for k in out}
    placements = [list(x.placements) for x in (cmss, means, nell)]
    emit("ensemble", N=N, T=T, B=BATCH, backend="nccl", ranks=mesh.size(),
         world_start_s=world_s, wall_s=wall, trials_per_s=BATCH / wall, peak_mem_added_gb=peak,
         k1_launches=launches, k1_launches_expected=2 * T,
         placements=[str(p) for p in placements], finite_frac=fin.double().mean().item(),
         finite_masks_equal=bool((fin == fin0).all()), finite_in_both=int(both.sum()),
         beyond_rtol={k: v[0] for k, v in gaps.items()},
         max_rel_gap={k: v[1] for k, v in gaps.items()}, rtol=ENSEMBLE_RTOL, card=smi)
    if launches != 2 * T:
        raise AssertionError(f"K1 launched {launches} times in the sharded pass, expected {2 * T}")
    if placements != [[Shard(1)], [Shard(1)], [Shard(0)]] or cmss.shape != (T, BATCH, 2 * N):
        raise AssertionError(f"sharded outputs placed {placements}, shaped {tuple(cmss.shape)}")
    if not (bool((fin == fin0).all()) and all(v[0] == 0 for v in gaps.values())):
        raise AssertionError(f"the sharded pass differs from the unsharded tier 0: {gaps}")
    return launches


def phase_sharded_grad(mle_ys, vals, grads, mesh, smi):
    """``sharded_nell_grad`` of the Well–Poisson objective (``mle_objective``,
    "fused") at one shared theta = (0.5, 0.5) over the one-rank NCCL mesh,
    on the trials ``mle_grad`` found finite, against the mean of
    ``mle_grad``'s per-trial values and gradients at P = 0.5 on the same
    trials: loss rtol 1e-12, gradient rtol 1e-10; and the all-reduce
    alone, by CUDA events.  Returns K1's launches (2T: the forward; the
    backward launches none)."""
    import torch.distributed as dist
    from mfs_tpu_torch.parallel import sharded_nell_grad
    finite = torch.isfinite(vals) & torch.isfinite(grads).all(-1)
    ys = mle_ys[:, finite].contiguous()
    theta = torch.full((2,), 0.5, dtype=torch.float64, device="cuda")

    def nell_fn(th, y):
        return mle_objective(y, "fused")(th.expand(y.shape[1], 2))

    launched_before = kernel_launches()
    (loss, grad), wall, peak = on_card(lambda: sharded_nell_grad(nell_fn, theta, ys, mesh))
    launches = kernel_launches(launched_before)["K1"]
    ref_loss, ref_grad = vals[finite].mean(), grads[finite].mean(0)
    loss_rel = ((loss - ref_loss).abs() / ref_loss.abs()).item()
    grad_rel = ((grad - ref_grad).abs() / ref_grad.abs()).max().item()
    # The one collective: [sum, gradient (2), count], 4 doubles.
    buf = torch.zeros(4, dtype=torch.float64, device="cuda")
    allreduce_ms = cuda_ms(lambda: dist.all_reduce(buf, group=mesh.get_group()), reps=20)
    emit("sharded_grad", N=MLE_N, T=MLE_T, trials=int(finite.sum()), theta=0.5,
         backend="nccl", ranks=mesh.size(), wall_s=wall, grad_trials_per_s=int(finite.sum()) / wall,
         allreduce_ms=allreduce_ms, peak_mem_added_gb=peak, k1_launches=launches,
         k1_launches_expected=2 * MLE_T,
         loss=loss.item(), grad=grad.tolist(), loss_rel_gap=loss_rel, grad_max_rel_gap=grad_rel,
         card=smi)
    if launches != 2 * MLE_T:
        raise AssertionError(f"K1 launched {launches} times in the sharded gradient")
    if not (loss_rel <= SHARDED_LOSS_RTOL and grad_rel <= SHARDED_GRAD_RTOL):
        raise AssertionError(f"sharded gradient against mle_grad's mean: loss {loss_rel}, "
                             f"gradient {grad_rel}")
    return launches


def phase_flops(model, trans, ys, setups, smi):
    """``count_flops`` of one main-path tier-0 pass (N=15, T=100, B=4096)
    and of two ND steps at N=3 (K2) and N=7 (nd_ldl + nd_ksolve): each
    kernel's breakdown key must equal its launches x B x its per-trial
    count (K2 at one sweep a dimension, a flagged lower bound).  Returns
    the launches of each kernel in this phase."""
    from mfs_tpu_torch.ops.flops import count_flops
    tier0 = make_runners(model, trans)[0]
    nd_ys = torch.ones((FLOPS_ND_STEPS, ND_B, 1), dtype=torch.float64, device="cuda")
    passes = [("main_path", N, T, BATCH, lambda: tier0(ys))] + [
        (f"nd_N{n}", n, FLOPS_ND_STEPS, ND_B, lambda n=n: run_nd_filter(setups[n], nd_ys, "auto"))
        for n in (3, 7)]
    counters = {"quadrature_1d": "K1", "posterior_1d": "post1d", "nd_eigh": "K2",
                "nd_ldl": "nd_ldl", "nd_ksolve": "nd_ksolve"}
    total_launches, bad = {k: 0 for k in counters}, []
    for name, order, steps, B, run in passes:
        before = kernel_launches()
        r, wall, _ = on_card(lambda: count_flops(run))
        launched = kernel_launches(before)
        launches = {k: launched[label] for k, label in counters.items()}
        s = setups[order][1].shape[1] if name != "main_path" else order
        per_trial = {"quadrature_1d": k1_flops(order)[0],
                     "posterior_1d": post1d_flops(order, 2 * order, "central"),
                     "nd_eigh": k2_flops(s, 2, [1, 1]), "nd_ldl": ldl_flops(s),
                     "nd_ksolve": ksolve_flops(s, 2)}
        kernels = {k: r["breakdown"].get(f"kernel[{k}][float64]", 0.0) for k in counters}
        expected = {k: launches[k] * B * per_trial[k] for k in counters}
        bad += [f"{name} {k}: {kernels[k]} != {expected[k]}" for k in counters
                if kernels[k] != expected[k]]
        bad += [f"{name}: no kernel launched"] if not any(launches.values()) else []
        for k in counters:
            total_launches[k] += launches[k]
        emit("flops", path=name, N=order, steps=steps, B=B, wall_s=wall, total=r["total"],
             f64=r["f64"], f32=r["f32"], kernels_share=sum(kernels.values()) / r["total"],
             per_step=r["total"] / steps, per_trial_step=r["total"] / steps / B,
             launches={k: v for k, v in launches.items() if v},
             kernel_flops={k: v for k, v in kernels.items() if v},
             kernel_per_trial={k: per_trial[k] for k in counters if launches[k]},
             breakdown=r["breakdown"], unknown_primitives=r["unknown_primitives"],
             lower_bounds=r["lower_bounds"], card=smi)
    if bad:
        raise AssertionError(f"count_flops' kernel keys disagree with launches x B x count: {bad}")
    return total_launches


def phase_profiling(model, trans, ys, tier0_out, smi):
    """``timed`` around the main path's tier-0 pass (reps=2; its outputs
    must equal ``main_path``'s tier 0) and ``trace`` around two of its
    steps: the Chrome trace must exist and name K1's kernel (the profiler
    has kept 3 or 4 of the 4 launches' events).  Returns K1's launches."""
    from mfs_tpu_torch.utils import timed, trace
    tier0 = make_runners(model, trans)[0]
    launched_before = kernel_launches()
    best, out = timed(tier0, ys, reps=2, warmup=False)
    same = all(torch.equal(out[k].nan_to_num(), tier0_out[k].nan_to_num()) for k in out)
    log_dir = ROOT / "chiprun_out" / "profile_trace"
    t0 = time.perf_counter()
    with trace(str(log_dir)):
        tier0(ys[:TRACE_STEPS])
    trace_s = time.perf_counter() - t0
    launches = kernel_launches(launched_before)["K1"]
    path = log_dir / "trace.json"
    events = json.loads(path.read_text())["traceEvents"] if path.exists() else []
    k1_events = [e for e in events if "quadrature_1d_kernel" in e.get("name", "")
                 and e.get("cat") == "kernel"]
    emit("profiling", timed_best_s=best, timed_trials_per_s=BATCH / best, timed_reps=2,
         timed_equals_tier0=same, trace_steps=TRACE_STEPS, trace_s=trace_s,
         trace_file=str(path.relative_to(ROOT)), trace_bytes=path.stat().st_size if events else 0,
         trace_events=len(events), k1_kernel_events=len(k1_events),
         k1_kernel_us=sum(e.get("dur", 0) for e in k1_events), k1_launches=launches,
         k1_launches_expected=2 * T * 2 + 2 * TRACE_STEPS, card=smi)
    if launches != 2 * T * 2 + 2 * TRACE_STEPS or not same:
        raise AssertionError(f"timed/trace: K1 launched {launches} times; equal to tier 0: {same}")
    if not k1_events:
        raise AssertionError(f"the Chrome trace {path} does not name K1's kernel")
    return launches


# ---------------------------------------------------------------------------
# The paper's method comparison (Fig 4): Beneš–Bernoulli, every method
# scored against the brute-force grid truth (experiments/compute_errors.py,
# experiments/method_comparison.py, experiments/benes_bernoulli.py)
# ---------------------------------------------------------------------------

FIG4_SEED = 0
FIG4_B = 1000
FIG4_NS = (3, 5, 8, 11, 15)
FIG4_TME_ORDER = 3
# TME-3 sub-steps per observation in the simulation (JAX: 100).  The 1,000
# host-bound TME-3 calls of 10 sub-steps took 20.6 s on an H100 (700 W), so
# 100 would take ~200 s, past the ~60 s this phase may take.
FIG4_SUBSTEPS = 10
FIG4_GRID = 2000  # truth grid points on [-6, 6]
FIG4_GRID_SUBSTEPS = 100
FIG4_Z = 400  # CF points on [-2, 2]
FIG4_GH = 11
FIG4_PARTICLES = 10_000
FIG4_PF_CHUNK = 250  # trials a PF call: (250, 10,000) particles
FIG4_Z_BLOCK = 50  # the PF's CF phase tensor (250, 10,000, 50): 1 GB
FIG4_CF_CHUNK = 100  # trials a moment-CF phase tensor (100, 100, 15, 400): 0.48 GB
FIG4_JAX_FACTOR = 1.5
FIG4_CPU_TRIALS = {"truth": 4, "moment": 8, "ghf": 8}
ROOT = Path(__file__).resolve().parent


def trapezoid_weights(xs_grid):
    from mfs_tpu_torch.filters.grid import _trapezoid_weights
    return _trapezoid_weights(xs_grid.shape[0], xs_grid[1] - xs_grid[0])


def true_cf(pss, xs_grid, zs):
    """True CF (re, im) ``(..., z)`` by the trapezoid rule and the means
    ``(...)`` of densities ``pss (..., grid)``, by two real contractions
    (``experiments/method_comparison.py::_true_cf_and_mean``)."""
    tw = trapezoid_weights(xs_grid)
    ang = zs[:, None] * xs_grid  # (z, grid)
    return (pss @ (torch.cos(ang) * tw).T, pss @ (torch.sin(ang) * tw).T,
            pss @ (xs_grid * tw))


def moment_cf(moments, zs, mean=None, scale=None, eigh_impl="pallas"):
    """Estimated CF (re, im) ``(trials, T, z)`` of moment vectors
    ``(T, trials, 2N)``: one quadrature of every (trial, t) vector in one
    call (K1 at B = trials x T on the card), then the (n x z) phase
    contraction, ``FIG4_CF_CHUNK`` trials at a time."""
    from mfs_tpu_torch.one_dim.quadrature import moment_quadrature
    ms = moments.transpose(0, 1).contiguous()
    args = [a.transpose(0, 1) for a in (mean, scale) if a is not None]
    w, x = moment_quadrature(ms, *args, stable=True, eigh_impl=eigh_impl)
    return rule_cf(w, x, zs)


def rule_cf(w, x, zs):
    """CF (re, im) ``(..., z)`` of quadrature rules ``w, x (..., n)``,
    ``FIG4_CF_CHUNK`` entries of the first axis at a time (a
    (chunk, T, n, z) phase tensor for Fig 4's (trials, T, n) rules)."""
    re, im = [], []
    for s0 in range(0, w.shape[0], FIG4_CF_CHUNK):
        ang = x[s0:s0 + FIG4_CF_CHUNK, ..., None] * zs
        wc = w[s0:s0 + FIG4_CF_CHUNK]
        re.append(torch.einsum("...n,...nz->...z", wc, torch.cos(ang)))
        im.append(torch.einsum("...n,...nz->...z", wc, torch.sin(ang)))
    return torch.cat(re), torch.cat(im)


def cf_distances(cf_est, cf_true, zs):
    """sup / L1 / L2 distances over z of two CFs given as (re, im) pairs."""
    diff = torch.sqrt((cf_est[0] - cf_true[0]) ** 2 + (cf_est[1] - cf_true[1]) ** 2)
    dz = zs[1] - zs[0]
    return (torch.amax(diff, dim=-1), torch.sum(diff, dim=-1) * dz,
            torch.sqrt(torch.sum(diff**2, dim=-1) * dz))


def cf_errors(moments, pss, xs_grid, zs, mean=None, scale=None, eigh_impl="pallas"):
    """sup / L1 / L2 CF distances ``(trials, T)`` of moment vectors
    ``(T, trials, 2N)`` (central when ``mean (T, trials)`` is given)
    from the truth ``pss (trials, T, grid)``: a copy of
    ``experiments/compute_errors.py::cf_errors`` (the JAX package has no
    scoring module)."""
    re, im, _ = true_cf(pss, xs_grid, zs)
    return cf_distances(moment_cf(moments, zs, mean, scale, eigh_impl), (re, im), zs)


def metrics(cf_est, cf_true, est_means, true_means, finite, zs):
    """Mean CF distances and absolute mean error over the finite trials
    and T (a copy of ``experiments/method_comparison.py::_metrics``).
    ``cf_est``/``cf_true`` are (re, im) pairs of (trials, T, z); means
    (trials, T); ``finite`` (trials,) bool."""
    sup_e, l1_e, l2_e = cf_distances(cf_est, cf_true, zs)
    mean_err = torch.abs(est_means - true_means)
    mask = torch.as_tensor(np.asarray(finite, dtype=bool), device=sup_e.device)
    return dict(divergent=int(mask.shape[0] - mask.sum()),
                cf_sup=float(torch.mean(sup_e[mask])), cf_l1=float(torch.mean(l1_e[mask])),
                cf_l2=float(torch.mean(l2_e[mask])),
                mean_abs_err=float(torch.mean(mean_err[mask])))


def gaussian_cf(m, v, zs):
    """CF (re, im) of N(m, v): exp(izm - z^2 v / 2)."""
    amp = torch.exp(-0.5 * v[..., None] * zs**2)
    ang = m[..., None] * zs
    return amp * torch.cos(ang), amp * torch.sin(ang)


def empirical_cf(samples, zs):
    """Ensemble CF (re, im) ``(..., z)`` of particles ``(..., P)``, by
    ``FIG4_Z_BLOCK`` z-points at a time."""
    re, im = [], []
    for z_blk in zs.split(FIG4_Z_BLOCK):
        ang = samples[..., None] * z_blk  # (..., P, z_block)
        re.append(torch.cos(ang).mean(-2))
        im.append(torch.sin(ang).mean(-2))
    return torch.cat(re, -1), torch.cat(im, -1)


def fig4_measurements(seed, trial_ids, probs):
    """Bernoulli measurements of ``probs (B, T)``: trial i's uniforms from
    its own stream ``np.random.default_rng([seed, i, 1])`` (``simulate_trials``
    takes ``[seed, i]`` for the path), so any chunking gives the same data."""
    us = np.stack([np.random.default_rng([seed, int(i), 1]).random(probs.shape[1])
                   for i in trial_ids])
    return (torch.as_tensor(us, device=probs.device) < probs).to(probs.dtype)


def on_card(fn):
    """(result, wall s, peak device memory GB added over the phase's
    start) of one phase on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - mem0) / 1e9


def phase_fig4_data(smi):
    """``FIG4_B`` Beneš–Bernoulli trials from ``simulate_trials`` (seed 0,
    ``FIG4_SUBSTEPS`` TME-3 sub-steps) and their Bernoulli observations:
    ys (T, B)."""
    from mfs_tpu_torch.models.one_dim import benes_bernoulli
    model = benes_bernoulli(N=2, device="cuda")
    ids = np.arange(FIG4_B)

    def run():
        xss = model.simulate_trials(FIG4_SEED, ids, FIG4_SUBSTEPS)
        return xss, fig4_measurements(FIG4_SEED, ids, model.emission(xss))
    (xss, yss), wall, peak = on_card(run)
    emit("fig4_data", B=FIG4_B, T=T, substeps=FIG4_SUBSTEPS, wall_s=wall, peak_mem_added_gb=peak,
         state_range=[xss.min().item(), xss.max().item()], y_mean=yss.mean().item(), card=smi)
    if xss.shape != (FIG4_B, T) or not bool(torch.isfinite(xss).all()):
        raise AssertionError("the Fig-4 trials have the wrong shape or are not finite")
    return yss.T.contiguous()


def fig4_truth(ys):
    """The grid truth of ``experiments/compute_errors.py::brute_force_truth``:
    2,000 points on [-6, 6], Chapman with TME-3, 100 substeps, all trials
    in one call.  Returns (pss (T, B, grid), grid)."""
    from mfs_tpu_torch.filters.grid import brute_force_filter
    from mfs_tpu_torch.models.one_dim import benes_bernoulli
    model = benes_bernoulli(N=2, device=ys.device)
    xs_grid = torch.linspace(-6.0, 6.0, FIG4_GRID, dtype=torch.float64, device=ys.device)
    init = model.init_cond.pdf(xs_grid).expand(ys.shape[1], FIG4_GRID)
    return brute_force_filter(model.drift, model.dispersion, model.measurement_cond_pdf, init,
                              xs_grid, ys, model.dt, integration_steps=FIG4_GRID_SUBSTEPS,
                              pred_method="chapman-tme-3"), xs_grid


def phase_fig4_truth(ys, smi):
    """The truth on the card: every density finite with mass 1 within 1e-10."""
    (pss, xs_grid), wall, peak = on_card(lambda: fig4_truth(ys))
    mass_gap = (pss @ trapezoid_weights(xs_grid) - 1).abs().max().item()
    finite = bool(torch.isfinite(pss).all())
    emit("fig4_truth", B=FIG4_B, T=T, grid=FIG4_GRID, substeps=FIG4_GRID_SUBSTEPS,
         pred_method="chapman-tme-3", wall_s=wall, peak_mem_added_gb=peak, finite=finite,
         max_mass_gap=mass_gap, card=smi)
    if not (finite and mass_gap <= 1e-10):
        raise AssertionError(f"grid truth: finite {finite}, mass gap {mass_gap}")
    return pss, xs_grid


def fig4_runner(model, trans, **kw):
    """ys (T, b) -> the central filter's (cmss, means, nell), a rescue runner."""
    from mfs_tpu_torch.one_dim.filtering import moment_filter_cms
    ic = model.init_cond
    n2 = ic.cms.shape[0]

    def run(y):
        b = y.shape[1]
        cmss, means, nell = moment_filter_cms(trans.cms, trans.mean, model.measurement_cond_pdf,
                                              ic.cms.expand(b, n2), ic.mean.expand(b), y, **kw)
        return {"cmss": cmss, "means": means, "nell": nell}
    return run


def fig4_finite(out):
    return (torch.isfinite(out["cmss"]).all(-1).all(0) & torch.isfinite(out["means"]).all(0)
            & torch.isfinite(out["nell"]))


def fig4_moment_setup(N, device):
    from mfs_tpu_torch.models.one_dim import benes_bernoulli
    from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme_normal
    model = benes_bernoulli(N=N, device=device)
    return model, sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt,
                                              FIG4_TME_ORDER, N)


def phase_fig4_moment(ys, smi):
    """K1's moment filter at each N of ``FIG4_NS`` as
    ``experiments/benes_bernoulli.py`` runs it: central moments, TME-3
    Normal closure, K1 ("pallas"), rescued like the 1D main path (tier 1:
    jitter 1e-8 in 512-trial buckets; tier 2: the f64 ``stable=True``
    path on the card) with these runners.  Returns, by N, the merged
    outputs, the finite mask, the tier-0 nell and K1's launches."""
    from mfs_tpu_torch.parallel.ensemble import rescue_diverged
    out = {}
    for N in FIG4_NS:
        model, trans = fig4_moment_setup(N, "cuda")
        tier0 = fig4_runner(model, trans, eigh_impl="pallas")
        tier1 = fig4_runner(model, trans, eigh_impl="pallas", quad_jitter=TIER1_JITTER)
        tier2 = fig4_runner(model, trans, stable=True, eigh_impl="xla")
        masks, nell0 = [], {}

        def run_fast(y):
            res = tier0(y)
            nell0["nell"] = res["nell"]
            return res

        def finite_fn(res):
            masks.append(fig4_finite(res).cpu().numpy())
            return masks[-1]

        launched_before = kernel_launches()
        (merged, finite, rescued), wall, peak = on_card(lambda: rescue_diverged(
            run_fast, [tier1, tier2], ys, finite_fn, {"cmss": 1, "means": 1, "nell": 0},
            bucket=TIER1_BUCKET))
        launches = kernel_launches(launched_before)["K1"]
        buckets1 = -(-int((~masks[0]).sum()) // TIER1_BUCKET)
        emit("fig4_moment", N=N, B=FIG4_B, T=T, tme_order=FIG4_TME_ORDER, wall_s=wall,
             peak_mem_added_gb=peak, finite_frac_tier0=float(masks[0].mean()),
             finite_frac_rescued=float(finite.mean()), rescued=rescued, tier1_buckets=buckets1,
             k1_launches=launches, k1_launches_expected=2 * T * (1 + buckets1), card=smi)
        if launches != 2 * T * (1 + buckets1):
            raise AssertionError(f"K1 launched {launches} times at N={N}")
        if not finite.mean() >= 0.99:
            raise AssertionError(f"moment filter N={N}: finite_frac {finite.mean()} after rescue")
        out[N] = dict(merged=merged, finite=finite, nell0=nell0["nell"], launches=launches)
    return out


def run_ghf(ys):
    """The batched Gauss–Hermite filter of
    ``experiments/method_comparison.py::run_ghf`` (gh = 11, TME-3) on
    ys (T, B) on their device: means, variances (T, B) and nell (T, B)."""
    from mfs_tpu_torch.filters.gaussian import sgp_filter
    from mfs_tpu_torch.filters.sigma_points import SigmaPoints
    from mfs_tpu_torch.models.one_dim import benes_bernoulli
    from mfs_tpu_torch.sde import tme
    model = benes_bernoulli(N=2, device=ys.device)

    def cond_m_cov(x, dt):
        m, v = tme.mean_and_var_1d(x[..., 0], dt, model.drift, model.dispersion, FIG4_TME_ORDER)
        return m[..., None], v[..., None, None]

    def meas_m_cov(x):
        p = model.emission(x[..., 0])
        return p[..., None], (p * (1 - p))[..., None, None]

    ic, B = model.init_cond, ys.shape[1]
    mfs, vfs, nell = sgp_filter(cond_m_cov, meas_m_cov,
                                SigmaPoints.gauss_hermite(1, FIG4_GH, device=ys.device),
                                ic.mean.expand(B, 1), ic.variance.expand(B, 1, 1), model.dt,
                                ys[..., None])
    return mfs[..., 0], vfs[..., 0, 0], nell


def phase_fig4_ghf(ys, smi):
    (m, v, nell), wall, peak = on_card(lambda: run_ghf(ys))
    emit("fig4_ghf", B=FIG4_B, T=T, gh=FIG4_GH, wall_s=wall, peak_mem_added_gb=peak,
         finite_trials=int(torch.isfinite(m).all(0).sum()), card=smi)
    return m, v, nell


def run_pf_chunk(model, ys, generator, zs):
    """The bootstrap PF of ``experiments/method_comparison.py::run_pf_chunk``
    on ys (T, b): ``FIG4_PARTICLES`` particles a trial, stratified
    resampling, a TME-3 Gaussian proposal; the empirical CF is accumulated
    in ``out_fn``.  Returns means (T, b), CF (re, im) (T, b, z), nell (b,)."""
    from mfs_tpu_torch.filters.resampling import stratified
    from mfs_tpu_torch.filters.smc import bootstrap_filter
    from mfs_tpu_torch.sde import tme
    b = ys.shape[1]

    def transition_sampler(samples, g):
        m, v = tme.mean_and_var_1d(samples, model.dt, model.drift, model.dispersion,
                                   FIG4_TME_ORDER)
        return m + torch.sqrt(v) * torch.randn(samples.shape, generator=g, dtype=samples.dtype,
                                               device=samples.device)

    def init_sampler(g, n):
        return model.init_cond.sampler(g, b * n).reshape(b, n)

    (means, re, im), nell = bootstrap_filter(
        transition_sampler, model.measurement_cond_pdf, ys, init_sampler, generator,
        FIG4_PARTICLES, stratified, out_fn=lambda s: (s.mean(-1),) + empirical_cf(s, zs))
    return means, re, im, nell


def phase_fig4_pf(ys, zs, smi):
    """The PF on all trials, ``FIG4_PF_CHUNK`` at a time, each chunk's
    generator seeded from (seed + 1, first trial)."""
    from mfs_tpu_torch.models.one_dim import benes_bernoulli
    model = benes_bernoulli(N=2, device="cuda")

    def run():
        parts = []
        for s0 in range(0, FIG4_B, FIG4_PF_CHUNK):
            seed = int(np.random.SeedSequence([FIG4_SEED + 1, s0]).generate_state(1)[0])
            gen = torch.Generator(device="cuda").manual_seed(seed)
            parts.append(run_pf_chunk(model, ys[:, s0:s0 + FIG4_PF_CHUNK], gen, zs))
        return [torch.cat(p, dim=1 if p[0].ndim > 1 else 0) for p in zip(*parts)]
    (means, re, im, nell), wall, peak = on_card(run)
    emit("fig4_pf", B=FIG4_B, T=T, particles=FIG4_PARTICLES, chunk=FIG4_PF_CHUNK,
         resampling="stratified", wall_s=wall, peak_mem_added_gb=peak,
         finite_trials=int(torch.isfinite(means).all(0).sum()), card=smi)
    return means, re, im


def phase_fig4_scores(pss, xs_grid, zs, moment, ghf, pf, smi):
    """One row per method against the truth (``metrics``), beside JAX's
    rows in ``experiments/SUMMARY_*.json`` (statistics of the estimators
    over 1,000 trials: they do not depend on the platform).  Checks: the
    moment filter's ``mean_abs_err`` and ``cf_sup`` strictly fall over N;
    every row is within 1.5 x JAX's; the moment filter beats the PF at
    N >= 8 and the GHF at N >= 5.  Returns K1's scoring launches by N."""
    t0 = time.perf_counter()
    re_t, im_t, means_t = (a.transpose(0, 1) for a in true_cf(pss, xs_grid, zs))  # (B, T, ...)
    cf_true = (re_t, im_t)
    jax_mf = {r["N"]: r for r in json.loads(
        (ROOT / "experiments/SUMMARY_benes_bernoulli.json").read_text())["rows"]}
    jax_mc = {r["method"]: r for r in json.loads(
        (ROOT / "experiments/SUMMARY_method_comparison.json").read_text())["rows"]}
    rows, launches = {}, {}
    for N in FIG4_NS:
        res = moment[N]["merged"]
        before = kernel_launches()
        cf = moment_cf(res["cmss"], zs, res["means"])
        launches[N] = kernel_launches(before)["K1"]
        rows[N] = dict(metrics(cf, cf_true, res["means"].T, means_t, moment[N]["finite"], zs),
                       jax=jax_mf[N])
    m, v, _ = ghf
    rows["ghf"] = dict(metrics(gaussian_cf(m.T, v.T, zs), cf_true, m.T, means_t,
                               torch.isfinite(m).all(0).cpu().numpy(), zs),
                       jax=jax_mc[f"ghf_gh{FIG4_GH}"])
    pm, pre, pim = pf
    rows["pf"] = dict(metrics((pre.transpose(0, 1), pim.transpose(0, 1)), cf_true, pm.T, means_t,
                              torch.isfinite(pm).all(0).cpu().numpy(), zs),
                      jax=jax_mc[f"bootstrap_pf_{FIG4_PARTICLES}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    keys = ("mean_abs_err", "cf_sup")
    bad = []
    for name, row in rows.items():
        jax_row = row.pop("jax")
        emit("fig4_scores", method=f"moment_N{name}" if isinstance(name, int) else name,
             trials=FIG4_B, **row, **{f"jax_{k}": jax_row[k] for k in keys},
             k1_scoring_launches=launches.get(name), card=smi)
        bad += [f"{name} {k}" for k in keys if not row[k] <= FIG4_JAX_FACTOR * jax_row[k]]
    for a, b in zip(FIG4_NS, FIG4_NS[1:]):
        bad += [f"{k} N={a}->{b}" for k in keys if not rows[b][k] < rows[a][k]]
    for N in FIG4_NS:
        for other, n_min in (("pf", 8), ("ghf", 5)):
            if N >= n_min:
                bad += [f"N={N} vs {other} {k}" for k in keys if not rows[N][k] < rows[other][k]]
    emit("fig4_scores_done", wall_s=wall, failed=bad)
    if bad:
        raise AssertionError(f"Fig-4 checks failed: {bad}")
    return launches


def phase_fig4_k1_timing(moment, zs):
    """K1 at Fig 4's two new shapes, on their own inputs (``k1_timing``):
    n=8, B=1,000 (the N=8 filter's state after 10 steps) and n=15,
    B=100,000 (every (trial, t) vector the N=15 row scores, held as
    measures on the scoring's z-points)."""
    rows = []
    for N, sel, z in ((8, slice(9, 10), None), (15, slice(None), zs)):
        res = moment[N]["merged"]
        ms = res["cmss"][sel].reshape(-1, 2 * N)
        mean = res["means"][sel].reshape(-1)
        ok = torch.isfinite(ms).all(-1) & torch.isfinite(mean)
        rows.append(k1_timing(ms[ok].contiguous(), mean[ok].contiguous(), z))
    return rows


def fig4_cpu_truth(ys):
    """The first trials' grid truth on the CPU; run in a worker."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    pss, _ = fig4_truth(torch.as_tensor(ys))
    return pss.numpy(), time.perf_counter() - t0


def fig4_cpu_moment(ys):
    """The first trials through each N's tier-0 filter on CPU tensors
    (K1's plain version); run in a worker.  Returns nell by N."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = {}
    for N in FIG4_NS:
        model, trans = fig4_moment_setup(N, "cpu")
        out[N] = fig4_runner(model, trans, eigh_impl="pallas")(torch.as_tensor(ys))["nell"].numpy()
    return out, time.perf_counter() - t0


def fig4_cpu_ghf(ys):
    """The first trials' GHF on the CPU; run in a worker."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    return [a.numpy() for a in run_ghf(torch.as_tensor(ys))], time.perf_counter() - t0


def start_fig4_cpu_reference(pool, ys):
    return {name: pool.apply_async(fn, (ys[:, :FIG4_CPU_TRIALS[name]].cpu().numpy(),))
            for name, fn in (("truth", fig4_cpu_truth), ("moment", fig4_cpu_moment),
                             ("ghf", fig4_cpu_ghf))}


def phase_fig4_cpu_reference(pending, pss, moment, ghf):
    """The CPU re-runs against the card: the truth's densities within 1e-10
    of each density's peak (its small tail values carry no more digits
    than that peak-relative gap); the tier-0 moment filters' nell within
    rtol 1e-6 on the trials finite in both, as on the 1D main path; the
    GHF's means, variances and nell within rtol 1e-10."""
    p_cpu, truth_s = pending["truth"].get()
    n = p_cpu.shape[1]
    p_card = pss[:, :n].cpu().numpy()
    gap = np.abs(p_card - p_cpu).max(-1) / np.abs(p_cpu).max(-1)
    big = np.abs(p_cpu) > 1e-200
    elem = (np.abs(p_card - p_cpu)[big] / np.abs(p_cpu)[big]).max()
    nells, moment_s = pending["moment"].get()
    m_rows = {}
    for N in FIG4_NS:
        card = moment[N]["nell0"][:FIG4_CPU_TRIALS["moment"]].cpu().numpy()
        both = np.isfinite(card) & np.isfinite(nells[N])
        m_rows[N] = dict(finite_in_both=int(both.sum()),
                         max_rel_gap=float((np.abs(card - nells[N]) / np.abs(nells[N]))[both].max()))
    g_cpu, ghf_s = pending["ghf"].get()
    k = g_cpu[0].shape[1]
    g_gap = max(float((np.abs(a[:, :k].cpu().numpy() - b) / np.abs(b)).max())
                for a, b in zip(ghf, g_cpu))
    emit("fig4_cpu_reference", truth_trials=n, truth_max_gap_over_peak=float(gap.max()),
         truth_max_rel_gap_above_1e_200=float(elem), truth_cpu_seconds=truth_s,
         moment_trials=FIG4_CPU_TRIALS["moment"], moment=m_rows, moment_cpu_seconds=moment_s,
         ghf_trials=k, ghf_max_rel_gap=g_gap, ghf_cpu_seconds=ghf_s)
    bad = [f"moment N={N}" for N, r in m_rows.items()
           if not (r["finite_in_both"] >= 6 and r["max_rel_gap"] <= 1e-6)]
    if not gap.max() <= 1e-10:
        bad.append("truth")
    if not g_gap <= 1e-10:
        bad.append("ghf")
    if bad:
        raise AssertionError(f"the card's Fig-4 runs disagree with the CPU re-runs: {bad}")


# ---------------------------------------------------------------------------
# The paper's convergence study (experiments/convergence.py): the OU /
# Matérn-1/2 model, the moment filter against the exact Kalman filter over
# N; and the density recovery of examples/benes_bernoulli_demo.py on
# Fig 4's trials against the grid truth
# ---------------------------------------------------------------------------

CONV_SEED = 0
CONV_B = 10_000
CONV_DT = 0.1  # T = 100 steps, as the main path's T
CONV_ELL, CONV_SIGMA, CONV_XI = 1.0, 0.5, 1.0
CONV_NS = tuple(range(2, 16))
CONV_RAW_CLEAN_N = 11  # raw mode loses no trial up to here (JAX: none)
CONV_JAX_FACTOR = 1.5
CONV_JACOBI_NS = (5, 15)
CONV_JACOBI_RTOL = 1e-6  # nell, the 1D kernel-vs-plain bound
CONV_TAYLOR_N, CONV_TAYLOR_ORDER = 3, 2
CONV_TAYLOR_MEAN_GAP = 0.3  # the JAX package's test bound against the cms filter
CONV_PF_B = 1000
CONV_PF_PARTICLES = (100, 1000, 10_000)
CONV_PCRLB_RTOL = 1e-6
CONV_CPU_TRIALS = 64
CONV_CPU_NS = (5, 10, 15)
DENSITY_NS = (8, 15)
DENSITY_STEPS = tuple(range(9, T, 10))  # t = 10, 20, ..., 100
# The inverse Fourier transform's z grid: [-8, 8] by 0.1.  Its period
# 2 pi / 0.1 ~ 63 is far wider than the truth's [-6, 6], and a quadrature
# rule's CF does not decay, so the window sets the smoothing (~pi / 8).
DENSITY_Z = (-8.0, 8.0, 161)
DENSITY_CHUNK = 2500  # densities a call: (2500, 2000, 30) Hermite ladders, 1.2 GB
DENSITY_FOURIER_CHUNK = 250  # (250, 2000, 161) complex phase tensors, 1.3 GB
DENSITY_CPU_TRIALS = 8  # at every step of DENSITY_STEPS: 80 densities an N
DENSITY_CPU_RTOL = 1e-9  # of each density's peak
DENSITY_MASS_GAP = 1e-2
DENSITY_METHODS = ("gram_charlier", "edgeworth", "saddle_point", "inverse_fourier")


def conv_transition():
    """The exact discretisation of the OU SDE: x' = F x + sqrt(Q) eps."""
    F = math.exp(-CONV_DT / CONV_ELL)
    return F, CONV_SIGMA**2 * (1 - math.exp(-2 * CONV_DT / CONV_ELL))


def conv_simulate(B, generator):
    """``experiments/convergence.py::simulate`` from a torch generator:
    x0 (B,) ~ N(0, sigma^2), the states xs (T, B) and ys = xs + noise."""
    F, Q = conv_transition()
    kw = dict(generator=generator, dtype=torch.float64, device=generator.device)
    x = CONV_SIGMA * torch.randn(B, **kw)
    steps, noise = torch.randn(T, B, **kw), torch.randn(T, B, **kw)
    x0, xs = x, []
    for eps in steps:
        x = F * x + math.sqrt(Q) * eps
        xs.append(x)
    xs = torch.stack(xs)
    return x0, xs, xs + math.sqrt(CONV_XI) * noise


def kalman_batch(ys):
    """The exact Kalman filter of ``experiments/convergence.py::kalman_batch``
    on ys (T, B): filtering means and variances (T, B)."""
    F, Q = conv_transition()
    mf = torch.zeros(ys.shape[1], dtype=ys.dtype, device=ys.device)
    vf = torch.full_like(mf, CONV_SIGMA**2)
    mfs, vfs = [], []
    for y in ys:
        mp, vp = F * mf, F * vf * F + Q
        gain = vp / (vp + CONV_XI)
        mf = mp + gain * (y - mp)
        vf = vp - vp * gain
        mfs.append(mf)
        vfs.append(vf)
    return torch.stack(mfs), torch.stack(vfs)


def conv_meas(y, x):
    return torch.exp(-0.5 * (y - x) ** 2 / CONV_XI) / math.sqrt(2 * math.pi * CONV_XI)


def conv_filter(N, mode, ys, eigh_impl="auto"):
    """The moment filter of ``experiments/convergence.py`` at order N in
    ``mode`` ("central" or "raw") on ys (T, B), with its closed-form
    Normal transition moments.  Returns means, variances (T, B), nell (B,)
    and the central moments (T, B, 2N) (None in raw mode)."""
    from mfs_tpu_torch.one_dim.filtering import moment_filter_cms, moment_filter_rms
    from mfs_tpu_torch.one_dim.moments import raw_to_central
    from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all
    F, Q = conv_transition()
    B = ys.shape[1]
    zero = torch.zeros(B, dtype=ys.dtype, device=ys.device)
    rms0 = normal_raw_moments_all(zero, CONV_SIGMA**2, 2 * N)
    if mode == "raw":
        rmss, nell = moment_filter_rms(lambda x: normal_raw_moments_all(F * x, Q, 2 * N),
                                       conv_meas, rms0, ys, eigh_impl=eigh_impl)
        means = rmss[..., 1]
        return means, rmss[..., 2] - means**2, nell, None
    cmss, means, nell = moment_filter_cms(
        lambda x, m: normal_raw_moments_all(F * x - m, Q, 2 * N), lambda x: F * x, conv_meas,
        raw_to_central(rms0), zero, ys, eigh_impl=eigh_impl)
    return means, cmss[..., 2], nell, cmss


def conv_scores(means, variances, kf_m, kf_v):
    """``experiments/convergence.py``'s masking and errors: a trial is
    divergent unless its means and variances are finite and its
    variances positive at every step; the errors average over the others
    and T."""
    finite = (torch.isfinite(means).all(0) & torch.isfinite(variances).all(0)
              & (variances > 0).all(0))
    m, v, km, kv = (a[:, finite] for a in (means, variances, kf_m, kf_v))
    kl = 0.5 * (torch.log(kv / v) + (v + (m - km) ** 2) / kv - 1.0)
    return dict(divergent=int((~finite).sum()), abs_mean_err=float((m - km).abs().mean()),
                abs_var_err=float((v - kv).abs().mean()), gauss_kl=float(kl.mean())), finite


def conv_jax_rows():
    """JAX's rows of ``experiments/SUMMARY_convergence.json`` by (N, mode)
    and by particle count: the estimators' statistics, not TPU timings."""
    rows = json.loads((ROOT / "experiments/SUMMARY_convergence.json").read_text())["rows"]
    return ({(r["N"], r["mode"]): r for r in rows if "mode" in r},
            {r["nparticles"]: r for r in rows if r.get("method") == "pf"})


def phase_conv_data(smi):
    """The OU trials on the card (``torch.Generator`` seeded ``CONV_SEED``)
    and the exact KF's means and variances."""
    def run():
        x0, xs, ys = conv_simulate(CONV_B, torch.Generator(device="cuda").manual_seed(CONV_SEED))
        return (x0, xs, ys) + kalman_batch(ys)
    (x0, xs, ys, kf_m, kf_v), wall, peak = on_card(run)
    emit("conv_data", B=CONV_B, T=T, dt=CONV_DT, ell=CONV_ELL, sigma=CONV_SIGMA, xi=CONV_XI,
         wall_s=wall, peak_mem_added_gb=peak, state_range=[xs.min().item(), xs.max().item()],
         kf_var_last=kf_v[-1, 0].item(), card=smi)
    return dict(x0=x0, xs=xs, ys=ys, kf_m=kf_m, kf_v=kf_v)


def phase_conv_moment(data, smi):
    """The central (K1, "auto") and raw filters at every N of ``CONV_NS``
    on all trials, each scored against the KF beside JAX's row.  Checks:
    2T K1 launches a pass; no central trial lost, no raw trial at
    N <= ``CONV_RAW_CLEAN_N``; central ``abs_mean_err`` strictly falling
    in N; every row's mean and variance errors within 1.5 x JAX's.
    Returns the passes' outputs the later phases read."""
    jax_rows, _ = conv_jax_rows()
    kept, launches_all, bad = {}, 0, []
    keys = ("abs_mean_err", "abs_var_err")
    for mode in ("central", "raw"):
        for N in CONV_NS:
            launched_before = kernel_launches()
            (means, variances, nell, cmss), wall, peak = on_card(
                lambda: conv_filter(N, mode, data["ys"]))
            launches = kernel_launches(launched_before)["K1"]
            launches_all += launches
            row, finite = conv_scores(means, variances, data["kf_m"], data["kf_v"])
            jax_row = jax_rows[N, mode]
            emit("conv_moment", N=N, mode=mode, B=CONV_B, T=T, **row, wall_s=wall,
                 peak_mem_added_gb=peak, k1_launches=launches,
                 **{f"jax_{k}": jax_row[k] for k in ("divergent",) + keys + ("gauss_kl",)},
                 jax_trials=jax_row["trials"], card=smi)
            if launches != 2 * T:
                bad.append(f"{mode} N={N}: {launches} K1 launches")
            if row["divergent"] and (mode == "central" or N <= CONV_RAW_CLEAN_N):
                bad.append(f"{mode} N={N}: {row['divergent']} divergent")
            bad += [f"{mode} N={N} {k}" for k in keys
                    if not row[k] <= CONV_JAX_FACTOR * jax_row[k]]
            if mode == "central":
                kept[N] = dict(means=means, nell=nell, finite=finite, row=row, wall_s=wall,
                               ms10=cmss[9].contiguous(), mean10=means[9].contiguous())
    errs = [kept[N]["row"]["abs_mean_err"] for N in CONV_NS]
    bad += [f"central abs_mean_err N={a}->{b}" for a, b, e0, e1 in
            zip(CONV_NS, CONV_NS[1:], errs, errs[1:]) if not e1 < e0]
    emit("conv_moment_done", k1_launches=launches_all, failed=bad)
    if bad:
        raise AssertionError(f"convergence-study checks failed: {bad}")
    return kept, launches_all


def phase_conv_jacobi(data, central, smi):
    """The central filter at ``CONV_JACOBI_NS`` through ``eigh_impl="jacobi"``
    (f64 Cholesky, two solves and the in-repo cyclic Jacobi solver, plain
    torch on the card) against the K1 pass on the same trials: the same
    trials finite, nell within rtol 1e-6, the means' gap reported."""
    bad = []
    for N in CONV_JACOBI_NS:
        (means, variances, nell, _), wall, peak = on_card(
            lambda: conv_filter(N, "central", data["ys"], eigh_impl="jacobi"))
        ref = central[N]
        row, finite = conv_scores(means, variances, data["kf_m"], data["kf_v"])
        both = finite & ref["finite"]
        rel = ((nell - ref["nell"]).abs() / ref["nell"].abs())[both].max().item()
        gap = (means - ref["means"])[:, both].abs().max().item()
        same = bool((finite == ref["finite"]).all())
        emit("conv_jacobi", N=N, B=CONV_B, T=T, wall_s=wall, peak_mem_added_gb=peak,
             k1_wall_s=ref["wall_s"], nell_max_rel_gap=rel, means_max_abs_gap=gap,
             same_finite_trials=same, **row, card=smi)
        if not (same and rel <= CONV_JACOBI_RTOL):
            bad.append(N)
    if bad:
        raise AssertionError(f"the Jacobi route disagrees with K1's at N={bad}")


def phase_conv_taylor(data, central, smi):
    """``moment_filter_taylor`` (no quadrature: derivative towers of the
    model callables at the running mean) at N=3, ``taylor_order=2`` on all
    trials, scored against the KF.  Checks: every output finite; its means
    within 0.3 of the central N=3 filter's on average over trials and
    steps.  The JAX test's form of the bound, each trial's largest gap
    over time (one trial, 40 steps of a gentler model there), is
    reported: on 10,000 OU trials the Taylor rule's bias passes 0.3 on
    about a tenth of them (the method's, as JAX's filter gives the same
    means to 1e-10 on the CPU)."""
    from mfs_tpu_torch.one_dim.filtering import moment_filter_taylor
    from mfs_tpu_torch.one_dim.moments import raw_to_central
    from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all
    F, Q = conv_transition()
    N, ys = CONV_TAYLOR_N, data["ys"]
    zero = torch.zeros(ys.shape[1], dtype=ys.dtype, device=ys.device)
    launched_before = kernel_launches()
    (cmss, means, nell), wall, peak = on_card(lambda: moment_filter_taylor(
        lambda x, m: normal_raw_moments_all(F * x - m, Q, 2 * N), lambda x: F * x, conv_meas,
        raw_to_central(normal_raw_moments_all(zero, CONV_SIGMA**2, 2 * N)), zero, ys,
        taylor_order=CONV_TAYLOR_ORDER))
    row, _ = conv_scores(means, cmss[..., 2], data["kf_m"], data["kf_v"])
    gap = (means - central[N]["means"]).abs()
    per_trial = gap.amax(0)
    all_finite = bool(torch.isfinite(cmss).all() & torch.isfinite(nell).all())
    emit("conv_taylor", N=N, taylor_order=CONV_TAYLOR_ORDER, B=CONV_B, T=T, wall_s=wall,
         peak_mem_added_gb=peak, **row, all_finite=all_finite, mean_gap_to_central=gap.mean().item(),
         trial_max_gap_quantiles={q: per_trial.quantile(q).item() for q in (0.5, 0.9, 0.99)},
         trial_max_gap_max=per_trial.max().item(),
         trials_within_gap=(per_trial <= CONV_TAYLOR_MEAN_GAP).double().mean().item(),
         central_abs_mean_err=central[N]["row"]["abs_mean_err"],
         k1_launches=kernel_launches(launched_before)["K1"],
         card=smi)
    if not (all_finite and gap.mean().item() <= CONV_TAYLOR_MEAN_GAP):
        raise AssertionError(f"Taylor filter: finite {all_finite}, mean gap {gap.mean().item()}")


def run_conv_pf(ys, nparticles, generator):
    """The convergence script's PF foil on ys (T, b): the locally optimal
    proposal N(F x + K (y - F x), Q - K Q), stratified resampling, the
    particles' mean and variance a step.  Returns means, variances (T, b)."""
    from mfs_tpu_torch.filters.resampling import stratified
    from mfs_tpu_torch.filters.smc import particle_filter
    F, Q = conv_transition()
    gain = Q / (Q + CONV_XI)
    prop_var = Q - gain * Q
    b = ys.shape[1]
    normal = lambda x, m, v: torch.exp(-0.5 * (x - m) ** 2 / v) / math.sqrt(2 * math.pi * v)

    def proposal_sampler(anc, y, g):
        m = F * anc + gain * (y - F * anc)
        return m + math.sqrt(prop_var) * torch.randn(anc.shape, generator=g, dtype=anc.dtype,
                                                     device=anc.device)

    def init_sampler(g, n):
        return CONV_SIGMA * torch.randn((b, n), generator=g, dtype=ys.dtype, device=ys.device)

    return particle_filter(
        proposal_sampler, lambda x, anc, y: normal(x, F * anc + gain * (y - F * anc), prop_var),
        lambda x, anc: normal(x, F * anc, Q), conv_meas, ys, init_sampler, generator,
        nparticles, stratified, out_fn=lambda s: (s.mean(-1), s.var(-1, correction=0)))


def phase_conv_pf(data, smi):
    """The PF foil on the first ``CONV_PF_B`` trials at each particle count,
    scored against the KF: each row within 1.5 x JAX's."""
    _, jax_pf = conv_jax_rows()
    ys = data["ys"][:, :CONV_PF_B]
    bad = []
    for npart in CONV_PF_PARTICLES:
        gen = torch.Generator(device="cuda").manual_seed(CONV_SEED + 7)
        (pm, pv), wall, peak = on_card(lambda: run_conv_pf(ys, npart, gen))
        row, _ = conv_scores(pm, pv, data["kf_m"][:, :CONV_PF_B], data["kf_v"][:, :CONV_PF_B])
        jax_row = jax_pf[npart]
        emit("conv_pf", particles=npart, B=CONV_PF_B, T=T, resampling="stratified", **row,
             wall_s=wall, peak_mem_added_gb=peak,
             **{f"jax_{k}": jax_row[k] for k in ("abs_mean_err", "abs_var_err", "gauss_kl")},
             card=smi)
        bad += [f"{npart} {k}" for k in ("abs_mean_err", "abs_var_err")
                if not row[k] <= CONV_JAX_FACTOR * jax_row[k]]
    if bad:
        raise AssertionError(f"PF rows beyond 1.5 x JAX's: {bad}")


def phase_conv_pcrlb(data, smi):
    """``posterior_cramer_rao`` on all simulated trajectories with the OU
    transition and likelihood log-densities: on this linear-Gaussian model
    the bound equals the KF variance (rtol 1e-6)."""
    from mfs_tpu_torch.utils.pcrlb import posterior_cramer_rao
    F, Q = conv_transition()
    trajs = torch.cat([data["x0"][None], data["xs"]])[..., None]  # (T + 1, B, 1)
    j0 = torch.full((1, 1), 1.0 / CONV_SIGMA**2, dtype=trajs.dtype, device=trajs.device)
    js, wall, peak = on_card(lambda: posterior_cramer_rao(
        trajs, data["ys"][..., None], j0,
        lambda xt, xs: -0.5 * (xt[0] - F * xs[0]) ** 2 / Q,
        lambda y, x: -0.5 * (y[0] - x[0]) ** 2 / CONV_XI))
    bound = 1.0 / js[:, 0, 0]
    rel = ((bound - data["kf_v"][:, 0]).abs() / data["kf_v"][:, 0]).max().item()
    emit("conv_pcrlb", trajectories=CONV_B, T=T, wall_s=wall, peak_mem_added_gb=peak,
         max_rel_gap_to_kf_var=rel, pcrlb_last=bound[-1].item(), card=smi)
    if not rel <= CONV_PCRLB_RTOL:
        raise AssertionError(f"PCRLB vs KF variance: {rel}")


def at_density_steps(a):
    """``a (T, B, ...)`` at ``DENSITY_STEPS``, trial-major: (B * 10, ...)."""
    a = a[list(DENSITY_STEPS)].transpose(0, 1)
    return a.reshape((-1,) + a.shape[2:]).contiguous()


def density_approximations(cms, mean, xs_grid, name):
    """One approximation's densities ``(b, grid)`` of central moments
    ``cms (b, 2N)`` about ``mean (b)``: the scaled moments (scale
    sqrt(cms_2)) and their cumulants, then Gram–Charlier, Edgeworth
    (order 2), the saddle point (50 Newton steps; "saddle_point_start":
    none, the density at the Newton start), or the inverse Fourier
    transform of the K1-quadrature characteristic function,
    ``DENSITY_CHUNK`` densities a call."""
    from mfs_tpu_torch.one_dim.moments import _powers, characteristic_fn, sms_to_cumulants
    from mfs_tpu_torch.one_dim import pdf_approximations as pa
    scale = torch.sqrt(cms[:, 2])
    sms = cms / _powers(scale, cms.shape[-1])
    if name == "inverse_fourier":
        zs = torch.linspace(*DENSITY_Z, dtype=cms.dtype, device=cms.device)
        cfs = characteristic_fn(zs, cms, mean)
        return torch.cat([pa.inverse_fourier(xs_grid, c, zs)
                          for c in cfs.split(DENSITY_FOURIER_CHUNK)])
    if name.startswith("saddle_point"):
        iters = 0 if name == "saddle_point_start" else 50
        pdfs = [pa.saddle_point(s, m, c, newton_iters=iters)(xs_grid) for s, m, c in
                zip(sms.split(DENSITY_CHUNK), mean.split(DENSITY_CHUNK),
                    scale.split(DENSITY_CHUNK))]
        return torch.cat(pdfs)
    ks = sms_to_cumulants(sms, mean, scale)
    make = pa.gram_charlier if name == "gram_charlier" else lambda k: pa.edgeworth(k, 2)
    return torch.cat([make(k)(xs_grid) for k in ks.split(DENSITY_CHUNK)])


def phase_density(pss, xs_grid, moment, smi):
    """Densities of Fig 4's N=8 and N=15 filter states at t = 10, 20, ...,
    100 (every finite trial: up to 10,000 an N) by each approximation,
    against the grid truth: mean L1 (trapezoid) and sup distances, mean
    trapezoid mass.  Checks: Gram–Charlier's mean mass within 1e-2 of 1.
    Returns the first ``DENSITY_CPU_TRIALS`` trials' densities and inputs
    (all ten steps) for the CPU re-run, and K1's launches (one a
    characteristic function)."""
    tw = trapezoid_weights(xs_grid)
    keep, launches, bad = {}, 0, []
    for N in DENSITY_NS:
        res, finite = moment[N]["merged"], torch.as_tensor(moment[N]["finite"], device=pss.device)
        cms, mean, truth = (at_density_steps(a[:, finite])
                            for a in (res["cmss"], res["means"], pss))
        rows = DENSITY_CPU_TRIALS * len(DENSITY_STEPS)
        keep[N] = dict(cms=cms[:rows].cpu().numpy(), mean=mean[:rows].cpu().numpy())
        for name in DENSITY_METHODS:
            launched_before = kernel_launches()
            pdf, wall, peak = on_card(lambda: density_approximations(cms, mean, xs_grid, name))
            launched = kernel_launches(launched_before)["K1"]
            launches += launched
            diff = (pdf - truth).abs()
            mass = pdf @ tw
            l1 = diff @ tw
            row = dict(l1=float(l1.mean()), l1_median=float(l1.median()),
                       sup=float(diff.amax(-1).mean()),
                       mass=float(mass.mean()), mass_min=float(mass.min()),
                       finite_share=float(torch.isfinite(pdf).all(-1).double().mean()))
            emit("density", N=N, method=name, densities=cms.shape[0], grid=xs_grid.shape[0],
                 **row, wall_s=wall, peak_mem_added_gb=peak, k1_launches=launched,
                 z_grid=list(DENSITY_Z) if name == "inverse_fourier" else None, card=smi)
            keep[N][name] = pdf[:rows].cpu().numpy()
            if name == "gram_charlier" and not abs(row["mass"] - 1) <= DENSITY_MASS_GAP:
                bad.append(f"N={N} Gram-Charlier mass {row['mass']}")
        keep[N]["saddle_point_start"] = density_approximations(
            cms[:rows], mean[:rows], xs_grid, "saddle_point_start").cpu().numpy()
    if bad:
        raise AssertionError(f"density checks failed: {bad}")
    return keep, launches


def conv_cpu_rerun(ys):
    """The first trials' central filters at ``CONV_CPU_NS`` on CPU tensors
    (K1's plain version); run in a worker.  Returns nell by N."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = {N: conv_filter(N, "central", torch.as_tensor(ys), eigh_impl="fused")[2].numpy()
           for N in CONV_CPU_NS}
    return out, time.perf_counter() - t0


def density_cpu_rerun(inputs, xs_grid):
    """The first trials' densities on the CPU from the card's inputs, and
    each density's sensitivity: its largest change, over its peak, when
    every input moment moves by one ulp (fixed random signs); run in a
    worker.  Returns (densities, sensitivities) by N and approximation."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    xs_grid = torch.as_tensor(xs_grid)
    out = {}
    for N, inp in inputs.items():
        cms, mean = torch.as_tensor(inp["cms"]), torch.as_tensor(inp["mean"])
        signs = torch.as_tensor(np.random.RandomState(N).choice([-1.0, 1.0], cms.shape))
        moved = cms * (1 + signs * np.finfo(np.float64).eps)
        out[N] = {}
        for name in DENSITY_METHODS + ("saddle_point_start",):
            pdf = density_approximations(cms, mean, xs_grid, name)
            alt = density_approximations(moved, mean, xs_grid, name)
            sens = ((alt - pdf).abs().amax(-1) / pdf.abs().amax(-1)).numpy()
            out[N][name] = (pdf.numpy(), sens)
    return out, time.perf_counter() - t0


def start_conv_cpu_reference(pool, data, density_keep, xs_grid):
    inputs = {N: {k: density_keep[N][k] for k in ("cms", "mean")} for N in DENSITY_NS}
    return dict(
        conv=pool.apply_async(conv_cpu_rerun, (data["ys"][:, :CONV_CPU_TRIALS].cpu().numpy(),)),
        density=pool.apply_async(density_cpu_rerun, (inputs, xs_grid.cpu().numpy())))


def phase_conv_cpu_reference(pending, central, density_keep):
    """The CPU re-runs against the card: the OU central filters' nell within
    rtol 1e-6 (the 1D kernel-vs-plain bound) on the trials finite in both;
    each density within 1e-9 of its peak where it is well conditioned (a
    one-ulp move of its moments changes it by at most 1e-10 of its peak,
    on the CPU).  Ill-conditioned densities are counted and their gaps
    reported: the saddle point's 50 clipped Newton steps are chaotic
    almost everywhere, so its arithmetic is held at the Newton start
    ("saddle_point_start"), and Gram–Charlier at N=15 loses its digits
    to cancellation in the cumulants of order up to 29."""
    nells, conv_s = pending["conv"].get()
    bad, conv_rows = [], {}
    for N in CONV_CPU_NS:
        card = central[N]["nell"][:CONV_CPU_TRIALS].cpu().numpy()
        both = np.isfinite(card) & np.isfinite(nells[N])
        rel = float((np.abs(card - nells[N]) / np.abs(nells[N]))[both].max())
        conv_rows[N] = dict(finite_in_both=int(both.sum()), max_rel_gap=rel)
        if not (both.sum() == CONV_CPU_TRIALS and rel <= CONV_JACOBI_RTOL):
            bad.append(f"conv N={N}")
    cpu, density_s = pending["density"].get()
    density_rows = {}
    for N in DENSITY_NS:
        rows = {}
        for name, (ref, sens) in cpu[N].items():
            gap = np.abs(density_keep[N][name] - ref).max(-1) / np.abs(ref).max(-1)
            ok = sens <= 1e-10
            rows[name] = dict(
                well_conditioned=int(ok.sum()), densities=int(ok.size),
                max_gap_over_peak=float(gap[ok].max()) if ok.any() else None,
                max_gap_over_peak_ill=float(gap[~ok].max()) if (~ok).any() else None,
                median_sensitivity=float(np.median(sens)))
            if ok.any() and not gap[ok].max() <= DENSITY_CPU_RTOL:
                bad.append(f"density N={N} {name}")
        density_rows[N] = rows
    emit("conv_cpu_reference", conv_trials=CONV_CPU_TRIALS, conv=conv_rows,
         conv_cpu_seconds=conv_s, density_trials=DENSITY_CPU_TRIALS, density=density_rows,
         density_cpu_seconds=density_s)
    if bad:
        raise AssertionError(f"the card's convergence/density runs disagree with the CPU: {bad}")

def main():
    smi = phase_device()
    from mfs_tpu_torch.models.one_dim import benes_bernoulli
    from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme_normal

    phase_build()
    phase_eigh_batch_limit()
    xss, yss = phase_nd_data()
    lv3d_xss, lv3d_yss = phase_lv3d_data(smi)
    model = benes_bernoulli(N=N)
    trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
    # The timed phases run first, with no other work on the host: the
    # filter loops are host-bound, so their walls and idle shares would
    # otherwise measure the CPU reference's load as well.
    timing = phase_timing(model, trans)
    post1d_row = phase_post1d_timing(model, trans)
    launches, post1d_main, ys, tier0_out = phase_main_path(model, trans, smi)
    phase_forced_rescue(model, trans, ys)
    phase_profile(model, trans)
    scms_1d_nell, scms_1d_launches = phase_scms_1d(model, trans, ys, tier0_out, smi)
    setups, outs, nd_passes = phase_nd_main_path(smi, xss, yss)
    nd_rows = phase_nd_timing("prey_predator", setups, outs, ND_T)
    phase_nd_profile(setups)
    scms_nd = phase_scms_nd(setups, outs, yss, smi)
    lv3d_setups, lv3d_outs, lv3d_passes = phase_lv3d_moment(lv3d_xss, lv3d_yss, smi)
    phase_lv3d_gaussian(lv3d_xss, lv3d_yss, smi)
    nd_rows.update(phase_nd_timing("lotka_volterra_3d", lv3d_setups, lv3d_outs, LV3D_T))
    for order, res in scms_nd.items():
        nd_rows.update({(name, "prey_predator_scaled", order): row
                        for name, row in res["rows"].items()})
    nd_passes += lv3d_passes + [res["record"] for res in scms_nd.values()]
    mle_ys = phase_mle_data()
    mle_vals, mle_grad = phase_mle_grad(mle_ys, smi)
    with nccl_world() as (mesh, world_s):
        mesh_launches = phase_ensemble(model, trans, ys, tier0_out, mesh, world_s, smi)
        mesh_launches += phase_sharded_grad(mle_ys, mle_vals, mle_grad, mesh, smi)
    flops_launches = phase_flops(model, trans, ys, setups, smi)
    profiling_launches = phase_profiling(model, trans, ys, tier0_out, smi)
    trace_p, mle_launches = phase_mle(mle_ys, smi)
    phase_mle_profile(mle_ys)
    mle_row = phase_mle_k1_timing(mle_ys)
    fig4_ys = phase_fig4_data(smi)
    pss, xs_grid = phase_fig4_truth(fig4_ys, smi)
    moment = phase_fig4_moment(fig4_ys, smi)
    ghf = phase_fig4_ghf(fig4_ys, smi)
    zs = torch.linspace(-2.0, 2.0, FIG4_Z, dtype=torch.float64, device="cuda")
    pf = phase_fig4_pf(fig4_ys, zs, smi)
    scoring_launches = phase_fig4_scores(pss, xs_grid, zs, moment, ghf, pf, smi)
    fig4_rows = phase_fig4_k1_timing(moment, zs)
    conv = phase_conv_data(smi)
    central, conv_launches = phase_conv_moment(conv, smi)
    phase_conv_jacobi(conv, central, smi)
    phase_conv_taylor(conv, central, smi)
    phase_conv_pf(conv, smi)
    phase_conv_pcrlb(conv, smi)
    density_keep, density_launches = phase_density(pss, xs_grid, moment, smi)
    conv_row = k1_timing(central[15]["ms10"], central[15]["mean10"], zs)
    # Then the checks, while the CPU references run in worker processes.
    with multiprocessing.get_context("spawn").Pool(6) as pool:  # terminated on exit
        fig4_pending = start_fig4_cpu_reference(pool, fig4_ys)
        mle_pending = pool.apply_async(
            mle_cpu_rerun, (mle_ys[:, :MLE_CPU_TRIALS].cpu().numpy(), 1))
        pending = start_nd_cpu_reference(pool, yss)
        conv_pending = start_conv_cpu_reference(pool, conv, density_keep, xs_grid)
        lv3d_pending = start_lv3d_cpu_reference(pool, lv3d_yss)
        scms_pending = start_scms_cpu_reference(pool, ys, yss)
        phase_kernel_vs_plain()
        phase_k1_grad_vs_plain()
        phase_rescue_tiers(model, trans, ys, tier0_out)
        phase_cpu_reference(model, trans, ys, tier0_out)
        phase_nd_kernels_vs_plain()
        phase_nd_k_vs_plain()
        phase_nd_cpu_reference(outs, pending)
        phase_lv3d_cpu_reference(lv3d_outs, lv3d_pending)
        phase_scms_cpu_reference(scms_1d_nell, scms_nd, scms_pending)
        phase_mle_cpu_reference(mle_grad, trace_p, mle_pending)
        phase_fig4_cpu_reference(fig4_pending, pss, moment, ghf)
        phase_conv_cpu_reference(conv_pending, central, density_keep)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    # K1's times at the main path's batch, each batch's in "by_batch": the
    # main path (n=15, B=4096), a rescue bucket (B=512), the MLE path
    # (n=4, B=1000) with its launches (mle_grad's 2T + mle's) and the
    # gradient's times, and Fig 4's filter (n=8, B=1000: the N=8 pass's
    # launches) and scoring (n=15, B=100,000: the N=15 row's launch), and
    # the convergence study's central N=15 filter (n=15, B=10,000: its
    # pass's launches).  "launches" adds every Fig-4 launch (the five
    # passes and scorings), the convergence study's (28 passes), the
    # density recovery's (a characteristic function an N), the sharded
    # pass's and gradient's, the counted pass's, the timed and traced
    # passes' and the scaled filter's to the 1D main path's.
    mle_row.update(launches=2 * MLE_T + mle_launches)
    fig4_rows[0].update(launches=moment[8]["launches"])
    fig4_rows[1].update(launches=scoring_launches[15])
    conv_row.update(launches=2 * T)
    fig4_launches = sum(m["launches"] for m in moment.values()) + sum(scoring_launches.values())
    k1 = {"name": "quadrature_1d", "route": "cuda",
          "source": "mfs_tpu_torch/csrc/quadrature_1d.cu",
          "replaces": "mfs_tpu/ops/pallas_quadrature.py:95",
          "launches": launches + fig4_launches + conv_launches + density_launches
          + mesh_launches + flops_launches["quadrature_1d"] + profiling_launches
          + scms_1d_launches,
          **{k: timing[0][k] for k in keys}, "library_ms": None,
          "by_batch": [{k: row[k] for k in ("n", "B") + keys} for row in timing]
          + [{k: mle_row[k] for k in ("n", "B") + keys + ("launches", "grad_ms", "grad_lu_ms")}]
          + [{k: row[k] for k in ("n", "B") + keys + ("launches",)} for row in fig4_rows[:1]]
          + [{k: fig4_rows[1][k] for k in ("n", "B") + keys + (
              "launches", "max_abs_err_cf", "trials_beyond_1e_9")}]
          + [{k: conv_row[k] for k in ("n", "B") + keys + (
              "launches", "max_abs_err_cf", "trials_beyond_1e_9")}]}
    # Each ND kernel's launches over every ND pass (prey–predator central
    # and scaled, the 3D food chain) and the counted steps of ``flops``;
    # its times and bound at the largest basis it ran on (K2: the food
    # chain's N=3, s=10, d=3; the pair: prey–predator's N=11, s=66), each
    # pass's in "by_order".  The pair also replaces K3 (``_nd_k_kernel``),
    # which computes the same K_m in one program on the TPU.
    nd = []
    for name, replaces, also in (
            ("K2", "mfs_tpu/ops/pallas_quadrature_nd.py:70", []),
            ("nd_ldl", "mfs_tpu/ops/pallas_quadrature_nd.py:396",
             ["mfs_tpu/ops/pallas_quadrature_nd.py:561", "mfs_tpu/ops/pallas_quadrature_nd.py:576",
              "mfs_tpu/ops/pallas_quadrature_nd.py:271"]),
            ("nd_ksolve", "mfs_tpu/ops/pallas_quadrature_nd.py:471",
             ["mfs_tpu/ops/pallas_quadrature_nd.py:516",
              "mfs_tpu/ops/pallas_quadrature_nd.py:271"])):
        ran = [p for p in nd_passes if name in p["launches"]]
        top = max(ran, key=lambda p: (p["s"], p["d"]))
        row = lambda p: nd_rows[name, p["model"], p["N"]]
        nd.append({"name": "nd_eigh" if name == "K2" else name, "route": "cuda",
                   "source": "mfs_tpu_torch/csrc/quadrature_nd.cu", "replaces": replaces,
                   "also_replaces": also, "launches": sum(p["launches"][name] for p in ran)
                   + flops_launches["nd_eigh" if name == "K2" else name],
                   **{k: row(top)[k] for k in keys}, "library_ms": None,
                   "by_order": [{"model": p["model"], "N": p["N"], "d": p["d"], "s": p["s"],
                                 "launches": p["launches"][name], "B": row(p)["B"],
                                 **{k: row(p)[k] for k in keys + ("f64_library_path_ms",)}}
                                for p in ran]})
    # The 1D Bayes update replaces no TPU kernel (the JAX package leaves
    # the update to XLA).  "main_path_launches" is the rescued main path's
    # (one a filter step in every tier, checked there); "launches" adds
    # every other 1D filter step the smoke runs on the card, and leaves
    # out the timing's own calls.
    post1d = {"name": "posterior_1d", "route": "cuda",
              "source": "mfs_tpu_torch/csrc/posterior_1d.cu", "replaces": None,
              "launches": kernel_launches()["post1d"] - post1d_row["timed_launches"],
              "main_path_launches": post1d_main,
              **{k: post1d_row[k] for k in keys}, "library_ms": None,
              "by_batch": [{k: post1d_row[k] for k in ("n", "B") + keys}]}
    print(json.dumps({"kernels": [k1] + nd + [post1d]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
