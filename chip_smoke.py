"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — the Beneš–Bernoulli N=15 central-moment
filter, T=100, B=4096, TME-2 Normal-closure transitions, with the
divergence rescue (tier 1: the same filter with Gram jitter 1e-8 in
512-trial buckets; tier 2: the f64 ``stable=True`` LAPACK path on the
card) — and holds every CUDA kernel of that path against its plain
PyTorch version.

    python3 chip_smoke.py

The first line is the card's name and power limit as ``nvidia-smi``
gives them; then each phase prints one JSON line, and any failure raises
and exits non-zero.  The line before the last lists the kernels, the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU and ``nvcc``
(``/usr/local/cuda/bin`` or on ``PATH``); imports nothing of JAX.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

N = 15
T = 100
BATCH = 4096
TIER1_BUCKET = 512
TIER1_JITTER = 1e-8
CPU_SUBSET = 256
FORCED_LOST = 600  # > one tier-1 bucket: the forced rescue runs two
# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; FP64 outside the
# tensor cores at 34 TFLOP/s (an FMA counts as two operations).  K1 is
# scalar FP64 code, so the FP64 tensor-core rate does not apply.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time per call, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_flops(n):
    """FP64 operations K1 does per trial at order n, counted from
    ``csrc/quadrature_1d.cu`` (add, sub, mul, div, sqrt one each; no
    iteration depends on the data).  Returns (operations, divisions)."""
    equil = 2 * n + (n - 1)                                  # sqrt, 1/x, ratios
    ldl = sum((n - j) * (3 * j + 2) + (n - j - 1) for j in range(n))
    gw = 2 * (n - 1) + 3 * (n - 1)
    back = 2 * n * (n - 1) // 2 + n + 1
    qform = 3 * n * (n + 1) // 2 + n * (n - 1) // 2
    gersh = 6 * n + 4
    sturm = 1 + 3 * (n - 1)
    bisect = n * 32 * (2 + sturm)
    newton = n * 8 * (8 * n + 2)
    weights = n * (2 + 7 * (n - 1) + 1 + 2)
    ops = equil + ldl + gw + back + qform + gersh + bisect + newton + weights
    divs = (2 * n - 1) + n * (n - 1) // 2 + (n - 1) + 1 + n * 32 * (n - 1) + n * 8 + n * n
    return ops, divs


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


def phase_build():
    from mfs_tpu_torch.ops import build
    t0 = time.perf_counter()
    logs = build.build(["quadrature_1d"])
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: [ln.strip() for ln in v.splitlines() if "Used" in ln or "stack" in ln]
                for k, v in logs.items()})


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
    """K1 at the main path's shape (n = 15, B = 4096) against its plain
    version and the f64 library pipeline, on the same inputs."""
    from mfs_tpu_torch.ops import quadrature_kernel as qk
    ms, mean = main_path_inputs(model, trans)
    ms, mean = ms[:BATCH], mean[:BATCH]
    B = ms.shape[0]
    scale = torch.ones_like(mean)
    w, x = qk.moment_quadrature_fused(ms, mean, scale)
    torch.cuda.synchronize()
    wp, xp = qk.moment_quadrature_fused_plain(ms, mean, scale)
    both = torch.isfinite(w).all(-1) & torch.isfinite(x).all(-1) & \
        torch.isfinite(wp).all(-1) & torch.isfinite(xp).all(-1)
    err = max((x - xp)[both].abs().max().item(), (w - wp)[both].abs().max().item())
    if not err < 1e-9:
        raise AssertionError(f"K1 disagrees with its plain version on main-path inputs: {err}")

    ms_k = cuda_ms(lambda: qk.moment_quadrature_fused(ms, mean, scale), reps=20)
    plain_k = cuda_ms(lambda: qk.moment_quadrature_fused_plain(ms, mean, scale), reps=3, warmup=1)

    g = torch.as_tensor(np.add.outer(np.arange(N), np.arange(N)), device="cuda")

    def library_path():
        # cholesky + 2 triangular solves + eigh: a multi-call yardstick,
        # no single PyTorch call computes K1's function.
        R, _ = torch.linalg.cholesky_ex(ms[:, g])
        X = torch.linalg.solve_triangular(R, ms[:, g + 1], upper=False)
        K = torch.linalg.solve_triangular(R.mT, X, upper=True, left=False)
        return torch.linalg.eigh(0.5 * (K + K.mT))
    lib_k = cuda_ms(library_path, reps=3, warmup=1)

    ops, divs = k1_flops(N)
    nbytes = (4 * N + 2) * 8 * B
    bound = max(nbytes / HBM_BYTES_PER_S, ops * B / FP64_FLOP_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S > ops * B / FP64_FLOP_PER_S else "operations"
    emit("timing", n=N, B=B, kernel_ms=ms_k, plain_ms=plain_k, f64_library_path_ms=lib_k,
         f64_library_path_note="cholesky_ex + 2 solve_triangular + eigh, multi-call yardstick",
         bound_ms=bound, bound_by=bound_by, fp64_ops_per_trial=ops,
         fp64_divisions_per_trial=divs, bytes=nbytes, max_abs_err=err)
    return dict(ms=ms_k, plain_ms=plain_k, bound_ms=bound, bound_by=bound_by,
                max_abs_err=err)


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
    from mfs_tpu_torch.ops import quadrature_kernel as qk
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

    qk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged, finite, rescued = rescue_diverged(
        run_fast, [tier1, tier2], ys, finite_fn, {"cms_last": 0, "nell": 0},
        bucket=TIER1_BUCKET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = qk.LAUNCHES

    lost = int((~masks[0]).sum())
    per_tier = []
    for mask in masks[1:]:
        per_tier.append(int(mask[:lost].sum()))
        lost -= per_tier[-1]
    buckets1 = -(-int((~masks[0]).sum()) // TIER1_BUCKET)
    finite0 = float(masks[0].mean())
    final = float(finite.mean())
    emit("main_path", N=N, T=T, B=BATCH, finite_frac_tier0=finite0,
         finite_frac_rescued=final, rescued_tier1=per_tier[0] if per_tier else 0,
         rescued_tier2=per_tier[1] if len(per_tier) > 1 else 0, rescued_total=rescued,
         tier1_buckets=buckets1, k1_launches=launches, wall_s=wall,
         trials_per_s=BATCH / wall, card=smi)
    if launches != 2 * T * (1 + buckets1) or launches == 0:
        raise AssertionError(f"K1 launched {launches} times, expected {2 * T * (1 + buckets1)}")
    if merged["nell"].shape != (BATCH,) or merged["cms_last"].shape != (BATCH, 2 * N):
        raise AssertionError("main-path outputs have the wrong shape")
    if not (final > 0.93 and final >= finite0):
        raise AssertionError(f"finite_frac {final} (tier 0: {finite0})")
    return launches, ys, tier0_out


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
    from mfs_tpu_torch.ops import quadrature_kernel as qk
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

    qk.LAUNCHES = 0
    t0 = time.perf_counter()
    merged, finite, rescued = rescue_diverged(
        tier0, [tier1, tier2], ys, finite_fn, {"cms_last": 0, "nell": 0},
        bucket=TIER1_BUCKET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = qk.LAUNCHES
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


def main():
    smi = phase_device()
    from mfs_tpu_torch.models.one_dim import benes_bernoulli
    from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme_normal

    phase_build()
    phase_kernel_vs_plain()
    model = benes_bernoulli(N=N)
    trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
    timing = phase_timing(model, trans)
    launches, ys, tier0_out = phase_main_path(model, trans, smi)
    phase_rescue_tiers(model, trans, ys, tier0_out)
    phase_forced_rescue(model, trans, ys)
    phase_cpu_reference(model, trans, ys, tier0_out)
    phase_profile(model, trans)
    print(json.dumps({"kernels": [{
        "name": "quadrature_1d",
        "route": "cuda",
        "source": "mfs_tpu_torch/csrc/quadrature_1d.cu",
        "replaces": "mfs_tpu/ops/pallas_quadrature.py:95",
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
