"""The port's spans and counters (``mfs_tpu_torch/utils/profiling.py``) on
the CPU: each quadrature loop's spans under ``torch.profiler``, nested
as the layers are, outputs unchanged by the profiler, the counters of
steps, quadratures by route and the rescue's trials, and the host-side
span totals against the profile.  Imports neither ``jax`` nor
``mfs_tpu``."""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mfs_tpu_torch.models.multi_dims import prey_predator  # noqa: E402
from mfs_tpu_torch.models.one_dim import benes_bernoulli  # noqa: E402
from mfs_tpu_torch.multi_dims import filtering as nd_filtering  # noqa: E402
from mfs_tpu_torch.multi_dims.moments import sde_cond_moments_nd_euler_maruyama  # noqa: E402
from mfs_tpu_torch.multi_dims.multi_indices import (  # noqa: E402
    generate_graded_lexico_multi_indices,
    gram_and_hankel_indices_graded_lexico,
)
from mfs_tpu_torch.one_dim import filtering  # noqa: E402
from mfs_tpu_torch.parallel.ensemble import rescue_diverged  # noqa: E402
from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme_normal  # noqa: E402
from mfs_tpu_torch.utils import profiling  # noqa: E402

T, B = 5, 8
LOOP_SPANS = ("mfs.filter", "mfs.step", "mfs.quadrature", "mfs.transition", "mfs.update")


def _loop_1d(mode):
    N = 3
    model = benes_bernoulli(N=N, device="cpu")
    trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
    ic, pdf = model.init_cond, model.measurement_cond_pdf
    ys = torch.as_tensor(np.random.RandomState(1).binomial(1, 0.5, (T, B)).astype(np.float64))
    quad = dict(eigh_impl="refined")
    if mode == "rms":
        return lambda: filtering.moment_filter_rms(trans.rms, pdf, ic.rms.expand(B, 2 * N), ys,
                                                   **quad)
    if mode == "cms":
        return lambda: filtering.moment_filter_cms(trans.cms, trans.mean, pdf,
                                                   ic.cms.expand(B, 2 * N), ic.mean.expand(B),
                                                   ys, **quad)
    return lambda: filtering.moment_filter_scms(
        trans.scms, trans.mean_var, pdf, ic.scms.expand(B, 2 * N), ic.mean.expand(B),
        torch.sqrt(ic.variance).expand(B), ys, **quad)


def _loop_nd(mode):
    N = 2
    mis = generate_graded_lexico_multi_indices(2, 2 * N - 1)
    inds = gram_and_hankel_indices_graded_lexico(N, 2)
    model = prey_predator(mis, device="cpu")
    trans = sde_cond_moments_nd_euler_maruyama(model.drift, model.dispersion, model.dt, mis)
    ic, pdf = model.init_cond, model.measurement_cond_pdf
    ys = torch.as_tensor(np.random.RandomState(2).binomial(1, 0.5, (T, B, 1)).astype(np.float64))
    order, quad = (mis, inds), dict(eigh_impl="refined")
    if mode == "rms":
        return lambda: nd_filtering.moment_filter_nd_rms(trans.rms, pdf, ys, order,
                                                         ic.rms.expand(B, -1), **quad)
    if mode == "cms":
        return lambda: nd_filtering.moment_filter_nd_cms(
            trans.cms, trans.mean, pdf, ys, order, ic.cms.expand(B, -1), ic.mean.expand(B, 2),
            **quad)
    scale = torch.sqrt(torch.diagonal(ic.cov))
    scms = ic.cms / torch.prod(scale ** torch.as_tensor(mis), dim=-1)
    return lambda: nd_filtering.moment_filter_nd_scms(
        trans.scms, trans.mean_var, pdf, ys, order, scms.expand(B, -1), ic.mean.expand(B, 2),
        scale.expand(B, 2), **quad)


def _mfs_events(prof):
    """(name, start_ns, end_ns) of every ``mfs.`` range on the host."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("mfs.") and e.device_type() == torch.autograd.DeviceType.CPU]


@pytest.mark.parametrize("loop", ["rms", "cms", "scms", "nd_rms", "nd_cms", "nd_scms"])
def test_each_quadrature_loop_shows_its_spans_and_counts(loop):
    """Under ``torch.profiler`` one filter call shows one ``mfs.filter``, T
    ``mfs.step``, 2T ``mfs.quadrature``, T ``mfs.transition`` and T
    ``mfs.update``, each inside a step; the outputs are bit for bit those
    of the call without a profiler; ``filter.steps`` counts T and
    ``quadrature.calls.refined`` 2T; and the span totals' calls grow by
    the profile's counts."""
    run = _loop_nd(loop[3:]) if loop.startswith("nd_") else _loop_1d(loop)
    plain = run()
    profiling.reset_counters()
    totals = profiling.span_totals()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = run()
    counts = profiling.counters()
    grown = {k: v["calls"] - totals.get(k, {"calls": 0})["calls"]
             for k, v in profiling.span_totals().items()}

    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    events = _mfs_events(prof)
    seen = Counter(name for name, _, _ in events)
    assert {k: seen[k] for k in LOOP_SPANS} == {"mfs.filter": 1, "mfs.step": T,
                                               "mfs.quadrature": 2 * T,
                                               "mfs.transition": T, "mfs.update": T}
    steps = [(s, e) for name, s, e in events if name == "mfs.step"]
    for name, s, e in events:
        if name in ("mfs.quadrature", "mfs.transition", "mfs.update"):
            assert sum(s0 <= s and e <= e0 for s0, e0 in steps) == 1, name
    assert counts["filter.steps"] == T
    assert counts["quadrature.calls.refined"] == 2 * T
    assert counts["quadrature.trials.refined"] == 2 * T * B
    assert {k: v for k, v in grown.items() if v} == dict(seen)


def test_a_forced_rescue_counts_the_trials_each_tier_takes():
    """A CPU rescue in which tier 0 loses every fifth trial: tier 1 is
    handed those trials and keeps them, the counters say so, each tier
    runs inside its span, and the masks and the splice inside theirs."""
    N, b, bucket = 3, 23, 4
    model = benes_bernoulli(N=N, device="cpu")
    trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
    ic = model.init_cond
    ys = torch.as_tensor(np.random.RandomState(3).binomial(1, 0.5, (T, b)).astype(np.float64))
    lost = torch.arange(b) % 5 == 1

    def runner(lose):
        def run(y):
            cmss, means, nell = filtering.moment_filter_cms(
                trans.cms, trans.mean, model.measurement_cond_pdf,
                ic.cms.expand(y.shape[1], 2 * N), ic.mean.expand(y.shape[1]), y,
                eigh_impl="refined")
            if lose:
                nell = torch.where(lost, torch.nan, nell)
            return {"cms_last": cmss[-1], "nell": nell}
        return run

    def finite_fn(out):
        return torch.isfinite(out["nell"]) & torch.isfinite(out["cms_last"]).all(-1)

    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        merged, finite, rescued = rescue_diverged(runner(True), [runner(False)], ys, finite_fn,
                                                  {"cms_last": 0, "nell": 0}, bucket=bucket)
    counts = profiling.counters()
    handed = int(lost.sum())
    assert rescued == handed and bool(finite.all())
    assert counts["rescue.handed.tier1"] == handed == counts["rescue.kept.tier1"]
    assert counts["rescue.kept.tier0"] == b - handed
    buckets = -(-handed // bucket)
    assert counts["filter.steps"] == T * (1 + buckets)
    assert "sync.rescue_mask" not in counts  # CPU tensors: the host waits for nothing
    seen = Counter(name for name, _, _ in _mfs_events(prof))
    assert seen["mfs.rescue.tier0"] == seen["mfs.rescue.tier1"] == seen["mfs.rescue.splice"] == 1
    assert seen["mfs.rescue.mask"] == 2 and seen["mfs.filter"] == 1 + buckets
    expected = runner(False)(ys)
    assert torch.equal(merged["nell"], expected["nell"])


def test_the_exporters_chrome_trace_names_the_programs_spans(tmp_path):
    """``trace(dir)``, the operator's exporter, writes the program's
    ``mfs.`` spans into its Chrome trace."""
    import json
    with profiling.trace(str(tmp_path)):
        _loop_1d("cms")()
    names = Counter(e.get("name") for e in
                    json.loads((tmp_path / "trace.json").read_text())["traceEvents"])
    assert names["mfs.filter"] == 1 and names["mfs.step"] == T
    assert names["mfs.quadrature"] == 2 * T and names["mfs.update"] == T


def test_a_span_is_a_host_range_and_not_a_user_annotation():
    """Under ``torch.profiler`` a span is an op's range on the host, not a
    ``record_function`` user annotation: the profiler copies a user
    annotation onto the device's timeline as an event of its own, where a
    reader of the trace would take it for device work."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("mfs.test"):
            torch.ones(2).sum()
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "mfs.test"]
    assert e.device_type() == torch.autograd.DeviceType.CPU
    assert not e.is_user_annotation()
    assert profiling.span_totals()["mfs.test"]["calls"] >= 1
