"""The port's grid filter, sigma-point rules, ``simulate_trials`` and the
Fig-4 scoring helpers of ``chip_smoke.py`` against the JAX package's.

- ``brute_force_filter`` for all four prediction methods, three trials
  filtered in one batched call, at rtol 1e-10 (the Kolmogorov method on
  320 points, as ``tests/test_classical_filters.py`` runs it).
- The sigma-point rules' points and weights, batched sigma points and
  ``gaussian_expectation``.
- ``simulate_trials``: trial i depends only on (seed, i).
- ``chip_smoke.cf_errors``, ``true_cf`` and ``metrics`` against
  ``experiments/compute_errors.py::cf_errors`` and
  ``experiments/method_comparison.py::_true_cf_and_mean`` and
  ``_metrics`` on 4 trials at N=3, at rtol 1e-8.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from experiments.compute_errors import cf_errors as j_cf_errors  # noqa: E402
from experiments.method_comparison import _metrics as j_metrics  # noqa: E402
from experiments.method_comparison import _true_cf_and_mean as j_true_cf  # noqa: E402
from mfs_tpu.filters.grid import brute_force_filter as j_brute_force_filter  # noqa: E402
from mfs_tpu.filters.sigma_points import SigmaPoints as JSigmaPoints  # noqa: E402
from mfs_tpu.filters.sigma_points import gaussian_expectation as j_gaussian_expectation  # noqa: E402
from mfs_tpu.models import benes_bernoulli as j_benes  # noqa: E402
from mfs_tpu_torch.filters.grid import brute_force_filter  # noqa: E402
from mfs_tpu_torch.filters.sigma_points import SigmaPoints, gaussian_expectation  # noqa: E402
from mfs_tpu_torch.models.one_dim import benes_bernoulli  # noqa: E402
from mfs_tpu_torch.one_dim.filtering import moment_filter_cms  # noqa: E402
from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme_normal  # noqa: E402


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _grid_inputs(n, B=3, T=20, seed=0):
    xs = np.linspace(-5.0, 5.0, n)
    ys = np.random.RandomState(seed).binomial(1, 0.5, (T, B)).astype(np.float64)
    tm = benes_bernoulli(N=2, device="cpu")
    init = np.broadcast_to(tm.init_cond.pdf(_t(xs)).numpy(), (B, n))
    return xs, ys, init, tm


@pytest.mark.parametrize("method, n, steps", [
    ("chapman-euler", 240, 4), ("chapman-tme-2", 240, 4), ("chapman-tme-3", 240, 10),
    ("kolmogorov", 320, 24)])
def test_brute_force_filter_matches_jax(method, n, steps):
    xs, ys, init, tm = _grid_inputs(n)
    jm = j_benes(N=2)
    ref = j_brute_force_filter(jm.drift, jm.dispersion, jm.measurement_cond_pdf,
                               jnp.asarray(init), jnp.asarray(xs), jnp.asarray(ys), jm.dt,
                               integration_steps=steps, pred_method=method)
    got = brute_force_filter(tm.drift, tm.dispersion, tm.measurement_cond_pdf, _t(init), _t(xs),
                             _t(ys), tm.dt, integration_steps=steps, pred_method=method)
    assert got.shape == (20, 3, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)
    with pytest.raises(NotImplementedError):
        brute_force_filter(tm.drift, tm.dispersion, tm.measurement_cond_pdf, _t(init), _t(xs),
                           _t(ys), tm.dt, pred_method="runge-kutta")


def test_sigma_point_rules_match_jax():
    for rule, jrule in ((SigmaPoints.gauss_hermite(2, 3, device="cpu"), JSigmaPoints.gauss_hermite(2, 3)),
                        (SigmaPoints.cubature(3, device="cpu"), JSigmaPoints.cubature(3)),
                        (SigmaPoints.unscented(2, alpha=0.5, device="cpu"),
                         JSigmaPoints.unscented(2, alpha=0.5))):
        assert rule.n_points == jrule.n_points
        for a, b in ((rule.w, jrule.w), (rule.xi, jrule.xi), (rule.wc, jrule.wc)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=1e-15)
    # batched points: the point axis leads, then the trials
    rng = np.random.RandomState(0)
    ms, L = rng.randn(4, 2), np.tril(rng.rand(4, 2, 2)) + np.eye(2)
    chi = SigmaPoints.gauss_hermite(2, 3, device="cpu").gen_sigma_points(_t(ms), _t(L))
    assert chi.shape == (9, 4, 2)
    for b in range(4):
        ref = JSigmaPoints.gauss_hermite(2, 3).gen_sigma_points(jnp.asarray(ms[b]), jnp.asarray(L[b]))
        np.testing.assert_allclose(chi[:, b].numpy(), np.asarray(ref), rtol=1e-14)
    mk, ck = rng.randn(7, 1), 0.2 + rng.rand(7, 1, 1)
    got = gaussian_expectation(_t(mk), _t(ck), lambda v: v[..., 0] ** 4)
    ref = j_gaussian_expectation(jnp.asarray(mk), jnp.asarray(ck), lambda v: v[..., 0] ** 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)


def test_simulate_trials_is_chunking_invariant():
    sim = benes_bernoulli(N=2, device="cpu").simulate_trials
    whole = sim(0, np.arange(6), 2)
    parts = torch.cat([sim(0, np.arange(3), 2), sim(0, np.arange(3, 6), 2)])
    picked = sim(0, [4, 1], 2)
    assert whole.shape == (6, 100) and bool(torch.isfinite(whole).all())
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-12)
    np.testing.assert_allclose(picked.numpy(), whole[[4, 1]].numpy(), rtol=1e-12)
    assert (sim(1, [4], 2) - whole[4]).abs().max().item() > 1e-3


def test_scoring_helpers_match_jax():
    """4 Beneš trials, the N=3 central filter's moments (and its raw
    moments), against a 600-point grid truth: ``cf_errors`` (central and
    raw) and ``metrics`` (one trial marked divergent) as JAX's scripts
    compute them from the same numpy arrays."""
    N, B, T = 3, 4, 20
    xs, ys, init, tm = _grid_inputs(600, B=B, T=T, seed=1)
    pss = brute_force_filter(tm.drift, tm.dispersion, tm.measurement_cond_pdf, _t(init), _t(xs),
                             _t(ys), tm.dt, integration_steps=10,
                             pred_method="chapman-tme-3").transpose(0, 1).numpy()
    model = benes_bernoulli(N=N, device="cpu")
    trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 3, N)
    ic = model.init_cond
    cmss, means, _ = moment_filter_cms(trans.cms, trans.mean, model.measurement_cond_pdf,
                                       ic.cms.expand(B, 2 * N), ic.mean.expand(B), _t(ys))
    cmss, means = cmss.numpy(), means.numpy()
    orders = np.arange(2 * N)
    binom = np.array([[math.comb(p, k) if k <= p else 0 for k in orders] for p in orders])
    # raw moments from the central ones: E[X^p] = sum_k C(p, k) m^(p-k) E[(X - m)^k]
    rmss = np.einsum("pk,tbk,tbpk->tbp", binom, cmss,
                     means[..., None, None] ** (orders[:, None] - orders[None, :]).clip(0))
    zs = np.linspace(-2.0, 2.0, 400)
    for moments, mean in ((cmss, means), (rmss, None)):
        got = chip_smoke.cf_errors(_t(moments), _t(pss), _t(xs), _t(zs),
                                   None if mean is None else _t(mean))
        ref = j_cf_errors(jnp.asarray(moments), jnp.asarray(pss), jnp.asarray(xs),
                          jnp.asarray(zs), None if mean is None else jnp.asarray(mean))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8)

    re_t, im_t, means_t = chip_smoke.true_cf(_t(pss), _t(xs), _t(zs))
    for a, b in zip((re_t, im_t, means_t), j_true_cf(jnp.asarray(pss), jnp.asarray(xs),
                                                     jnp.asarray(zs))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-14)
    est = chip_smoke.gaussian_cf(_t(means.T), _t(cmss[..., 2].T), _t(zs))
    finite = np.array([True, False, True, True])
    got = chip_smoke.metrics(est, (re_t, im_t), _t(means.T), means_t, finite, _t(zs))
    ref = j_metrics(tuple(jnp.asarray(a.numpy()) for a in est),
                    (jnp.asarray(re_t.numpy()), jnp.asarray(im_t.numpy())),
                    jnp.asarray(means.T), jnp.asarray(means_t.numpy()), finite, jnp.asarray(zs))
    assert got["divergent"] == ref["divergent"] == 1
    for k in ("cf_sup", "cf_l1", "cf_l2", "mean_abs_err"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-8)
