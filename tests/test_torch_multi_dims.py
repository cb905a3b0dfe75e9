"""Port vs JAX: the ND building blocks on the same numpy inputs.

Multi-index tables (exact), monomials, Kan–Magnus moments and
Gaussian-sum moments (rtol 1e-12: the two sides evaluate the same
expression with sums in a possibly different order), the vector TME
(rtol 1e-11, as the 1D TME tests), the polynomial TME's constant tables
(exact) and its fused predictions at N=3 (rtol 1e-11), and the ND
models.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mfs_tpu.models.multi_dims import lotka_volterra_3d as j_lv3d  # noqa: E402
from mfs_tpu.models.multi_dims import prey_predator as j_prey_predator  # noqa: E402
from mfs_tpu.multi_dims import moments as j_moments  # noqa: E402
from mfs_tpu.multi_dims import multi_indices as j_mi  # noqa: E402
from mfs_tpu.multi_dims.poly_tme import poly_tme_nd as j_poly_tme_nd  # noqa: E402
from mfs_tpu.sde import tme as j_tme  # noqa: E402
from mfs_tpu.utils.gaussian import GaussianSumND as JGaussianSumND  # noqa: E402
from mfs_tpu_torch.interop import gaussian_sum_nd_from_numpy, nd_filter_inputs_from_numpy  # noqa: E402
from mfs_tpu_torch.models.multi_dims import lotka_volterra_3d, prey_predator  # noqa: E402
from mfs_tpu_torch.multi_dims import moments, multi_indices  # noqa: E402
from mfs_tpu_torch.multi_dims.poly_tme import poly_tme_nd  # noqa: E402
from mfs_tpu_torch.sde import tme  # noqa: E402

RTOL = 1e-12
DT = 1e-3


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _mvn(d, B, seed):
    rng = np.random.RandomState(seed)
    mean = 0.3 * rng.randn(B, d)
    a = rng.randn(B, d, d)
    return mean, np.einsum("bij,bkj->bik", a, a) * 0.1 + 0.5 * np.eye(d)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("N", [2, 3, 5, 7])
def test_index_tables_equal_jax(d, N):
    mis = multi_indices.generate_graded_lexico_multi_indices(d, 2 * N - 1)
    np.testing.assert_array_equal(mis, j_mi.generate_graded_lexico_multi_indices(d, 2 * N - 1))
    np.testing.assert_array_equal(
        multi_indices.gram_and_hankel_indices_graded_lexico(N, d),
        np.asarray(j_mi.gram_and_hankel_indices_graded_lexico(N, d)))
    np.testing.assert_array_equal(multi_indices.find_indices(mis), np.arange(mis.shape[0]))
    assert multi_indices.sizeof_multi_indices(d, 2 * N - 1) == mis.shape[0]


@pytest.mark.parametrize("d", [2, 3])
def test_monomials_nd(d):
    mis = multi_indices.generate_graded_lexico_multi_indices(d, 9)
    x = np.random.RandomState(d).randn(4, 7, d)
    np.testing.assert_allclose(moments.monomials_nd(_t(x), mis).numpy(),
                               np.asarray(j_moments.monomials_nd(jnp.asarray(x), mis)),
                               rtol=RTOL)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_weighted_monomials_nd(d):
    """The factorised Σ_m w_m x_m^k equals the weights contracted with the
    JAX package's monomials (rtol 1e-12: another order of the sums)."""
    mis = multi_indices.generate_graded_lexico_multi_indices(d, 7)
    rng = np.random.RandomState(d)
    x, w = rng.randn(3, 11, d), rng.rand(3, 11)
    want = np.einsum("bmz,bm->bz", np.asarray(j_moments.monomials_nd(jnp.asarray(x), mis)), w)
    got = moments.weighted_monomials_nd(_t(w), _t(x), mis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("d", [2, 3])
def test_raw_moments_mvn_kan_all(d):
    mis = multi_indices.generate_graded_lexico_multi_indices(d, 7)
    mean, cov = _mvn(d, 5, d)
    got = moments.raw_moments_mvn_kan_all(_t(mean), _t(cov), mis).numpy()
    want = np.asarray(j_moments.raw_moments_mvn_kan_all(jnp.asarray(mean), jnp.asarray(cov), mis))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-13)


def test_moment_accessors():
    d, N = 2, 3
    mis = multi_indices.generate_graded_lexico_multi_indices(d, 2 * N - 1)
    mean, cov = _mvn(d, 3, 0)
    ms = j_moments.raw_moments_mvn_kan_all(jnp.asarray(mean), jnp.asarray(cov), mis)
    tms = _t(ms)
    np.testing.assert_array_equal(moments.extract_mean(tms, d).numpy(),
                                  np.asarray(j_moments.extract_mean(ms, d)))
    np.testing.assert_array_equal(moments.extract_cov(tms, d).numpy(),
                                  np.asarray(j_moments.extract_cov(ms, d)))
    np.testing.assert_array_equal(moments.marginalise_moments(tms, d, N, 1).numpy(),
                                  np.asarray(j_moments.marginalise_moments(ms, d, N, 1)))


def test_gaussian_sum_nd():
    mis = multi_indices.generate_graded_lexico_multi_indices(2, 5)
    means = [[1.0, 0.5], [-0.3, 1.2]]
    covs = [[[0.2, 0.05], [0.05, 0.1]], [[0.3, 0.0], [0.0, 0.15]]]
    weights = [0.3, 0.7]
    gs = gaussian_sum_nd_from_numpy(means, covs, weights, mis, device="cpu")
    jg = JGaussianSumND.new(jnp.asarray(means), jnp.asarray(covs), jnp.asarray(weights), mis)
    for name in ("rms", "cms", "mean", "cov"):
        np.testing.assert_allclose(getattr(gs, name).numpy(), np.asarray(getattr(jg, name)),
                                   rtol=RTOL, atol=1e-15)
    x = np.array([[0.2, 0.9], [1.1, 0.4]])
    np.testing.assert_allclose(gs.pdf(_t(x)).numpy(),
                               np.asarray(jax.jit(jax.vmap(jg.pdf))(jnp.asarray(x))), rtol=RTOL)
    np.testing.assert_allclose(gs.logpdf(_t(x)).numpy(),
                               np.asarray(jax.jit(jax.vmap(jg.logpdf))(jnp.asarray(x))), rtol=RTOL)
    # 40,000 draws: sample mean within 5 standard errors of the mixture mean
    draws = gs.sampler(torch.Generator().manual_seed(0), 40000)
    assert draws.shape == (40000, 2)
    se = np.sqrt(np.diag(gs.cov.numpy()) / 40000)
    assert np.all(np.abs(draws.mean(0).numpy() - gs.mean.numpy()) < 5 * se)


@pytest.fixture(scope="module")
def prey_predator_n3():
    mis = multi_indices.generate_graded_lexico_multi_indices(2, 5)
    return mis, prey_predator(mis, device="cpu"), j_prey_predator(mis)


@pytest.mark.parametrize("order", [1, 2])
def test_vector_tme_mean_and_cov(prey_predator_n3, order):
    _, tm, jm = prey_predator_n3
    x = 1.0 + 0.1 * np.random.RandomState(order).randn(6, 2)
    m, c = tme.mean_and_cov(_t(x), DT, tm.drift, tm.dispersion, order)
    jmn, jc = jax.jit(jax.vmap(
        lambda u: j_tme.mean_and_cov(u, DT, jm.drift, jm.dispersion, order)))(jnp.asarray(x))
    np.testing.assert_allclose(m.numpy(), np.asarray(jmn), rtol=1e-11)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-11, atol=1e-18)


def test_vector_tme_expectation_and_transitions(prey_predator_n3):
    """Order-2 TME of all monomials of degree <= 3 and the three ND
    transition factories, at a few nodes."""
    _, tm, jm = prey_predator_n3
    mis = multi_indices.generate_graded_lexico_multi_indices(2, 3)
    rng = np.random.RandomState(1)
    nodes = 1.0 + 0.1 * rng.randn(2, 2, 2)
    mean = 1.0 + 0.05 * rng.randn(2, 2)
    scale = 0.5 + rng.rand(2, 2)
    J = jnp.asarray
    got = tme.expectation(lambda u: moments.monomials_nd(u, mis), _t(nodes[0]), DT,
                          tm.drift, tm.dispersion, 2)
    want = jax.jit(jax.vmap(lambda u: j_tme.expectation(
        lambda v: j_moments.monomials_nd(v, mis), u, DT, jm.drift, jm.dispersion, 2)))(J(nodes[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11)
    tt = moments.sde_cond_moments_nd_tme(tm.drift, tm.dispersion, DT, 2, mis)
    jt = j_moments.sde_cond_moments_nd_tme(jm.drift, jm.dispersion, DT, 2, mis)
    np.testing.assert_allclose(tt.scms(_t(nodes), _t(mean), _t(scale)).numpy(),
                               np.asarray(jax.jit(jt.scms)(J(nodes), J(mean), J(scale))),
                               rtol=1e-11, atol=1e-20)
    tn = moments.sde_cond_moments_nd_tme_normal(tm.drift, tm.dispersion, DT, 2, mis)
    jn = j_moments.sde_cond_moments_nd_tme_normal(jm.drift, jm.dispersion, DT, 2, mis)
    np.testing.assert_allclose(tn.cms(_t(nodes), _t(mean)).numpy(),
                               np.asarray(jax.jit(jn.cms)(J(nodes), J(mean))),
                               rtol=1e-11, atol=1e-20)
    te = moments.sde_cond_moments_nd_euler_maruyama(tm.drift, tm.dispersion, DT, mis)
    je = j_moments.sde_cond_moments_nd_euler_maruyama(jm.drift, jm.dispersion, DT, mis)
    np.testing.assert_allclose(te.rms(_t(nodes)).numpy(), np.asarray(je.rms(J(nodes))),
                               rtol=1e-11)


@pytest.fixture(scope="module")
def poly_n3(prey_predator_n3):
    mis, tm, jm = prey_predator_n3
    return (poly_tme_nd(tm.drift, tm.dispersion, tm.dt, 2, mis, 2, 1, device="cpu"),
            j_poly_tme_nd(jm.drift, jm.dispersion, jm.dt, 2, mis, 2, 1))


def test_poly_tme_constant_tables(poly_n3):
    tp, jp = poly_n3
    np.testing.assert_array_equal(tp.ops_t.numpy(), np.asarray(jp.ops_t))
    np.testing.assert_array_equal(tp.a_coefs.numpy(), jp.a_coefs)
    np.testing.assert_array_equal(tp.bbt_coefs.numpy(), jp.bbt_coefs)
    np.testing.assert_array_equal(tp.mis_ext, jp.mis_ext)
    np.testing.assert_array_equal(tp.a_slots, jp.a_slots)
    np.testing.assert_array_equal(tp.b_slots, jp.b_slots)
    np.testing.assert_array_equal(tp.pair_rank, jp.pair_rank)
    for field in ("out_rank", "in_rank", "binom", "s_pow", "m_pow"):
        np.testing.assert_array_equal(getattr(tp.a_table, field), getattr(jp.a_table, field))
        np.testing.assert_array_equal(getattr(tp.b_table, field), getattr(jp.b_table, field))
    assert tp.small_z == jp.small_z and tp.ops_t.shape == (36, 36, 36)


def _predict_inputs(seed):
    rng = np.random.RandomState(seed)
    w = rng.rand(3, 36)
    w /= w.sum(-1, keepdims=True)
    return (w, 1.0 + 0.05 * rng.randn(3, 36, 2), 1.0 + 0.02 * rng.randn(3, 2),
            0.03 + 0.01 * rng.rand(3, 2))


def test_poly_tme_predict_cms_scms(poly_n3):
    """The fused predictions at rtol 1e-11.  The port sums the weighted
    node monomials in another order (``weighted_monomials_nd``), so an
    odd central moment that cancels to ~1e-17 is held to 1e-11 of its
    degree's scale prod_i sd_i^{k_i} instead."""
    tp, jp = poly_n3
    w, nodes, mean, scale = _predict_inputs(0)
    J = jnp.asarray
    (m, cms), (jm, jcms) = (tp.predict_cms(_t(w), _t(nodes), _t(mean)),
                            jp.predict_cms(J(w), J(nodes), J(mean)))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-11)
    sd = np.sqrt(np.asarray(j_moments.extract_cov(jcms, 2))[..., [0, 1], [0, 1]])
    degree_scale = np.asarray(j_moments.monomials_nd(jnp.asarray(sd), tp.mis))
    np.testing.assert_allclose(cms.numpy() / degree_scale, np.asarray(jcms) / degree_scale,
                               rtol=1e-11, atol=1e-11)
    for got, want in zip(tp.predict_scms(_t(w), _t(nodes), _t(mean), _t(scale)),
                         jp.predict_scms(J(w), J(nodes), J(mean), J(scale))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11, atol=1e-11)


def test_poly_tme_per_node(poly_n3):
    tp, jp = poly_n3
    _, nodes, mean, scale = _predict_inputs(1)
    J = jnp.asarray
    pairs = [(tp.rms(_t(nodes)), jp.rms(J(nodes))),
             (tp.cms(_t(nodes), _t(mean)), jp.cms(J(nodes), J(mean))),
             (tp.scms(_t(nodes), _t(mean), _t(scale)), jp.scms(J(nodes), J(mean), J(scale))),
             (tp.mean(_t(nodes)), jp.mean(J(nodes)))]
    pairs += list(zip(tp.mean_var(_t(nodes)), jp.mean_var(J(nodes))))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11, atol=1e-20)


def test_poly_tme_rejects_non_polynomial(prey_predator_n3):
    mis, tm, _ = prey_predator_n3
    with pytest.raises(ValueError):
        poly_tme_nd(lambda x: torch.sin(x), tm.dispersion, DT, 2, mis, 2, 1, device="cpu")


def test_models_initial_conditions():
    for d, (tf, jf) in ((2, (prey_predator, j_prey_predator)), (3, (lotka_volterra_3d, j_lv3d))):
        mis = multi_indices.generate_graded_lexico_multi_indices(d, 5)
        tm, jm = tf(mis, device="cpu"), jf(mis)
        np.testing.assert_allclose(tm.init_cond.cms.numpy(), np.asarray(jm.init_cond.cms),
                                   rtol=RTOL, atol=1e-18)
        np.testing.assert_allclose(tm.init_cond.rms.numpy(), np.asarray(jm.init_cond.rms),
                                   rtol=RTOL)
        x = 1.0 + 0.1 * np.random.RandomState(d).randn(5, d)
        np.testing.assert_allclose(tm.drift(_t(x)).numpy(),
                                   np.asarray(jax.vmap(jm.drift)(jnp.asarray(x))), rtol=RTOL)
        np.testing.assert_allclose(tm.dispersion(_t(x)).numpy(),
                                   np.asarray(jax.vmap(jm.dispersion)(jnp.asarray(x))), rtol=RTOL)
        y = np.array([[1.0], [0.0], [1.0], [1.0], [0.0]])
        np.testing.assert_allclose(tm.measurement_cond_pdf(_t(y), _t(x)).numpy(),
                                   np.asarray(jm.measurement_cond_pdf(jnp.asarray(y),
                                                                      jnp.asarray(x))), rtol=RTOL)


def test_prey_predator_simulate_milstein():
    """The port's ensemble Milstein simulator on given increments equals
    the recursion of ``mfs_tpu/models/multi_dims.py::prey_predator``
    written out in numpy (rtol 1e-13), and draws its own noise when none
    is given."""
    mis = multi_indices.generate_graded_lexico_multi_indices(2, 3)
    tm = prey_predator(mis, device="cpu")
    T, steps, n = tm.T, 2, 3
    dws = np.sqrt(tm.dt / steps) * np.random.RandomState(0).randn(T, steps, n, 2)
    gen = torch.Generator().manual_seed(0)
    x0s, xss, yss = tm.simulate(gen, n, steps, dws=_t(dws))
    assert xss.shape == (T, n, 2) and yss.shape == (T, n, 1)
    x = x0s.numpy().copy()
    ddt = tm.dt / steps
    want = []
    for t in range(T):
        for dw in dws[t]:
            drift = x * (x[..., ::-1] * np.array([-4.0, 4.0]) + np.array([4.0, -4.0]))
            x = x + drift * ddt + 0.1 * x * dw + 0.5 * 0.01 * x * (dw**2 - ddt)
        want.append(x)
    np.testing.assert_allclose(xss.numpy(), np.array(want), rtol=1e-13)
    assert set(np.unique(yss.numpy())) <= {0.0, 1.0}
    _, xss2, _ = tm.simulate(torch.Generator().manual_seed(1), 2, 1)
    assert bool(torch.isfinite(xss2).all()) and xss2.shape == (T, 2, 2)


def test_nd_filter_inputs_from_numpy():
    cms0, mean0, ys = np.zeros((4, 6)), np.ones((4, 2)), np.zeros((5, 4, 1))
    out = nd_filter_inputs_from_numpy(cms0, mean0, ys, device="cpu")
    assert [o.shape for o in out] == [(4, 6), (4, 2), (5, 4, 1)]
    assert all(o.dtype == torch.float64 for o in out)


def test_nd_entry_points_default_to_cuda():
    """Without ``device`` the ND model and the polynomial TME go to the
    GPU, and raise on a host without one."""
    mis = multi_indices.generate_graded_lexico_multi_indices(2, 3)
    if torch.cuda.is_available():
        assert prey_predator(mis).init_cond.cms.device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        prey_predator(mis)
    tm = prey_predator(mis, device="cpu")
    with pytest.raises(RuntimeError):
        poly_tme_nd(tm.drift, tm.dispersion, tm.dt, 2, mis, 2, 1)
