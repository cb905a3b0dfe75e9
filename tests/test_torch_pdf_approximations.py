"""Port vs JAX: density recovery from moments and cumulants
(``one_dim/pdf_approximations.py``) on the filter states of four
Beneš–Bernoulli N=8 trials after 20 central-moment filter steps, the
same numpy arrays on both sides (the cumulants are the port's, which
``tests/test_torch_moments.py`` holds to JAX's).  The port evaluates all
four trials' densities in one batched call; JAX one trial at a time."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mfs_tpu.models import benes_bernoulli as j_benes  # noqa: E402
from mfs_tpu.one_dim import filtering as jfilt  # noqa: E402
from mfs_tpu.one_dim import moments as jm  # noqa: E402
from mfs_tpu.one_dim import pdf_approximations as jp  # noqa: E402
from mfs_tpu.sde import sde_cond_moments_tme_normal as j_tme_normal  # noqa: E402
from mfs_tpu_torch.one_dim import moments as tm  # noqa: E402
from mfs_tpu_torch.one_dim import pdf_approximations as tp  # noqa: E402

N, B, T = 8, 4, 20
XS = np.linspace(-6.0, 6.0, 241)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


@pytest.fixture(scope="module")
def state():
    """Central moments, means, scales, scaled central moments and
    cumulants of the filter states."""
    model = j_benes(N=N)
    trans = j_tme_normal(model.drift, model.dispersion, model.dt, 3, N)
    ys = np.random.RandomState(0).binomial(1, 0.5, (T, B)).astype(np.float64)
    ic = model.init_cond
    cmss, means, _ = jfilt.moment_filter_cms(
        trans.cms, trans.mean, model.measurement_cond_pdf, jnp.broadcast_to(ic.cms, (B, 2 * N)),
        ic.mean, jnp.asarray(ys), stable=True, eigh_impl="xla")
    cms, mean = np.asarray(cmss[-1]), np.asarray(means[-1])
    scale = np.sqrt(cms[:, 2])
    sms = cms / scale[:, None] ** np.arange(2 * N)
    ks = tm.sms_to_cumulants(_t(sms), _t(mean), _t(scale)).numpy()
    return dict(cms=cms, mean=mean, scale=scale, sms=sms, ks=ks)


def _per_trial(got, make_pdf, inputs, xs, trials=range(B), **tol):
    """The port's batched densities ``got (B, ...)`` against JAX's
    ``make_pdf(*trial_inputs)(xs)``, trial by trial."""
    assert got.shape == (B,) + np.shape(xs)
    for b in trials:
        want = make_pdf(*(jnp.asarray(a[b]) for a in inputs))(jnp.asarray(xs))
        np.testing.assert_allclose(got[b], np.asarray(want), **tol)


def test_gram_charlier_matches_jax(state):
    """Order 2N - 1 = 15 series (Bell coefficients up to B_15): rtol 1e-10
    against JAX on the first trial (JAX's Bell programme takes ~5 s of
    eager ops a trial), and every trial of the batch equal to the port's
    own single-trial series, rtol 1e-12 (atol 1e-15: the batched and the
    single contraction sum in different orders)."""
    ks = state["ks"]
    got = tp.gram_charlier(_t(ks))(_t(XS)).numpy()
    _per_trial(got, jp.gram_charlier, (ks,), XS, trials=[0], rtol=1e-10)
    for b in range(B):
        np.testing.assert_allclose(got[b], tp.gram_charlier(_t(ks[b]))(_t(XS)).numpy(),
                                   rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_edgeworth_matches_jax(state, order):
    """Edgeworth at orders 1-3: rtol 1e-10."""
    ks = state["ks"]
    _per_trial(tp.edgeworth(_t(ks), order)(_t(XS)).numpy(),
               lambda k: jp.edgeworth(k, order), (ks,), XS, rtol=1e-10)


def test_legendre_expansion_matches_jax(state):
    """The raw moments applied unshifted, as the JAX function applies
    them, on [-3, 3] (the state has no bounded support; the comparison is
    of the arithmetic): rtol 1e-10; and the uniform density on [-1, 1]
    from its exact moments: 0.5, rtol 1e-8 (the JAX test's bound)."""
    cms, mean = state["cms"], state["mean"]
    rms = np.asarray(jm.central_to_raw(jnp.asarray(cms), jnp.asarray(mean)))
    _per_trial(tp.legendre_poly_expansion(_t(rms), -3.0, 3.0)(_t(XS)).numpy(),
               lambda r: jp.legendre_poly_expansion(r, -3.0, 3.0), (rms,), XS, rtol=1e-10)
    uniform = _t([1.0 / (p + 1) if p % 2 == 0 else 0.0 for p in range(10)])
    xs = _t(np.linspace(-0.95, 0.95, 41))
    np.testing.assert_allclose(tp.legendre_poly_expansion(uniform)(xs).numpy(), 0.5, rtol=1e-8)


def test_truncated_cgf_matches_jax(state):
    """K(z) of the scaled moments with per-trial mean and scale, z in
    [-1, 1]: rtol 1e-10."""
    sms, mean, scale = state["sms"], state["mean"], state["scale"]
    zs = np.linspace(-1.0, 1.0, 21)
    got = tp.truncated_cumulant_generating_function(_t(zs), _t(sms), _t(mean), _t(scale)).numpy()
    for b in range(B):
        want = jp.truncated_cumulant_generating_function(jnp.asarray(zs), jnp.asarray(sms[b]),
                                                         mean[b], scale[b])
        np.testing.assert_allclose(got[b], np.asarray(want), rtol=1e-10)


def test_saddle_point_matches_jax(state):
    """The density after 50 damped Newton steps: rtol 1e-8 wherever the
    iteration has settled (a 51st step moves the port's density by less
    than 1e-10 of itself); in the tails the clipped iteration wanders,
    and there at most 2% of the points may differ, since rounding-level
    differences in K' send it elsewhere.  The closed forms of K' and K''
    against ``jax.grad`` of the JAX function's CGF at the initial points:
    rtol 1e-12."""
    sms, mean, scale = state["sms"], state["mean"], state["scale"]
    args = (_t(sms), _t(mean), _t(scale))
    got = tp.saddle_point(*args)(_t(XS)).numpy()
    more = tp.saddle_point(*args, newton_iters=51)(_t(XS)).numpy()
    settled = np.abs(more - got) <= 1e-10 * np.abs(got)
    want = np.stack([np.asarray(jp.saddle_point(jnp.asarray(sms[b]), mean[b], scale[b])(
        jnp.asarray(XS))) for b in range(B)])
    np.testing.assert_allclose(got[settled], want[settled], rtol=1e-8)
    differ = ~np.isclose(got, want, rtol=1e-8, atol=0)
    assert settled.mean() > 0.2 and differ.mean() <= 0.02
    facts = np.array([math.factorial(n) for n in range(2 * N)], dtype=np.float64)
    for b in range(B):
        poly = jnp.flip(jnp.asarray(sms[b] / facts))
        cgf = lambda z: z * mean[b] + jnp.log(jnp.polyval(poly, z * scale[b]))
        s0 = (XS[60:180] - mean[b]) / scale[b] ** 2
        d1 = jax.vmap(jax.grad(cgf))(jnp.asarray(s0))
        d2 = jax.vmap(jax.grad(jax.grad(cgf)))(jnp.asarray(s0))
        coeffs = [_t(c) for c in sms[b] / facts]
        _, t1, t2 = tp._cgf_terms(coeffs, _t(mean[b]), _t(scale[b]), _t(s0))
        np.testing.assert_allclose(t1.numpy(), np.asarray(d1), rtol=1e-12)
        np.testing.assert_allclose(t2.numpy(), np.asarray(d2), rtol=1e-12)


def test_inverse_fourier_matches_jax(state):
    """The density from JAX's characteristic function of each state on
    z in [-8, 8] (321 points), the same CF on both sides: rtol 1e-10
    against each density's peak (the truncated transform of a discrete
    rule oscillates through zero)."""
    cms, mean = state["cms"], state["mean"]
    zs = np.linspace(-8.0, 8.0, 321)
    cfs = np.stack([np.asarray(jm.characteristic_fn(jnp.asarray(zs), jnp.asarray(cms[b]), mean[b]))
                    for b in range(B)])
    got = tp.inverse_fourier(_t(XS), torch.as_tensor(cfs), _t(zs)).numpy()
    assert got.shape == (B, XS.size)
    for b in range(B):
        want = np.asarray(jp.inverse_fourier(jnp.asarray(XS), jnp.asarray(cfs[b]),
                                             jnp.asarray(zs)))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-10 * np.abs(want).max())
