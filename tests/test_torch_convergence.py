"""The convergence study as a whole, port vs JAX, on the same numpy inputs.

``chip_smoke.py``'s convergence phases (``conv_filter``, ``kalman_batch``,
``conv_scores``) on CPU tensors, where the port's filters run K1's plain
version, against the JAX package's filters built as
``experiments/convergence.py`` builds them (its default "refined" route)
and against its ``kalman_batch``; and ``posterior_cramer_rao`` against
JAX's and against the Kalman variance it must equal on this
linear-Gaussian model.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from experiments import convergence as jconv  # noqa: E402
from mfs_tpu.one_dim.filtering import moment_filter_cms, moment_filter_rms  # noqa: E402
from mfs_tpu.one_dim.moments import raw_to_central  # noqa: E402
from mfs_tpu.utils.gaussian import normal_raw_moments_all  # noqa: E402
from mfs_tpu.utils.pcrlb import posterior_cramer_rao as j_pcrlb  # noqa: E402
from mfs_tpu_torch.utils.pcrlb import posterior_cramer_rao  # noqa: E402

B = 64


@pytest.fixture(scope="module")
def data():
    """B OU trials of T = 100 steps from JAX's own simulator (seed 3)."""
    xs, ys = jconv.simulate(B, 3)
    return np.asarray(xs), np.asarray(ys)


def _jax_filter(N, mode, ys):
    """``experiments/convergence.py``'s filter at order N in ``mode``."""
    F = math.exp(-jconv.DT / jconv.ELL)
    Q = jconv.SIGMA**2 * (1 - math.exp(-2 * jconv.DT / jconv.ELL))
    meas = lambda y, x: jnp.exp(-0.5 * (y - x) ** 2 / jconv.XI) / jnp.sqrt(2 * jnp.pi * jconv.XI)
    rms0 = jnp.broadcast_to(normal_raw_moments_all(jconv.MEAN0, jconv.VAR0, 2 * N), (B, 2 * N))
    if mode == "raw":
        rmss, nell = moment_filter_rms(lambda x: normal_raw_moments_all(F * x, Q, 2 * N), meas,
                                       rms0, jnp.asarray(ys))
        means = rmss[..., 1]
        return np.asarray(means), np.asarray(rmss[..., 2] - means**2), np.asarray(nell)
    cmss, means, nell = moment_filter_cms(
        lambda x, m: normal_raw_moments_all(F * x - m, Q, 2 * N), lambda x: F * x, meas,
        raw_to_central(rms0), jconv.MEAN0 * jnp.ones(B), jnp.asarray(ys))
    return np.asarray(means), np.asarray(cmss[..., 2]), np.asarray(nell)


def test_model_constants_and_kalman_filter_match_the_experiment(data):
    """The chip script's OU constants are the experiment's, and its
    ``kalman_batch`` gives the experiment's means and variances, rtol 1e-12."""
    assert (cs.CONV_DT, cs.T, cs.CONV_ELL, cs.CONV_SIGMA, cs.CONV_XI) == (
        jconv.DT, jconv.T, jconv.ELL, jconv.SIGMA, jconv.XI)
    assert jconv.MEAN0 == 0.0 and jconv.VAR0 == cs.CONV_SIGMA**2
    _, ys = data
    jm, jv = jconv.kalman_batch(jnp.asarray(ys))
    tm, tv = cs.kalman_batch(torch.as_tensor(ys))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12)


@pytest.mark.parametrize("N", [2, 5, 8])
def test_moment_filters_match_jax(data, N):
    """Central and raw filters at order N through K1's plain version
    against JAX's: means and variances rtol 1e-8 (the JAX package's
    end-to-end bound), nell rtol 1e-8; and the scores of
    ``conv_scores`` (no divergent trial) as the experiment computes them."""
    _, ys = data
    kf_m, kf_v = cs.kalman_batch(torch.as_tensor(ys))
    for mode in ("central", "raw"):
        means, variances, nell, _ = cs.conv_filter(N, mode, torch.as_tensor(ys), eigh_impl="fused")
        jm, jv, jn = _jax_filter(N, mode, ys)
        np.testing.assert_allclose(means.numpy(), jm, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(variances.numpy(), jv, rtol=1e-8)
        np.testing.assert_allclose(nell.numpy(), jn, rtol=1e-8)
        row, finite = cs.conv_scores(means, variances, kf_m, kf_v)
        assert row["divergent"] == 0 and bool(finite.all())
        np.testing.assert_allclose(row["abs_mean_err"], np.abs(jm - kf_m.numpy()).mean(),
                                   rtol=1e-6)
        kl = 0.5 * (np.log(kf_v.numpy() / jv) + (jv + (jm - kf_m.numpy()) ** 2) / kf_v.numpy() - 1)
        np.testing.assert_allclose(row["gauss_kl"], kl.mean(), rtol=1e-3, atol=1e-15)


def test_pcrlb_matches_jax_and_the_kalman_variance(data):
    """``posterior_cramer_rao`` on the B trajectories (x0 drawn with numpy)
    against JAX's, rtol 1e-12, and 1 / J against the KF variance, rtol
    1e-6 (the JAX package's bound)."""
    xs, ys = data
    x0 = np.random.RandomState(4).randn(B) * cs.CONV_SIGMA
    trajs = np.concatenate([x0[None], xs])[..., None]
    F, Q = cs.conv_transition()
    j0 = np.array([[1.0 / cs.CONV_SIGMA**2]])
    lt_t = lambda xt, xs_: -0.5 * (xt[0] - F * xs_[0]) ** 2 / Q
    ll_t = lambda y, x: -0.5 * (y[0] - x[0]) ** 2 / cs.CONV_XI
    js = posterior_cramer_rao(torch.as_tensor(trajs), torch.as_tensor(ys[..., None]),
                              torch.as_tensor(j0), lt_t, ll_t)
    jj = j_pcrlb(jnp.asarray(trajs), jnp.asarray(ys[..., None]), jnp.asarray(j0), lt_t, ll_t)
    assert js.shape == (cs.T, 1, 1)
    np.testing.assert_allclose(js.numpy(), np.asarray(jj), rtol=1e-12)
    _, kf_v = cs.kalman_batch(torch.as_tensor(ys))
    np.testing.assert_allclose(1.0 / js[:, 0, 0].numpy(), kf_v[:, 0].numpy(), rtol=1e-6)
