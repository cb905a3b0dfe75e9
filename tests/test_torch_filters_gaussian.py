"""The port's Gaussian filters and smoothers (``mfs_tpu_torch.filters``)
against the JAX package's, on the same numpy inputs.

The OU model of ``tests/test_classical_filters.py`` (dX = -X dt + q dW,
Y = X + r), three trials filtered in one batched call of the port and by
JAX's single-trial functions under ``jax.vmap``, with F and Q from each
package's own ``discretise_lti_sde``: means, covariances and the running
nell at rtol 1e-10.  Then the paper's Gauss–Hermite filter (gh = 11,
TME-3) on eight Beneš–Bernoulli trials against JAX's vmapped
``sgp_filter``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mfs_tpu.filters import gaussian as jg  # noqa: E402
from mfs_tpu.filters.sigma_points import SigmaPoints as JSigmaPoints  # noqa: E402
from mfs_tpu.models import benes_bernoulli as j_benes  # noqa: E402
from mfs_tpu.sde import tme as j_tme  # noqa: E402
from mfs_tpu.utils.gaussian import discretise_lti_sde as j_discretise  # noqa: E402
from mfs_tpu_torch.filters import gaussian as tg  # noqa: E402
from mfs_tpu_torch.filters.sigma_points import SigmaPoints  # noqa: E402
from mfs_tpu_torch.models.one_dim import benes_bernoulli  # noqa: E402
from mfs_tpu_torch.sde import tme  # noqa: E402
from mfs_tpu_torch.utils.gaussian import discretise_lti_sde  # noqa: E402

DT, T, B = 1e-2, 60, 3
Q_DIFF, XI = 0.7, 0.25
M0, V0 = np.array([0.2]), np.array([[0.8]])
RTOL = 1e-10


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _ys():
    """(B, T, 1) OU measurements, each trial its own path."""
    rng = np.random.RandomState(3)
    F, q = math.exp(-DT), Q_DIFF**2 / 2 * (1 - math.exp(-2 * DT))
    x = np.full(B, 0.2)
    ys = []
    for _ in range(T):
        x = F * x + math.sqrt(q) * rng.randn(B)
        ys.append(x + math.sqrt(XI) * rng.randn(B))
    return np.stack(ys, axis=1)[..., None]


YS = _ys()


def _ou(pkg):
    """The model's pieces for the port ("torch") or JAX ("jax")."""
    A, Bd = np.array([[-1.0]]), np.array([[Q_DIFF]])
    if pkg == "jax":
        F, Q = j_discretise(jnp.asarray(A), jnp.asarray(Bd), DT)
        return dict(F=F, Q=Q, H=jnp.eye(1), Xi=XI * jnp.eye(1), m0=jnp.asarray(M0),
                    v0=jnp.asarray(V0), cond=lambda x, dt: (F @ x, Q),
                    meas=lambda x: (x, XI * jnp.eye(1)), drift=lambda x: -x,
                    disp=lambda x: Q_DIFF * jnp.eye(1), Dm=Q_DIFF * jnp.eye(1))
    F, Q = discretise_lti_sde(_t(A), _t(Bd), DT)
    return dict(F=F, Q=Q, H=torch.eye(1, dtype=torch.float64), Xi=XI * torch.eye(1, dtype=torch.float64),
                m0=_t(M0).expand(B, 1), v0=_t(V0).expand(B, 1, 1),
                cond=lambda x, dt: (x @ F.mT, Q), meas=lambda x: (x, XI * torch.eye(1, dtype=x.dtype)),
                drift=lambda x: -x, disp=lambda x: Q_DIFF * torch.eye(1, dtype=x.dtype),
                Dm=Q_DIFF * torch.eye(1, dtype=torch.float64))


def _rule(pkg, name):
    cls = JSigmaPoints if pkg == "jax" else SigmaPoints
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return cls.gauss_hermite(1, 5, **kw) if name == "gh" else cls.cubature(1, **kw)


def _run(pkg, method):
    """(mfs, vfs, nell, mss, vss) of one filter and its smoother; the
    port's trial axis second, JAX's (under vmap) first."""
    g, m = (jg, _ou("jax")) if pkg == "jax" else (tg, _ou("torch"))

    def filt(ys):
        if method == "kf":
            return g.kf(m["F"], m["Q"], m["H"], m["Xi"], m["m0"], m["v0"], ys)
        if method == "ekf":
            return g.ekf(m["cond"], m["meas"], m["m0"], m["v0"], DT, ys)
        if method == "cd_ekf":
            return g.cd_ekf(m["drift"], m["disp"], m["meas"], m["m0"], m["v0"], DT, ys)
        if method == "cd_sgp":
            return g.cd_sgp_filter(m["drift"], m["Dm"], m["meas"], _rule(pkg, "gh"), m["m0"],
                                   m["v0"], DT, ys, const_measurement_cov=True)
        return g.sgp_filter(m["cond"], m["meas"], _rule(pkg, method[4:]), m["m0"], m["v0"], DT,
                            ys, const_measurement_cov=True)

    def smooth(mfs, vfs):
        if method == "kf":
            return g.rts(m["F"], m["Q"], mfs, vfs)
        if method == "ekf":
            return g.eks(m["cond"], mfs, vfs, DT)
        if method == "cd_ekf":
            return g.cd_eks(m["drift"], m["disp"], mfs, vfs, DT)
        if method == "cd_sgp":
            return g.cd_sgp_smoother(m["drift"], m["Dm"], _rule(pkg, "gh"), mfs, vfs, DT)
        return g.sgp_smoother(m["cond"], _rule(pkg, method[4:]), mfs, vfs, DT)

    if pkg == "jax":
        def one(ys):
            mfs, vfs, nell = filt(ys)
            return (mfs, vfs, nell) + tuple(smooth(mfs, vfs))
        return tuple(np.swapaxes(np.asarray(o), 0, 1) for o in jax.jit(jax.vmap(one))(jnp.asarray(YS)))
    mfs, vfs, nell = filt(_t(np.swapaxes(YS, 0, 1)))
    return tuple(o.numpy() for o in (mfs, vfs, nell) + tuple(smooth(mfs, vfs)))


def test_discretise_lti_sde_matches_jax():
    A = np.array([[-1.0, 0.3], [-0.5, -0.2]])
    Bd = np.array([[0.4, 0.0], [0.1, 0.9]])
    for dt in (DT, 0.5):
        F, Q = discretise_lti_sde(_t(A), _t(Bd), dt)
        jF, jQ = j_discretise(jnp.asarray(A), jnp.asarray(Bd), dt)
        np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=RTOL)
        np.testing.assert_allclose(Q.numpy(), np.asarray(jQ), rtol=RTOL)


@pytest.mark.parametrize("method", ["kf", "ekf", "sgp_gh", "sgp_cubature", "cd_ekf", "cd_sgp"])
def test_filter_and_smoother_match_jax(method):
    """The batched port against JAX per trial; the smoother runs on each
    package's own filtering output."""
    got, ref = _run("torch", method), _run("jax", method)
    for name, a, b in zip(("mfs", "vfs", "nell", "mss", "vss"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=name)


def test_batched_ghf_matches_jax_vmap():
    """The paper's GHF on Beneš–Bernoulli (gh = 11, TME-3 transition
    moments, Bernoulli measurement moments), eight trials in one call,
    as ``experiments/method_comparison.py::run_ghf`` runs JAX's."""
    n_trials = 8
    ys = np.random.RandomState(5).binomial(1, 0.5, (100, n_trials)).astype(np.float64)
    jm = j_benes(N=2)

    def j_cond(x, dt):
        m, v = j_tme.mean_and_var_1d(x[0], dt, jm.drift, jm.dispersion, 3)
        return m[None], v[None, None]

    def j_meas(x):
        p = jm.emission(x[0])
        return p[None], (p * (1 - p))[None, None]

    j_one = lambda y: jg.sgp_filter(j_cond, j_meas, JSigmaPoints.gauss_hermite(1, 11),
                                    jnp.array([jm.init_cond.mean]),
                                    jnp.array([[jm.init_cond.variance]]), jm.dt, y[:, None])
    ref = jax.jit(jax.vmap(j_one, in_axes=1))(jnp.asarray(ys))

    tm = benes_bernoulli(N=2, device="cpu")

    def cond(x, dt):
        m, v = tme.mean_and_var_1d(x[..., 0], dt, tm.drift, tm.dispersion, 3)
        return m[..., None], v[..., None, None]

    def meas(x):
        p = tm.emission(x[..., 0])
        return p[..., None], (p * (1 - p))[..., None, None]

    ic = tm.init_cond
    got = tg.sgp_filter(cond, meas, SigmaPoints.gauss_hermite(1, 11, device="cpu"),
                        ic.mean.expand(n_trials, 1), ic.variance.expand(n_trials, 1, 1), tm.dt,
                        _t(ys)[..., None])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.swapaxes(a.numpy(), 0, 1), np.asarray(b), rtol=RTOL)
