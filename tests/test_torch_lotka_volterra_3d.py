"""The 3D food chain (d = 3) and the scaled-moment filters: the port
against the JAX package on the same numpy inputs, and the port's scaled
modes against its central modes.

- ``lotka_volterra_3d``'s Milstein simulation fed JAX's own initial
  states and Brownian increments;
- the N=2 central filter (s=4, 64 nodes), B=2, T=20, through "fused"
  (on the CPU: K2's plain version at d=3) and "refined", and two steps
  of N=3 (s=10, 1,000 nodes) through "fused", against JAX's f64 "xla"
  route, filtered moments and all;
- the Gauss–Hermite filter (order 7, 343 points) and the EKF of
  ``experiments/lotka_volterra_3d.py``, batch-first, against JAX's
  single-trial filters under ``jax.vmap``;
- the 1D and ND scaled-central filters against the central ones on the JAX package's own mode-equivalence problems
  (``tests/test_filtering.py::test_mode_equivalence``,
  ``tests/test_multi_dim_filtering.py::test_nd_scms_matches_nd_cms``)
  and bounds, through K1's and K2's plain versions.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mfs_tpu.filters import gaussian as jg  # noqa: E402
from mfs_tpu.filters.sigma_points import SigmaPoints as JSigmaPoints  # noqa: E402
from mfs_tpu.models.multi_dims import lotka_volterra_3d as j_lv3d  # noqa: E402
from mfs_tpu.multi_dims import filtering as j_filtering  # noqa: E402
from mfs_tpu.multi_dims.multi_indices import (  # noqa: E402
    generate_graded_lexico_multi_indices as j_generate,
    gram_and_hankel_indices_graded_lexico as j_gram_inds,
)
from mfs_tpu.multi_dims.poly_tme import poly_tme_nd as j_poly_tme_nd  # noqa: E402
from mfs_tpu_torch.filters import gaussian as tg  # noqa: E402
from mfs_tpu_torch.filters.sigma_points import SigmaPoints  # noqa: E402
from mfs_tpu_torch.models.multi_dims import lotka_volterra_3d  # noqa: E402
from mfs_tpu_torch.multi_dims import filtering  # noqa: E402
from mfs_tpu_torch.multi_dims.moments import monomials_nd, raw_moments_mvn_kan_all  # noqa: E402
from mfs_tpu_torch.multi_dims.multi_indices import (  # noqa: E402
    generate_graded_lexico_multi_indices,
    gram_and_hankel_indices_graded_lexico,
)
from mfs_tpu_torch.multi_dims.poly_tme import poly_tme_nd  # noqa: E402
from mfs_tpu_torch.one_dim.filtering import (  # noqa: E402
    moment_filter_cms,
    moment_filter_scms,
)
from mfs_tpu_torch.one_dim.moments import raw_to_central, raw_to_scaled  # noqa: E402
from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme  # noqa: E402
from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all  # noqa: E402

B = 2
RTOL = 1e-8  # nell and means: the JAX kernel path's own end-to-end bound
# Filtered moments, per trial: tests/test_multi_dim_filtering.py's
# batch-against-single-trial bound on this model.
CMS_RTOL, CMS_ATOL = 1e-8, 1e-10
GAUSS_RTOL = 1e-10  # the Gaussian filters, as tests/test_torch_filters_gaussian.py


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _jax_paths(n, steps):
    """JAX's LV3D simulation (key 0) and the initial states and
    Brownian increments it drew, recomputed from the same key split."""
    jm = j_lv3d(j_generate(3, 1))
    key = jax.random.PRNGKey(0)
    x0s, xss, yss = jm.simulate(key, n, steps)
    _, key_w, _ = jax.random.split(key, 3)
    dws = math.sqrt(jm.dt / steps) * jax.random.normal(key_w, (jm.T, steps, n, 3))
    return jm, np.asarray(x0s), np.asarray(dws), np.asarray(xss), np.asarray(yss)


_PATHS = {}


def _paths():
    """Three JAX-simulated paths, 2 sub-steps an observation."""
    if not _PATHS:
        _PATHS["paths"] = _jax_paths(3, 2)
    return _PATHS["paths"]


def _ys(T):
    """Bernoulli prey observations (T, B, 1) of the first B paths."""
    return np.ascontiguousarray(_paths()[-1][:T, :B])


def test_simulate_on_jax_noise():
    """Fed JAX's initial states and increments (3 paths, 2 sub-steps an
    observation, the model's T=2000), the port's Milstein paths equal
    JAX's to rtol 1e-12 (the same recursion, evaluated in the same
    order), and so does the prey sensor's probability."""
    jm, x0s, dws, xss, _ = _paths()
    tm = lotka_volterra_3d(generate_graded_lexico_multi_indices(3, 1), device="cpu")
    x0, got, yss = tm.simulate(torch.Generator().manual_seed(0), 3, 2, dws=_t(dws), x0s=_t(x0s))
    assert got.shape == (2000, 3, 3) and yss.shape == (2000, 3, 1)
    np.testing.assert_array_equal(x0.numpy(), x0s)
    np.testing.assert_allclose(got.numpy(), xss, rtol=1e-12)
    np.testing.assert_allclose(tm.emission(got[..., 0]).numpy(),
                               np.asarray(jm.emission(jnp.asarray(xss[..., 0]))), rtol=1e-12)
    assert set(np.unique(yss.numpy())) <= {0.0, 1.0}


class _Setup:
    """Both packages' LV3D model and polynomial TME-2 at order N."""

    def __init__(self, N):
        self.mis = j_generate(3, 2 * N - 1)
        self.inds = np.asarray(j_gram_inds(N, 3))
        np.testing.assert_array_equal(gram_and_hankel_indices_graded_lexico(N, 3), self.inds)
        self.jm = j_lv3d(self.mis)
        self.jp = j_poly_tme_nd(self.jm.drift, self.jm.dispersion, self.jm.dt, 2, self.mis, 2, 1)
        self.tm = lotka_volterra_3d(self.mis, device="cpu")
        self.tp = poly_tme_nd(self.tm.drift, self.tm.dispersion, self.tm.dt, 2, self.mis, 2, 1,
                              device="cpu")
        z = self.mis.shape[0]
        self.cms0 = np.broadcast_to(np.asarray(self.jm.init_cond.cms), (B, z)).copy()
        self.mean0 = np.broadcast_to(np.asarray(self.jm.init_cond.mean), (B, 3)).copy()

    def jax_filter(self, ys):
        run = jax.jit(lambda c, m, y: j_filtering.moment_filter_nd_cms(
            self.jp.cms, self.jp.mean, self.jm.measurement_cond_pdf, y, (self.mis, self.inds),
            c, m, eigh_impl="xla", predict_fn=self.jp.predict_cms))
        return [np.asarray(a) for a in run(self.cms0, self.mean0, ys)]

    def port_filter(self, ys, impl, cms0=None, mean0=None):
        cms0 = self.cms0 if cms0 is None else cms0
        mean0 = self.mean0 if mean0 is None else mean0
        out = filtering.moment_filter_nd_cms(
            self.tp.cms, self.tp.mean, self.tm.measurement_cond_pdf, _t(ys),
            (self.mis, self.inds), _t(cms0), _t(mean0), eigh_impl=impl,
            predict_fn=self.tp.predict_cms)
        return [a.numpy() for a in out]


def _hold(got, want, label):
    cmss, means, nell = got
    np.testing.assert_allclose(nell, want[2], rtol=RTOL, err_msg=label)
    np.testing.assert_allclose(means, want[1], rtol=RTOL, err_msg=label)
    np.testing.assert_allclose(cmss, want[0], rtol=CMS_RTOL, atol=CMS_ATOL, err_msg=label)


def test_n2_filter_vs_jax():
    """N=2 (s=4, 64 nodes), B=2, T=20: the port's "fused" (K2's plain
    version at d=3) and "refined" routes against JAX's "xla" route: nell
    and means rtol 1e-8, filtered moments rtol 1e-8 / atol 1e-10; and
    trial 1 filtered alone (no batch axis) equals the batch's trial 1 to
    the same bounds."""
    su = _Setup(2)
    ys = _ys(20)
    want = su.jax_filter(ys)
    for impl in ("fused", "refined"):
        got = su.port_filter(ys, impl)
        assert got[0].shape == (20, B, su.mis.shape[0]) and got[1].shape == (20, B, 3)
        _hold(got, want, impl)
    alone = su.port_filter(ys[:, 1], "fused", su.cms0[1], su.mean0[1])
    _hold(alone, [w[:, 1] if w.ndim > 1 else w[1] for w in want], "trial 1 alone")


def test_n3_steps_vs_jax():
    """Two steps of N=3 (s=10, 1,000 nodes a trial), B=2, through "fused"
    (K2's plain version at its largest basis, d=3) against JAX's "xla":
    nell and means rtol 1e-8, filtered moments rtol 1e-8 / atol 1e-10."""
    su = _Setup(3)
    ys = _ys(2)
    _hold(su.port_filter(ys, "fused"), su.jax_filter(ys), "fused")


def _jax_baseline(method, ys):
    jm = j_lv3d(j_generate(3, 1))
    ic = jm.init_cond

    def cond(x, dt):
        return x + jm.drift(x) * dt, jm.dispersion(x) ** 2 * dt

    def meas(x):
        p = jm.emission(x[0])
        return jnp.atleast_1d(p), jnp.atleast_2d(p * (1 - p))

    if method == "ghf":
        sgps = JSigmaPoints.gauss_hermite(d=3, order=7)
        run = lambda y: jg.sgp_filter(cond, meas, sgps, ic.mean, ic.cov, jm.dt, y)
    else:
        run = lambda y: jg.ekf(cond, meas, ic.mean, ic.cov, jm.dt, y)
    return [np.asarray(a) for a in jax.jit(jax.vmap(run, in_axes=1, out_axes=1))(ys)]


def _port_baseline(method, ys):
    tm = lotka_volterra_3d(generate_graded_lexico_multi_indices(3, 1), device="cpu")
    ic = tm.init_cond
    n = ys.shape[1]

    def cond(x, dt):
        return x + tm.drift(x) * dt, tm.dispersion(x) ** 2 * dt

    def meas(x):
        p = tm.emission(x[..., 0])
        return p[..., None], (p * (1 - p))[..., None, None]

    m0, v0 = ic.mean.expand(n, 3), ic.cov.expand(n, 3, 3)
    if method == "ghf":
        out = tg.sgp_filter(cond, meas, SigmaPoints.gauss_hermite(3, 7, device="cpu"), m0, v0,
                            tm.dt, _t(ys))
    else:
        out = tg.ekf(cond, meas, m0, v0, tm.dt, _t(ys))
    return [a.numpy() for a in out]


@pytest.mark.parametrize("method", ["ghf", "ekf"])
def test_gaussian_baselines_vs_jax(method):
    """The baselines of ``experiments/lotka_volterra_3d.py`` (Euler
    transition, Bernoulli prey sensor), B=2, T=20, batch-first against
    JAX's under ``jax.vmap``: means, covariances and the running nell at
    rtol 1e-10, with an absolute floor of 1e-10 of each output's largest
    entry (off-diagonal covariances of ~1e-11 come from cancellation
    between entries of ~1e-3, and carry only ~1e-14 of absolute
    accuracy)."""
    ys = _ys(20)
    got, want = _port_baseline(method, ys), _jax_baseline(method, ys)
    for g, w, name in zip(got, want, ("means", "covariances", "nell")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=GAUSS_RTOL, atol=GAUSS_RTOL * np.abs(w).max(),
                                   err_msg=name)


def test_scms_matches_cms_1d():
    """The JAX package's 1D mode equivalence (OU / Matérn-1/2, Gaussian
    measurements, N=4, TME-2 without closure, T=100) through K1's plain
    version: the central and scaled-central filters give the same means
    and variances (atol 1e-10), nell (atol 1e-9) and third central
    moment (atol 1e-9), JAX's bounds."""
    dt, T, ell, sigma, xi, mean0, var0, N = 1e-2, 100, 1.0, 0.5, 1.0, 0.1, 0.1, 4
    rng = np.random.RandomState(666)
    ts = np.linspace(dt, dt * T, T)
    k = sigma**2 * np.exp(-np.abs(ts[None, :] - ts[:, None]) / ell)
    ys = _t(np.linalg.cholesky(k + 1e-12 * np.eye(T)) @ rng.randn(T)
            + math.sqrt(xi) * rng.randn(T))
    trans = sde_cond_moments_tme(lambda x: -x / ell,
                                 lambda x: math.sqrt(2.0) * sigma / math.sqrt(ell), dt, 2, N)

    def meas(y, x):
        return torch.exp(-0.5 * (y - x) ** 2 / xi) / math.sqrt(2 * math.pi * xi)

    rms0 = normal_raw_moments_all(_t(mean0), var0, 2 * N)
    quad = dict(eigh_impl="fused")
    cmss, means_c, nell_c = moment_filter_cms(trans.cms, trans.mean, meas, raw_to_central(rms0),
                                              mean0, ys, **quad)
    scmss, means_s, scales_s, nell_s = moment_filter_scms(
        trans.scms, trans.mean_var, meas, raw_to_scaled(rms0), mean0, math.sqrt(var0), ys,
        **quad)
    close = lambda a, b, atol: np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)
    close(means_c, means_s, 1e-10)
    close(cmss[:, 2], scales_s**2, 1e-10)
    close(nell_c, nell_s, 1e-9)
    close(cmss[:, 3], scmss[:, 3] * scales_s**3, 1e-9)


def test_nd_scms_matches_nd_cms():
    """The JAX package's ND mode equivalence (2D OU, dX = -X dt + 0.7 dW,
    Gaussian measurements, N=3, TME-2, T=40) through K2's plain version
    (s=6): the scaled-central and central filters give nell and means to
    atol 1e-8 and the variance to rtol 1e-7, JAX's bounds.  The
    transition moments are the polynomial TME (``poly_tme_nd``,
    ``drift_deg=1``, ``dispersion_deg=0``), the same expansion as JAX's
    generic TME for this linear SDE in closed form: the port's nested-JVP
    TME takes ~1.3 s a step here on one core."""
    N, d, dt, xi, var0, mean0 = 3, 2, 1e-2, 1.0, 0.1, 0.1
    mis = generate_graded_lexico_multi_indices(d, 2 * N - 1)
    inds = gram_and_hankel_indices_graded_lexico(N, d)
    poly = poly_tme_nd(lambda x: -x, lambda x: 0.7 * torch.eye(d, dtype=x.dtype).expand(
        x.shape[:-1] + (d, d)), dt, 2, mis, 1, 0, device="cpu")
    rng = np.random.RandomState(7)
    ys = _t(0.5 * rng.randn(40) + 0.1)
    ys = torch.stack([ys, -ys], dim=-1)

    def meas(y, x):
        return torch.prod(torch.exp(-0.5 * (y - x) ** 2 / xi) / math.sqrt(2 * math.pi * xi),
                          dim=-1)

    cms0 = raw_moments_mvn_kan_all(torch.zeros(d, dtype=torch.float64),
                                   var0 * torch.eye(d, dtype=torch.float64), mis)
    scale0 = math.sqrt(var0) * torch.ones(d, dtype=torch.float64)
    scms0 = cms0 / monomials_nd(scale0, mis)
    m0 = mean0 * torch.ones(d, dtype=torch.float64)
    cmss, means_c, nell_c = filtering.moment_filter_nd_cms(
        poly.cms, poly.mean, meas, ys, (mis, inds), cms0, m0, eigh_impl="fused")
    _, means_s, scales_s, nell_s = filtering.moment_filter_nd_scms(
        poly.scms, poly.mean_var, meas, ys, (mis, inds), scms0, m0, scale0, eigh_impl="fused")
    np.testing.assert_allclose(nell_s.item(), nell_c.item(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(means_s.numpy(), means_c.numpy(), rtol=0, atol=1e-8)
    var_c = cmss[:, int(np.flatnonzero((mis == [2, 0]).all(-1))[0])]
    np.testing.assert_allclose(scales_s[:, 0].numpy() ** 2, var_c.numpy(), rtol=1e-7)
