"""Port vs JAX: TME expansions, transition-moment factories and SDE
simulation, on the same numpy inputs.

Bound for the expansions: rtol 1e-11.  JAX differentiates with nested
forward mode (``jax.jvp``), the port's scalar-state TME with nested
double-backward autograd (``tme._jvp_1d``); both evaluate the same
expression tree and differ in the order of a few sums, and the order-30
Normal-closure recurrence amplifies that by up to ~1e3 ulps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mfs_tpu.models import benes_bernoulli as j_benes  # noqa: E402
from mfs_tpu.sde import tme as j_tme  # noqa: E402
from mfs_tpu.sde import transitions as j_tr  # noqa: E402
from mfs_tpu.utils.sdes import simulate_sde as j_simulate_sde  # noqa: E402
from mfs_tpu_torch.models.one_dim import benes_bernoulli  # noqa: E402
from mfs_tpu_torch.sde import tme, transitions  # noqa: E402
from mfs_tpu_torch.utils.sdes import simulate_sde  # noqa: E402

RTOL = 1e-11
DT = 1e-2


@pytest.fixture(scope="module")
def models():
    return benes_bernoulli(N=15, device="cpu"), j_benes(N=15)


def _nodes():
    # Beneš quadrature-node range: a (trials, nodes) grid over [-3, 3].
    rng = np.random.RandomState(0)
    return np.sort(rng.uniform(-3.0, 3.0, (4, 15)), axis=-1)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_mean_and_var_1d(models, order):
    tm, jm = models
    x = _nodes()
    m, v = tme.mean_and_var_1d(_t(x), DT, tm.drift, tm.dispersion, order)
    jm_, jv = j_tme.mean_and_var_1d(jnp.asarray(x), DT, jm.drift, jm.dispersion, order)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm_), rtol=RTOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=RTOL)


def test_expectation_1d_vector_phi(models):
    tm, jm = models
    x = _nodes()
    got = tme.expectation_1d(
        lambda u: torch.stack([u, u * u, torch.sin(u)], dim=-1),
        _t(x), DT, tm.drift, tm.dispersion, 3,
    )
    want = j_tme.expectation_1d(
        lambda u: jnp.stack([u, u * u, jnp.sin(u)], axis=-1),
        jnp.asarray(x), DT, jm.drift, jm.dispersion, 3,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_1d_tme_keeps_a_graph_only_where_one_is_needed():
    """Nodes and callables that need no gradient give results without an
    autograd graph (a filter or simulation loop would chain it from step
    to step), in grad mode too; a drift parameter or nodes that require
    grad keep it, and its gradients match central differences."""
    x = _t(_nodes()[:, :5])
    p = torch.tensor(3.0, dtype=torch.float64, requires_grad=True)
    drift = lambda u: u * (1.0 - p * u**2)
    one = lambda u: torch.ones_like(u)
    for out in (*tme.mean_and_var_1d(x, DT, lambda u: u * (1.0 - 3.0 * u**2), one, 3),
                tme.expectation_1d(lambda u: torch.stack([u, u * u], -1), x, DT, torch.tanh,
                                   one, 2)):
        assert not out.requires_grad
    with torch.no_grad():
        assert not tme.mean_and_var_1d(x, DT, drift, one, 3)[0].requires_grad
    xg = x.clone().requires_grad_(True)
    m, v = tme.mean_and_var_1d(xg, DT, drift, one, 3)
    gx, gp = torch.autograd.grad((m + 7.0 * v).sum(), (xg, p))

    def f(dx, dp):
        with torch.no_grad():
            m, v = tme.mean_and_var_1d(x + dx, DT, lambda u: u * (1.0 - (3.0 + dp) * u**2), one, 3)
            return (m + 7.0 * v).sum().item()

    eps = 1e-6
    d = _t(np.random.RandomState(1).randn(*x.shape))
    np.testing.assert_allclose((gx * d).sum().item(), (f(eps * d, 0) - f(-eps * d, 0)) / (2 * eps),
                               rtol=1e-7)
    np.testing.assert_allclose(gp.item(), (f(0, eps) - f(0, -eps)) / (2 * eps), rtol=1e-6)


@pytest.mark.parametrize("tme_order", [2, 3])
def test_sde_cond_moments_tme_normal_N15(models, tme_order):
    tm, jm = models
    N = 15
    x = _nodes()
    mean = x.mean(axis=-1, keepdims=True)
    scale = np.full_like(mean, 0.8)
    tt = transitions.sde_cond_moments_tme_normal(tm.drift, tm.dispersion, DT, tme_order, N)
    jt = j_tr.sde_cond_moments_tme_normal(jm.drift, jm.dispersion, DT, tme_order, N)
    pairs = [
        (tt.rms(_t(x)), jt.rms(jnp.asarray(x))),
        (tt.cms(_t(x), _t(mean)), jt.cms(jnp.asarray(x), jnp.asarray(mean))),
        (tt.scms(_t(x), _t(mean), _t(scale)),
         jt.scms(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(scale))),
        (tt.mean(_t(x)), jt.mean(jnp.asarray(x))),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("kind", ["tme", "euler"])
def test_other_transition_factories(models, kind):
    tm, jm = models
    N = 3
    x = _nodes()
    mean = x.mean(axis=-1, keepdims=True)
    scale = np.full_like(mean, 0.8)
    if kind == "tme":
        tt = transitions.sde_cond_moments_tme(tm.drift, tm.dispersion, DT, 2, N)
        jt = j_tr.sde_cond_moments_tme(jm.drift, jm.dispersion, DT, 2, N)
    else:
        tt = transitions.sde_cond_moments_euler(tm.drift, tm.dispersion, DT, N)
        jt = j_tr.sde_cond_moments_euler(jm.drift, jm.dispersion, DT, N)
    pairs = [
        (tt.rms(_t(x)), jt.rms(jnp.asarray(x))),
        (tt.cms(_t(x), _t(mean)), jt.cms(jnp.asarray(x), jnp.asarray(mean))),
        (tt.scms(_t(x), _t(mean), _t(scale)),
         jt.scms(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(scale))),
        (tt.mean(_t(x)), jt.mean(jnp.asarray(x))),
        (tt.mean_var(_t(x))[1], jt.mean_var(jnp.asarray(x))[1]),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-300)


def test_simulate_sde_with_jax_noise(models):
    """Fed JAX's own increments, drawn as ``mfs_tpu/utils/sdes.py``
    draws them, the port follows the same path.  Bound: atol 1e-12 (the
    same TME-3 step and 1x1 Cholesky, 15 sub-steps of accumulation)."""
    tm, jm = models
    T, steps = 5, 3
    key = jax.random.PRNGKey(7)
    x0 = 0.3

    def j_m_and_cov(x, dt):
        m, v = j_tme.mean_and_var_1d(x[0], dt, jm.drift, jm.dispersion, order=3)
        return m[None], v[None, None]

    def t_m_and_cov(x, dt):
        m, v = tme.mean_and_var_1d(x[..., 0], dt, tm.drift, tm.dispersion, order=3)
        return m[..., None], v[..., None, None]

    want = j_simulate_sde(j_m_and_cov, jnp.asarray([x0]), jm.dt, T, key,
                          integration_steps=steps)
    k, _ = jax.random.split(key)
    eps = np.asarray(jax.random.normal(k, (T, steps, 1), dtype=jnp.float64))
    got = simulate_sde(t_m_and_cov, _t([x0]), tm.dt, T, eps=_t(eps),
                       integration_steps=steps)
    assert got.shape == (T, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    # diagonal_cov takes sqrt instead of the Cholesky factor: same for d = 1
    got_d = simulate_sde(t_m_and_cov, _t([x0]), tm.dt, T, eps=_t(eps),
                         integration_steps=steps, diagonal_cov=True)
    np.testing.assert_allclose(got_d.numpy(), got.numpy(), atol=1e-15)


def test_simulate_sde_default_device_is_cuda_and_raises_without_gpu(models):
    """A non-tensor ``x0`` is placed on ``device``, which defaults to cuda
    and raises on a host without a GPU; a tensor ``x0`` keeps its device."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves to it")
    tm, _ = models

    def m_and_cov(x, dt):
        return x - 0.1 * x * dt, torch.full(x.shape + (1,), dt, dtype=x.dtype)

    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_sde(m_and_cov, 0.3, tm.dt, 4, generator=torch.Generator())
    got = simulate_sde(m_and_cov, 0.3, tm.dt, 4, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert got.device == torch.device("cpu") and got.shape == (4, 1)
    assert got.dtype == torch.float64
    got = simulate_sde(m_and_cov, _t([0.3]), tm.dt, 4, generator=torch.Generator())
    assert got.device == torch.device("cpu")


def test_benes_simulate_shapes_and_seed():
    """One run costs T = 100 TME-3 steps of eager nested JVPs (~12 s on
    a CPU core), so the path is simulated once; reproducibility per seed
    is checked on the initial draw, which starts the same generator."""
    model = benes_bernoulli(N=2, device="cpu")
    xs = model.simulate(torch.Generator().manual_seed(3), 3, integration_steps=1)
    assert xs.shape == (3, model.T) and xs.dtype == torch.float64
    assert torch.isfinite(xs).all()
    x0 = model.init_cond.sampler(torch.Generator().manual_seed(3), 3)
    # first step moves each path by O(sqrt(dt)) from its own initial draw
    assert (xs[:, 0] - x0).abs().max() < 0.6
