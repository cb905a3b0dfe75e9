"""Port vs JAX: the maximum-likelihood path.

The Well–Poisson model and its likelihood's gradient through the kernel
route, ``simulate_sde_ensemble``, ``lbfgs_batched`` and the MLE
routines, each against its JAX counterpart on the same numpy inputs.
K1's gradient itself is held by ``tests/test_torch_k1_gradient.py``.

JAX's "pallas" route runs the kernel through ``pallas_call``, whose
interpret mode takes ~100 s to compile a T=3 Well–Poisson gradient on one
CPU core (~25 s eagerly).  So the filter-level gradient test swaps only the
JAX route's primal for JAX's own f64 quadrature: its custom JVP
(``_fused_jvp`` / ``_implicit_tangent``) is what differentiates, as on a
TPU.  The kernel body itself is held against the port's plain version by
``tests/test_torch_quadrature.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mfs_tpu.ops.pallas_quadrature as pq  # noqa: E402
from mfs_tpu.estimation import fit_mle_scipy as j_fit_mle_scipy  # noqa: E402
from mfs_tpu.estimation import lbfgs_batched as j_lbfgs_batched  # noqa: E402
from mfs_tpu.models import well_poisson as j_well_poisson  # noqa: E402
from mfs_tpu.one_dim.filtering import moment_filter_cms as j_filter_cms  # noqa: E402
from mfs_tpu.one_dim.filtering import moment_filter_rms as j_filter_rms  # noqa: E402
from mfs_tpu.one_dim.quadrature import moment_quadrature as j_moment_quadrature  # noqa: E402
from mfs_tpu.sde import sde_cond_moments_euler as j_euler  # noqa: E402
from mfs_tpu.utils.gaussian import normal_raw_moments_all as j_moments  # noqa: E402
from mfs_tpu.utils.sdes import simulate_sde_ensemble as j_simulate_sde_ensemble  # noqa: E402
from mfs_tpu_torch.estimation import fit_mle_optax, fit_mle_scipy, lbfgs_batched  # noqa: E402
from mfs_tpu_torch.models import well_poisson  # noqa: E402
from mfs_tpu_torch.one_dim.filtering import moment_filter_cms, moment_filter_rms  # noqa: E402
from mfs_tpu_torch.sde.transitions import sde_cond_moments_euler  # noqa: E402
from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all  # noqa: E402
from mfs_tpu_torch.utils.sdes import simulate_sde_ensemble  # noqa: E402

WP_N = 4


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ---------------------------------------------------------------------------
# Well–Poisson
# ---------------------------------------------------------------------------


def _j_nell_fn(ys, impl):
    """Batch-first Well–Poisson nell, P (B, 2) -> (B,), as
    ``experiments/parameter_estimation.py`` builds it."""
    dt, _, _, ic, drift, disp, _, pmf, _ = j_well_poisson(3.0, N=WP_N)
    ys = jnp.asarray(ys)
    B = ys.shape[1]

    def nell(P):
        p1 = jnp.logaddexp(0.0, P[:, 0])[:, None]
        p2 = jnp.logaddexp(0.0, P[:, 1])[:, None]
        trans = j_euler(lambda u: drift(u, p1), disp, dt, WP_N)
        _, _, out = j_filter_cms(trans.cms, trans.mean, lambda y, u: pmf(y, u, p2),
                                 jnp.broadcast_to(ic.cms, (B, 2 * WP_N)), ic.mean * jnp.ones(B),
                                 ys, eigh_impl=impl)
        return out

    return nell


def _nell_fn(ys, impl):
    """The port's counterpart of ``_j_nell_fn``."""
    dt, _, _, ic, drift, disp, _, pmf, _ = well_poisson(3.0, N=WP_N, device="cpu")
    ys = _t(ys)
    B = ys.shape[1]
    sp = lambda z: torch.logaddexp(torch.zeros((), dtype=z.dtype), z)

    def nell(P):
        p1, p2 = sp(P[:, 0])[:, None], sp(P[:, 1])[:, None]
        trans = sde_cond_moments_euler(lambda u: drift(u, p1), disp, dt, WP_N)
        _, _, out = moment_filter_cms(trans.cms, trans.mean, lambda y, u: pmf(y, u, p2),
                                      ic.cms.expand(B, 2 * WP_N), ic.mean.expand(B), ys,
                                      eigh_impl=impl)
        return out

    return nell


def _wp_ys(T, B, seed):
    """Poisson counts of double-well paths at the true (3, 3): numpy
    Euler–Maruyama with 10 sub-steps from the model's initial mixture."""
    rng = np.random.RandomState(seed)
    x = rng.choice([-0.5, 0.5], B) + np.sqrt(0.05) * rng.randn(B)
    ys = []
    for _ in range(T):
        for _ in range(10):
            x = x + x * (1.0 - 3.0 * x**2) * 1e-3 + np.sqrt(1e-3) * rng.randn(B)
        ys.append(rng.poisson(np.logaddexp(0.0, 3.0 * x)))
    return np.asarray(ys, dtype=np.float64)  # (T, B)


def _f64_primal(ms, mean=0.0, scale=1.0, jitter=0.0):
    """JAX's f64 quadrature in the kernel's conventions (ascending nodes,
    weights carrying m0), standing in for the Pallas primal."""
    w, x = j_moment_quadrature(ms, mean, scale, sort_nodes=True, eigh_impl="refined")
    return w * ms[..., :1], x


def test_well_poisson_nell_and_gradient_match_jax(monkeypatch):
    """Per-trial nell and d nell / d(P) at P = 0.5 (softplus
    parameters), N=4, B=4, T=5: the port's kernel route (plain K1 +
    ``_FusedQuadrature``) against JAX's "pallas" route (its custom JVP
    around an f64 primal); nell rtol 1e-8, gradient rtol 1e-6."""
    monkeypatch.setattr(pq, "moment_quadrature_pallas", _f64_primal)
    ys = _wp_ys(5, 4, seed=0)
    P = np.full((4, 2), 0.5)
    j_nell = _j_nell_fn(ys, "pallas")

    def j_value_and_grad(P):
        vals, vjp = jax.vjp(j_nell, P)
        return vals, vjp(jnp.ones_like(vals))[0]

    vals, j_grad = jax.jit(j_value_and_grad)(jnp.asarray(P))
    Pt = _t(P).requires_grad_(True)
    out = _nell_fn(ys, "fused")(Pt)
    (grad,) = torch.autograd.grad(out, Pt, torch.ones_like(out))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(vals), rtol=1e-8)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=1e-6)


def test_well_poisson_model_pieces_match_jax():
    """drift, emission (logaddexp, not the thresholded softplus) and the
    pmf against JAX on the same arrays.  ``simulate`` always runs the
    model's T=1000 (~12 s of TME-3 steps on one core): ``chip_smoke.py``
    drives it on the card."""
    jm = j_well_poisson(3.0, N=WP_N)
    tm = well_poisson(3.0, N=WP_N, device="cpu")
    assert (tm[0], tm[1]) == (jm[0], jm[1])
    np.testing.assert_allclose(tm[2].numpy(), np.asarray(jm[2]), rtol=1e-15)
    np.testing.assert_allclose(tm[3].cms.numpy(), np.asarray(jm[3].cms), rtol=1e-14)
    x = np.linspace(-3.0, 3.0, 13)
    p = np.linspace(0.5, 30.0, 13)  # p2 x up to 90: softplus's threshold is 20
    y = np.arange(13.0)
    np.testing.assert_allclose(tm[4](_t(x), _t(p)).numpy(), np.asarray(jm[4](x, p)), rtol=1e-15)
    np.testing.assert_allclose(tm[6](_t(x), _t(p)).numpy(), np.asarray(jm[6](x, p)), rtol=1e-15)
    np.testing.assert_allclose(tm[7](_t(y), _t(x), _t(p)).numpy(),
                               np.asarray(jm[7](y, x, p)), rtol=1e-12)


def test_simulate_sde_ensemble_matches_jax():
    """B independent paths from per-path draws: JAX's keys' own normals
    are passed in (``eps``), paths agree to 1e-13.  The increments are
    Euler–Maruyama's, with a full (Cholesky) covariance."""
    B, T, S = 3, 20, 2

    def j_m_and_cov(x, dt):
        return x + x * (1.0 - 3.0 * x**2) * dt, dt * jnp.eye(1)

    def m_and_cov(x, dt):
        return x + x * (1.0 - 3.0 * x**2) * dt, dt * torch.eye(1, dtype=x.dtype).expand(
            x.shape + (1,))

    keys = jax.random.split(jax.random.PRNGKey(4), B)
    x0s = np.linspace(-0.5, 0.5, B)[:, None]
    want = j_simulate_sde_ensemble(j_m_and_cov, jnp.asarray(x0s), 0.01, T, keys,
                                   integration_steps=S)
    eps = np.stack([np.asarray(jax.random.normal(jax.random.split(k)[0], (T, S, 1)))
                    for k in keys])  # simulate_sde's draw for each key
    got = simulate_sde_ensemble(m_and_cov, _t(x0s), 0.01, T, eps=_t(eps), integration_steps=S)
    assert got.shape == (B, T, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-13)
    gen = simulate_sde_ensemble(m_and_cov, _t(x0s), 0.01, 4, generator=torch.Generator())
    assert gen.shape == (B, 4, 1) and torch.isfinite(gen).all()


# ---------------------------------------------------------------------------
# lbfgs_batched and the MLE routines
# ---------------------------------------------------------------------------


def _quadratic_batch(seed=0, B=5, p=3):
    """B convex quadratics with known optima c_b; trial 2's objective is
    NaN everywhere."""
    rng = np.random.RandomState(seed)
    A = rng.randn(B, p, p)
    H = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(p)
    c = rng.randn(B, p)
    scale = np.ones(B)
    scale[2] = np.nan
    return H, c, scale


def test_lbfgs_batched_matches_jax_step_for_step():
    """A closed-form batch: steps and converged equal to JAX's,
    parameters to 1e-8, the optima reached, the NaN trial frozen."""
    H, c, scale = _quadratic_batch()
    P0 = np.zeros_like(c)

    def j_f(P):
        r = P - c
        return 0.5 * scale * jnp.einsum("bi,bij,bj->b", r, H, r)

    Ht, ct, st = _t(H), _t(c), _t(scale)

    def f(P):
        r = P - ct
        return 0.5 * st * torch.einsum("bi,bij,bj->b", r, Ht, r)

    kw = dict(history=4, max_steps=30, chunk_steps=5, gtol=1e-9)
    jP, jinfo = j_lbfgs_batched(j_f, jnp.asarray(P0), **kw)
    P, info = lbfgs_batched(f, _t(P0), **kw)
    np.testing.assert_array_equal(info["steps"].numpy(), np.asarray(jinfo["steps"]))
    np.testing.assert_array_equal(info["converged"].numpy(), np.asarray(jinfo["converged"]))
    assert info["segments_run"] == jinfo["segments_run"]
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), atol=1e-8)
    ok = np.isfinite(scale)
    np.testing.assert_allclose(P.numpy()[ok], c[ok], atol=1e-8)
    assert info["steps"][2] == 0 and info["converged"][2] and (P[2] == 0).all()
    assert set(info) == set(jinfo)


def test_well_poisson_mle_matches_jax_lbfgs():
    """N=4, B=4, T=20, 3 steps: the port's ``lbfgs_batched`` through
    the kernel route (plain K1 on the CPU) against JAX's through
    "refined": parameters rtol 1e-6, steps equal, and no trial's nell
    rises from one step to the next."""
    ys = _wp_ys(20, 4, seed=1)
    P0 = np.full((4, 2), 0.5)
    kw = dict(max_steps=3, chunk_steps=3)
    jP, jinfo = j_lbfgs_batched(_j_nell_fn(ys, "refined"), jnp.asarray(P0), **kw)
    trace = []
    P, info = lbfgs_batched(_nell_fn(ys, "fused"), _t(P0),
                            callback=lambda P, f: trace.append(f.clone()), **kw)
    np.testing.assert_array_equal(info["steps"].numpy(), np.asarray(jinfo["steps"]))
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), rtol=1e-6)
    np.testing.assert_allclose(info["nell"].numpy(), np.asarray(jinfo["nell"]), rtol=1e-8)
    f = torch.stack(trace)
    assert len(trace) == 3 and bool((f[1:] <= f[:-1]).all())


def _linear_gaussian(T=40, N=4):
    """The JAX estimation tests' model: x' = F x + N(0, 0.3), y = x +
    N(0, 0.4), F unknown (tanh-parameterised), raw-moment filter."""
    rng = np.random.RandomState(11)
    x, ys = 0.0, []
    for _ in range(T):
        x = 0.85 * x + np.sqrt(0.3) * rng.randn()
        ys.append(x + np.sqrt(0.4) * rng.randn())
    ys = np.asarray(ys)

    def j_nell(params):
        f = jnp.tanh(params[0])
        from mfs_tpu.sde.transitions import _normal_closure_factory
        trans = _normal_closure_factory(lambda x: (f * x, 0.3 * jnp.ones_like(x)), 2 * N)
        pdf = lambda y, x: jnp.exp(-0.5 * (y - x) ** 2 / 0.4) / jnp.sqrt(2 * jnp.pi * 0.4)
        return j_filter_rms(trans.rms, pdf, j_moments(0.0, 1.0, 2 * N), jnp.asarray(ys))[1]

    def nell(params):
        f = torch.tanh(params[0])
        from mfs_tpu_torch.sde.transitions import _normal_closure_factory
        trans = _normal_closure_factory(lambda x: (f * x, 0.3 * torch.ones_like(x)), 2 * N)
        pdf = lambda y, x: torch.exp(-0.5 * (y - x) ** 2 / 0.4) / np.sqrt(2 * np.pi * 0.4)
        rms0 = normal_raw_moments_all(torch.zeros((), dtype=torch.float64), 1.0, 2 * N)
        return moment_filter_rms(trans.rms, pdf, rms0, _t(ys), eigh_impl="refined")[1]

    return j_nell, nell


def test_fit_mle_routines_reach_jax_scipy_optimum():
    """``fit_mle_scipy`` and ``fit_mle_optax`` (torch L-BFGS) reach
    JAX ``fit_mle_scipy``'s optimum on one small problem: parameter
    within 1e-5, nell rtol 1e-5.  The chunk ValueError is kept.  The
    filter runs "refined" here: the MLE routines are under test, and K1's
    gradient is held above."""
    j_nell, nell = _linear_gaussian()
    ref = j_fit_mle_scipy(j_nell, jnp.array([0.1]))
    res = fit_mle_scipy(nell, torch.tensor([0.1], dtype=torch.float64))
    np.testing.assert_allclose(res.x, ref.x, atol=1e-5)
    np.testing.assert_allclose(res.fun, ref.fun, rtol=1e-5)
    params, losses = fit_mle_optax(nell, torch.tensor([0.1], dtype=torch.float64), num_steps=6)
    assert losses.shape == (6,) and bool((losses[1:] <= losses[:-1]).all())
    np.testing.assert_allclose(params.numpy(), ref.x, atol=1e-5)
    np.testing.assert_allclose(nell(params).item(), ref.fun, rtol=1e-5)
    with pytest.raises(ValueError, match="chunk_steps"):
        fit_mle_optax(nell, torch.tensor([0.1], dtype=torch.float64), num_steps=10, chunk_steps=3)
