"""Port vs JAX: the cyclic Jacobi eigensolver (``ops/eigh.py::eigh_batched``)
and its derivative rule, the quadratures that use it ("jacobi" in both
quadratures, textbook Golub–Welsch), and the Taylor rule with the
quadrature-free filter, on the same numpy inputs.

Eigenpairs are held by rotation-free checks (sorted eigenvalues, residual,
orthonormality); the backward by the dot-product identity against JAX's
JVP rule evaluated at the port's own eigenpairs."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mfs_tpu.multi_dims.multi_indices import (  # noqa: E402
    generate_graded_lexico_multi_indices, gram_and_hankel_indices_graded_lexico)
from mfs_tpu.multi_dims.quadrature import moment_quadrature_nd as j_quad_nd  # noqa: E402
from mfs_tpu.one_dim import filtering as jf  # noqa: E402
from mfs_tpu.one_dim import quadrature as jq  # noqa: E402
from mfs_tpu.ops import eigh as je  # noqa: E402
from mfs_tpu.utils.gaussian import GaussianSumND as JGaussianSumND  # noqa: E402
from mfs_tpu.utils.gaussian import normal_raw_moments_all as j_moments  # noqa: E402
from mfs_tpu_torch.multi_dims.quadrature import moment_quadrature_nd as t_quad_nd  # noqa: E402
from mfs_tpu_torch.one_dim import filtering as tf  # noqa: E402
from mfs_tpu_torch.one_dim import quadrature as tq  # noqa: E402
from mfs_tpu_torch.ops import eigh as te  # noqa: E402
from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all as t_moments  # noqa: E402


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _symmetric(B, n, seed, cluster=False):
    """(B, n, n) symmetric matrices; with ``cluster`` each has eigenvalues
    1, 1 + 1e-13 (a near-degenerate pair, where the derivative rule's
    gap guard acts) and well separated others."""
    rng = np.random.RandomState(seed)
    if not cluster:
        a = rng.randn(B, n, n)
        return a + np.swapaxes(a, -1, -2)
    q, _ = np.linalg.qr(rng.randn(B, n, n))
    lam = np.concatenate([[1.0, 1.0 + 1e-13], 2.0 + np.arange(n - 2)])
    return np.einsum("bij,j,bkj->bik", q, lam, q)


def _mixture(N, B, seed):
    rng = np.random.RandomState(seed)
    m, v = rng.randn(B) * 0.3, 0.5 + rng.rand(B)
    return np.asarray(0.6 * j_moments(jnp.asarray(m), jnp.asarray(v), 2 * N)
                      + 0.4 * j_moments(jnp.asarray(m + 0.3), jnp.asarray(v * 0.8), 2 * N))


@pytest.mark.parametrize("n, B", [(2, 3), (7, 5), (15, 4)])
def test_eigh_batched_matches_jax(n, B):
    """Sorted eigenvalues vs JAX's rtol 1e-12; residual ‖AV − VΛ‖ and
    ‖VᵀV − I‖ below 1e-12 of ‖A‖; ``sort`` orders values and vectors."""
    a = _symmetric(B, n, seed=n)
    vals, vecs = te.eigh_batched(_t(a))
    jv, _ = je.eigh_batched(jnp.asarray(a))
    np.testing.assert_allclose(np.sort(vals.numpy(), -1), np.sort(np.asarray(jv), -1),
                               rtol=1e-12, atol=1e-12 * np.abs(a).max())
    scale = np.abs(a).max()
    assert np.abs(a @ vecs.numpy() - vecs.numpy() * vals.numpy()[:, None, :]).max() < 1e-12 * scale
    assert np.abs(np.swapaxes(vecs.numpy(), -1, -2) @ vecs.numpy() - np.eye(n)).max() < 1e-12
    svals, svecs = te.eigh_batched(_t(a), sort=True)
    assert bool((svals.diff(dim=-1) >= 0).all())
    np.testing.assert_allclose((svecs @ torch.diag_embed(svals) @ svecs.mT).numpy(), a,
                               atol=1e-12 * scale)


def test_eigh_batched_backward_is_the_transpose_of_jax_jvp(monkeypatch):
    """<JVP_jax(dA), (gw, gV)> = <dA, VJP_port(gw, gV)> per matrix, rtol
    1e-10: JAX's rule (``_eigh_core_jvp``) evaluated at the port's own
    eigenpairs, on generic matrices (where the port's eigenvectors also
    equal JAX's, atol 1e-12) and on matrices with a near-degenerate pair
    (gap 1e-13, under the 1e-9 spread guard, where the pair's basis is
    arbitrary and the rule gives no tangent inside it)."""
    B, n = 4, 6
    rng = np.random.RandomState(7)
    for cluster in (False, True):
        a = _symmetric(B, n, seed=8, cluster=cluster)
        da = rng.randn(B, n, n)
        gw, gv = rng.randn(B, n), rng.randn(B, n, n)
        at = _t(a).requires_grad_(True)
        vals, vecs = te.eigh_batched(at)
        (grad,) = torch.autograd.grad((vals, vecs), at, (_t(gw), _t(gv)))
        if not cluster:
            np.testing.assert_allclose(vecs.detach().numpy(),
                                       np.asarray(je.eigh_batched(jnp.asarray(a))[1]), atol=1e-12)
        own = (jnp.asarray(vals.detach().numpy()), jnp.asarray(vecs.detach().numpy()))
        monkeypatch.setattr(je, "_eigh_core", lambda a_, sweeps: own)
        _, (djv, djV) = je._eigh_core_jvp(te._default_sweeps(n), (jnp.asarray(a),),
                                          (jnp.asarray(da),))
        lhs = (np.asarray(djv) * gw).sum(-1) + (np.asarray(djV) * gv).sum((-1, -2))
        rhs = (grad.numpy() * da).sum((-1, -2))
        np.testing.assert_allclose(rhs, lhs, rtol=1e-10)


def test_quadratures_through_jacobi_match_jax():
    """``eigh_impl="jacobi"`` resolves in both quadratures.  1D (n = 5, raw
    mixture moments, sorted): nodes atol 1e-12, weights rtol 1e-10.  2D
    (order 3, a Gaussian sum): the rules as measures, their moments at
    every basis multi-index, rtol 1e-10.  Textbook Golub–Welsch on (4, 2n)
    raw mixture moments at n = 6, with mean and scale: sorted nodes atol
    1e-12, weights rtol 1e-10."""
    ms = _mixture(5, 6, seed=1)
    w, x = tq.moment_quadrature(_t(ms), eigh_impl="jacobi", sort_nodes=True)
    jw, jx = jq.moment_quadrature(jnp.asarray(ms), eigh_impl="jacobi", sort_nodes=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-12)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-10)

    N, d = 3, 2
    mis = generate_graded_lexico_multi_indices(d, 2 * N - 1)
    gs = JGaussianSumND.new(jnp.array([[0.3, -0.2], [-0.4, 0.5]]),
                            jnp.array([np.eye(2) * 0.5, [[0.6, 0.1], [0.1, 0.4]]]),
                            jnp.array([0.4, 0.6]), mis)
    inds = gram_and_hankel_indices_graded_lexico(N, d)
    ms_nd = np.stack([np.asarray(gs.rms)] * 2)
    w2, x2 = t_quad_nd(_t(ms_nd), inds, eigh_impl="jacobi")
    jw2, jx2 = j_quad_nd(jnp.asarray(ms_nd), inds, eigh_impl="jacobi")
    mi = np.asarray(mis)
    powers = lambda xx: np.prod(np.asarray(xx)[..., None, :] ** mi, axis=-1)
    got = np.einsum("bk,bkm->bm", w2.numpy(), powers(x2.numpy()))
    want = np.einsum("bk,bkm->bm", np.asarray(jw2), powers(jx2))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    ms = _mixture(6, 4, seed=2)
    mean, scale = np.linspace(-0.5, 0.5, 4), np.linspace(0.8, 1.4, 4)
    w, x = tq.gauss_quadrature_golub_welsch(_t(ms), _t(mean), _t(scale), sort_nodes=True)
    jw, jx = jq.gauss_quadrature_golub_welsch(jnp.asarray(ms), jnp.asarray(mean),
                                              jnp.asarray(scale), sort_nodes=True)
    assert w.shape == (4, 5)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-12)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-10)


def test_taylor_rules_match_jax():
    """``taylor_quadrature`` of a vector-valued elementwise integrand at
    order 4 over (5,) trials, and the ``make_derivatives`` tower of a
    scalar function at order 3: rtol 1e-12."""
    rng = np.random.RandomState(4)
    cms = np.asarray(j_moments(jnp.zeros(5), jnp.asarray(0.2 + rng.rand(5)), 6))
    mean = rng.randn(5)
    f_t = lambda u: torch.stack([torch.sin(u) * torch.exp(-u * u), u**3], dim=-1)
    f_j = lambda u: jnp.stack([jnp.sin(u) * jnp.exp(-u * u), u**3], axis=-1)
    np.testing.assert_allclose(
        tq.taylor_quadrature(f_t, _t(cms), _t(mean), 4).numpy(),
        np.asarray(jq.taylor_quadrature(f_j, jnp.asarray(cms), jnp.asarray(mean), 4)),
        rtol=1e-12)
    g_t = lambda u, c: torch.stack([torch.tanh(c * u), u**4])
    g_j = lambda u, c: jnp.stack([jnp.tanh(c * u), u**4])
    for dt, dj in zip(tq.make_derivatives(g_t, 3), jq.make_derivatives(g_j, 3)):
        np.testing.assert_allclose(dt(_t(0.3), 1.7).numpy(), np.asarray(dj(0.3, 1.7)),
                                   rtol=1e-12)


# The OU / Matérn-1/2 model of the convergence study, closed-form moments.
DT, ELL, SIGMA, XI = 0.1, 1.0, 0.5, 1.0
F = math.exp(-DT / ELL)
Q = SIGMA**2 * (1 - math.exp(-2 * DT / ELL))


@pytest.mark.parametrize("N, order", [(3, 2), (2, None)])
def test_moment_filter_taylor_matches_jax(N, order):
    """The quadrature-free filter on 6 OU trials, T=20: the port's batch
    against JAX's batch, cmss, means and nell rtol 1e-10; ``taylor_order``
    2 at N=3 (as on the card) and the default 2N - 1 = 3 at N=2."""
    B, T = 6, 20
    rng = np.random.RandomState(N)
    ys = rng.randn(T, B)
    cms0 = np.broadcast_to(np.asarray(j_moments(0.0, SIGMA**2, 2 * N)), (B, 2 * N)).copy()
    meas_t = lambda y, x: torch.exp(-0.5 * (y - x) ** 2 / XI) / math.sqrt(2 * math.pi * XI)
    meas_j = lambda y, x: jnp.exp(-0.5 * (y - x) ** 2 / XI) / math.sqrt(2 * math.pi * XI)
    got = tf.moment_filter_taylor(lambda u, m: t_moments(F * u - m, Q, 2 * N), lambda u: F * u,
                                  meas_t, _t(cms0), 0.0, _t(ys), taylor_order=order)
    want = jf.moment_filter_taylor(lambda u, m: j_moments(F * u - m, Q, 2 * N), lambda u: F * u,
                                   meas_j, jnp.asarray(cms0), 0.0, jnp.asarray(ys),
                                   taylor_order=order)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-14)
