"""Port vs JAX: K1's implicit-function gradient.

``ops/quadrature_kernel.py::_FusedQuadrature`` on CPU tensors, around
the kernel's plain version, against the JAX package's JVP
(``mfs_tpu/ops/pallas_quadrature.py::_implicit_tangent``) and against
central differences, on the same numpy inputs.  The card's kernel route
is held against this plain route by ``chip_smoke.py``
(``k1_grad_vs_plain``) and ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mfs_tpu.ops.pallas_quadrature as pq  # noqa: E402
from mfs_tpu.utils.gaussian import normal_raw_moments_all as j_moments  # noqa: E402
from mfs_tpu_torch.ops import quadrature_kernel as qk  # noqa: E402


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _mixture(N, B, seed):
    """Raw moments of two-Gaussian mixtures, scaled so that m0 = 1.3."""
    rng = np.random.RandomState(seed)
    means = rng.randn(B) * 0.3
    varis = 0.5 + rng.rand(B)
    ms = 0.6 * j_moments(jnp.asarray(means), jnp.asarray(varis), 2 * N) + 0.4 * j_moments(
        jnp.asarray(means) + 0.3, jnp.asarray(varis) * 0.8, 2 * N)
    return np.array(ms) * 1.3


def _quadrature_inputs(N, B, seed):
    rng = np.random.RandomState(seed + 100)
    return _mixture(N, B, seed), rng.randn(B) * 0.1, 1.0 + 0.2 * rng.rand(B), rng


def _vjp(ms, mean, scale, gw, gx):
    """The port's (w, x) and its backward for cotangents (gw, gx)."""
    args = [_t(a).requires_grad_(True) for a in (ms, mean, scale)]
    w, x = qk.moment_quadrature_fused(*args)
    grads = torch.autograd.grad((w, x), args, (_t(gw), _t(gx)))
    return w.detach().numpy(), x.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("N", [3, 4])
def test_k1_vjp_is_the_transpose_of_jax_jvp(N):
    """<JVP_jax(d), g> = <d, VJP_port(g)> per trial, with JAX's
    ``_implicit_tangent`` run on the port's own (w, x); m0 = 1.3."""
    B = 6
    ms, mean, scale, rng = _quadrature_inputs(N, B, seed=N)
    gw, gx = rng.randn(B, N), rng.randn(B, N)
    dms = rng.randn(B, 2 * N) * np.abs(ms) * 0.1
    dmean, dscale = rng.randn(B), rng.randn(B) * 0.1
    w, x, (g_ms, g_mean, g_scale) = _vjp(ms, mean, scale, gw, gx)
    dw, dx = jax.jit(pq._implicit_tangent)(w, x, ms, mean, scale, dms, dmean, dscale)
    lhs = (np.asarray(dw) * gw).sum(-1) + (np.asarray(dx) * gx).sum(-1)
    rhs = (g_ms * dms).sum(-1) + g_mean * dmean + g_scale * dscale
    np.testing.assert_allclose(rhs, lhs, rtol=1e-8)


@pytest.mark.parametrize("N", [3, 4])
def test_k1_vjp_matches_central_differences(N):
    """The full Jacobian from the VJP (one unit cotangent per output)
    against central differences of the plain primal along every input
    coordinate: atol 1e-6, JAX's bound for its JVP."""
    B = 4
    ms, mean, scale, _ = _quadrature_inputs(N, B, seed=10 + N)
    inputs = np.concatenate([ms, mean[:, None], scale[:, None]], axis=-1)  # (B, 2N + 2)
    jac_vjp = np.zeros((B, 2 * N, 2 * N + 2))
    for k in range(2 * N):  # output k: w_k (k < N) or x_{k-N}
        g = np.zeros((B, 2 * N))
        g[:, k] = 1.0
        _, _, grads = _vjp(ms, mean, scale, g[:, :N], g[:, N:])
        jac_vjp[:, k] = np.concatenate([grads[0], grads[1][:, None], grads[2][:, None]], -1)

    def f(z):
        w, x = qk.moment_quadrature_fused(_t(z[:, :2 * N]), _t(z[:, 2 * N]), _t(z[:, 2 * N + 1]))
        return np.concatenate([w.numpy(), x.numpy()], -1)

    eps = 1e-6
    jac_fd = np.zeros_like(jac_vjp)
    for i in range(2 * N + 2):
        step = np.zeros_like(inputs)
        step[:, i] = eps * max(1.0, np.abs(inputs[:, i]).max())
        jac_fd[:, :, i] = (f(inputs + step) - f(inputs - step)) / (2 * step[0, i])
    np.testing.assert_allclose(jac_vjp, jac_fd, atol=1e-6)


def test_k1_gradient_shapes_and_constants():
    """``mean``/``scale`` gradients come back in the shapes passed (0-d,
    (B,), (1,)); a Python float gets none, and ``ms`` alone can ask."""
    N, B = 3, 5
    ms, mean, scale, _ = _quadrature_inputs(N, B, seed=3)
    m = _t(ms).requires_grad_(True)
    mu0 = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    sc = _t(scale).requires_grad_(True)
    sc1 = torch.tensor([1.1], dtype=torch.float64, requires_grad=True)
    w, x = qk.moment_quadrature_fused(m, mu0, sc)
    g = torch.autograd.grad((x.sum() + w.sum(), ), (m, mu0, sc))
    assert g[0].shape == (B, 2 * N) and g[1].shape == () and g[2].shape == (B,)
    # d(sum x)/d(mean) = n per trial, summed over the batch for a 0-d mean
    assert abs(g[1].item() - N * B) < 1e-12
    w, x = qk.moment_quadrature_fused(m, 0.0, sc1)
    (g1,) = torch.autograd.grad(x.sum(), sc1)
    assert g1.shape == (1,)
    w, x = qk.moment_quadrature_fused(m)
    (gm,) = torch.autograd.grad(w.sum(), m)
    assert torch.isfinite(gm).all()


def test_k1_gradient_of_a_nonfinite_trial_is_nan():
    """A NaN trial gets NaN gradients, the batch does not raise, and
    the other trials' gradients equal those of a batch without it."""
    N, B = 4, 5
    ms, mean, scale, rng = _quadrature_inputs(N, B, seed=7)
    gw, gx = rng.randn(B, N), rng.randn(B, N)
    bad = ms.copy()
    bad[2, 3] = np.nan
    _, _, grads = _vjp(bad, mean, scale, gw, gx)
    keep = [0, 1, 3, 4]
    _, _, ref = _vjp(ms[keep], mean[keep], scale[keep], gw[keep], gx[keep])
    assert np.isnan(grads[0][2]).all()
    for got, want in zip(grads, ref):
        np.testing.assert_array_equal(got[keep], want)
