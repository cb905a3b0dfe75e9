"""Port vs JAX: the 1D moment quadrature, f64 path and fused kernel K1.

On the CPU the fused wrapper runs K1's plain PyTorch version; it is held
against the JAX kernel body run eagerly through ``run_kernel_as_jnp`` (as
``tests/test_pallas_quadrature.py`` runs it).  The CUDA kernel itself is
held against the plain version by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py`` on a GPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mfs_tpu.ops.doublefloat as dfm  # noqa: E402
from mfs_tpu.ops.doublefloat import DF  # noqa: E402
from mfs_tpu.ops.pallas_quadrature import run_kernel_as_jnp  # noqa: E402
from mfs_tpu.one_dim.quadrature import moment_quadrature as j_moment_quadrature  # noqa: E402
from mfs_tpu.utils.gaussian import normal_raw_moments_all as j_moments  # noqa: E402
from mfs_tpu_torch import config  # noqa: E402
from mfs_tpu_torch.one_dim.quadrature import hankel_indices, moment_quadrature  # noqa: E402
from mfs_tpu_torch.ops import quadrature_kernel as qk  # noqa: E402


def _mixture(N, B, seed):
    rng = np.random.RandomState(seed)
    means = rng.randn(B) * 0.3
    varis = 0.5 + rng.rand(B)
    ms = 0.6 * j_moments(jnp.asarray(means), jnp.asarray(varis), 2 * N) + 0.4 * j_moments(
        jnp.asarray(means) + 0.3, jnp.asarray(varis) * 0.8, 2 * N
    )
    return np.array(ms)


def _sorted(w, x):
    order = np.argsort(x, axis=-1)
    return np.take_along_axis(w, order, -1), np.take_along_axis(x, order, -1)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("N", [3, 4, 8])
def test_f64_moment_quadrature_vs_jax_xla(N, stable):
    """Port f64 path vs JAX ``eigh_impl="xla"``: both are LAPACK f64
    Cholesky/LDL + triangular solves + symmetric eigensolver on the same
    raw Hankel pair.  Bound: nodes atol 1e-10, weights atol 1e-12 — the
    raw N=8 Hankel has condition ~1e8, which scales the few-ulp
    differences of two LAPACK call sequences."""
    ms = _mixture(N, 6, seed=N)
    mean, scale = 0.2, 1.3
    w, x = moment_quadrature(_t(ms), mean, scale, stable=stable, eigh_impl="xla")
    jw, jx = j_moment_quadrature(jnp.asarray(ms), mean, scale, sort_nodes=True,
                                 stable=stable, eigh_impl="xla")
    w, x = _sorted(w.numpy(), x.numpy())
    np.testing.assert_allclose(x, np.asarray(jx), atol=1e-10)
    np.testing.assert_allclose(w, np.asarray(jw), atol=1e-12)
    np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-12)  # normalised rule


def _jax_kernel_body(ms, mean, scale, jitter):
    N = ms.shape[-1] // 2
    msd = dfm.from_f64(jnp.asarray(ms.T))
    md = dfm.from_f64(jnp.asarray(mean)[None])
    sd = dfm.from_f64(jnp.asarray(scale)[None])
    wh, wl, xh, xl = run_kernel_as_jnp(
        N, msd.hi, msd.lo, jnp.concatenate([md.hi, md.lo]),
        jnp.concatenate([sd.hi, sd.lo]), jitter=jitter,
    )
    return (np.asarray(dfm.to_f64(DF(wh, wl))).T, np.asarray(dfm.to_f64(DF(xh, xl))).T)


@pytest.mark.parametrize("jitter", [0.0, 1e-8])
@pytest.mark.parametrize("N", [3, 4, 8])
def test_fused_plain_vs_jax_kernel_body(N, jitter):
    """K1's plain version vs the JAX kernel body (double-f32, eager).

    Bounds at N <= 4: nodes 5e-12, weights 5e-8, the JAX kernel tests'
    own bounds against the f64 path (``tests/test_pallas_quadrature.py``);
    measured 4e-14 / 1.4e-14.  At N = 8 the JAX body works at ~2^-45
    against a Hankel of condition ~1e8: nodes 1e-9 (measured 4e-12), and
    without jitter the port's rule reproduces the moments to rtol 1e-10.
    (With jitter the rule is exact for a perturbed moment sequence, so
    only the agreement with the JAX body is held.)"""
    B = 7
    ms = _mixture(N, B, seed=10 + N)
    rng = np.random.RandomState(N)
    mean = rng.randn(B)
    scale = 0.5 + rng.rand(B)
    w, x = qk.moment_quadrature_fused(_t(ms), _t(mean), _t(scale), jitter=jitter)
    w, x = w.numpy(), x.numpy()
    jw, jx = _jax_kernel_body(ms, mean, scale, jitter)
    np.testing.assert_allclose(x, jx, atol=5e-12 if N <= 4 else 1e-9)
    np.testing.assert_allclose(w, jw, atol=5e-8)
    if jitter == 0.0:
        lam = (x - mean[:, None]) / scale[:, None]
        for p in range(2 * N):
            got = np.sum(w * lam**p, axis=-1)
            np.testing.assert_allclose(got, ms[:, p], rtol=1e-10, atol=1e-12)


def test_fused_ragged_batch_shape_and_mass():
    """Any batch shape, and the mass convention: K1's weights sum to m_0,
    the f64 path's to 1 (``mfs_tpu/ops/pallas_quadrature.py:405-408``)."""
    N = 4
    ms = _mixture(N, 15, seed=3).reshape(3, 5, 2 * N) * 1.3
    w, x = qk.moment_quadrature_fused(_t(ms), 0.5, 2.0)
    assert w.shape == x.shape == (3, 5, N)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.3, rtol=1e-12)
    w64, x64 = moment_quadrature(_t(ms), 0.5, 2.0, eigh_impl="xla")
    np.testing.assert_allclose(w64.sum(-1).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.sort(x.numpy(), -1), np.sort(x64.numpy(), -1), atol=1e-11)
    # one trial alone gives the same rule as inside the batch
    w1, x1 = qk.moment_quadrature_fused(_t(ms[1, 2]), 0.5, 2.0)
    np.testing.assert_allclose(x1.numpy(), x[1, 2].numpy(), rtol=1e-14)


def test_moment_quadrature_routes():
    N = 3
    ms = _t(_mixture(N, 4, seed=5))
    wf, xf = moment_quadrature(ms, eigh_impl="fused")
    wa, xa = moment_quadrature(ms, eigh_impl="auto")  # CPU tensor -> "refined"
    wr, xr = moment_quadrature(ms, eigh_impl="refined")
    assert torch.equal(xa, xr)
    np.testing.assert_allclose(np.sort(xf.numpy(), -1), xr.numpy(), atol=1e-12)
    with pytest.raises(NotImplementedError, match="E3"):
        moment_quadrature(ms, eigh_impl="jacobi")
    with pytest.raises(ValueError):
        moment_quadrature(ms, eigh_impl="nope")
    g, h = hankel_indices(3, device="cpu")
    assert g.tolist() == [[0, 1, 2], [1, 2, 3], [2, 3, 4]] and torch.equal(h, g + 1)


def test_nonfinite_inputs_give_nan_not_errors():
    """A non-PD or NaN Hankel diverges the trial (NaN), as in JAX, on
    every route, and leaves the other trials alone."""
    N = 3
    ms = _mixture(N, 3, seed=6)
    ms[1, 2] = -1.0  # m_2 < 0: G not PD
    ms[2, 4] = np.nan
    for impl in ("xla", "fused"):
        w, x = moment_quadrature(_t(ms), eigh_impl=impl)
        assert torch.isfinite(x[0]).all(), impl
        assert not torch.isfinite(x[2]).all(), impl
    w, x = moment_quadrature(_t(ms), eigh_impl="xla")
    assert not torch.isfinite(x[1]).all()


def test_fused_rejects_what_it_cannot_do():
    ms = _t(_mixture(3, 2, seed=7))
    with pytest.raises(NotImplementedError, match="B3"):
        qk.moment_quadrature_fused(ms.clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match="B3"):
        qk.moment_quadrature_fused(ms, torch.zeros(2, dtype=torch.float64, requires_grad=True))
    with pytest.raises(ValueError):
        qk.moment_quadrature_fused(torch.ones(2, 66, dtype=torch.float64))  # n = 33
    with pytest.raises(ValueError):
        qk.moment_quadrature_fused(torch.ones(2, 2, dtype=torch.float64))  # n = 1
    with pytest.raises(TypeError):
        qk.moment_quadrature_fused(ms.float())


def test_default_device_is_cuda_and_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        config.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        hankel_indices(3)
    assert config.default_device("cpu") == torch.device("cpu")

