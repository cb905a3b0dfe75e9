"""Port vs JAX: Gaussian moment closed forms, the Gaussian-sum initial
condition and the batched LDL helpers, on the same numpy inputs.

Bound: rtol 1e-12.  Both sides run the same recurrences and column loops
in f64, so they differ only by summation order in the einsums and
reductions (a few ulps, amplified at most ~100x by the order-30 moment
recurrence at these scales).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mfs_tpu.utils.gaussian import GaussianSum1D as JGaussianSum1D  # noqa: E402
from mfs_tpu.utils.gaussian import normal_raw_moments_all as j_moments  # noqa: E402
from mfs_tpu.utils.linalg import ldl as j_ldl, ldl_chol as j_ldl_chol  # noqa: E402
from mfs_tpu_torch.interop import gaussian_sum_1d_from_numpy, to_numpy  # noqa: E402
from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all  # noqa: E402
from mfs_tpu_torch.utils.linalg import ldl, ldl_chol  # noqa: E402

RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


@pytest.mark.parametrize("num_moments", [1, 2, 7, 30])
def test_normal_raw_moments_all(num_moments):
    rng = np.random.RandomState(0)
    mean = rng.randn(3, 5) * 0.7
    var = 0.1 + rng.rand(3, 5)
    got = normal_raw_moments_all(_t(mean), _t(var), num_moments).numpy()
    want = np.asarray(j_moments(jnp.asarray(mean), jnp.asarray(var), num_moments))
    assert got.shape == want.shape == (3, 5, num_moments)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300)


def test_normal_raw_moments_broadcast_scalar_variance():
    mean = np.linspace(-1.0, 1.0, 4)
    got = normal_raw_moments_all(_t(mean), 0.3, 6).numpy()
    want = np.asarray(j_moments(jnp.asarray(mean), 0.3, 6))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("N", [2, 15])
def test_gaussian_sum_1d_new(N):
    means, variances, weights = [-0.5, 0.5, 1.2], [0.05, 0.05, 0.3], [0.4, 0.4, 0.2]
    got = gaussian_sum_1d_from_numpy(means, variances, weights, N, device="cpu")
    want = JGaussianSum1D.new(
        jnp.asarray(means), jnp.asarray(variances), jnp.asarray(weights), N=N
    )
    for field in ("mean", "variance", "rms", "cms", "scms"):
        np.testing.assert_allclose(
            to_numpy(getattr(got, field)), np.asarray(getattr(want, field)),
            rtol=RTOL, atol=1e-15, err_msg=field,
        )
    xs = np.linspace(-2.0, 2.0, 9)
    np.testing.assert_allclose(
        got.pdf(_t(xs)).numpy(), np.asarray(want.pdf(jnp.asarray(xs))), rtol=RTOL
    )


def test_gaussian_sum_1d_sampler():
    # Different RNG streams from JAX by design: check determinism per
    # seed and the first two moments of a large draw instead.
    ic = gaussian_sum_1d_from_numpy([-0.5, 0.5], [0.05, 0.05], [0.5, 0.5], 2, device="cpu")
    draw = lambda seed: ic.sampler(torch.Generator().manual_seed(seed), 20000)
    a, b = draw(0), draw(0)
    assert a.shape == (20000,) and a.dtype == torch.float64
    assert torch.equal(a, b)
    # mean 0, variance 0.3: 5-sigma bounds for 20000 draws.
    assert abs(a.mean().item()) < 5 * np.sqrt(0.3 / 20000)
    assert abs(a.var().item() - 0.3) < 0.02


def _sym_batch(seed, n, indefinite):
    rng = np.random.RandomState(seed)
    a = rng.randn(4, n, n)
    mat = a @ np.swapaxes(a, -1, -2) + n * np.eye(n)
    if indefinite:
        mat = mat - 1.5 * n * np.eye(n)
    return mat


@pytest.mark.parametrize("indefinite", [False, True])
def test_ldl_and_ldl_chol(indefinite):
    mat = _sym_batch(1, 6, indefinite)
    L, d = ldl(_t(mat))
    jL, jd = j_ldl(jnp.asarray(mat))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=RTOL)
    if indefinite:
        assert (d.numpy() < 0).any()
    R = ldl_chol(_t(mat)).numpy()
    np.testing.assert_allclose(R, np.asarray(j_ldl_chol(jnp.asarray(mat))),
                               rtol=RTOL, atol=1e-14)
    # explicit eps
    np.testing.assert_allclose(
        ldl_chol(_t(mat), eps=1e-3).numpy(),
        np.asarray(j_ldl_chol(jnp.asarray(mat), eps=1e-3)), rtol=RTOL, atol=1e-14,
    )
