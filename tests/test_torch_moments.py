"""Port vs JAX: combinatorics, the normal-moment helpers, the 1D moment
conversions, cumulants and characteristic functions, on the same numpy
inputs.  The port's functions also take leading trial axes; each trial
is held against JAX's single-vector result."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mfs_tpu.one_dim import moments as jm  # noqa: E402
from mfs_tpu.utils import combinatorics as jc  # noqa: E402
from mfs_tpu.utils import gaussian as jg  # noqa: E402
from mfs_tpu_torch.one_dim import moments as tm  # noqa: E402
from mfs_tpu_torch.utils import combinatorics as tc  # noqa: E402
from mfs_tpu_torch.utils import gaussian as tg  # noqa: E402


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _mixture_raw(N, B, seed):
    """Raw moments (B, 2N) of two-Gaussian mixtures."""
    rng = np.random.RandomState(seed)
    m, v = rng.randn(B) * 0.5, 0.4 + rng.rand(B)
    return (0.6 * np.asarray(jg.normal_raw_moments_all(jnp.asarray(m), jnp.asarray(v), 2 * N))
            + 0.4 * np.asarray(jg.normal_raw_moments_all(jnp.asarray(m + 0.7),
                                                         jnp.asarray(v * 0.5), 2 * N)))


def test_combinatorics_match_jax():
    """gamma, factorial, binom, pascal_lower, the Hermite ladders and the
    stacked calls: rtol 1e-14; Bell polynomials of one vector exactly
    (the same operations in the same order)."""
    x = np.array([0.5, 1.5, 3.25, 7.0])
    for tf, jf in ((tc.gamma, jc.gamma), (tc.factorial, jc.factorial)):
        np.testing.assert_allclose(tf(_t(x)).numpy(), np.asarray(jf(jnp.asarray(x))), rtol=1e-14)
    np.testing.assert_allclose(tc.binom(_t(x) + 3.0, _t(x)).numpy(),
                               np.asarray(jc.binom(jnp.asarray(x) + 3.0, jnp.asarray(x))),
                               rtol=1e-14)
    np.testing.assert_array_equal(tc.pascal_lower(9), jc.pascal_lower(9))
    rng = np.random.RandomState(0)
    xs = rng.randn(8)
    for n in range(8):
        for k in range(8):
            assert float(tc.partial_bell(n, k, _t(xs))) == float(jc.partial_bell(n, k, jnp.asarray(xs)))
        assert float(tc.complete_bell(n, _t(xs))) == float(jc.complete_bell(n, jnp.asarray(xs)))
    h = rng.randn(5, 3)
    np.testing.assert_allclose(tc.hermite_probabilist_all(9, _t(h)).numpy(),
                               np.asarray(jc.hermite_probabilist_all(9, jnp.asarray(h))), rtol=1e-14)
    for n in (0, 1, 4, 9):
        np.testing.assert_allclose(tc.hermite_probabilist(n, _t(h)).numpy(),
                                   np.asarray(jc.hermite_probabilist(n, jnp.asarray(h))),
                                   rtol=1e-14)
    funcs = [lambda v: v ** 2, lambda v: v.sum() * v, lambda v: -v]
    np.testing.assert_allclose(tc.vmap_list_of_funcs(funcs)(_t(x)).numpy(),
                               np.asarray(jc.vmap_list_of_funcs(funcs)(jnp.asarray(x))),
                               rtol=1e-14)


def test_bell_polynomials_batch_over_leading_axes():
    """One programme over ``xs (4, 3, 8)`` equals JAX's per-vector values
    exactly, and reads as many tensor operations as one vector's."""
    xs = np.random.RandomState(1).randn(4, 3, 8)
    got = tc.partial_bell(7, 3, _t(xs)).numpy()
    full = tc.complete_bell(8, _t(xs)).numpy()
    for i in np.ndindex(4, 3):
        assert got[i] == float(jc.partial_bell(7, 3, jnp.asarray(xs[i])))
        assert full[i] == float(jc.complete_bell(8, jnp.asarray(xs[i])))
    # a list of per-entry tensors works like the last axis of one tensor
    as_list = [_t(xs[..., i]) for i in range(8)]
    np.testing.assert_array_equal(tc.partial_bell(7, 3, as_list).numpy(), got)


def test_normal_moment_helpers_match_jax():
    """``raw_moment_of_standard_normal`` exactly; ``raw_moment_of_normal``
    and ``central_moment_of_normal`` rtol 1e-14, batched."""
    mean, var = np.array([-0.3, 0.0, 1.2]), np.array([0.5, 2.0, 0.1])
    for p in range(12):
        assert tg.raw_moment_of_standard_normal(p) == jg.raw_moment_of_standard_normal(p)
        np.testing.assert_allclose(
            tg.raw_moment_of_normal(_t(mean), _t(var), p).numpy(),
            np.asarray(jg.raw_moment_of_normal(jnp.asarray(mean), jnp.asarray(var), p)),
            rtol=1e-14)
        np.testing.assert_allclose(
            np.asarray(tg.central_moment_of_normal(_t(var), p)),
            np.asarray(jg.central_moment_of_normal(jnp.asarray(var), p)), rtol=1e-14)


@pytest.mark.parametrize("N", [3, 8])
def test_conversions_match_jax(N):
    """raw_to_central, central_to_raw, raw_to_scaled (own and given scale)
    and scaled_to_central, batched over (5, 2N) vectors: rtol 1e-12."""
    rms = _mixture_raw(N, 5, seed=N)
    scale = 0.7 + np.arange(5) * 0.1
    jr = jnp.asarray(rms)
    cms_t = tm.raw_to_central(_t(rms))
    cms_j = jm.raw_to_central(jr)
    np.testing.assert_allclose(cms_t.numpy(), np.asarray(cms_j), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tm.central_to_raw(cms_t, _t(rms[:, 1])).numpy(),
                               np.asarray(jm.central_to_raw(cms_j, jr[:, 1])), rtol=1e-12)
    np.testing.assert_allclose(tm.raw_to_scaled(_t(rms)).numpy(),
                               np.asarray(jm.raw_to_scaled(jr)), rtol=1e-12, atol=1e-14)
    sms_t = tm.raw_to_scaled(_t(rms), _t(scale))
    sms_j = jm.raw_to_scaled(jr, jnp.asarray(scale))
    np.testing.assert_allclose(sms_t.numpy(), np.asarray(sms_j), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tm.scaled_to_central(sms_t, _t(scale)).numpy(),
                               np.asarray(jm.scaled_to_central(sms_j, jnp.asarray(scale))),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("N", [2, 8])
def test_cumulants_match_jax(N):
    """``sms_to_cumulants`` on (4, 2N) vectors against JAX's one vector at
    a time: rtol 1e-12 (the same Bell programme, so in practice equal)."""
    rms = _mixture_raw(N, 4, seed=10 + N)
    scale = np.sqrt(rms[:, 2] - rms[:, 1] ** 2)
    sms = np.asarray(jm.raw_to_scaled(jnp.asarray(rms)))
    got = tm.sms_to_cumulants(_t(sms), _t(rms[:, 1]), _t(scale)).numpy()
    assert got.shape == (4, 2 * N - 1)
    for b in range(4):
        want = np.asarray(jm.sms_to_cumulants(jnp.asarray(sms[b]), rms[b, 1], scale[b]))
        np.testing.assert_allclose(got[b], want, rtol=1e-12)
    # k1 = mean, k2 = variance
    np.testing.assert_allclose(got[:, 1], scale**2, rtol=1e-12)


def test_characteristic_functions_match_jax():
    """``characteristic_fn`` through K1's plain version (the port's rule on
    a CPU tensor) against JAX's "refined" rule, on central moments of
    three mixtures: atol 1e-12 (the rules agree as measures); and
    ``characteristic_from_pdf`` of a gridded Normal: rtol 1e-12."""
    N = 6
    rms = _mixture_raw(N, 3, seed=3)
    cms = np.asarray(jm.raw_to_central(jnp.asarray(rms)))
    zs = np.linspace(-3.0, 3.0, 41).reshape(41, 1)
    got = tm.characteristic_fn(_t(zs), _t(cms), _t(rms[:, 1])).numpy()
    assert got.shape == (3, 41, 1) and got.dtype == np.complex128
    for b in range(3):
        want = np.asarray(jm.characteristic_fn(jnp.asarray(zs), jnp.asarray(cms[b]), rms[b, 1]))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-12)
    xs = np.linspace(-6.0, 6.0, 801)
    ps = np.exp(-0.5 * (xs - 0.3) ** 2) / math.sqrt(2 * math.pi)
    np.testing.assert_allclose(
        tm.characteristic_from_pdf(_t(zs[:, 0]), _t(ps), _t(xs)).numpy(),
        np.asarray(jm.characteristic_from_pdf(jnp.asarray(zs[:, 0]), jnp.asarray(ps),
                                              jnp.asarray(xs))), rtol=1e-12)
