"""Port vs JAX: the ND moment quadrature and the plain versions of K2 and
of the K-builder (``nd_k_fused``, the function of K3 and of the staged
builder).

On the CPU the fused wrappers run the plain PyTorch versions.  They are
held against the JAX kernel bodies run eagerly, as the JAX package's own
tests run them (Pallas interpret mode hangs XLA's CPU compiler on the ND
kernels): K2's ``_nd_kernel`` through ``run_nd_kernel_as_jnp``, K3's
``_nd_k_kernel`` through the ``_ArrayRef`` shim.  Each body runs once per
module.  Eigenvectors within a cluster of repeated eigenvalues are only
defined up to a rotation, so K2 is held by quantities that do not depend
on it: sorted eigenvalues, the residual ||K V - V diag(vals)||, V's
orthonormality and the quadrature's moment reproduction, at the JAX
test's bounds (residual 1e-12, orthonormality 1e-13, moments 5e-12).
The CUDA kernels are held against these plain versions on a GPU
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mfs_tpu.ops.doublefloat as dfm  # noqa: E402
import mfs_tpu.ops.pallas_quadrature_nd as j_pqnd  # noqa: E402
from mfs_tpu.multi_dims.moments import raw_moments_mvn_kan_all as j_kan_all  # noqa: E402
from mfs_tpu.multi_dims.quadrature import moment_quadrature_nd as j_moment_quadrature_nd  # noqa: E402
from mfs_tpu.multi_dims.quadrature import nd_cartesian_prod as j_nd_cartesian_prod  # noqa: E402
from mfs_tpu.ops.eigh import _round_robin_schedule as j_round_robin_schedule  # noqa: E402
from mfs_tpu_torch.multi_dims import multi_indices  # noqa: E402
from mfs_tpu_torch.multi_dims.moments import monomials_nd  # noqa: E402
from mfs_tpu_torch.multi_dims.quadrature import (  # noqa: E402
    moment_quadrature_nd,
    nd_cartesian_prod,
    nd_cartesian_prod_indices,
)
from mfs_tpu_torch.ops.dispatch import resolve_impl_nd  # noqa: E402
from mfs_tpu_torch.ops import quadrature_nd_kernel as qnd  # noqa: E402


def _moments(N, d, B, seed):
    """Raw moments of B random Gaussians (numpy, through the JAX tables)."""
    rng = np.random.RandomState(seed)
    mis = multi_indices.generate_graded_lexico_multi_indices(d, 2 * N - 1)
    mean = 0.3 * rng.randn(B, d)
    a = rng.randn(B, d, d)
    cov = np.einsum("bij,bkj->bik", a, a) * 0.1 + 0.5 * np.eye(d)
    ms = np.array(j_kan_all(jnp.asarray(mean), jnp.asarray(cov), mis))
    return ms, mis, multi_indices.gram_and_hankel_indices_graded_lexico(N, d)


def _f64_K(ms, inds):
    """The K_m of the f64 library path (Cholesky + two solves)."""
    m = torch.as_tensor(ms)
    idx = torch.as_tensor(inds)
    R = torch.linalg.cholesky(m[:, idx[0]])[:, None]
    X = torch.linalg.solve_triangular(R, m[:, idx[1:]], upper=False)
    K = torch.linalg.solve_triangular(R.mT, X, upper=True, left=False)
    return 0.5 * (K + K.mT)


def _reproduction_gap(ms, mis, w, x):
    got = torch.einsum("bmz,bm->bz", monomials_nd(x, mis), w)
    return (got - torch.as_tensor(ms)).abs().max().item()


@pytest.fixture(scope="module", params=[2, 3])
def k2_case(request):
    """K2's JAX body (double-f32) and plain version on the same inputs."""
    N = request.param
    ms, mis, inds = _moments(N, 2, 4, seed=N)
    d, s = 2, inds.shape[1]
    msd = dfm.from_f64(jnp.asarray(ms).T)
    va_h, va_l, _, _ = j_pqnd.run_nd_kernel_as_jnp(d, s, inds[0], inds[1:], msd.hi, msd.lo)
    j_vals = np.asarray(dfm.to_f64(dfm.DF(va_h, va_l))).T.reshape(4, d, s)
    vals, vecs = qnd.nd_eigh_fused(torch.as_tensor(ms), inds)
    return ms, mis, inds, j_vals, vals, vecs


def test_k2_plain_vs_jax_body_eigenvalues(k2_case):
    """Sorted eigenvalues: both are the eigenvalues of the same K_m, the
    JAX body's to its double-f32 precision (~2^-45 relative)."""
    _, _, _, j_vals, vals, _ = k2_case
    np.testing.assert_allclose(np.sort(vals.numpy(), -1), np.sort(j_vals, -1), atol=1e-12)


def test_k2_plain_residual_and_orthonormality(k2_case):
    ms, _, inds, _, vals, vecs = k2_case
    s = inds.shape[1]
    K = _f64_K(ms, inds)
    resid = K @ vecs - vecs * vals[..., None, :]
    orth = vecs.mT @ vecs - torch.eye(s, dtype=torch.float64)
    assert resid.abs().max().item() < 1e-12
    assert orth.abs().max().item() < 1e-13


def test_k2_plain_moment_reproduction(k2_case):
    """The "fused" quadrature (K2's plain version on the CPU) reproduces
    every moment up to order 2N-1, as JAX's "pallas" branch does in
    ``tests/test_pallas_nd.py``."""
    ms, mis, inds, _, _, _ = k2_case
    w, x = moment_quadrature_nd(torch.as_tensor(ms), inds, eigh_impl="fused")
    assert _reproduction_gap(ms, mis, w, x) < 5e-12


@pytest.fixture(scope="module")
def k3_case():
    """K3's JAX body at N=5 (s=15) and the plain version on the same inputs."""
    N, d, B = 5, 2, 4
    ms, mis, inds = _moments(N, d, B, seed=0)
    s, z = inds.shape[1], ms.shape[-1]
    ms_df = dfm.from_f64(jnp.asarray(ms).T)
    key = tuple(int(v) for v in np.asarray(inds, np.int64).reshape(-1))
    oh = jnp.asarray(j_pqnd._nd_onehots(key, d, s, z).reshape(-1, z))
    outs = [j_pqnd._ArrayRef(shape=(d * s * s, B)) for _ in range(2)]
    j_pqnd._nd_k_kernel(d, s, j_pqnd._ArrayRef(oh),
                        j_pqnd._ArrayRef(ms_df.hi.astype(jnp.float32)),
                        j_pqnd._ArrayRef(ms_df.lo.astype(jnp.float32)), *outs)
    Kj = np.asarray(dfm.to_f64(dfm.DF(outs[0].value, outs[1].value))).T.reshape(B, d, s, s)
    return ms, mis, inds, 0.5 * (Kj + np.swapaxes(Kj, -1, -2))


def test_k3_plain_vs_jax_body(k3_case):
    """K atol 1e-10, the JAX K-builder test's bound against the f64 path."""
    ms, _, inds, Kj = k3_case
    K = qnd.nd_k_fused(torch.as_tensor(ms), inds)
    np.testing.assert_allclose(K.numpy(), Kj, atol=1e-10)
    np.testing.assert_allclose(K.numpy(), _f64_K(ms, inds).numpy(), atol=1e-10)


def test_k3_route_moment_reproduction(k3_case):
    """"fused" at s=15 runs the K-builder (plain) + f64 eigh: its weights reproduce
    the moments as a measure, like JAX's f64 "refined" route (the JAX
    route's own gap, measured on the same inputs, bounds the port's up to
    a factor 10)."""
    ms, mis, inds, _ = k3_case
    w, x = moment_quadrature_nd(torch.as_tensor(ms), inds, eigh_impl="fused")
    jw, jx = jax.jit(lambda m: j_moment_quadrature_nd(m, inds, eigh_impl="refined"))(
        jnp.asarray(ms))
    gap = _reproduction_gap(ms, mis, w, x)
    j_gap = _reproduction_gap(ms, mis, torch.as_tensor(np.array(jw)),
                              torch.as_tensor(np.array(jx)))
    assert gap < max(10 * j_gap, 5e-11)


@pytest.mark.parametrize("N, d", [(3, 2), (5, 2), (3, 3)])
def test_fused_vs_jax_refined_as_measure(N, d):
    """Port "fused" vs JAX "refined" (f64).  Grid nodes that share a
    repeated eigenvalue coincide, and the two eigensolvers split the
    weight among them differently, so the rules are compared as measures:
    the integrals of smooth test functions agree (1e-12), both reproduce
    every moment up to order 2N-1 (5e-12), and the sorted node sets agree
    (1e-10)."""
    ms, mis, inds = _moments(N, d, 3, seed=10 * N + d)
    mean = np.random.RandomState(1).randn(3, d)
    w, x = moment_quadrature_nd(torch.as_tensor(ms), inds, torch.as_tensor(mean),
                                eigh_impl="fused")
    jw, jx = jax.jit(lambda m, mu: j_moment_quadrature_nd(m, inds, mu, eigh_impl="refined"))(
        jnp.asarray(ms), jnp.asarray(mean))
    jw, jx = torch.as_tensor(np.array(jw)), torch.as_tensor(np.array(jx))
    tests = (lambda u: torch.exp(0.3 * u[..., 0] - 0.2 * u[..., -1]),
             lambda u: torch.cos(u.sum(-1)),
             lambda u: 1.0 / (1.0 + u[..., 0] ** 2))
    for f in tests:
        np.testing.assert_allclose((w * f(x)).sum(-1).numpy(), (jw * f(jx)).sum(-1).numpy(),
                                   atol=1e-12)
    assert _reproduction_gap(ms, mis, w, x - torch.as_tensor(mean)[:, None, :]) < 5e-12
    np.testing.assert_allclose(torch.sort(x.flatten(1), -1)[0].numpy(),
                               torch.sort(jx.flatten(1), -1)[0].numpy(), atol=1e-10)


@pytest.mark.parametrize("N, impl", [(3, "fused"), (5, "fused"), (3, "refined"), (5, "xla")])
def test_ragged_batch_shape(N, impl):
    """A (3, 5) batch of 15 trials equals the trials one by one."""
    ms, mis, inds = _moments(N, 2, 15, seed=3)
    t = torch.as_tensor(ms).reshape(3, 5, -1)
    w, x = moment_quadrature_nd(t, inds, eigh_impl=impl)
    s = inds.shape[1]
    assert w.shape == (3, 5, s * s) and x.shape == (3, 5, s * s, 2)
    w1, x1 = moment_quadrature_nd(t[1, 2], inds, eigh_impl=impl)
    np.testing.assert_allclose(torch.sort(x[1, 2].flatten())[0].numpy(),
                               torch.sort(x1.flatten())[0].numpy(), atol=1e-12)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-12)


def test_non_finite_trial_stays_nan():
    """A diverged trial comes out NaN from both plain versions, and the
    others are untouched."""
    for N in (3, 5):
        ms, _, inds = _moments(N, 2, 3, seed=4)
        t = torch.as_tensor(ms)
        t[1, 4] = float("nan")
        K = qnd.nd_k_fused(t, inds)
        assert bool(torch.isnan(K[1]).any()) and bool(torch.isfinite(K[[0, 2]]).all())
        w, x = moment_quadrature_nd(t, inds, eigh_impl="fused")
        assert bool(torch.isnan(w[1]).all()) and bool(torch.isfinite(w[[0, 2]]).all())
    vals, vecs = qnd.nd_eigh_fused(t[:, :21], multi_indices.gram_and_hankel_indices_graded_lexico(3, 2))
    assert bool(torch.isnan(vals[1]).all() and torch.isnan(vecs[1]).all())


def test_wrappers_refuse_what_they_do_not_take():
    ms, _, inds = _moments(3, 2, 2, seed=5)
    t = torch.as_tensor(ms)
    with pytest.raises(NotImplementedError):
        qnd.nd_eigh_fused(t.clone().requires_grad_(True), inds)
    with pytest.raises(NotImplementedError):
        qnd.nd_k_fused(t.clone().requires_grad_(True), inds)
    with pytest.raises(TypeError):
        qnd.nd_k_fused(t.float(), inds)
    with pytest.raises(ValueError):  # s = 15 > K2's 10
        qnd.nd_eigh_fused(torch.zeros(2, 45, dtype=torch.float64),
                          multi_indices.gram_and_hankel_indices_graded_lexico(5, 2))
    with pytest.raises(ValueError):
        qnd.nd_k_fused(t[:, :10], inds)


@pytest.mark.parametrize("n", [3, 6, 10])
def test_auto_routing_on_cpu_and_jacobi_schedule(n):
    """"auto" sends CPU tensors to "refined"; K2's round-robin schedule
    is the JAX package's."""
    assert resolve_impl_nd(n, 2, "auto", 2, device=torch.device("cpu")) == "refined"
    assert resolve_impl_nd(n, 2, "fused", 2, device=torch.device("cpu")) == "fused"
    want = tuple((tuple(int(v) for v in p), tuple(int(v) for v in q))
                 for p, q in j_round_robin_schedule(n))
    assert qnd.round_robin_schedule(n) == want


def test_nd_cartesian_prod():
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    got = nd_cartesian_prod(x)
    assert got.shape == (9, 2)
    np.testing.assert_array_equal(got.numpy()[:, 0], np.repeat([0.0, 1.0, 2.0], 3))
    np.testing.assert_array_equal(nd_cartesian_prod_indices(2, 3)[4], [1, 1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_nd_cartesian_prod(jnp.asarray(x.numpy()))))
