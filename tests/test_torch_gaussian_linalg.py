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


def test_eigh_refined_takes_polish_sweeps_as_jax_does():
    """``eigh_refined(a, polish_sweeps=0, sort=False)``: the JAX signature,
    so a positional second argument is ``polish_sweeps`` and not ``sort``;
    with native f64 it is ignored.  Eigenvalues agree with JAX's polished
    f64 ones to 1e-12, eigenvectors up to sign."""
    import inspect

    from mfs_tpu.ops.eigh import eigh_refined as j_eigh_refined
    from mfs_tpu_torch.ops.eigh import eigh_refined

    params = lambda f: [(p.name, p.default) for p in inspect.signature(f).parameters.values()]
    assert params(eigh_refined) == params(j_eigh_refined)
    a = np.random.RandomState(5).randn(3, 6, 6)
    a = a + np.swapaxes(a, -1, -2)
    jv, jV = j_eigh_refined(jnp.asarray(a), 2, True)
    for vals, vecs in (eigh_refined(_t(a), 2), eigh_refined(_t(a), polish_sweeps=2, sort=True)):
        np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=1e-12)
        overlap = np.abs(np.swapaxes(vecs.numpy(), -1, -2) @ np.asarray(jV))
        np.testing.assert_allclose(overlap, np.broadcast_to(np.eye(6), overlap.shape), atol=1e-10)


# Each subpackage's re-exports: the names the JAX subpackage exports that
# the port has (``parallel`` re-exports the port's ``rescue_diverged``).
_EXPORTS = {
    "sde": ["generator", "generator_1d", "expectation", "expectation_1d", "mean_and_cov",
            "mean_and_var_1d", "sde_cond_moments_tme", "sde_cond_moments_tme_normal",
            "sde_cond_moments_euler"],
    "models": ["benes_bernoulli", "well_poisson", "lotka_volterra_3d", "prey_predator",
               "satellite_orbital_stability"],
    "ops": ["eigh_batched", "eigh_xla", "eigh_refined"],
    "one_dim": ["hankel_indices", "moment_quadrature", "gauss_quadrature_golub_welsch",
                "taylor_quadrature", "make_derivatives", "raw_to_central", "central_to_raw",
                "raw_to_scaled", "scaled_to_central", "sms_to_cumulants", "characteristic_fn",
                "characteristic_from_pdf", "moment_filter_rms", "moment_filter_cms",
                "moment_filter_scms", "moment_filter_taylor", "gram_charlier", "edgeworth",
                "legendre_poly_expansion", "truncated_cumulant_generating_function",
                "saddle_point", "inverse_fourier"],
    "utils": ["gamma", "factorial", "binom", "vmap_list_of_funcs", "partial_bell",
              "complete_bell", "hermite_probabilist", "hermite_probabilist_all", "pascal_lower",
              "normal_raw_moments_all", "raw_moment_of_normal", "raw_moment_of_standard_normal",
              "central_moment_of_normal", "GaussianSum1D", "GaussianSumND", "ldl", "ldl_chol",
              "lanczos", "lanczos_ritz", "simulate_sde", "simulate_sde_ensemble",
              "discretise_lti_sde", "posterior_cramer_rao", "timed", "trace"],
    "filters": ["SigmaPoints", "rk4_m_cov", "rk4_m_cov_backward", "gaussian_expectation", "kf",
                "rts", "ekf", "eks", "cd_ekf", "cd_eks", "sgp_filter", "sgp_smoother",
                "cd_sgp_filter", "cd_sgp_smoother", "bootstrap_filter", "particle_filter",
                "systematic", "stratified", "multinomial", "continuous_resampling",
                "brute_force_filter"],
    "parallel": ["trial_mesh", "shard_trials", "replicate", "run_ensemble_filter",
                 "sharded_nell_grad", "rescue_diverged"],
    "estimation": ["fit_mle_scipy", "fit_mle_optax", "fit_mle_batched", "lbfgs_batched"],
    "multi_dims": ["sizeof_multi_indices", "graded_lexico_indexof_multi_index",
                   "generate_graded_lexico_multi_indices", "find_indices",
                   "gram_and_hankel_indices_graded_lexico", "raw_moments_mvn_kan",
                   "central_moments_mvn_kan", "raw_moments_mvn_kan_all", "raw_moments_mvn_mgf",
                   "moments_nd_uniform", "extract_moments", "extract_mean", "extract_cov",
                   "marginalise_moments", "monomials_nd", "sde_cond_moments_nd_tme",
                   "sde_cond_moments_nd_tme_normal", "sde_cond_moments_nd_euler_maruyama",
                   "poly_tme_nd", "moment_quadrature_nd", "moment_filter_nd_rms",
                   "moment_filter_nd_cms", "moment_filter_nd_scms"],
}


@pytest.fixture(scope="module")
def fresh_imports():
    """Per subpackage, (returncode, stderr) of importing its re-exported
    names as the first import of a fresh interpreter; they all run at once."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {sub: subprocess.Popen(
        [sys.executable, "-c", f"from mfs_tpu_torch.{sub} import {', '.join(names)}"],
        cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for sub, names in _EXPORTS.items()}
    out = {}
    for sub, p in procs.items():
        err = p.communicate(timeout=120)[1]
        out[sub] = (p.returncode, err)
    return out


@pytest.mark.parametrize("sub", sorted(_EXPORTS))
def test_subpackage_reexports(sub, fresh_imports):
    """Each name imports from the subpackage as the first import of a
    fresh interpreter (so an import cycle would show), and, but for
    ``parallel.rescue_diverged``, is a name the JAX subpackage exports
    too."""
    import importlib

    rc, err = fresh_imports[sub]
    assert rc == 0, err
    jax_pkg = importlib.import_module(f"mfs_tpu.{sub}")
    assert all(hasattr(jax_pkg, n) for n in _EXPORTS[sub] if n != "rescue_diverged")
