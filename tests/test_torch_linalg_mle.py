"""Port vs JAX: Lanczos, ``fit_mle_batched``, the MGF moment oracle and
the type aliases, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mfs_tpu.estimation import fit_mle_batched as j_fit_mle_batched  # noqa: E402
from mfs_tpu.multi_dims import raw_moments_mvn_mgf as j_mgf  # noqa: E402
from mfs_tpu.utils import lanczos as j_lanczos  # noqa: E402
from mfs_tpu.utils import lanczos_ritz as j_lanczos_ritz  # noqa: E402
from mfs_tpu_torch.estimation import fit_mle_batched  # noqa: E402
from mfs_tpu_torch.multi_dims import raw_moments_mvn_kan, raw_moments_mvn_mgf  # noqa: E402
from mfs_tpu_torch.utils import lanczos, lanczos_ritz  # noqa: E402


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _symmetric(n=7, seed=2):
    a = np.random.RandomState(seed).randn(n, n)
    return a + a.T


@pytest.mark.parametrize("m", [7, 4])
def test_lanczos_matches_jax(m):
    """``tests/test_utils.py``'s matrix (7 x 7, v0 = e_0): V orthonormal
    to 1e-8 and V^T A V = T to 1e-7 (JAX's own bounds; no
    re-orthogonalisation), and V, alphas, betas equal to JAX's to 1e-12
    (the same recurrence in the same order; the last of 7 steps amplifies
    rounding the most)."""
    a = _symmetric()
    v0 = np.zeros(7)
    v0[0] = 1.0
    V, alphas, betas = (x.numpy() for x in lanczos(_t(a), _t(v0), m))
    assert V.shape == (7, m) and alphas.shape == (m,) and betas.shape == (m - 1,)
    np.testing.assert_allclose(V.T @ V, np.eye(m), atol=1e-8)
    T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    np.testing.assert_allclose(V.T @ a @ V, T, atol=1e-7)
    jV, ja, jb = (np.asarray(x) for x in j_lanczos(jnp.asarray(a), jnp.asarray(v0), m))
    np.testing.assert_allclose(V, jV, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(alphas, ja, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(betas, jb, rtol=1e-12, atol=1e-12)


def test_lanczos_ritz_matches_jax():
    """Ritz pairs from an unnormalised start: at m = n the Ritz values
    are the eigenvalues (1e-7, JAX's bound); values and vectors equal
    JAX's to 1e-10 at m = 7 and m = 4 (the vector formula
    ``V U diag(U[0] |v0|)`` carries each eigenvector's sign twice, so it
    does not depend on the eigensolver's choice of signs)."""
    a = _symmetric()
    v0 = np.random.RandomState(3).randn(7)
    for m in (7, 4):
        vecs, vals = (x.numpy() for x in lanczos_ritz(_t(a), _t(v0), m))
        j_vecs, j_vals = (np.asarray(x) for x in j_lanczos_ritz(jnp.asarray(a),
                                                                jnp.asarray(v0), m))
        np.testing.assert_allclose(vals, j_vals, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(vecs, j_vecs, rtol=1e-10, atol=1e-10)
        if m == 7:
            np.testing.assert_allclose(vals, np.linalg.eigvalsh(a), atol=1e-7)


def test_fit_mle_batched_matches_jax():
    """Per-trial Gaussian MLE (mean, log sd) of 6 trials of 30 numpy
    draws each, solved to gtol 1e-10 by the port's per-trial L-BFGS and
    by JAX's vmapped optax L-BFGS: the converged parameters agree to
    1e-6 and with the closed form; every trial converges in both; the
    port raises for an optimiser other than its own."""
    rng = np.random.RandomState(4)
    data = rng.randn(6, 30) * np.linspace(0.5, 2.0, 6)[:, None] + np.linspace(-1, 1, 6)[:, None]

    def nell(q, y, lib):
        return lib.sum(0.5 * ((y - q[0]) / lib.exp(q[1])) ** 2 + q[1])

    P, info = fit_mle_batched(lambda q, y: nell(q, y, torch), torch.zeros(6, 2,
                                                                          dtype=torch.float64),
                              _t(data), max_steps=100, gtol=1e-10)
    jP, jinfo = j_fit_mle_batched(lambda q, y: nell(q, y, jnp), jnp.zeros((6, 2)),
                                  jnp.asarray(data), max_steps=100, gtol=1e-10)
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), atol=1e-6)
    closed = np.stack([data.mean(1), np.log(data.std(1))], axis=1)
    np.testing.assert_allclose(P.numpy(), closed, atol=1e-6)
    np.testing.assert_array_equal(info["converged"].numpy(), np.asarray(jinfo["converged"]))
    assert bool(info["converged"].all())
    assert set(info) == set(jinfo) == {"converged", "steps", "nell", "segments_run"}
    np.testing.assert_allclose(info["nell"].numpy(), np.asarray(jinfo["nell"]), rtol=1e-12)
    with pytest.raises(TypeError, match="optimiser=None"):
        fit_mle_batched(lambda q, y: nell(q, y, torch), torch.zeros(6, 2, dtype=torch.float64),
                        _t(data), optimiser="adam")


def test_raw_moments_mvn_mgf_matches_jax():
    """E[X^kappa] of a 2D and a 3D Gaussian by nested ``torch.func.grad``
    of the MGF, against JAX's nested ``jax.grad`` (rtol 1e-12) and the
    port's Kan formula (orders up to 4: JAX's eager nested gradients
    grow fast with the order)."""
    for mean, cov, kappas in (
            ([0.3, -0.2], [[1.0, 0.3], [0.3, 0.5]], [(0, 0), (1, 0), (2, 1), (0, 4)]),
            ([0.1, 0.4, -0.5], [[0.8, 0.1, 0.0], [0.1, 0.6, -0.2], [0.0, -0.2, 1.1]],
             [(1, 1, 1)])):
        for kappa in kappas:
            got = raw_moments_mvn_mgf(_t(mean), _t(cov), kappa).item()
            want = float(j_mgf(jnp.asarray(mean), jnp.asarray(cov), kappa))
            np.testing.assert_allclose(got, want, rtol=1e-12)
            np.testing.assert_allclose(
                got, raw_moments_mvn_kan(_t(mean), _t(cov), kappa).item(), rtol=1e-12, atol=1e-15)


def test_type_aliases():
    from mfs_tpu_torch import typings

    assert typings.ArrayLike.__args__ == (torch.Tensor, float, int)
    assert typings.IntScalar.__args__ == (int, torch.Tensor)
