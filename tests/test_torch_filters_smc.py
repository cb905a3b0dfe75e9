"""The port's resamplers and particle filters (``mfs_tpu_torch.filters``)
against the JAX package's.

Torch's and JAX's random streams differ, so the parity tests feed both
packages the same uniforms and a deterministic sampler: indices, particle
trajectories and nell must then agree to rtol 1e-12.  The port's own
streams are checked by the bootstrap PF tracking the Kalman filter at the
tolerances of ``tests/test_classical_filters.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mfs_tpu.filters import resampling as jr  # noqa: E402
from mfs_tpu.filters import smc as jsmc  # noqa: E402
from mfs_tpu_torch.filters import resampling as tr  # noqa: E402
from mfs_tpu_torch.filters import smc as tsmc  # noqa: E402
from mfs_tpu_torch.filters.gaussian import kf  # noqa: E402
from mfs_tpu_torch.utils.gaussian import discretise_lti_sde  # noqa: E402

RTOL = 1e-12
XI = 0.25


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _weights(rng, B, n):
    w = rng.rand(B, n) ** 3
    return w / w.sum(-1, keepdims=True)


def test_inverse_cdf_matches_jax():
    """The three resamplers' uniform constructions through both lookups;
    the last trial's cumsum ends just below 1, so its last uniforms fall
    past the end and are clipped to n - 1."""
    rng = np.random.RandomState(0)
    B, n = 5, 64
    w = _weights(rng, B, n)
    w[-1] *= 1 - 1e-9
    grid = np.arange(n)
    es = -np.log(rng.rand(B, n + 1))
    z = np.cumsum(es, -1)
    for us in ((grid + rng.rand(B, 1)) / n, (grid + rng.rand(B, n)) / n, z[:, :-1] / z[:, -1:],
               np.full((B, 3), 1 - 1e-12)):
        got = tr._inverse_cdf(_t(w), _t(us)).numpy()
        ref = np.asarray(jr._inverse_cdf(jnp.asarray(w), jnp.asarray(us)))
        np.testing.assert_array_equal(got, ref)
    assert got[-1].tolist() == [n - 1] * 3


def test_continuous_resampling_matches_jax(monkeypatch):
    """JAX's uniforms for its key, fed to the port in place of its draw:
    the resampled particles and their gradients in samples and weights."""
    rng = np.random.RandomState(1)
    B, n, m = 3, 40, 50
    samples, w = rng.randn(B, n), _weights(rng, B, n)
    key = jax.random.PRNGKey(2)
    us = np.asarray(jax.random.uniform(key, (B, m), jnp.float64))
    monkeypatch.setattr(tr, "_uniform", lambda shape, like, g: _t(us))
    cot = rng.randn(B, m)

    j_fn = lambda s, ww: jnp.sum(jr.continuous_resampling(s, ww, m, key) * cot)
    j_out = np.asarray(jr.continuous_resampling(jnp.asarray(samples), jnp.asarray(w), m, key))
    j_gs, j_gw = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(samples), jnp.asarray(w))

    s_t, w_t = _t(samples).requires_grad_(True), _t(w).requires_grad_(True)
    out = tr.continuous_resampling(s_t, w_t, m, torch.Generator())
    g_s, g_w = torch.autograd.grad((out * _t(cot)).sum(), (s_t, w_t))
    np.testing.assert_allclose(out.detach().numpy(), j_out, rtol=RTOL)
    np.testing.assert_allclose(g_s.numpy(), np.asarray(j_gs), rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(g_w.numpy(), np.asarray(j_gw), rtol=RTOL, atol=1e-15)


def _deterministic_problem(vector_state):
    """Callbacks that ignore their key/generator, for either package:
    a polynomial transition, fixed stratified uniforms, fixed initial
    particles.  With ``vector_state`` each particle carries its initial
    index in a second component, which the transition keeps."""
    rng = np.random.RandomState(3)
    T, B, n = 25, 3, 200
    ys = 0.3 * rng.randn(T, B)
    x0 = rng.randn(B, n)
    if vector_state:
        x0 = np.stack([x0, np.broadcast_to(np.arange(n, dtype=np.float64), (B, n))], -1)
        ys = ys[..., None]
    us = (np.arange(n) + rng.rand(B, n)) / n

    def make(xp, inverse_cdf, asarray):
        def move(x, y=0.0):
            u = x[..., 0] if vector_state else x
            u = 0.95 * u + 0.1 - 0.02 * u**3 + 0.5 * y
            return xp.stack([u, x[..., 1]], -1) if vector_state else u

        def meas_pdf(y, x):
            u = x[..., 0] if vector_state else x
            y = y[..., 0] if vector_state else y
            return xp.exp(-0.5 * (y - u) ** 2 / XI) / math.sqrt(2 * math.pi * XI)

        def resample(w, key):
            return inverse_cdf(w, asarray(us))

        return move, meas_pdf, resample, (lambda key, k: asarray(x0))

    return ys, make


@pytest.mark.parametrize("kind", ["bootstrap", "bootstrap_vector_state", "particle"])
def test_smc_matches_jax_on_the_same_draws(kind):
    vector_state = kind == "bootstrap_vector_state"
    ys, make = _deterministic_problem(vector_state)
    j_move, j_pdf, j_res, j_init = make(jnp, jr._inverse_cdf, jnp.asarray)
    t_move, t_pdf, t_res, t_init = make(torch, tr._inverse_cdf, _t)
    if kind == "particle":
        dens = lambda xp: (lambda s, a, y=None: xp.exp(-0.5 * s**2) * (1.0 + 0.1 * a**2))
        ref = jsmc.particle_filter(
            lambda a, y, k: j_move(a, y), dens(jnp), lambda s, a: dens(jnp)(s, a),
            j_pdf, jnp.asarray(ys), j_init, jax.random.PRNGKey(0), 200, j_res)
        got = tsmc.particle_filter(
            lambda a, y, g: t_move(a, y), dens(torch), lambda s, a: dens(torch)(s, a),
            t_pdf, _t(ys), t_init, torch.Generator(), 200, t_res)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
        return
    ref, ref_nell = jsmc.bootstrap_filter(
        lambda s, k: j_move(s), j_pdf, jnp.asarray(ys), j_init, jax.random.PRNGKey(0), 200,
        j_res, vector_state=vector_state)
    got, nell = tsmc.bootstrap_filter(
        lambda s, g: t_move(s), t_pdf, _t(ys), t_init, torch.Generator(), 200, t_res,
        vector_state=vector_state)
    assert got.shape == ref.shape and nell.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    np.testing.assert_allclose(nell.numpy(), np.asarray(ref_nell), rtol=RTOL)
    if vector_state:  # the same ancestors, index for index
        np.testing.assert_array_equal(got[..., 1].numpy(), np.asarray(ref)[..., 1])


def _ou_problem(B):
    """The OU model of tests/test_classical_filters.py: its measurements
    (T = 200) and the port's callbacks, B trials on the same data."""
    DT, Q_DIFF = 1e-2, 0.7
    rng = np.random.RandomState(3)
    F_s, q = math.exp(-DT), Q_DIFF**2 / 2 * (1 - math.exp(-2 * DT))
    xs = [0.2]
    for _ in range(200):
        xs.append(F_s * xs[-1] + math.sqrt(q) * rng.randn())
    ys = np.asarray(xs[1:]) + math.sqrt(XI) * rng.randn(200)
    F, Q = discretise_lti_sde(_t([[-1.0]]), _t([[Q_DIFF]]), DT)
    f, chol_q = float(F[0, 0]), float(torch.sqrt(Q[0, 0]))

    def transition_sampler(samples, g):
        return f * samples + chol_q * torch.randn(samples.shape, generator=g, dtype=samples.dtype)

    def meas_pdf(y, x):
        return torch.exp(-0.5 * (y - x) ** 2 / XI) / math.sqrt(2 * math.pi * XI)

    def init_sampler(g, n):
        return 0.2 + math.sqrt(0.8) * torch.randn((B, n), generator=g, dtype=torch.float64)

    kalman = kf(F, Q, torch.eye(1, dtype=torch.float64), XI * torch.eye(1, dtype=torch.float64),
                _t([0.2]), _t([[0.8]]), _t(ys)[:, None])
    return _t(ys)[:, None].expand(200, B), transition_sampler, meas_pdf, init_sampler, kalman


def test_bootstrap_pf_tracks_kf():
    """The port's own streams, each resampler, two trials a call: the
    means within 0.2 of the KF's and nell within 5%, as the JAX package's
    test holds its PF; the trials' resampling noise differs."""
    ys, transition_sampler, meas_pdf, init_sampler, kalman = _ou_problem(2)
    for resampler in (tr.systematic, tr.stratified, tr.multinomial):
        samples, nell = tsmc.bootstrap_filter(
            transition_sampler, meas_pdf, ys, init_sampler, torch.Generator().manual_seed(0),
            5000, resampler, out_fn=lambda s: s.mean(-1))
        assert samples.shape == (200, 2)
        for b in range(2):
            np.testing.assert_allclose(samples[:, b].numpy(), kalman[0][:, 0].numpy(), atol=2e-1)
            np.testing.assert_allclose(nell[b].item(), kalman[2][-1].item(), rtol=5e-2)
        assert (samples[:, 0] - samples[:, 1]).abs().max().item() > 1e-4


def test_remat_chunk_keeps_results_and_gradients():
    """Checkpointed segments: the same outputs and the same gradient of
    nell through the continuous resampler; a chunk that does not divide T
    raises as in JAX."""
    ys, _, meas_pdf, _, _ = _ou_problem(2)
    ys = ys[:20]
    a = _t(0.9).requires_grad_(True)

    def run(chunk):
        sampler = lambda s, g: a * s + 0.1 * torch.randn(s.shape, generator=g, dtype=s.dtype)
        init = lambda g, n: torch.randn((2, n), generator=g, dtype=torch.float64)
        out, nell = tsmc.bootstrap_filter(
            sampler, meas_pdf, ys, init, torch.Generator().manual_seed(4), 300, tr.stratified,
            conti_resampling=True, remat_chunk=chunk, out_fn=lambda s: (s.mean(-1), s.var(-1)))
        (g,) = torch.autograd.grad(nell.sum(), a)
        return out, nell, g

    (m0, v0), nell0, g0 = run(0)
    (m1, v1), nell1, g1 = run(5)
    for x, y in ((m0, m1), (v0, v1), (nell0, nell1), (g0, g1)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=1e-12)
    assert m0.shape == (20, 2) and bool(torch.isfinite(g0))
    with pytest.raises(ValueError):
        run(3)
