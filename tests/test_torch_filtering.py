"""The slice as a whole: the port's 1D moment filters vs JAX, and the
port's divergence rescue vs JAX's, on the same numpy inputs.

The port runs each filter through ``"fused"`` (on the CPU: K1's plain
version) and through ``"xla"`` (f64 LAPACK); the reference is JAX's
``stable=True, eigh_impl="xla"`` f64 path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mfs_tpu.models import benes_bernoulli as j_benes  # noqa: E402
from mfs_tpu.one_dim import filtering as j_filtering  # noqa: E402
from mfs_tpu.parallel.ensemble import rescue_diverged as j_rescue_diverged  # noqa: E402
from mfs_tpu.sde import sde_cond_moments_tme_normal as j_tme_normal  # noqa: E402
from mfs_tpu_torch.interop import filter_inputs_from_numpy, to_numpy  # noqa: E402
from mfs_tpu_torch.models.one_dim import benes_bernoulli  # noqa: E402
from mfs_tpu_torch.one_dim import filtering  # noqa: E402
from mfs_tpu_torch.parallel.ensemble import rescue_diverged  # noqa: E402
from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme_normal  # noqa: E402

_JAX_CACHE = {}


def _setup(N, B, T):
    rng = np.random.RandomState(N)
    ys = rng.binomial(1, 0.5, (T, B)).astype(np.float64)
    jm = j_benes(N=N)
    jt = j_tme_normal(jm.drift, jm.dispersion, jm.dt, 2, N)
    tm = benes_bernoulli(N=N, device="cpu")
    tt = sde_cond_moments_tme_normal(tm.drift, tm.dispersion, tm.dt, 2, N)
    return ys, jm, jt, tm, tt


def _jax_outputs(mode, N, B, T):
    key = (mode, N, B, T)
    if key not in _JAX_CACHE:
        ys, jm, jt, _, _ = _setup(N, B, T)
        ic = jm.init_cond
        common = dict(stable=True, eigh_impl="xla")
        y = jnp.asarray(ys)
        if mode == "cms":
            out = j_filtering.moment_filter_cms(
                jt.cms, jt.mean, jm.measurement_cond_pdf,
                jnp.broadcast_to(ic.cms, (B, 2 * N)), ic.mean, y, **common)
        elif mode == "rms":
            out = j_filtering.moment_filter_rms(
                jt.rms, jm.measurement_cond_pdf,
                jnp.broadcast_to(ic.rms, (B, 2 * N)), y, **common)
        else:
            out = j_filtering.moment_filter_scms(
                jt.scms, jt.mean_var, jm.measurement_cond_pdf,
                jnp.broadcast_to(ic.scms, (B, 2 * N)), ic.mean,
                jnp.sqrt(ic.variance), y, **common)
        _JAX_CACHE[key] = tuple(np.asarray(o) for o in out)
    return _JAX_CACHE[key]


def _port_outputs(mode, N, B, T, impl):
    ys, jm, _, tm, tt = _setup(N, B, T)
    ic = jm.init_cond
    cms0, mean0, y = filter_inputs_from_numpy(
        np.broadcast_to(np.asarray(ic.cms), (B, 2 * N)),
        np.full(B, float(ic.mean)), ys, device="cpu")
    tic = tm.init_cond
    common = dict(stable=True, eigh_impl=impl)
    if mode == "cms":
        out = filtering.moment_filter_cms(
            tt.cms, tt.mean, tm.measurement_cond_pdf, cms0, mean0, y, **common)
    elif mode == "rms":
        out = filtering.moment_filter_rms(
            tt.rms, tm.measurement_cond_pdf, tic.rms.expand(B, 2 * N), y, **common)
    else:
        out = filtering.moment_filter_scms(
            tt.scms, tt.mean_var, tm.measurement_cond_pdf, tic.scms.expand(B, 2 * N),
            tic.mean, torch.sqrt(tic.variance), y, **common)
    return to_numpy(out)


@pytest.mark.parametrize("impl", ["fused", "xla"])
@pytest.mark.parametrize("mode", ["cms", "rms", "scms"])
def test_filters_N4_vs_jax(mode, impl):
    """Beneš N=4, B=8, T=20.  Bound: nell rtol 1e-8, the JAX kernel
    path's own end-to-end bound (``tests/test_pallas_compiled.py``);
    measured 8e-16."""
    N, B, T = 4, 8, 20
    got = _port_outputs(mode, N, B, T, impl)
    want = _jax_outputs(mode, N, B, T)
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-8)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("impl", ["fused", "xla"])
@pytest.mark.parametrize("mode", ["cms", "rms", "scms"])
def test_filters_N15_vs_jax(mode, impl):
    """Beneš N=15 (the production width), B=4, T=5.  Bound: nell rtol
    1e-6; measured gap 3.8e-16 to 7.7e-16 (all three modes, both routes)."""
    N, B, T = 15, 4, 5
    got = _port_outputs(mode, N, B, T, impl)
    want = _jax_outputs(mode, N, B, T)
    assert np.isfinite(got[-1]).all()
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-6)


def _synthetic_runners(lib, nan_fast, nan_robust):
    """A per-trial runner whose output is NaN exactly on the trials whose
    ``ys`` column id lies in ``bad`` (a pure function of the inputs)."""
    def make(bad):
        def run(ys):
            ids = ys[0]
            val = ys.sum(0) * 1.5
            if lib is torch:
                is_bad = torch.isin(ids, torch.as_tensor(sorted(bad), dtype=ids.dtype))
                return {"nell": torch.where(is_bad, float("nan"), val), "traj": ys * 2.0}
            is_bad = jnp.isin(ids, jnp.asarray(sorted(bad), dtype=ids.dtype))
            return {"nell": jnp.where(is_bad, jnp.nan, val), "traj": ys * 2.0}
        return run
    return make(nan_fast), [make(b) for b in nan_robust]


@pytest.mark.parametrize("bucket", [None, 2])
def test_rescue_diverged_vs_jax(bucket):
    """Multi-tier rescue on synthetic runners: the port's merged outputs,
    mask and count equal JAX's exactly."""
    B, T = 10, 3
    ys = np.arange(T * B, dtype=np.float64).reshape(T, B) % 7
    ys[0] = np.arange(B)
    nan_fast = {1, 4, 5, 8}
    nan_robust = [{4, 5}, {5}]  # tier 1 rescues 1 and 8, tier 2 rescues 4; 5 stays lost
    axes = {"nell": 0, "traj": 1}

    jf, jr = _synthetic_runners(jnp, nan_fast, nan_robust)
    j_merged, j_finite, j_rescued = j_rescue_diverged(
        jf, jr, jnp.asarray(ys), lambda o: jnp.isfinite(o["nell"]), axes)
    tf, tr = _synthetic_runners(torch, nan_fast, nan_robust)
    merged, finite, rescued = rescue_diverged(
        tf, tr, torch.as_tensor(ys), lambda o: torch.isfinite(o["nell"]), axes,
        bucket=bucket)

    assert rescued == j_rescued == 3
    np.testing.assert_array_equal(finite, np.asarray(j_finite))
    assert finite.tolist() == [i != 5 for i in range(B)]
    for key in axes:
        np.testing.assert_array_equal(to_numpy(merged[key]), np.asarray(j_merged[key]))
