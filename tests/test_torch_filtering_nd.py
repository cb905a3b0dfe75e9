"""The slice as a whole: the port's ND moment filters vs JAX on the
2D prey–predator model, on the same numpy inputs (B=8 trials of T=20
Bernoulli observations).

The port runs "fused" (on the CPU: K2's plain version at N=3, s=6; the
plain versions of the K-builder pair ``nd_ldl`` + ``nd_ksolve`` + f64
eigh at N=5, s=15 and N=8, s=36) and
"refined" (f64 library path).  The reference is JAX's f64
``eigh_impl="xla"`` path (``"refined"`` at N=8).  Bound:
nell rtol 1e-8, the JAX kernel path's own end-to-end bound
(``tests/test_pallas_compiled.py``); the rules agree far closer, but
the eigensolvers rotate repeated-eigenvalue clusters differently.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mfs_tpu.models.multi_dims import prey_predator as j_prey_predator  # noqa: E402
from mfs_tpu.multi_dims import filtering as j_filtering  # noqa: E402
from mfs_tpu.multi_dims.moments import monomials_nd as j_monomials_nd  # noqa: E402
from mfs_tpu.multi_dims.moments import sde_cond_moments_nd_tme as j_tme_nd  # noqa: E402
from mfs_tpu.multi_dims.multi_indices import (  # noqa: E402
    generate_graded_lexico_multi_indices as j_generate,
    gram_and_hankel_indices_graded_lexico as j_gram_inds,
)
from mfs_tpu.multi_dims.poly_tme import poly_tme_nd as j_poly_tme_nd  # noqa: E402
from mfs_tpu_torch.interop import nd_filter_inputs_from_numpy, to_numpy  # noqa: E402
from mfs_tpu_torch.models.multi_dims import prey_predator  # noqa: E402
from mfs_tpu_torch.multi_dims import filtering  # noqa: E402
from mfs_tpu_torch.multi_dims import quadrature as nd_quadrature  # noqa: E402
from mfs_tpu_torch.multi_dims.moments import sde_cond_moments_nd_tme  # noqa: E402
from mfs_tpu_torch.multi_dims.poly_tme import poly_tme_nd  # noqa: E402
from mfs_tpu_torch.ops import dispatch  # noqa: E402

B, T = 8, 20
RTOL = 1e-8


def _ys(T_, seed=0):
    return np.random.RandomState(seed).binomial(1, 0.5, (T_, B, 1)).astype(np.float64)


class _Setup:
    """Both packages' prey–predator model and polynomial TME at order N,
    built from the JAX package's own index tables."""

    def __init__(self, N):
        self.mis = j_generate(2, 2 * N - 1)
        self.inds = np.asarray(j_gram_inds(N, 2))
        self.jm = j_prey_predator(self.mis)
        self.jp = j_poly_tme_nd(self.jm.drift, self.jm.dispersion, self.jm.dt, 2, self.mis, 2, 1)
        self.tm = prey_predator(self.mis, device="cpu")
        self.tp = poly_tme_nd(self.tm.drift, self.tm.dispersion, self.tm.dt, 2, self.mis, 2, 1,
                              device="cpu")
        z = self.mis.shape[0]
        self.cms0 = np.broadcast_to(np.asarray(self.jm.init_cond.cms), (B, z)).copy()
        self.mean0 = np.broadcast_to(np.asarray(self.jm.init_cond.mean), (B, 2)).copy()


_SETUPS = {}


def _setup(N):
    if N not in _SETUPS:
        _SETUPS[N] = _Setup(N)
    return _SETUPS[N]


@pytest.mark.parametrize("N", [3, 5])
def test_prey_predator_cms_poly_nell(N):
    su = _setup(N)
    ys = _ys(T)
    jrun = jax.jit(lambda c, m, y: j_filtering.moment_filter_nd_cms(
        su.jp.cms, su.jp.mean, su.jm.measurement_cond_pdf, y, (su.mis, su.inds), c, m,
        eigh_impl="xla", predict_fn=su.jp.predict_cms))
    _, j_means, j_nell = jrun(su.cms0, su.mean0, ys)
    cms0, mean0, y = nd_filter_inputs_from_numpy(su.cms0, su.mean0, ys, device="cpu")
    for impl in ("fused", "refined"):
        cmss, means, nell = filtering.moment_filter_nd_cms(
            su.tp.cms, su.tp.mean, su.tm.measurement_cond_pdf, y, (su.mis, su.inds), cms0,
            mean0, eigh_impl=impl, predict_fn=su.tp.predict_cms)
        assert cmss.shape == (T, B, su.mis.shape[0]) and means.shape == (T, B, 2)
        np.testing.assert_allclose(to_numpy(nell), np.asarray(j_nell), rtol=RTOL, err_msg=impl)
        np.testing.assert_allclose(to_numpy(means), np.asarray(j_means), rtol=RTOL, err_msg=impl)


def test_prey_predator_scms_poly_nell():
    su = _setup(3)
    ys = _ys(T, seed=1)
    scale0 = np.sqrt(np.diag(np.asarray(su.jm.init_cond.cov)))
    scms0 = su.cms0 / np.asarray(j_monomials_nd(jnp.asarray(scale0), su.mis))
    s0 = np.broadcast_to(scale0, (B, 2)).copy()
    jrun = jax.jit(lambda a, m, s, y: j_filtering.moment_filter_nd_scms(
        su.jp.scms, su.jp.mean_var, su.jm.measurement_cond_pdf, y, (su.mis, su.inds), a, m, s,
        eigh_impl="xla", predict_fn=su.jp.predict_scms))
    *_, j_scales, j_nell = jrun(scms0, su.mean0, s0, ys)
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64))
    *_, scales, nell = filtering.moment_filter_nd_scms(
        su.tp.scms, su.tp.mean_var, su.tm.measurement_cond_pdf, t(ys), (su.mis, su.inds),
        t(scms0), t(su.mean0), t(s0), eigh_impl="fused", predict_fn=su.tp.predict_scms)
    np.testing.assert_allclose(nell.numpy(), np.asarray(j_nell), rtol=RTOL)
    np.testing.assert_allclose(scales.numpy(), np.asarray(j_scales), rtol=RTOL)


def test_prey_predator_rms_autodiff_tme_nell():
    """Raw moments with the autodiff (nested-JVP) TME at N=3, over T=3
    steps: the eager nested JVPs cost ~2 s a step on the CPU."""
    su = _setup(3)
    ys = _ys(3, seed=2)[:, :2]
    rms0 = np.asarray(su.jm.init_cond.rms)[None].repeat(2, 0)
    jt = j_tme_nd(su.jm.drift, su.jm.dispersion, su.jm.dt, 2, su.mis)
    _, j_nell = jax.jit(lambda r, y: j_filtering.moment_filter_nd_rms(
        jt.rms, su.jm.measurement_cond_pdf, y, (su.mis, su.inds), r, eigh_impl="xla"))(rms0, ys)
    tt = sde_cond_moments_nd_tme(su.tm.drift, su.tm.dispersion, su.tm.dt, 2, su.mis)
    rmss, nell = filtering.moment_filter_nd_rms(
        tt.rms, su.tm.measurement_cond_pdf, torch.as_tensor(ys), (su.mis, su.inds),
        torch.as_tensor(rms0), eigh_impl="fused")
    assert rmss.shape == (3, 2, su.mis.shape[0])
    np.testing.assert_allclose(nell.numpy(), np.asarray(j_nell), rtol=RTOL)


def test_cms_without_predict_fn_matches_fused_predict():
    """The per-node transition path (``PolyTME.cms``/``mean``) and the
    fused ``predict_cms`` give the same filter (rtol 1e-10)."""
    su = _setup(3)
    cms0, mean0, y = nd_filter_inputs_from_numpy(su.cms0, su.mean0, _ys(5, seed=3), device="cpu")
    args = (su.tp.cms, su.tp.mean, su.tm.measurement_cond_pdf, y, (su.mis, su.inds), cms0, mean0)
    *_, n_fused = filtering.moment_filter_nd_cms(*args, eigh_impl="fused",
                                                 predict_fn=su.tp.predict_cms)
    *_, n_node = filtering.moment_filter_nd_cms(*args, eigh_impl="fused")
    np.testing.assert_allclose(n_node.numpy(), n_fused.numpy(), rtol=1e-10)


def test_moment_vector_size_is_checked():
    su = _setup(3)
    with pytest.raises(ValueError):
        filtering.moment_filter_nd_cms(
            su.tp.cms, su.tp.mean, su.tm.measurement_cond_pdf, torch.zeros(2, B, 1),
            (su.mis, su.inds), torch.zeros(B, 10, dtype=torch.float64),
            torch.zeros(B, 2, dtype=torch.float64))


def _count_large_route(monkeypatch):
    """Count the quadrature's calls of the K-builder pair."""
    calls = []
    real = nd_quadrature.nd_k_fused
    monkeypatch.setattr(nd_quadrature, "nd_k_fused",
                        lambda ms, inds: calls.append(1) or real(ms, inds))
    return calls


def test_prey_predator_n8_large_pair_nell(monkeypatch):
    """N=8 (s=36, z=136, 1,296 nodes), the lowest 2D order past the TPU's
    one-program K3, which the JAX package takes to its staged builder: the
    port's "fused" route runs the pair's plain versions + f64 eigh with
    nothing patched, 2 trials over 5 steps, against JAX's f64 "refined"
    filter: nell and the filtering means rtol 1e-8."""
    N, T_, b = 8, 5, 2
    su = _setup(N)
    ys = _ys(T_, seed=4)[:, :b]
    jrun = jax.jit(lambda c, m, y: j_filtering.moment_filter_nd_cms(
        su.jp.cms, su.jp.mean, su.jm.measurement_cond_pdf, y, (su.mis, su.inds), c, m,
        eigh_impl="refined", predict_fn=su.jp.predict_cms))
    _, j_means, j_nell = jrun(su.cms0[:b], su.mean0[:b], ys)
    calls = _count_large_route(monkeypatch)
    cms0, mean0, y = nd_filter_inputs_from_numpy(su.cms0[:b], su.mean0[:b], ys, device="cpu")
    _, means, nell = filtering.moment_filter_nd_cms(
        su.tp.cms, su.tp.mean, su.tm.measurement_cond_pdf, y, (su.mis, su.inds), cms0, mean0,
        eigh_impl="fused", predict_fn=su.tp.predict_cms)
    assert len(calls) == 2 * T_
    np.testing.assert_allclose(to_numpy(nell), np.asarray(j_nell), rtol=RTOL)
    np.testing.assert_allclose(to_numpy(means), np.asarray(j_means), rtol=RTOL)


def test_prey_predator_n5_through_large_pair_nell(monkeypatch):
    """N=5 (s=15, where the JAX package runs its one-program K3) takes the
    K-builder pair (plain versions on the CPU) with nothing patched, here
    in the scaled central filter (the cms filter at N=5 is
    ``test_prey_predator_cms_poly_nell``): nell and scales rtol 1e-8
    against JAX's f64 filter."""
    su = _setup(5)
    ys = _ys(T, seed=5)
    assert dispatch.fused_nd_kernel(15, 2) == "nd_k"
    scale0 = np.sqrt(np.diag(np.asarray(su.jm.init_cond.cov)))
    scms0 = su.cms0 / np.asarray(j_monomials_nd(jnp.asarray(scale0), su.mis))
    s0 = np.broadcast_to(scale0, (B, 2)).copy()
    jrun = jax.jit(lambda a, m, s, y: j_filtering.moment_filter_nd_scms(
        su.jp.scms, su.jp.mean_var, su.jm.measurement_cond_pdf, y, (su.mis, su.inds), a, m, s,
        eigh_impl="xla", predict_fn=su.jp.predict_scms))
    *_, j_scales, j_nell = jrun(scms0, su.mean0, s0, ys)
    calls = _count_large_route(monkeypatch)
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64))
    *_, scales, nell = filtering.moment_filter_nd_scms(
        su.tp.scms, su.tp.mean_var, su.tm.measurement_cond_pdf, t(ys), (su.mis, su.inds),
        t(scms0), t(su.mean0), t(s0), eigh_impl="fused", predict_fn=su.tp.predict_scms)
    assert len(calls) == 2 * T
    np.testing.assert_allclose(nell.numpy(), np.asarray(j_nell), rtol=RTOL)
    np.testing.assert_allclose(scales.numpy(), np.asarray(j_scales), rtol=RTOL)


@pytest.mark.parametrize("s, d, kernel", [
    (6, 2, "nd_eigh"), (10, 3, "nd_eigh"), (15, 2, "nd_k"), (28, 2, "nd_k"), (32, 2, "nd_k"),
    (36, 2, "nd_k"), (45, 2, "nd_k"), (66, 2, "nd_k"), (35, 3, "nd_k"),
    (119, 2, "nd_k"), (120, 2, None), (6, 4, None)])
def test_dispatch_routes_by_the_kernels_limits(s, d, kernel):
    """``ops/dispatch.py``: "auto" takes the kernels on CUDA within their
    own limits and "refined" elsewhere; named routes pass through."""
    assert dispatch.fused_nd_kernel(s, d) == kernel
    want = "fused" if kernel else "refined"
    assert dispatch.resolve_impl_nd(s, 1024, "auto", d, device=torch.device("cuda")) == want
    assert dispatch.resolve_impl_nd(s, 1024, "auto", d, device="cpu") == "refined"
    assert dispatch.resolve_impl_nd(s, 1024, "xla", d, device="cuda") == "xla"
    with pytest.raises(TypeError):  # the tensor's device is always given
        dispatch.resolve_impl_nd(s, 1024, "auto", d)
    n = s  # the 1D order: K1 takes n <= 32
    assert dispatch.resolve_impl_1d(n, 4096, "auto", device="cuda") == (
        "fused" if n <= 32 else "refined")
    assert dispatch.resolve_impl_1d(n, 4096, "auto", device="cpu") == "refined"
    assert dispatch.resolve_impl_1d(n, 4096, "refined", device="cuda") == "refined"
    with pytest.raises(TypeError):
        dispatch.resolve_impl_1d(n, 4096, "auto")
