"""Tests of the port that need an NVIDIA GPU and nvcc (marker ``cuda``).

They skip where there is no GPU.  On a CUDA host run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which a CUDA host
need not have; this file imports neither ``jax`` nor ``mfs_tpu``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mfs_tpu_torch.models.one_dim import benes_bernoulli  # noqa: E402
from mfs_tpu_torch.one_dim.filtering import moment_filter_cms  # noqa: E402
from mfs_tpu_torch.one_dim.quadrature import hankel_indices, moment_quadrature  # noqa: E402
from mfs_tpu_torch.ops import posterior_kernel as pk  # noqa: E402
from mfs_tpu_torch.ops import quadrature_kernel as qk  # noqa: E402
from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme_normal  # noqa: E402
from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all  # noqa: E402
from mfs_tpu_torch.utils.profiling import counters  # noqa: E402

pytestmark = pytest.mark.cuda


def _k1():
    """K1's launches counted by the registry."""
    return counters().get("kernel.launches.k1", 0)


def _post1d():
    """The posterior update kernel's launches counted by the registry."""
    return counters().get("kernel.launches.post1d", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _mixture(N, B, seed, device):
    """Raw moments of two-Gaussian mixtures (well conditioned at N <= 8)."""
    rng = np.random.RandomState(seed)
    m = torch.as_tensor(rng.randn(B) * 0.3, device=device)
    v = torch.as_tensor(0.5 + rng.rand(B), device=device)
    return 0.6 * normal_raw_moments_all(m, v, 2 * N) + 0.4 * normal_raw_moments_all(
        m + 0.3, v * 0.8, 2 * N)


def _central_mixture(N, B, seed, device):
    """The filter's regime: central moments of symmetric two-Gaussian
    mixtures of unit variance."""
    a = torch.as_tensor(0.3 + 0.2 * np.random.RandomState(seed).rand(B), device=device)
    return 0.5 * normal_raw_moments_all(-a, 1 - a * a, 2 * N) + 0.5 * normal_raw_moments_all(
        a, 1 - a * a, 2 * N)


@pytest.mark.parametrize("N", [3, 8, 15])
def test_kernel_matches_plain_version(cuda, N):
    """K1 vs its plain version on the same card inputs, ragged B = 513.
    Bounds: nodes 5e-12 / weights 5e-8 at n <= 8 on raw mixture moments
    (the JAX kernel tests' bounds); at n = 15, in the filter's central
    regime, nodes 1e-9 / weights 1e-10: the Hankel conditioning amplifies
    the kernel's FMA contraction (measured 3.5e-11 in ``chip_smoke.py``)."""
    ms = _mixture(N, 513, N, cuda) if N <= 8 else _central_mixture(N, 513, N, cuda)
    mean = torch.linspace(-1.0, 1.0, 513, dtype=torch.float64, device=cuda)
    scale = torch.full_like(mean, 1.5)
    tol_x, tol_w = (5e-12, 5e-8) if N <= 8 else (1e-9, 1e-10)
    before = _k1()
    for jitter in (0.0, 1e-8):
        w, x = qk.moment_quadrature_fused(ms, mean, scale, jitter)
        torch.cuda.synchronize()
        wp, xp = qk.moment_quadrature_fused_plain(ms, mean, scale, jitter)
        assert w.device.type == "cuda" and w.shape == (513, N)
        assert (x - xp).abs().max().item() < tol_x
        assert (w - wp).abs().max().item() < tol_w
    assert _k1() == before + 2


def _moment_residual(w, x, ms, mean, scale):
    """Per trial: max over orders p of |sum_k w_k lam_k^p - m_p| relative
    to sum_k w_k |lam_k|^p, lam = (x - mean) / scale (as in
    ``chip_smoke.py``)."""
    lam = (x - mean[:, None]) / scale[:, None]
    powers = lam[..., None] ** torch.arange(ms.shape[-1], device=lam.device)
    got = torch.einsum("bk,bkp->bp", w, powers)
    denom = torch.einsum("bk,bkp->bp", w.abs(), powers.abs())
    return ((got - ms).abs() / denom).amax(-1)


@pytest.mark.parametrize("B", [1, 31, 32, 33, 512, 4096])
@pytest.mark.parametrize("n", [2, 15, 16, 17, 32])
def test_k1_launch_geometry(cuda, n, B):
    """K1 vs its plain version at the edges of its teams (n = 16 is the
    largest order on 16-lane teams, two trials a warp; n = 17 the least
    on whole warps) and of its 64-thread CTAs (four or two trials each),
    with and without jitter, under ``chip_smoke.py``'s bounds: raw
    mixture moments at n = 2 (nodes 5e-12, weights 5e-8); the filter's
    central regime at n = 15-17 (nodes 1e-9, weights 1e-10) and at n = 32
    (with jitter nodes 1e-6, weights 1e-7; without, the Gram is beyond
    f64's reach and the kernel's rule reproduces the moments within 10x
    the plain rule's residual + 1e-12).  Each call is one launch."""
    ms = _mixture(n, B, n, cuda) if n <= 8 else _central_mixture(n, B, n + B, cuda)
    mean = torch.linspace(-1.0, 1.0, B, dtype=torch.float64, device=cuda)
    scale = torch.full_like(mean, 1.5)
    before = _k1()
    for jitter in (0.0, 1e-8):
        w, x = qk.moment_quadrature_fused(ms, mean, scale, jitter)
        torch.cuda.synchronize()
        wp, xp = qk.moment_quadrature_fused_plain(ms, mean, scale, jitter)
        assert w.shape == x.shape == (B, n)
        assert bool(torch.isfinite(w).all() and torch.isfinite(x).all())
        dx, dw = (x - xp).abs().max().item(), (w - wp).abs().max().item()
        if n <= 8:
            assert dx < 5e-12 and dw < 5e-8
        elif n < 32:
            assert dx < 1e-9 and dw < 1e-10
        elif jitter:
            assert dx < 1e-6 and dw < 1e-7
        else:
            res = _moment_residual(w, x, ms, mean, scale).max().item()
            res_p = _moment_residual(wp, xp, ms, mean, scale).max().item()
            assert res <= 10 * res_p + 1e-12
    assert _k1() == before + 2


def test_kernel_raises_instead_of_falling_back(cuda):
    before = _k1()
    with pytest.raises(ValueError):
        qk.moment_quadrature_fused(torch.ones(4, 66, dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        qk.moment_quadrature_fused(_mixture(3, 4, 0, cuda).float())
    assert _k1() == before
    # inputs that require grad run the kernel too (the backward is plain
    # torch), never the plain version
    ms = _mixture(3, 4, 0, cuda).requires_grad_(True)
    (g,) = torch.autograd.grad(qk.moment_quadrature_fused(ms)[1].sum(), ms)
    assert _k1() == before + 1
    assert g.shape == ms.shape and bool(torch.isfinite(g).all())


def _post1d_inputs(N, B, device):
    """K1's rule at ``B`` trials, as the filters hand it to the update
    (``(B, n)`` views of ``(n, B)`` storage), and the Beneš–Bernoulli
    likelihood at its nodes; trial 7 has NaN moments, trial 11 a
    likelihood of zero."""
    ms = _mixture(N, B, N, device) if N <= 8 else _central_mixture(N, B, N, device)
    ms[7] = float("nan")
    mean = torch.linspace(-1.0, 1.0, B, dtype=torch.float64, device=device)
    w, x = qk.moment_quadrature_fused(ms, mean, 1.0)
    gen = torch.Generator(device=device).manual_seed(N)
    ys = torch.bernoulli(torch.full((B,), 0.5, dtype=torch.float64, device=device),
                         generator=gen)
    p = benes_bernoulli(N=N, device=device).measurement_cond_pdf(ys[:, None], x)
    p[11] = 0.0
    return x, w, p


@pytest.mark.parametrize("N", [4, 15])
def test_post1d_matches_plain_version(cuda, N):
    """The posterior update's kernel against its plain version on the same
    card inputs (``_post1d_inputs``, B = 4,096, 2N moments), in the three
    modes, one launch a call.  Trials 7 and 11 come out non-finite, and
    every output is finite exactly where the plain version's is.  Finite
    outputs within rtol 1e-12 of the size of the terms they sum, since
    the two versions sum the nodes in another order: pdf_y and the scale
    of their own size, the mean of ``sum_k |x_k| wp_k / pdf_y``, moment j
    of ``sum_k |u_k|^j wp_k / pdf_y`` (an odd central moment is ~0 by
    cancellation, a mean may be)."""
    B = 4096
    x, w, p = _post1d_inputs(N, B, cuda)
    assert x.T.is_contiguous() and w.T.is_contiguous() and p.T.is_contiguous()
    for mode in ("raw", "central", "scaled"):
        before = _post1d()
        got = pk.posterior_moments_1d(x, w, p, mode)
        torch.cuda.synchronize()
        assert _post1d() == before + 1
        _assert_post1d_close(got, x, w, p, mode, 2 * N)
        assert not bool(torch.isfinite(got[0][[7, 11]]).all(-1).any())


def _assert_post1d_close(got, x, w, p, mode, num):
    """The kernel's outputs ``got`` against the plain version's on the
    same inputs: the same shapes, finite in the same places, and within
    rtol 1e-12 of the size of the terms each sums (see
    ``test_post1d_matches_plain_version``)."""
    want = pk.posterior_moments_1d_plain(x, w, p, mode, num)
    assert got[0].shape == (x.shape[0], num) and got[0].is_contiguous()
    for g, h in zip(got, want):
        assert g.shape == h.shape
        assert torch.equal(torch.isfinite(g), torch.isfinite(h))
    u = x if mode == "raw" else x - want[1][:, None]
    u = u / want[2][:, None] if mode == "scaled" else u
    sizes = [pk.posterior_moments_1d_plain(u.abs(), w, p, "raw", num)[0]]
    if mode != "raw":
        sizes.append(pk.posterior_moments_1d_plain(x.abs(), w, p, "raw", 2)[0][:, 1])
    sizes += [h.abs() for h in want[len(sizes):]]
    for g, h, size in zip(got, want, sizes):
        ok = torch.isfinite(h)
        assert bool(((g - h).abs() <= 1e-12 * size)[ok].all())


def test_post1d_beyond_one_block_of_moments(cuda):
    """More moments than the kernel's block of 64 accumulators: n = 40
    nodes (beyond K1, as the f64 library route gives them) at 80 and 130
    moments, B = 1,000 (not a whole number of thread blocks), in (n, B)
    storage, in the three modes, one launch a call and as close to the
    plain version as ``test_post1d_matches_plain_version`` asks."""
    n, B = 40, 1000
    gen = torch.Generator(device=cuda).manual_seed(40)
    draw = lambda: torch.rand((n, B), dtype=torch.float64, device=cuda, generator=gen).T
    x = torch.randn((n, B), dtype=torch.float64, device=cuda, generator=gen).T * 0.8
    w, p = draw() + 0.05, draw()
    w = w / w.sum(-1, keepdim=True)
    for num in (80, 130):
        for mode in ("raw", "central", "scaled"):
            before = _post1d()
            got = pk.posterior_moments_1d(x, w, p, mode, num)
            torch.cuda.synchronize()
            assert _post1d() == before + 1
            _assert_post1d_close(got, x, w, p, mode, num)


def test_post1d_gradient_matches_plain_autograd(cuda):
    """The update's ``autograd.Function`` on CUDA tensors, n = 4, B = 256:
    the forward launches the kernel though the inputs require grad, and
    the gradient in nodes, weights and likelihood values, for random
    cotangents on every output, equals autograd through the plain version
    on the card (rtol 1e-12), in the three modes."""
    x, w, p = (t[12:268] for t in _post1d_inputs(4, 4096, cuda))
    gen = torch.Generator(device=cuda).manual_seed(5)
    for mode in ("raw", "central", "scaled"):
        cots = None
        grads = []
        for fn in (pk.posterior_moments_1d, lambda *a: pk.posterior_moments_1d_plain(*a, 8)):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, p)]
            before = _post1d()
            outs = fn(*leaves, mode)
            if cots is None:
                assert _post1d() == before + 1
                cots = [torch.randn(o.shape, dtype=o.dtype, device=cuda, generator=gen)
                        for o in outs]
            loss = sum((o * c).sum() for o, c in zip(outs, cots))
            grads.append(torch.autograd.grad(loss, leaves))
        for g, h in zip(*grads):
            assert bool(torch.isfinite(h).all())
            torch.testing.assert_close(g, h, rtol=1e-12, atol=0.0)


def test_filter_on_card_matches_cpu_plain_path(cuda):
    """Beneš N=4, B=8, T=20 central filter through K1 on the card vs the
    same filter on the CPU (plain version): nell rtol 1e-10, every
    quadrature of the card run is one K1 launch and every update one
    launch of the posterior kernel."""
    N, B = 4, 8
    rng = np.random.RandomState(0)
    ys = rng.binomial(1, 0.5, (20, B)).astype(np.float64)
    nells = {}
    for dev in ("cpu", "cuda"):
        model = benes_bernoulli(N=N, device=dev)
        trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
        ic = model.init_cond
        before, post_before = _k1(), _post1d()
        _, _, nell = moment_filter_cms(
            trans.cms, trans.mean, model.measurement_cond_pdf, ic.cms.expand(B, 2 * N),
            ic.mean.expand(B), torch.as_tensor(ys, device=dev), eigh_impl="auto")
        nells[dev] = nell.cpu()
        assert _k1() - before == (2 * 20 if dev == "cuda" else 0)
        assert _post1d() - post_before == (20 if dev == "cuda" else 0)
    np.testing.assert_allclose(nells["cuda"].numpy(), nells["cpu"].numpy(), rtol=1e-10)


def test_filter_beyond_k1_on_card_matches_cpu_plain_path(cuda):
    """Beneš N=33 (66 moments, past K1's 32 nodes and the posterior
    kernel's block of 64 moments), B=8, T=2 (at T >= 3 the f64 rule loses
    trials): the central filter on the card takes the f64 library route
    and the posterior kernel, one launch a step and no K1, and its nell
    matches the CPU's plain path (rtol 1e-10)."""
    N, B, T = 33, 8, 2
    ys = np.random.RandomState(0).binomial(1, 0.5, (T, B)).astype(np.float64)
    nells = {}
    for dev in ("cpu", "cuda"):
        model = benes_bernoulli(N=N, device=dev)
        trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
        ic = model.init_cond
        before, post_before = _k1(), _post1d()
        _, _, nell = moment_filter_cms(
            trans.cms, trans.mean, model.measurement_cond_pdf, ic.cms.expand(B, 2 * N),
            ic.mean.expand(B), torch.as_tensor(ys, device=dev), eigh_impl="auto")
        nells[dev] = nell.cpu()
        assert _k1() == before
        assert _post1d() - post_before == (T if dev == "cuda" else 0)
    assert bool(torch.isfinite(nells["cpu"]).all())
    np.testing.assert_allclose(nells["cuda"].numpy(), nells["cpu"].numpy(), rtol=1e-10)


def test_f64_path_on_card(cuda):
    """The f64 LAPACK path on the card: the same rule as on the CPU for
    the PD trials, and the non-PD trial comes back NaN instead of raising
    (with ``stable=True`` it is completed to a nearby PD matrix, whose
    ill-conditioned rule the two libraries need not agree on)."""
    ms = _mixture(4, 6, 1, cuda)
    ms[2, 2] = -1.0
    pd = torch.arange(6) != 2
    for stable in (False, True):
        w, x = moment_quadrature(ms, 0.1, 1.2, stable=stable, eigh_impl="xla")
        wc, xc = moment_quadrature(ms.cpu(), 0.1, 1.2, stable=stable, eigh_impl="xla")
        x, w = x.cpu(), w.cpu()
        assert bool(torch.isfinite(x[pd]).all())
        if not stable:
            assert not bool(torch.isfinite(x[2]).any())
        np.testing.assert_allclose(x[pd].numpy(), xc[pd].numpy(), atol=1e-10)
        np.testing.assert_allclose(w[pd].numpy(), wc[pd].numpy(), atol=1e-10)


def test_default_device_is_cuda(cuda):
    model = benes_bernoulli(N=2)
    assert model.init_cond.cms.device.type == "cuda"
    assert hankel_indices(3)[0].device.type == "cuda"


# ---------------------------------------------------------------------------
# ND kernels: K2 (fused eigenpairs) and the K-builder (nd_ldl + nd_ksolve)
# ---------------------------------------------------------------------------

from mfs_tpu_torch.models.multi_dims import prey_predator  # noqa: E402
from mfs_tpu_torch.multi_dims import multi_indices as nd_mi  # noqa: E402
from mfs_tpu_torch.multi_dims.filtering import moment_filter_nd_cms  # noqa: E402
from mfs_tpu_torch.multi_dims.moments import monomials_nd, raw_moments_mvn_kan_all  # noqa: E402
from mfs_tpu_torch.multi_dims.poly_tme import poly_tme_nd  # noqa: E402
from mfs_tpu_torch.multi_dims.quadrature import moment_quadrature_nd  # noqa: E402
from mfs_tpu_torch.ops import quadrature_nd_kernel as qnd  # noqa: E402


def _nd_moments(N, d, B, seed, device):
    """Raw moments of B random Gaussians in d dimensions, orders <= 2N-1."""
    rng = np.random.RandomState(seed)
    mis = nd_mi.generate_graded_lexico_multi_indices(d, 2 * N - 1)
    mean = torch.as_tensor(0.3 * rng.randn(B, d), device=device)
    a = torch.as_tensor(rng.randn(B, d, d), device=device)
    cov = a @ a.mT * 0.1 + 0.5 * torch.eye(d, dtype=torch.float64, device=device)
    # 64 trials at a time: Kan's sum for one trial of 2D order 15 takes ~30 MB
    ms = torch.cat([raw_moments_mvn_kan_all(mean[i:i + 64], cov[i:i + 64], mis)
                    for i in range(0, B, 64)])
    return ms, nd_mi.gram_and_hankel_indices_graded_lexico(N, d)


@pytest.mark.parametrize("N, d", [(5, 2), (6, 2), (7, 2), (3, 2)])
def test_k3_matches_plain_version(cuda, N, d):
    """K3's function at its sizes (s = 15, 21, 28 and 6): ``nd_k_fused``
    (one launch each of nd_ldl and nd_ksolve) vs its plain version on the
    card, ragged B = 1021, one trial NaN: K atol 1e-11 (FMA contraction),
    the NaN trial NaN."""
    ms, inds = _nd_moments(N, d, 1021, N, cuda)
    ms[7] = float("nan")
    before = _launches()
    K = qnd.nd_k_fused(ms, inds)
    torch.cuda.synchronize()
    Kp = qnd.nd_k_fused_plain(ms, inds)
    ok = torch.arange(1021, device=cuda) != 7
    ran = {k: v - before[k] for k, v in _launches().items()}
    assert ran == {"nd_eigh": 0, "nd_ldl": 1, "nd_ksolve": 1}
    assert (K - Kp)[ok].abs().max().item() < 1e-11
    assert bool(torch.isnan(K[7]).any())


@pytest.mark.parametrize("N, d", [(2, 2), (3, 2), (4, 2), (3, 3)])
def test_k2_matches_plain_version(cuda, N, d):
    """K2 vs its plain version on the card by rotation-free checks
    (sorted eigenvalues 1e-12, residual 1e-12, orthonormality 1e-13);
    a NaN trial comes out NaN in values and vectors."""
    ms, inds = _nd_moments(N, d, 513, N + d, cuda)
    ms[5] = float("nan")
    s = inds.shape[1]
    before = _launches()["nd_eigh"]
    vals, vecs = qnd.nd_eigh_fused(ms, inds)
    torch.cuda.synchronize()
    vp, _ = qnd.nd_eigh_fused_plain(ms, inds)
    K = qnd.nd_k_fused_plain(ms, inds)
    ok = torch.arange(513, device=cuda) != 5
    assert _launches()["nd_eigh"] == before + 1
    assert (vals.sort(-1)[0] - vp.sort(-1)[0])[ok].abs().max().item() < 1e-12
    assert (K @ vecs - vecs * vals[..., None, :])[ok].abs().max().item() < 1e-12
    eye = torch.eye(s, dtype=torch.float64, device=cuda)
    assert (vecs.mT @ vecs - eye)[ok].abs().max().item() < 1e-13
    assert bool(torch.isnan(vals[5]).all() and torch.isnan(vecs[5]).all())


def test_nd_kernels_raise_instead_of_falling_back(cuda):
    ms, inds = _nd_moments(3, 2, 4, 0, cuda)
    before = _launches()
    with pytest.raises(NotImplementedError):
        qnd.nd_eigh_fused(ms.clone().requires_grad_(True), inds)
    with pytest.raises(NotImplementedError):
        qnd.nd_k_fused(ms.clone().requires_grad_(True), inds)
    with pytest.raises(TypeError):
        qnd.nd_k_fused(ms.float(), inds)
    with pytest.raises(ValueError):
        qnd.nd_eigh_fused(*_nd_moments(5, 2, 4, 0, cuda))
    assert _launches() == before


@pytest.mark.parametrize("N, kernels", [(3, ("nd_eigh",)),
                                        (5, ("nd_ldl", "nd_ksolve"))])
def test_auto_routes_cuda_tensors_to_the_kernels(cuda, N, kernels):
    """"auto" on a CUDA tensor launches K2 at s = 6 and nd_ldl + nd_ksolve
    at s = 15, and the rule reproduces the moments to 5e-12 relative
    (moments of order 9 reach ~200 here)."""
    ms, inds = _nd_moments(N, 2, 64, 1, cuda)
    before = _launches()
    w, x = moment_quadrature_nd(ms, inds, eigh_impl="auto")
    ran = {k: v - before[k] for k, v in _launches().items()}
    assert ran == {k: 1 if k in kernels else 0 for k in _COUNTERS}
    mis = nd_mi.generate_graded_lexico_multi_indices(2, 2 * N - 1)
    got = torch.einsum("bmz,bm->bz", monomials_nd(x, mis), w)
    assert ((got - ms).abs() / ms.abs().clamp_min(1.0)).max().item() < 5e-12


_COUNTERS = ("nd_eigh", "nd_ldl", "nd_ksolve")


def _launches():
    """The ND kernels' launches counted by the registry."""
    counts = counters()
    return {name: counts.get("kernel.launches." + name, 0) for name in _COUNTERS}


@pytest.mark.parametrize("N, kernels", [(3, ("nd_eigh",)),
                                        (5, ("nd_ldl", "nd_ksolve")),
                                        (8, ("nd_ldl", "nd_ksolve"))])
def test_nd_filter_on_card_matches_cpu_plain_path(cuda, N, kernels):
    """Prey–predator central filter, poly TME-2, B = 8, T = 20, through
    K2 (N=3) or nd_ldl + nd_ksolve + cuSOLVER eigh (N=5, N=8) on the card vs the same filter on the CPU (plain versions):
    nell rtol 1e-10, each of the route's kernels launched once a
    quadrature (two a step) and no other."""
    B, T = 8, 20
    mis = nd_mi.generate_graded_lexico_multi_indices(2, 2 * N - 1)
    inds = nd_mi.gram_and_hankel_indices_graded_lexico(N, 2)
    ys = np.random.RandomState(0).binomial(1, 0.5, (T, B, 1)).astype(np.float64)
    nells = {}
    for dev in ("cpu", "cuda"):
        model = prey_predator(mis, device=dev)
        poly = poly_tme_nd(model.drift, model.dispersion, model.dt, 2, mis, 2, 1, device=dev)
        ic = model.init_cond
        before = _launches()
        _, _, nell = moment_filter_nd_cms(
            poly.cms, poly.mean, model.measurement_cond_pdf, torch.as_tensor(ys, device=dev),
            (mis, inds), ic.cms.expand(B, -1), ic.mean.expand(B, 2),
            eigh_impl="auto" if dev == "cuda" else "fused",
            predict_fn=poly.predict_cms)
        nells[dev] = nell.cpu()
        ran = {k: v - before[k] for k, v in _launches().items()}
        assert ran == {k: 2 * T if dev == "cuda" and k in kernels else 0 for k in _COUNTERS}
    np.testing.assert_allclose(nells["cuda"].numpy(), nells["cpu"].numpy(), rtol=1e-10)


# ---------------------------------------------------------------------------
# The K-builder's kernels alone: nd_ldl and nd_ksolve
# ---------------------------------------------------------------------------


def _cond_tol(ms, inds, X):
    """Per trial, the gap allowed between a kernel (FMA-contracted) and
    its plain version: max|X| (1e-13 + 10 eps cond(G')), G' the
    equilibrated Gram both factorise (``chip_smoke.py::conditioned_tol``).
    It holds where 10 eps cond(G') <= 1e-2 (``chip_smoke.py``'s
    ``ILL_CONDITIONED``), as for every trial of these Gaussian inputs."""
    c, Gp, _ = qnd._equilibrated(ms, inds)
    cond = torch.linalg.cond(Gp)
    assert bool((10 * 2.2e-16 * cond <= 1e-2).all())
    return X.flatten(1).abs().amax(-1) * (1e-13 + 10 * 2.2e-16 * cond)


def _over_tol(ms, inds, X, Xp, ok):
    gap = (X - Xp).flatten(1).abs().amax(-1)
    return (gap[ok] / _cond_tol(ms[ok], inds, Xp[ok])).max().item()


@pytest.mark.parametrize("N, d, B", [(8, 2, 1021), (9, 2, 1024), (11, 2, 1021), (11, 2, 1),
                                     (14, 2, 1021), (5, 3, 515), (7, 3, 515)])
def test_large_pair_matches_plain_version(cuda, N, d, B):
    """nd_ldl and nd_ksolve vs their plain versions on the card at s = 36,
    45, 66, 105 (d = 2) and 35, 84 (d = 3, 84 its largest order within
    MAX_S_K), ragged B, one trial NaN (``_check_large_pair``)."""
    ms, inds = _nd_moments(N, d, B, 100 + N, cuda)
    _check_large_pair(cuda, ms, inds, d, B)


def test_large_pair_at_its_shared_memory_limit(cuda):
    """The pair at s = MAX_S_K = 119, the first 119 basis polynomials
    of 2D order 15 (nd_ksolve's Lu and W, padded to 120 rows at an
    unpadded stride, take 232,320 of the 232,448 bytes of shared memory
    the card grants a block), B = 257."""
    ms, inds = _nd_moments(15, 2, 257, 115, cuda)
    inds = np.ascontiguousarray(inds[:, :qnd.MAX_S_K, :qnd.MAX_S_K])
    _check_large_pair(cuda, ms, inds, 2, 257)


def _check_large_pair(cuda, ms, inds, d, B):
    """Lu, 1/scale and K within the conditioned tolerance, c to 1e-15
    relative (the same operations); nd_ksolve also on the plain factor,
    so that each kernel is held alone; the NaN trial comes out NaN from
    both."""
    nan = B // 2 if B > 1 else -1
    if B > 1:
        ms[nan] = float("nan")
    ok = torch.arange(B, device=cuda) != nan
    before = _launches()
    Lu, piv, c, isc = qnd.nd_ldl_fused(ms, inds)
    K = qnd.nd_ksolve_fused(ms, inds, Lu, c, isc)
    torch.cuda.synchronize()
    Lup, pivp, cp, iscp = qnd.nd_ldl_plain(ms, inds)
    Kp = qnd.nd_ksolve_plain(ms, inds, Lup, cp, iscp)
    K_on_plain = qnd.nd_ksolve_fused(ms, inds, Lup, cp, iscp)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in _launches().items()}
    assert ran == {"nd_eigh": 0, "nd_ldl": 1, "nd_ksolve": 2}
    s = inds.shape[1]
    assert Lu.shape == (B, s, s) and K.shape == (B, d, s, s)
    assert ((c - cp)[ok].abs() / cp[ok].abs()).max().item() <= 1e-15
    assert _over_tol(ms, inds, Lu, Lup, ok) <= 1.0
    assert _over_tol(ms, inds, isc, iscp, ok) <= 1.0
    assert _over_tol(ms, inds, piv, pivp, ok) <= 1.0
    assert _over_tol(ms, inds, K, Kp, ok) <= 1.0
    assert _over_tol(ms, inds, K_on_plain, Kp, ok) <= 1.0
    assert torch.equal(K[ok], K[ok].mT)
    if B > 1:  # at s = 1 Lu is the constant [[1]]
        assert bool(torch.isnan(piv[nan]).all() and torch.isnan(K[nan]).any())
        assert s == 1 or bool(torch.isnan(Lu[nan]).any())
        assert bool(torch.isfinite(K[ok]).all())


def test_large_pair_raises_instead_of_falling_back(cuda):
    ms, inds = _nd_moments(8, 2, 4, 0, cuda)
    before = _launches()
    with pytest.raises(NotImplementedError):
        qnd.nd_ldl_fused(ms.clone().requires_grad_(True), inds)
    with pytest.raises(TypeError):
        qnd.nd_ldl_fused(ms.float(), inds)
    Lu, _, c, isc = qnd.nd_ldl_plain(ms, inds)
    with pytest.raises(TypeError):  # the factor on another device
        qnd.nd_ksolve_fused(ms, inds, Lu.cpu(), c, isc)
    with pytest.raises(ValueError):  # s = 120 > MAX_S_K
        qnd.nd_ldl_fused(torch.zeros(2, 465, dtype=torch.float64, device=cuda),
                         nd_mi.gram_and_hankel_indices_graded_lexico(15, 2))
    assert _launches() == before


@pytest.mark.parametrize("N", [8, 11])
def test_auto_routes_large_bases_to_the_pair(cuda, N):
    """"auto" on a CUDA tensor at s = 36 and 66 launches nd_ldl and
    nd_ksolve once each; the rule reproduces the moments no worse than
    10x the f64 library route's rule + 1e-12 (relative to the moments'
    own magnitude)."""
    ms, inds = _nd_moments(N, 2, 64, 1, cuda)
    mis = nd_mi.generate_graded_lexico_multi_indices(2, 2 * N - 1)
    before = _launches()
    gaps = {}
    for impl in ("auto", "refined"):
        w, x = moment_quadrature_nd(ms, inds, eigh_impl=impl)
        got = torch.einsum("bmz,bm->bz", monomials_nd(x, mis), w)
        gaps[impl] = ((got - ms).abs() / ms.abs().clamp_min(1.0)).max().item()
    ran = {k: v - before[k] for k, v in _launches().items()}
    assert ran == {"nd_eigh": 0, "nd_ldl": 1, "nd_ksolve": 1}
    assert gaps["auto"] <= 10 * gaps["refined"] + 1e-12


# ---------------------------------------------------------------------------
# Launch geometry: K2 packs EIGH_TRIALS trials (one warp per dimension) into
# a CTA; nd_ksolve runs one CTA per trial, one warp per 8-column strip of s
# padded to a multiple of 8.  The batches below are not multiples of the
# trials per CTA, and the bases reach each padding and shared-memory layout.
# ---------------------------------------------------------------------------

# The least order N whose basis (C(N - 1 + d, d) polynomials) holds s
_ORDER_FOR = {2: {1: 1, 3: 2, 6: 3, 8: 4, 10: 4, 11: 5, 15: 5, 28: 7, 29: 8, 66: 11, 105: 14,
                  119: 15},
              3: {1: 1, 3: 2, 6: 3, 8: 3, 10: 3, 15: 4, 28: 5, 66: 7, 105: 8, 119: 8}}


def _moments_at(s, d, B, seed, device):
    """Moments of B random Gaussians and the index tables of the first s
    basis polynomials (the leading block of the Gram and of each Hankel)."""
    ms, inds = _nd_moments(_ORDER_FOR[d][s], d, B, seed, device)
    return ms, np.ascontiguousarray(inds[:, :s, :s])


@pytest.mark.parametrize("s, d, B", [(s, d, 1021) for d in (2, 3) for s in (1, 3, 6, 10)]
                         + [(6, 2, 1), (6, 2, 31), (10, 3, 1), (10, 3, 31)])
def test_k2_launch_geometry(cuda, s, d, B):
    """K2 vs its plain version (sorted eigenvalues 1e-12, residual 1e-12,
    orthonormality 1e-13) at every s and d it takes and at ragged
    batches; the NaN trial alone comes out NaN."""
    ms, inds = _moments_at(s, d, B, 200 + s + d, cuda)
    if B > 1:
        ms[B // 2] = float("nan")
    before = _launches()["nd_eigh"]
    vals, vecs = qnd.nd_eigh_fused(ms, inds)
    torch.cuda.synchronize()
    assert _launches()["nd_eigh"] == before + 1
    assert vals.shape == (B, d, s) and vecs.shape == (B, d, s, s)
    vp, _ = qnd.nd_eigh_fused_plain(ms, inds)
    K = qnd.nd_eigh_operators_plain(ms, inds)
    ok = torch.arange(B, device=cuda) != (B // 2 if B > 1 else -1)
    assert bool(torch.isfinite(vals[ok]).all() and torch.isfinite(vecs[ok]).all())
    assert (vals.sort(-1)[0] - vp.sort(-1)[0])[ok].abs().max().item() < 1e-12
    assert (K @ vecs - vecs * vals[..., None, :])[ok].abs().max().item() < 1e-12
    eye = torch.eye(s, dtype=torch.float64, device=cuda)
    assert (vecs.mT @ vecs - eye)[ok].abs().max().item() < 1e-13
    if B > 1:
        assert bool(torch.isnan(vals[B // 2]).all() and torch.isnan(vecs[B // 2]).all())


@pytest.mark.parametrize("s, d, B", [(s, 2, 1021) for s in (1, 8, 15, 28, 66, 105)]
                         + [(s, 3, 1021) for s in (1, 8, 15, 28, 66)]
                         + [(119, 2, 257), (105, 3, 31), (119, 3, 31), (28, 2, 1), (28, 2, 31),
                            (66, 2, 1), (66, 2, 31), (119, 2, 31)])
def test_ksolve_launch_geometry(cuda, s, d, B):
    """nd_ldl + nd_ksolve vs their plain versions at every padding of s
    to the 8-row panels (s = 1, 8, 15, 28, 66, 105 and 119, the last in
    the unpadded-stride layout), d = 2 and 3, ragged batches
    (``_check_large_pair``: the conditioned tolerance, K exactly
    symmetric, the NaN trial alone NaN).  At s = 119 in 2D the batch is
    257, as in ``test_large_pair_at_its_shared_memory_limit``: among 1,021
    of these Gaussians some Grams exceed the conditioning for which the
    tolerance holds (10 eps cond(G') <= 1e-2), which ``_cond_tol``
    requires of every trial."""
    ms, inds = _moments_at(s, d, B, 300 + s + d, cuda)
    _check_large_pair(cuda, ms, inds, d, B)


@pytest.mark.parametrize("s", [1, 8, 28, 66, 112, 113, 119])
def test_ksolve_layout(cuda, s):
    """nd_ksolve's launch layout: s padded to the 8-row panels, the
    bank-spreading stride sp + 4 where Lu and one W fit beside it (up to
    sp = 112), else sp; as many dimensions side by side as leave room for
    two CTAs on an SM; one warp per 8-column strip; the shared memory
    within the 232,448 bytes a block may use, and the card holding at
    least one CTA an SM (two where the shared memory allows)."""
    for d in (2, 3):
        lay = qnd.ksolve_layout(s, d)
        sp = -(-s // 8) * 8
        assert lay["sp"] == sp and lay["ld"] == (sp + 4 if sp <= 112 else sp)
        assert 1 <= lay["g"] <= d and lay["warps"] == lay["g"] * sp // 8
        assert lay["smem_bytes"] == ((1 + lay["g"]) * sp * lay["ld"] + 2 * sp) * 8 <= 232448
        assert lay["ctas_per_sm"] >= (2 if lay["smem_bytes"] <= 232448 // 2 - 1024 else 1)


@pytest.mark.parametrize("s, B", [(11, 1021), (28, 906), (29, 1021), (66, 1024), (66, 31),
                                  (119, 257), (119, 1)])
def test_ldl_launch_geometry(cuda, s, B):
    """nd_ldl's four outputs vs ``nd_ldl_plain`` (one CTA per trial, each
    column's trailing updates spread flat over its threads) at bases
    below, at and above a warp's 32 lanes and up to MAX_S_K, ragged
    batches: c
    to 1e-15 relative (the same operations), Lu, the pivots and 1/scale
    within the conditioned tolerance, Lu exactly unit lower triangular,
    the NaN trial NaN.  At s = 119 the batch is 257, as in
    ``test_large_pair_at_its_shared_memory_limit`` and on its inputs
    (seed 115): other draws of 257 such Gaussians hold Grams beyond the
    conditioning for which the tolerance holds, which ``_cond_tol``
    requires of every trial."""
    ms, inds = _moments_at(s, 2, B, 115 if s == 119 else 400 + s, cuda)
    nan = B // 2 if B > 1 else -1
    if B > 1:
        ms[nan] = float("nan")
    ok = torch.arange(B, device=cuda) != nan
    before = _launches()["nd_ldl"]
    Lu, piv, c, isc = qnd.nd_ldl_fused(ms, inds)
    torch.cuda.synchronize()
    assert _launches()["nd_ldl"] == before + 1
    Lup, pivp, cp, iscp = qnd.nd_ldl_plain(ms, inds)
    assert Lu.shape == (B, s, s) and piv.shape == c.shape == isc.shape == (B, s)
    assert ((c - cp)[ok].abs() / cp[ok].abs()).max().item() <= 1e-15
    for X, Xp in ((Lu, Lup), (piv, pivp), (isc, iscp)):
        assert _over_tol(ms, inds, X, Xp, ok) <= 1.0
    eye = torch.eye(s, dtype=torch.float64, device=cuda)
    assert torch.equal(Lu[ok].triu(), eye.expand(int(ok.sum()), s, s))
    if B > 1:
        assert bool(torch.isnan(piv[nan]).all() and torch.isnan(Lu[nan]).any())


# ---------------------------------------------------------------------------
# mfs_tpu_torch.filters: the grid truth, the GHF and the bootstrap PF
# ---------------------------------------------------------------------------

from mfs_tpu_torch.filters import (  # noqa: E402
    SigmaPoints,
    bootstrap_filter,
    brute_force_filter,
    continuous_resampling,
    sgp_filter,
    stratified,
)
from mfs_tpu_torch.sde import tme  # noqa: E402


def _benes_ys(T, B, seed):
    return np.random.RandomState(seed).binomial(1, 0.5, (T, B)).astype(np.float64)


def test_grid_filter_on_card_matches_cpu(cuda):
    """Chapman TME-3 on 600 points, 10 substeps, 4 trials, T=20: a cuda
    result within rtol 1e-10 of the CPU run's."""
    ys = _benes_ys(20, 4, 0)
    out = {}
    for dev in ("cpu", "cuda"):
        model = benes_bernoulli(N=2, device=dev)
        xs = torch.linspace(-5.0, 5.0, 600, dtype=torch.float64, device=dev)
        pss = brute_force_filter(model.drift, model.dispersion, model.measurement_cond_pdf,
                                 model.init_cond.pdf(xs).expand(4, 600), xs,
                                 torch.as_tensor(ys, device=dev), model.dt, 10, "chapman-tme-3")
        assert pss.device.type == dev and pss.shape == (20, 4, 600)
        out[dev] = pss.cpu().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-10)


def test_ghf_on_card_matches_cpu(cuda):
    """The paper's GHF (gh = 11, TME-3), 8 trials, T=100: cuda outputs
    within rtol 1e-10 of the CPU run's."""
    ys = _benes_ys(100, 8, 1)
    out = {}
    for dev in ("cpu", "cuda"):
        model = benes_bernoulli(N=2, device=dev)

        def cond(x, dt):
            m, v = tme.mean_and_var_1d(x[..., 0], dt, model.drift, model.dispersion, 3)
            return m[..., None], v[..., None, None]

        def meas(x):
            p = model.emission(x[..., 0])
            return p[..., None], (p * (1 - p))[..., None, None]

        ic = model.init_cond
        res = sgp_filter(cond, meas, SigmaPoints.gauss_hermite(1, 11, device=dev),
                         ic.mean.expand(8, 1), ic.variance.expand(8, 1, 1), model.dt,
                         torch.as_tensor(ys, device=dev)[..., None])
        assert all(r.device.type == dev for r in res)
        out[dev] = [r.cpu().numpy() for r in res]
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-10)


def test_pf_on_card(cuda):
    """The bootstrap PF (TME-3 proposal, stratified) on cuda data with a
    cuda generator: cuda outputs, finite, reproducible from the seed,
    each step's particle mean near the grid truth's mean (PF error at
    10,000 particles)."""
    ys = torch.as_tensor(_benes_ys(20, 4, 2), device=cuda)
    model = benes_bernoulli(N=2, device=cuda)

    def sampler(s, g):
        m, v = tme.mean_and_var_1d(s, model.dt, model.drift, model.dispersion, 3)
        return m + torch.sqrt(v) * torch.randn(s.shape, generator=g, dtype=s.dtype, device=s.device)

    def run(seed):
        return bootstrap_filter(sampler, model.measurement_cond_pdf, ys,
                                lambda g, n: model.init_cond.sampler(g, 4 * n).reshape(4, n),
                                torch.Generator(device=cuda).manual_seed(seed), 10_000, stratified,
                                out_fn=lambda s: s.mean(-1))

    means, nell = run(0)
    assert means.device.type == nell.device.type == "cuda" and means.shape == (20, 4)
    assert bool(torch.isfinite(means).all() and torch.isfinite(nell).all())
    assert torch.equal(run(0)[0], means) and not torch.equal(run(1)[0], means)
    xs = torch.linspace(-6.0, 6.0, 2000, dtype=torch.float64, device=cuda)
    pss = brute_force_filter(model.drift, model.dispersion, model.measurement_cond_pdf,
                             model.init_cond.pdf(xs).expand(4, 2000), xs, ys, model.dt, 100,
                             "chapman-tme-3")
    truth = (pss * xs).sum(-1) * (xs[1] - xs[0])
    assert (means - truth).abs().max().item() < 0.1


def test_generator_on_another_device_raises(cuda):
    """A CPU generator with cuda data raises; it is never moved."""
    w = torch.full((3, 10), 0.1, dtype=torch.float64, device=cuda)
    g = torch.Generator()
    with pytest.raises(ValueError):
        stratified(w, g)
    with pytest.raises(ValueError):
        continuous_resampling(w, w, 10, g)
    model = benes_bernoulli(N=2, device=cuda)
    with pytest.raises(ValueError):
        bootstrap_filter(lambda s, gg: s, model.measurement_cond_pdf,
                         torch.ones((5, 3), dtype=torch.float64, device=cuda),
                         lambda gg, n: torch.zeros((3, n), dtype=torch.float64, device=cuda),
                         g, 10, stratified)


def test_f64_eigh_takes_100000_matrices_in_one_call(cuda, monkeypatch):
    """``eigh_xla`` on 100,000 15 x 15 matrices (cuSOLVER's batched eigh
    rejects more than 16,384 a call): the same eigenvalues as 4,096-matrix
    chunks (rtol 1e-12 of each matrix's scale), residual ‖AV − VΛ‖ below
    1e-12 of it, nothing masked."""
    from mfs_tpu_torch.ops import eigh as te
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(100_000, 15, 15, generator=g, dtype=torch.float64, device=cuda)
    a = a + a.mT
    before = counters().get("eigh.nonconverged", 0)
    vals, vecs = te.eigh_xla(a)
    monkeypatch.setattr(te, "EIGH_CHUNK", 4096)
    vals_c, _ = te.eigh_xla(a)
    scale = a.abs().amax((-1, -2))
    assert counters().get("eigh.nonconverged", 0) == before and bool(torch.isfinite(vals).all())
    assert ((vals - vals_c).abs().amax(-1) <= 1e-12 * scale).all()
    assert ((a @ vecs - vecs * vals[:, None, :]).abs().amax((-1, -2)) <= 1e-12 * scale).all()


@pytest.mark.parametrize("n", [8, 15, 32])
def test_jacobi_eigh_on_card_matches_cusolver(cuda, n):
    """``eigh_batched`` (plain torch on the card) against
    ``torch.linalg.eigh``: sorted eigenvalues within 1e-12 of each
    matrix's scale, residual and ‖VᵀV − I‖ below 1e-12 (of it); the
    backward runs on the card."""
    from mfs_tpu_torch.ops.eigh import eigh_batched
    g = torch.Generator(device=cuda).manual_seed(n)
    a = torch.randn(513, n, n, generator=g, dtype=torch.float64, device=cuda)
    a = (a + a.mT).requires_grad_(True)
    vals, vecs = eigh_batched(a, sort=True)
    ref = torch.linalg.eigh(a.detach())[0]
    scale = a.detach().abs().amax((-1, -2))
    assert ((vals - ref).abs().amax(-1) <= 1e-12 * scale).all()
    assert ((a @ vecs - vecs * vals[:, None, :]).abs().amax((-1, -2)) <= 1e-12 * scale).all()
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    assert (vecs.mT @ vecs - eye).abs().max().item() <= 1e-12
    (grad,) = torch.autograd.grad(vals.sum(), a)
    # d(trace)/dA = I
    assert (grad - eye).abs().max().item() <= 1e-10


def test_densities_on_card_match_cpu(cuda):
    """``characteristic_fn`` (K1 on the card, its plain version on the
    CPU), ``gram_charlier`` and ``saddle_point`` on cuda tensors against
    the same calls on CPU tensors, on N=8 central mixture moments: the
    CF atol 1e-12 (the rules agree as measures); Gram–Charlier and the
    saddle point at its Newton start (``newton_iters=0``) rtol 1e-10 of
    each density's peak.  After 50 clipped Newton steps the saddle point
    is chaotic in the tails (a one-ulp change moves it), so there it is
    only held finite on the card."""
    from mfs_tpu_torch.one_dim.moments import characteristic_fn, sms_to_cumulants
    from mfs_tpu_torch.one_dim.pdf_approximations import gram_charlier, saddle_point
    N = 8
    cms = _central_mixture(N, 64, 3, "cpu")
    mean = torch.linspace(-0.5, 0.5, 64, dtype=torch.float64)
    scale = torch.sqrt(cms[:, 2])
    sms = cms / scale[:, None] ** torch.arange(2 * N)
    xs = torch.linspace(-4.0, 4.0, 801, dtype=torch.float64)
    zs = torch.linspace(-8.0, 8.0, 161, dtype=torch.float64)
    out = {}
    for dev in ("cpu", cuda):
        c, m, s, sm, x, z = (t.to(dev) for t in (cms, mean, scale, sms, xs, zs))
        before = _k1()
        cf = characteristic_fn(z, c, m)
        launched = _k1() - before
        gc = gram_charlier(sms_to_cumulants(sm, m, s))(x)
        sp0 = saddle_point(sm, m, s, newton_iters=0)(x)
        sp = saddle_point(sm, m, s)(x)
        out[str(dev)] = [t.cpu() for t in (cf, gc, sp0, sp)] + [launched]
    assert out["cuda"][4] == 1 and out["cpu"][4] == 0
    assert bool(torch.isfinite(out["cuda"][3]).all())
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-12
    for card, host in zip(out["cuda"][1:3], out["cpu"][1:3]):
        peak = host.abs().amax(-1, keepdim=True)
        assert ((card - host).abs() <= 1e-10 * peak).all()


def test_fit_mle_batched_on_card_matches_cpu(cuda):
    """``fit_mle_batched`` (per-trial L-BFGS, ``torch.func.vmap``'d
    objective) on cuda tensors against the same call on CPU tensors: a
    per-trial Gaussian MLE of 64 trials, gtol 1e-8, 100 steps.  The
    parameters agree within 1e-7 with each other and with the closed
    form; every trial converges on the CPU, and a trial the card does not
    flag converged has run all 100 steps.  (Within ~1e-9 of the optimum
    the objective, ~50, changes by less than its rounding, so the Armijo
    search accepts or refuses steps by rounding, and an iterate can
    wander there without its gradient meeting gtol, as on an H100.)"""
    from mfs_tpu_torch.estimation import fit_mle_batched
    rng = np.random.RandomState(4)
    data = torch.as_tensor(rng.randn(64, 50) * np.linspace(0.5, 2.0, 64)[:, None]
                           + np.linspace(-1, 1, 64)[:, None])

    def nell(q, y):
        return torch.sum(0.5 * ((y - q[0]) / torch.exp(q[1])) ** 2 + q[1])

    out = {}
    for dev in ("cpu", cuda):
        P, info = fit_mle_batched(nell, torch.zeros(64, 2, dtype=torch.float64, device=dev),
                                  data.to(dev), max_steps=100, gtol=1e-8)
        assert P.device.type == torch.device(dev).type
        assert bool((info["converged"] | (info["steps"] == 100)).all())
        assert bool(info["converged"].all()) or dev != "cpu"
        out[str(dev)] = P.cpu()
    closed = torch.stack([data.mean(1), torch.log(data.std(1, unbiased=False))], dim=1)
    assert (out["cuda"] - out["cpu"]).abs().max().item() <= 1e-7
    assert (out["cuda"] - closed).abs().max().item() <= 1e-7


def test_count_flops_counts_k1_launches(cuda):
    """``count_flops`` of a Beneš–Bernoulli N=15 pass on the card (T=3,
    B=512): K1 launches 2T times, and its breakdown key is launches x B
    x ``k1_flops(15)``; the glue's aten ops are counted beside it."""
    from mfs_tpu_torch.ops.flops import count_flops, k1_flops
    N, B, T = 15, 512, 3
    model = benes_bernoulli(N=N, device=cuda)
    trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
    ic = model.init_cond
    ys = torch.ones((T, B), dtype=torch.float64, device=cuda)
    before = _k1()
    r = count_flops(lambda: moment_filter_cms(
        trans.cms, trans.mean, model.measurement_cond_pdf, ic.cms.expand(B, 2 * N),
        ic.mean.expand(B), ys, eigh_impl="fused"))
    launches = _k1() - before
    assert launches == 2 * T
    assert r["breakdown"]["kernel[quadrature_1d][float64]"] == launches * B * k1_flops(N)[0]
    assert r["f64"] > r["breakdown"]["kernel[quadrature_1d][float64]"]
    assert not r["lower_bounds"]


def test_trial_mesh_cuda_raises_without_a_gpu(cuda):
    """With the GPU hidden (``CUDA_VISIBLE_DEVICES=""``), asking for a
    CUDA mesh raises instead of returning a CPU mesh."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, "-c", "from mfs_tpu_torch.parallel import trial_mesh; "
         "trial_mesh(device_type='cuda')"],
        cwd=root, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and "needs a GPU" in p.stderr


# ---------------------------------------------------------------------------
# The 3D food chain (d = 3) and the scaled-moment filters on the card
# ---------------------------------------------------------------------------

from mfs_tpu_torch.models.multi_dims import lotka_volterra_3d  # noqa: E402
from mfs_tpu_torch.multi_dims.filtering import moment_filter_nd_scms  # noqa: E402
from mfs_tpu_torch.one_dim.filtering import moment_filter_scms  # noqa: E402


@pytest.mark.parametrize("N, kernels", [(3, ("nd_eigh",)),
                                        (4, ("nd_ldl", "nd_ksolve"))])
def test_lv3d_filter_on_card_matches_cpu_plain_path(cuda, N, kernels):
    """The 3D food chain's central filter, poly TME-2, B = 8, T = 5,
    through K2 at d = 3, s = 10 (N=3, 1,000 nodes a trial) or nd_ldl +
    nd_ksolve + cuSOLVER eigh at d = 3, s = 20 (N=4, 8,000 nodes) on the
    card vs the same filter on the CPU (plain versions): nell rtol 1e-10,
    as the 2D filter's test, each of the route's kernels launched once a
    quadrature and no other."""
    B, T = 8, 5
    mis = nd_mi.generate_graded_lexico_multi_indices(3, 2 * N - 1)
    inds = nd_mi.gram_and_hankel_indices_graded_lexico(N, 3)
    ys = np.random.RandomState(N).binomial(1, 0.5, (T, B, 1)).astype(np.float64)
    nells = {}
    for dev in ("cpu", "cuda"):
        model = lotka_volterra_3d(mis, device=dev)
        poly = poly_tme_nd(model.drift, model.dispersion, model.dt, 2, mis, 2, 1, device=dev)
        ic = model.init_cond
        before = _launches()
        _, _, nell = moment_filter_nd_cms(
            poly.cms, poly.mean, model.measurement_cond_pdf, torch.as_tensor(ys, device=dev),
            (mis, inds), ic.cms.expand(B, -1), ic.mean.expand(B, 3),
            eigh_impl="auto" if dev == "cuda" else "fused", predict_fn=poly.predict_cms)
        nells[dev] = nell.cpu()
        ran = {k: v - before[k] for k, v in _launches().items()}
        assert ran == {k: 2 * T if dev == "cuda" and k in kernels else 0 for k in _COUNTERS}
    assert bool(torch.isfinite(nells["cuda"]).all())
    np.testing.assert_allclose(nells["cuda"].numpy(), nells["cpu"].numpy(), rtol=1e-10)


@pytest.mark.parametrize("d, N, kernels", [(1, 4, ()), (2, 3, ("nd_eigh",)),
                                           (2, 5, ("nd_ldl", "nd_ksolve"))])
def test_scms_filters_on_card_match_cpu_plain_path(cuda, d, N, kernels):
    """The scaled-central filters on the card vs the same filters on the
    CPU (plain versions), B = 8: Beneš N=4, T=20, TME-2 Normal closure,
    through K1 (d = 1); prey–predator N=3 (K2, s = 6) and N=5 (nd_ldl +
    nd_ksolve + cuSOLVER eigh, s = 15), T=20, poly TME-2's
    ``predict_scms`` (d = 2).  nell and the scales rtol 1e-10, as the
    central filters' tests; each of the route's kernels launched once a
    quadrature and no other."""
    B, T = 8, 20
    rng = np.random.RandomState(10 + N)
    shape = (T, B) if d == 1 else (T, B, 1)
    ys = rng.binomial(1, 0.5, shape).astype(np.float64)
    outs = {}
    for dev in ("cpu", "cuda"):
        y = torch.as_tensor(ys, device=dev)
        k1_before, before = _k1(), _launches()
        if d == 1:
            model = benes_bernoulli(N=N, device=dev)
            trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
            ic = model.init_cond
            _, _, scales, nell = moment_filter_scms(
                trans.scms, trans.mean_var, model.measurement_cond_pdf,
                ic.scms.expand(B, 2 * N), ic.mean.expand(B), torch.sqrt(ic.variance).expand(B),
                y, eigh_impl="fused")
            assert _k1() - k1_before == (2 * T if dev == "cuda" else 0)
        else:
            mis = nd_mi.generate_graded_lexico_multi_indices(2, 2 * N - 1)
            inds = nd_mi.gram_and_hankel_indices_graded_lexico(N, 2)
            model = prey_predator(mis, device=dev)
            poly = poly_tme_nd(model.drift, model.dispersion, model.dt, 2, mis, 2, 1, device=dev)
            ic = model.init_cond
            scale0 = torch.sqrt(torch.diagonal(ic.cov))
            _, _, scales, nell = moment_filter_nd_scms(
                poly.scms, poly.mean_var, model.measurement_cond_pdf, y, (mis, inds),
                (ic.cms / monomials_nd(scale0, mis)).expand(B, -1), ic.mean.expand(B, 2),
                scale0.expand(B, 2), eigh_impl="auto" if dev == "cuda" else "fused",
                predict_fn=poly.predict_scms)
        ran = {k: v - before[k] for k, v in _launches().items()}
        assert ran == {k: 2 * T if dev == "cuda" and k in kernels else 0 for k in _COUNTERS}
        outs[dev] = (nell.cpu(), scales.cpu())
    assert bool(torch.isfinite(outs["cuda"][0]).all())
    for got, want in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)
