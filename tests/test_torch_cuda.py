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
from mfs_tpu_torch.ops import quadrature_kernel as qk  # noqa: E402
from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme_normal  # noqa: E402
from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all  # noqa: E402

pytestmark = pytest.mark.cuda


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
    before = qk.LAUNCHES
    for jitter in (0.0, 1e-8):
        w, x = qk.moment_quadrature_fused(ms, mean, scale, jitter)
        torch.cuda.synchronize()
        wp, xp = qk.moment_quadrature_fused_plain(ms, mean, scale, jitter)
        assert w.device.type == "cuda" and w.shape == (513, N)
        assert (x - xp).abs().max().item() < tol_x
        assert (w - wp).abs().max().item() < tol_w
    assert qk.LAUNCHES == before + 2


def test_kernel_raises_instead_of_falling_back(cuda):
    before = qk.LAUNCHES
    with pytest.raises(ValueError):
        qk.moment_quadrature_fused(torch.ones(4, 66, dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        qk.moment_quadrature_fused(_mixture(3, 4, 0, cuda).float())
    with pytest.raises(NotImplementedError):
        qk.moment_quadrature_fused(_mixture(3, 4, 0, cuda).requires_grad_(True))
    assert qk.LAUNCHES == before


def test_filter_on_card_matches_cpu_plain_path(cuda):
    """Beneš N=4, B=8, T=20 central filter through K1 on the card vs the
    same filter on the CPU (plain version): nell rtol 1e-10, and every
    quadrature of the card run is one K1 launch."""
    N, B = 4, 8
    rng = np.random.RandomState(0)
    ys = rng.binomial(1, 0.5, (20, B)).astype(np.float64)
    nells = {}
    for dev in ("cpu", "cuda"):
        model = benes_bernoulli(N=N, device=dev)
        trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
        ic = model.init_cond
        before = qk.LAUNCHES
        _, _, nell = moment_filter_cms(
            trans.cms, trans.mean, model.measurement_cond_pdf, ic.cms.expand(B, 2 * N),
            ic.mean.expand(B), torch.as_tensor(ys, device=dev), eigh_impl="auto")
        nells[dev] = nell.cpu()
        assert qk.LAUNCHES - before == (2 * 20 if dev == "cuda" else 0)
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
