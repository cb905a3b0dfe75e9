"""The 1D Bayes update (``mfs_tpu_torch/ops/posterior_kernel.py``) on the
CPU: its plain version against the update the 1D filters computed
inline, written out here; the gradient of the wrapper and of its
``autograd.Function`` (whose forward, the kernel's launch, is swapped
here for the plain version) against autograd through that formula; what
the wrapper refuses; and the three filters' use of it.  The CUDA kernel is held against the plain
version in ``tests/test_torch_cuda.py``.  Imports neither ``jax`` nor
``mfs_tpu``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mfs_tpu_torch.models.one_dim import benes_bernoulli  # noqa: E402
from mfs_tpu_torch.one_dim import filtering  # noqa: E402
from mfs_tpu_torch.ops import posterior_kernel as pk  # noqa: E402
from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme_normal  # noqa: E402

MODES = ("raw", "central", "scaled")


def _monomials(u, num):
    out = [torch.ones_like(u)]
    for _ in range(num - 1):
        out.append(out[-1] * u)
    return torch.stack(out, dim=-1)


def _inline_update(nodes, weights, pdf_vals, mode, num):
    """The update as ``moment_filter_rms`` / ``_cms`` / ``_scms`` wrote it
    inline before it moved into ``ops/posterior_kernel.py``."""
    if mode == "raw":
        pdf_y = torch.einsum("...n,...n->...", pdf_vals, weights)
        post = _monomials(nodes, num) * (pdf_vals * weights)[..., None]
        return torch.sum(post, dim=-2) / pdf_y[..., None], pdf_y
    wp = pdf_vals * weights
    pdf_y = torch.sum(wp, dim=-1)
    mean = torch.sum(nodes * wp, dim=-1) / pdf_y
    if mode == "central":
        post = _monomials(nodes - mean[..., None], num) * wp[..., None]
        return torch.sum(post, dim=-2) / pdf_y[..., None], mean, pdf_y
    centred = nodes - mean[..., None]
    scale = torch.sqrt(torch.sum(centred**2 * wp, dim=-1) / pdf_y)
    post = _monomials(centred / scale[..., None], num) * wp[..., None]
    return torch.sum(post, dim=-2) / pdf_y[..., None], mean, scale, pdf_y


def _rule(batch=(4, 3), n=5, seed=0):
    """Nodes, normalised weights and likelihood values (..., n); trial 1
    (in row-major order) has a NaN node, trial 5 a likelihood of zero
    everywhere."""
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(*batch, n) * 1.5 + 0.3)
    w = torch.as_tensor(rng.rand(*batch, n) + 0.1)
    w = w / w.sum(-1, keepdim=True)
    p = torch.as_tensor(rng.rand(*batch, n))
    x.view(-1, n)[1, 2] = float("nan")
    p.view(-1, n)[5] = 0.0
    return x, w, p


@pytest.mark.parametrize("mode", MODES)
def test_plain_version_is_the_filters_update(mode):
    """``posterior_moments_1d_plain``, and the wrapper on CPU tensors, give
    the inline update's outputs bit for bit, NaN and inf included, at 2n
    moments, at an odd count and beyond the kernel's block of 64; one
    rule broadcasts over the trials' likelihoods as it did."""
    x, w, p = _rule()
    for num in (10, 70, 7):
        want = _inline_update(x, w, p, mode, num)
        for got in (pk.posterior_moments_1d_plain(x, w, p, mode, num),
                    pk.posterior_moments_1d(x, w, p, mode, num)):
            assert len(got) == len(want) == {"raw": 2, "central": 3, "scaled": 4}[mode]
            for a, b in zip(got, want):
                assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    moments = got[0].view(-1, 7)
    assert torch.isnan(moments[1, 1:]).all() and torch.isnan(moments[5]).all()
    # one rule (an unbatched state) under each trial's likelihood
    want = _inline_update(x[2, 2], w[2, 2], p, mode, 10)
    got = pk.posterior_moments_1d(x[2, 2], w[2, 2], p, mode)
    assert all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)) for a, b in zip(got, want))
    assert got[0].shape == (4, 3, 10)


@pytest.mark.parametrize("mode", MODES)
def test_gradient_is_autograd_through_the_formula(mode, monkeypatch):
    """The gradient in nodes, weights and likelihood values, for random
    cotangents on every output, of the wrapper on CPU tensors and of the
    Function that runs the kernel on CUDA tensors (its launch replaced by
    the plain version), equals autograd's through the inline update; with
    only the weights requiring grad, the others get none."""
    monkeypatch.setattr(pk, "_posterior_cuda", pk.posterior_moments_1d_plain)
    x, w, p = _rule(batch=(10,), n=4, seed=1)
    x, w, p = x[6:], w[6:], p[6:]  # finite trials only
    rng = np.random.RandomState(2)
    outs = _inline_update(x, w, p, mode, 8)
    cots = [torch.as_tensor(rng.randn(*o.shape)) for o in outs]

    def grads(fn, wanted):
        leaves = [t.clone().requires_grad_(need) for t, need in zip((x, w, p), wanted)]
        loss = sum((o * c).sum() for o, c in zip(fn(*leaves, mode, 8), cots))
        need = [t for t in leaves if t.requires_grad]
        return torch.autograd.grad(loss, need)

    for wanted in ((True, True, True), (False, True, False)):
        want = grads(_inline_update, wanted)
        for fn in (pk.posterior_moments_1d, pk._Posterior.apply):
            got = grads(fn, wanted)
            assert len(got) == sum(wanted)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-14, atol=0.0)


def test_wrapper_refuses_what_it_does_not_take():
    """A dtype other than float64, an unknown mode, no nodes, no moments,
    shapes that do not broadcast, mixed devices, and a device that is
    neither the CPU nor CUDA."""
    x, w, p = _rule()
    with pytest.raises(TypeError, match="float64"):
        pk.posterior_moments_1d(x.float(), w, p, "central")
    with pytest.raises(TypeError, match="tensor"):
        pk.posterior_moments_1d(x, w, p.tolist(), "central")
    with pytest.raises(ValueError, match="mode"):
        pk.posterior_moments_1d(x, w, p, "cumulant")
    with pytest.raises(ValueError, match="moments"):
        pk.posterior_moments_1d(x[..., :0], w[..., :0], p[..., :0], "central")
    with pytest.raises(ValueError, match="moments"):
        pk.posterior_moments_1d(x, w, p, "raw", 0)
    with pytest.raises(RuntimeError):
        pk.posterior_moments_1d(x, w[..., :3], p, "central")
    with pytest.raises(ValueError, match="meta"):
        pk.posterior_moments_1d(x, w.to("meta"), p, "central")
    with pytest.raises(ValueError, match="no posterior update for device meta"):
        pk.posterior_moments_1d(x.to("meta"), w.to("meta"), p.to("meta"), "scaled")


def test_each_1d_loop_updates_through_the_wrapper(monkeypatch):
    """``moment_filter_rms`` / ``_cms`` / ``_scms`` call the wrapper once a
    step, in their mode and with their moment count, and their nell is
    ``-sum log pdf_y`` of its evidence."""
    N, T, B = 3, 4, 5
    model = benes_bernoulli(N=N, device="cpu")
    trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
    ic, pdf = model.init_cond, model.measurement_cond_pdf
    ys = torch.as_tensor(np.random.RandomState(3).binomial(1, 0.5, (T, B)).astype(np.float64))
    seen = []

    def spy(nodes, weights, pdf_vals, mode, num_moments=None):
        out = pk.posterior_moments_1d(nodes, weights, pdf_vals, mode, num_moments)
        seen.append((mode, num_moments, out[-1]))
        return out

    monkeypatch.setattr(filtering, "posterior_moments_1d", spy)
    quad = dict(eigh_impl="refined")
    runs = {
        "raw": lambda: filtering.moment_filter_rms(trans.rms, pdf, ic.rms.expand(B, 2 * N), ys,
                                                   **quad),
        "central": lambda: filtering.moment_filter_cms(
            trans.cms, trans.mean, pdf, ic.cms.expand(B, 2 * N), ic.mean.expand(B), ys, **quad),
        "scaled": lambda: filtering.moment_filter_scms(
            trans.scms, trans.mean_var, pdf, ic.scms.expand(B, 2 * N), ic.mean.expand(B),
            torch.sqrt(ic.variance).expand(B), ys, **quad),
    }
    for mode, run in runs.items():
        seen.clear()
        nell = run()[-1]
        assert [(m, k) for m, k, _ in seen] == [(mode, 2 * N)] * T
        torch.testing.assert_close(nell, -sum(torch.log(e) for _, _, e in seen),
                                   rtol=1e-15, atol=0.0)
        assert bool(torch.isfinite(nell).all())
