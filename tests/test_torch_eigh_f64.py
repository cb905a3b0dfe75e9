"""The port's f64 eigh route (``ops/eigh.py::_eigh_f64``, behind
``eigh_xla``/``eigh_refined``): batches are cut into ``EIGH_CHUNK``
matrices a ``torch.linalg.eigh`` call, and a matrix that does not
converge comes back NaN and is counted instead of failing the batch (the
JAX package's LAPACK route marks such a matrix NaN).  CPU only; the card
test at 100,000 matrices is in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mfs_tpu_torch.one_dim.quadrature import moment_quadrature  # noqa: E402
from mfs_tpu_torch.ops import eigh as te  # noqa: E402
from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all  # noqa: E402
from mfs_tpu_torch.utils.profiling import counters  # noqa: E402

MARK = 12345.0  # a_00 of the matrix the fake solver refuses


def _symmetric(shape, n, seed):
    a = torch.as_tensor(np.random.RandomState(seed).randn(*shape, n, n))
    return a + a.mT


def _refusing_eigh(original):
    """torch.linalg.eigh that reports non-convergence for any batch
    holding a matrix with a_00 == MARK, as LAPACK and cuSOLVER word it."""
    def eigh(a, *args, **kwargs):
        if bool((a[..., 0, 0] == MARK).any()):
            raise torch.linalg.LinAlgError(
                "linalg.eigh: (Batch element 0): The algorithm failed to converge because "
                "the input matrix is ill-conditioned or has too many repeated eigenvalues "
                "(error code: 3).")
        return original(a, *args, **kwargs)
    return eigh


@pytest.mark.parametrize("chunk", [1, 4, 7])
def test_chunked_equals_one_call_bit_for_bit(chunk, monkeypatch):
    """(3, 5) batches of 6 x 6 matrices, one diverged (NaN) trial, through
    chunks of 1, 4 and 7 matrices: the same bits as one call."""
    a = _symmetric((3, 5), 6, seed=chunk)
    a[1, 2, 0, 0] = float("nan")
    vals0, vecs0 = te.eigh_xla(a)
    monkeypatch.setattr(te, "EIGH_CHUNK", chunk)
    vals, vecs = te.eigh_refined(a)
    assert vals.shape == (3, 5, 6) and vecs.shape == (3, 5, 6, 6)
    assert torch.equal(vals.nan_to_num(7.0), vals0.nan_to_num(7.0))
    assert torch.equal(vecs.nan_to_num(7.0), vecs0.nan_to_num(7.0))
    assert bool(torch.isnan(vals[1, 2]).all()) and int(torch.isnan(vals).any(-1).sum()) == 1


@pytest.mark.parametrize("chunk", [16_384, 5])
def test_nonconverged_matrix_masks_only_its_trial(chunk, monkeypatch):
    """A solver that refuses one matrix of 37: that trial's values and
    vectors are NaN, every other trial equals the unpatched call, and
    the counter ``eigh.nonconverged`` counts one."""
    a = _symmetric((37,), 5, seed=3)
    want_vals, want_vecs = te.eigh_xla(a)
    a[20, 0, 0] = MARK
    monkeypatch.setattr(te, "EIGH_CHUNK", chunk)
    monkeypatch.setattr(torch.linalg, "eigh", _refusing_eigh(torch.linalg.eigh))
    before = counters().get("eigh.nonconverged", 0)
    vals, vecs = te.eigh_xla(a)
    assert counters().get("eigh.nonconverged", 0) - before == 1
    bad = torch.isnan(vals).any(-1)
    assert bad.tolist() == [i == 20 for i in range(37)]
    assert bool(torch.isnan(vecs[20]).all())
    keep = ~bad
    assert torch.equal(vals[keep], want_vals[keep]) and torch.equal(vecs[keep], want_vecs[keep])


def test_other_solver_errors_raise(monkeypatch):
    """An error that is not a convergence failure (here cuSOLVER's refusal
    of an oversized batch, which torch also raises as LinAlgError) is
    not masked."""
    def refuse(a, *args, **kwargs):
        raise torch.linalg.LinAlgError("cusolver error: CUSOLVER_STATUS_INVALID_VALUE")
    monkeypatch.setattr(torch.linalg, "eigh", refuse)
    before = counters().get("eigh.nonconverged", 0)
    with pytest.raises(torch.linalg.LinAlgError, match="INVALID_VALUE"):
        te.eigh_xla(_symmetric((4,), 3, seed=0))
    assert counters().get("eigh.nonconverged", 0) == before


def test_masked_trial_leaves_the_quadrature_of_the_others(monkeypatch):
    """Through the "xla" quadrature route: the refused trial's rule is NaN
    (the rescue tiers' signal), the other trials' rules are unchanged."""
    N, B = 4, 9
    m = torch.linspace(-0.5, 0.5, B, dtype=torch.float64)
    rms = normal_raw_moments_all(m, torch.full_like(m, 0.7), 2 * N)
    w0, x0 = moment_quadrature(rms, eigh_impl="xla")
    refuse_trial = 6
    original = torch.linalg.eigh

    def eigh(a, *args, **kwargs):
        # the trial's K is recognisable by its first diagonal entry
        target = k00[refuse_trial]
        if bool((a[..., 0, 0] == target).any()):
            raise torch.linalg.LinAlgError("linalg.eigh: The algorithm failed to converge")
        return original(a, *args, **kwargs)

    captured = {}

    def capture(a, *args, **kwargs):
        captured["k00"] = a[..., 0, 0].clone()
        return original(a, *args, **kwargs)
    monkeypatch.setattr(torch.linalg, "eigh", capture)
    moment_quadrature(rms, eigh_impl="xla")
    k00 = captured["k00"]
    monkeypatch.setattr(torch.linalg, "eigh", eigh)
    w, x = moment_quadrature(rms, eigh_impl="xla")
    bad = torch.isnan(w).any(-1) | torch.isnan(x).any(-1)
    assert bad.tolist() == [i == refuse_trial for i in range(B)]
    assert torch.equal(w[~bad], w0[~bad]) and torch.equal(x[~bad], x0[~bad])
