"""Port vs JAX: FLOP accounting (``ops/flops.py``) and the profiling
helpers (``utils/profiling.py``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from mfs_tpu.models import benes_bernoulli as j_benes_bernoulli  # noqa: E402
from mfs_tpu.one_dim.filtering import moment_filter_cms as j_filter_cms  # noqa: E402
from mfs_tpu.ops.flops import count_flops as j_count_flops  # noqa: E402
from mfs_tpu.sde import sde_cond_moments_tme_normal as j_tme_normal  # noqa: E402
from mfs_tpu_torch.models import benes_bernoulli  # noqa: E402
from mfs_tpu_torch.one_dim.filtering import moment_filter_cms  # noqa: E402
from mfs_tpu_torch.ops import flops  # noqa: E402
from mfs_tpu_torch.ops.flops import count_flops  # noqa: E402
from mfs_tpu_torch.sde import sde_cond_moments_tme_normal  # noqa: E402
from mfs_tpu_torch.utils import timed, trace  # noqa: E402


def test_count_flops_unit_cases_equal_jax():
    """JAX's two unit cases (``tests/test_ops_aux.py``): a (4, 8) x (8, 16)
    product and ten steps of ``c * 2 + 1`` on 5 elements (a ``scan`` in
    JAX, a Python loop here): the totals equal JAX's exactly."""
    f64 = dict(dtype=torch.float64)
    r = count_flops(lambda a, b: a @ b, torch.ones(4, 8, **f64), torch.ones(8, 16, **f64))
    want = j_count_flops(lambda a, b: a @ b, jnp.ones((4, 8)), jnp.ones((8, 16)))
    assert r["total"] == want["total"] == 2 * 4 * 16 * 8
    assert r["breakdown"] == want["breakdown"] == {"dot_general[float64]": 1024.0}

    def g(x):
        for _ in range(10):
            x = x * 2.0 + 1.0
        return x

    r = count_flops(g, torch.ones(5, **f64))
    want = j_count_flops(lambda x: jax.lax.scan(
        lambda c, _: (c * 2.0 + 1.0, None), x, None, length=10)[0], jnp.ones(5))
    assert r["total"] == want["total"] == 100
    assert r["breakdown"] == want["breakdown"]
    assert not r["unknown_primitives"] and not want["unknown_primitives"]


N_FILTER, B_FILTER = 4, 8


def _port_count(T):
    """The port's count of the Beneš–Bernoulli N=4 central filter (TME-2),
    B=8, T steps, through the fused quadrature."""
    N, B = N_FILTER, B_FILTER
    model = benes_bernoulli(N=N, device="cpu")
    trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
    ic = model.init_cond
    return count_flops(
        lambda c0, m0, y: moment_filter_cms(trans.cms, trans.mean, model.measurement_cond_pdf,
                                            c0, m0, y, eigh_impl="pallas"),
        ic.cms.expand(B, 2 * N), ic.mean * torch.ones(B, dtype=torch.float64),
        torch.zeros(T, B, dtype=torch.float64))


def _jax_count(T):
    """JAX's count of the same filter through its "pallas" route."""
    N, B = N_FILTER, B_FILTER
    jm = j_benes_bernoulli(N=N)
    jt = j_tme_normal(jm.drift, jm.dispersion, jm.dt, 2, N)
    jic = jm.init_cond
    return j_count_flops(
        lambda c0, m0, y: j_filter_cms(jt.cms, jt.mean, jm.measurement_cond_pdf, c0, m0, y,
                                       eigh_impl="pallas"),
        jnp.broadcast_to(jic.cms, (B, 2 * N)), jic.mean * jnp.ones(B), jnp.zeros((T, B)))


def test_count_flops_filter_against_jax():
    """The 1D filter at N=4, B=8 over T=3 and 2T steps (JAX's
    ``test_count_flops_enters_filter_step``): no unknown op, and the total
    doubles with T (rtol 1e-6).

    Against JAX's count of the same filter: the filter's matrix products
    and reductions are the same program, so ``dot_general[float64]`` and
    ``reduce[float64]`` are equal exactly.  The totals are not: JAX counts
    its kernel body as f32 (the double-f32 ladder over a 512-lane block),
    the port its plain version in f64.  So the port's f64 count must lie
    above JAX's f64 count (the glue alone) and below JAX's total, and
    within 25% of JAX's f64 glue plus 2T x B x ``k1_flops(4)``: the plain
    version does 1.2-1.3x the kernel's analytic count (it runs every row
    of its (n, B) tensors with masks), and JAX's glue adds the f64 <->
    double-f32 splits; measured -7.5%."""
    port, port2, ref = _port_count(3), _port_count(6), _jax_count(3)
    assert not port["unknown_primitives"] and not port2["unknown_primitives"]
    np.testing.assert_allclose(port2["total"], 2 * port["total"], rtol=1e-6)
    for key in ("dot_general[float64]", "reduce[float64]"):
        assert port["breakdown"][key] == ref["breakdown"][key] > 0
    assert ref["f64"] < port["f64"] < ref["total"]
    analytic = ref["f64"] + 2 * 3 * 8 * flops.k1_flops(4)[0]
    np.testing.assert_allclose(port["f64"], analytic, rtol=0.25)
    assert port["f32"] == 0 and not port["lower_bounds"]


def test_kernel_counts_moved_from_chip_smoke():
    """The kernels' analytic counts live in ``ops/flops.py`` and the smoke
    run imports them; they still give PERF.md's figures."""
    assert chip_smoke.k1_flops is flops.k1_flops and chip_smoke.k2_flops is flops.k2_flops
    assert chip_smoke.ldl_flops is flops.ldl_flops
    assert chip_smoke.ksolve_flops is flops.ksolve_flops
    assert [flops.k1_flops(n)[0] for n in (15, 8, 4)] == [40_709, 11_463, 2_891]


def test_kernel_launch_accounting():
    """A wrapper's ``kernel_launch`` adds per-trial operations x B to every
    open count and nothing outside one; K2's launches are flagged as a
    lower bound (one sweep a dimension)."""
    flops.kernel_launch("quadrature_1d", 4096, lambda: 1 / 0)  # no count open: not called

    def launches():
        flops.kernel_launch("quadrature_1d", 4096, lambda: flops.k1_flops(15)[0])
        inner = count_flops(lambda: flops.kernel_launch("nd_ldl", 1024,
                                                        lambda: flops.ldl_flops(28)))
        flops.kernel_launch("nd_eigh", 1024, lambda: flops.k2_flops(6, 2, [1, 1]),
                            lower_bound=True)
        return inner

    outer = {}
    outer.update(count_flops(lambda: outer.setdefault("inner", launches())))
    bd = outer["breakdown"]
    assert bd["kernel[quadrature_1d][float64]"] == 4096 * 40_709
    assert bd["kernel[nd_ldl][float64]"] == 1024 * flops.ldl_flops(28)
    assert bd["kernel[nd_eigh][float64]"] == 1024 * flops.k2_flops(6, 2, [1, 1])
    assert outer["lower_bounds"] == ["kernel[nd_eigh][float64]"]
    assert outer["f64"] == outer["total"] == sum(bd.values())
    assert outer["inner"]["breakdown"] == {"kernel[nd_ldl][float64]": 1024 * flops.ldl_flops(28)}
    assert not flops._OPEN


def test_timed_and_trace_on_the_cpu(tmp_path):
    """``timed`` returns the best of ``reps`` walls and the last outputs;
    ``trace`` writes a Chrome trace that names the ops it saw."""
    calls = []

    def fn(x):
        calls.append(1)
        return torch.linalg.matrix_exp(x)

    x = torch.eye(8, dtype=torch.float64)
    best, out = timed(fn, x, reps=2)
    assert len(calls) == 3 and 0 < best < 10 and torch.equal(out, torch.linalg.matrix_exp(x))
    best, _ = timed(fn, x, reps=1, warmup=False)
    assert len(calls) == 4
    with trace(str(tmp_path / "trace")) as log_dir:
        torch.linalg.matrix_exp(x)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert log_dir == str(tmp_path / "trace")
    assert any("matrix_exp" in e.get("name", "") for e in events)
