"""Port vs JAX: the K-builder pair ``nd_ldl`` + ``nd_ksolve``.

On the CPU ``nd_ldl_fused`` and ``nd_ksolve_fused`` run their plain
versions.  They are held against the five programs of the JAX package's
staged K-builder (``mfs_tpu/ops/pallas_quadrature_nd.py::
nd_k_pallas_staged``), run eagerly through the ``_ArrayRef`` shim (Pallas
interpret mode hangs XLA's CPU compiler on the ND kernels), stage by
stage: the single-program LDL (``_nd_ldl_kernel``); the equilibration
vector and the left-looking panels (``_nd_cvec_kernel`` then
``_nd_ldl_panel_kernel`` over 4-column panels, the split the JAX test
forces); the forward and transposed solves (``_nd_fsolve_kernel`` over
column chunks, ``_nd_tsolve_kernel`` over row chunks).  The pair is also
held against the monolithic K3 body (``_nd_k_kernel``) at the JAX
staged-vs-monolithic bound, atol 1e-12 (``tests/test_pallas_compiled.py``).

Inputs: raw moments of B=4 random 2D Gaussians at N=5 (s=15, z=45),
whose equilibrated Grams have condition numbers of 2e2-6e2, so the JAX
bodies' double-f32 arithmetic (~2^-45 a step) agrees with f64 to ~1e-13.
The CUDA kernels are held against these plain versions on a GPU
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mfs_tpu.ops.doublefloat as dfm  # noqa: E402
import mfs_tpu.ops.pallas_quadrature_nd as j_pqnd  # noqa: E402
from mfs_tpu.multi_dims.moments import raw_moments_mvn_kan_all as j_kan_all  # noqa: E402
from mfs_tpu_torch.multi_dims import multi_indices  # noqa: E402
from mfs_tpu_torch.ops import quadrature_nd_kernel as qnd  # noqa: E402

N, D, B = 5, 2, 4
CHUNK = 4  # columns per LDL panel and per solve chunk
Ref = j_pqnd._ArrayRef


def _moments(N_, d, B_, seed):
    """Raw moments of B random Gaussians (numpy, through the JAX tables)."""
    rng = np.random.RandomState(seed)
    mis = multi_indices.generate_graded_lexico_multi_indices(d, 2 * N_ - 1)
    mean = 0.3 * rng.randn(B_, d)
    a = rng.randn(B_, d, d)
    cov = np.einsum("bij,bkj->bik", a, a) * 0.1 + 0.5 * np.eye(d)
    ms = np.array(j_kan_all(jnp.asarray(mean), jnp.asarray(cov), mis))
    return ms, multi_indices.gram_and_hankel_indices_graded_lexico(N_, d)


def _f64(hi, lo):
    return np.asarray(dfm.to_f64(dfm.DF(hi, lo)))


def _trial_major(flat):
    """(n, B) lane layout -> (B, n)."""
    return np.ascontiguousarray(flat.T)


def _col_major(flat, s):
    """(s*s, B) flat column-major (column j at rows j*s..j*s+s-1) -> (B, s, s)."""
    return _trial_major(flat).reshape(-1, s, s).transpose(0, 2, 1)


class _Jax:
    """The staged builder's programs on one set of inputs, eagerly."""

    def __init__(self, ms, inds):
        self.d, self.s = inds.shape[0] - 1, inds.shape[1]
        self.z = ms.shape[-1]
        df = dfm.from_f64(jnp.asarray(ms).T)
        self.hi, self.lo = df.hi.astype(jnp.float32), df.lo.astype(jnp.float32)
        key = tuple(int(v) for v in np.asarray(inds, np.int64).reshape(-1))
        self.oh = j_pqnd._nd_onehots(key, self.d, self.s, self.z)

    def refs(self, *shapes):
        return [Ref(shape=(n, B)) for n in shapes]

    @functools.cached_property
    def ldl_single(self):
        """K4: (L, c, 1/scale) as DF ref values."""
        s = self.s
        outs = self.refs(s * s, s * s, s, s, s, s)
        j_pqnd._nd_ldl_kernel(s, Ref(self.hi), Ref(self.lo), Ref(jnp.asarray(self.oh[0])), *outs)
        return [o.value for o in outs]

    def ldl_panelled(self):
        """K5, then K6 over CHUNK-column panels: (L, d, c, 1/scale)."""
        s, z = self.s, self.z
        ohdiag = self.oh[0].reshape(s, s, z)[np.arange(s), np.arange(s)]
        c = self.refs(s, s)
        j_pqnd._nd_cvec_kernel(s, Ref(self.hi), Ref(self.lo), Ref(jnp.asarray(ohdiag)), *c)
        c_h, c_l = c[0].value, c[1].value
        parts = {k: [] for k in ("lh", "ll", "dh", "dl", "ih", "il")}
        for j0 in range(0, s, CHUNK):
            j1 = min(s, j0 + CHUNK)
            zl = jnp.zeros((s * s - j0 * s, B), jnp.float32)
            zd = jnp.zeros((s - j0, B), jnp.float32)
            prev = [jnp.concatenate(parts[k] + [zl], 0) for k in ("lh", "ll")] + \
                [jnp.concatenate(parts[k] + [zd], 0) for k in ("dh", "dl")]
            outs = self.refs(*([(j1 - j0) * s] * 2 + [j1 - j0] * 4))
            j_pqnd._nd_ldl_panel_kernel(
                s, j0, j1, Ref(self.hi), Ref(self.lo), Ref(jnp.asarray(self.oh[0][j0 * s:j1 * s])),
                Ref(c_h), Ref(c_l), *[Ref(p) for p in prev], *outs)
            for k, o in zip(("lh", "ll", "dh", "dl", "ih", "il"), outs):
                parts[k].append(o.value)
        cat = {k: jnp.concatenate(v, 0) for k, v in parts.items()}
        return cat["lh"], cat["ll"], cat["dh"], cat["dl"], c_h, c_l, cat["ih"], cat["il"]

    def solves(self, l_h, l_l, c_h, c_l, i_h, i_l):
        """K7 over CHUNK-column chunks, then K8 over CHUNK-row chunks, per
        dimension: W (B, d, s, s) and the unsymmetrised K (B, d, s, s)."""
        s = self.s
        Ws, Ks = [], []
        for m in range(self.d):
            w_parts = []
            for c0 in range(0, s, CHUNK):
                c1 = min(s, c0 + CHUNK)
                outs = self.refs((c1 - c0) * s, (c1 - c0) * s)
                j_pqnd._nd_fsolve_kernel(
                    s, c0, c1, Ref(self.hi), Ref(self.lo),
                    Ref(jnp.asarray(self.oh[m + 1][c0 * s:c1 * s])),
                    Ref(l_h), Ref(l_l), Ref(c_h), Ref(c_l), *outs)
                w_parts.append(outs)
            w_h = jnp.concatenate([p[0].value for p in w_parts], 0)
            w_l = jnp.concatenate([p[1].value for p in w_parts], 0)
            k_parts = []
            for i0 in range(0, s, CHUNK):
                i1 = min(s, i0 + CHUNK)
                outs = self.refs((i1 - i0) * s, (i1 - i0) * s)
                j_pqnd._nd_tsolve_kernel(s, i0, i1, Ref(w_h), Ref(w_l), Ref(l_h), Ref(l_l),
                                         Ref(i_h), Ref(i_l), *outs)
                k_parts.append(outs)
            k_flat = _f64(jnp.concatenate([p[0].value for p in k_parts], 0),
                          jnp.concatenate([p[1].value for p in k_parts], 0))
            Ws.append(_col_major(_f64(w_h, w_l), s))
            Ks.append(_trial_major(k_flat).reshape(-1, s, s))  # row i at rows i*s..
        return np.stack(Ws, 1), np.stack(Ks, 1)

    def k3(self):
        d, s = self.d, self.s
        outs = self.refs(d * s * s, d * s * s)
        j_pqnd._nd_k_kernel(d, s, Ref(jnp.asarray(self.oh.reshape(-1, self.z))), Ref(self.hi),
                            Ref(self.lo), *outs)
        K = _trial_major(_f64(outs[0].value, outs[1].value)).reshape(-1, d, s, s)
        return 0.5 * (K + np.swapaxes(K, -1, -2))


@pytest.fixture(scope="module")
def case():
    ms, inds = _moments(N, D, B, seed=0)
    return ms, inds, _Jax(ms, inds), qnd.nd_ldl_fused(torch.as_tensor(ms), inds)


def test_nd_ldl_plain_vs_single_program_ldl_body(case):
    """Lu atol 1e-12, c rtol 1e-13, 1/scale rtol 1e-11 against K4: the
    JAX body's double-f32 steps (~2^-45) through a Gram of condition
    <= 6e2."""
    _, inds, jx, (Lu, piv, c, isc) = case
    s = jx.s
    l_h, l_l, c_h, c_l, i_h, i_l = jx.ldl_single
    assert Lu.shape == (B, s, s) and piv.shape == c.shape == isc.shape == (B, s)
    np.testing.assert_allclose(Lu.numpy(), _col_major(_f64(l_h, l_l), s), rtol=0, atol=1e-12)
    np.testing.assert_allclose(c.numpy(), _trial_major(_f64(c_h, c_l)), rtol=1e-13)
    np.testing.assert_allclose(isc.numpy(), _trial_major(_f64(i_h, i_l)), rtol=1e-11)
    # the pivots are d_j = 1/(1/scale_j)^2 when no pivot was guarded
    np.testing.assert_allclose(piv.numpy(), 1.0 / isc.numpy() ** 2, rtol=1e-13)


def test_nd_ldl_plain_vs_cvec_and_panel_bodies(case):
    """The same bounds against K5 followed by K6 over 4-column panels;
    the panels' pivots d_j rtol 1e-11."""
    _, _, jx, (Lu, piv, c, isc) = case
    l_h, l_l, d_h, d_l, c_h, c_l, i_h, i_l = jx.ldl_panelled()
    np.testing.assert_allclose(Lu.numpy(), _col_major(_f64(l_h, l_l), jx.s), rtol=0, atol=1e-12)
    np.testing.assert_allclose(piv.numpy(), _trial_major(_f64(d_h, d_l)), rtol=1e-11)
    np.testing.assert_allclose(c.numpy(), _trial_major(_f64(c_h, c_l)), rtol=1e-13)
    np.testing.assert_allclose(isc.numpy(), _trial_major(_f64(i_h, i_l)), rtol=1e-11)


def test_nd_ksolve_plain_vs_fsolve_and_tsolve_bodies(case):
    """K7 over column chunks and K8 over row chunks, fed K4's factor,
    against the plain version fed its own: W = Lu^{-1} H' and the
    symmetrised K atol 1e-12."""
    ms, inds, jx, (Lu, _, c, isc) = case
    W, Kj = jx.solves(*jx.ldl_single)
    Kj = 0.5 * (Kj + np.swapaxes(Kj, -1, -2))
    idx = torch.as_tensor(inds[1:])
    W_port = qnd._unit_forward(Lu, qnd._scaled(c, torch.as_tensor(ms)[:, idx]))
    np.testing.assert_allclose(W_port.numpy(), W, rtol=0, atol=1e-12)
    K = qnd.nd_ksolve_fused(torch.as_tensor(ms), inds, Lu, c, isc)
    assert K.shape == (B, D, jx.s, jx.s)
    np.testing.assert_allclose(K.numpy(), Kj, rtol=0, atol=1e-12)


def test_pair_vs_monolithic_k3_body(case):
    """The pair's K against K3's JAX body at the JAX package's
    staged-vs-monolithic bound (atol 1e-12); on a CPU tensor
    ``nd_k_fused`` is ``nd_k_fused_plain``, the pair's plain versions
    chained."""
    ms, inds, jx, _ = case
    K = qnd.nd_k_fused(torch.as_tensor(ms), inds)
    np.testing.assert_allclose(K.numpy(), jx.k3(), rtol=0, atol=1e-12)
    assert torch.equal(K, qnd.nd_k_fused_plain(torch.as_tensor(ms), inds))


def test_pair_d3_vs_f64_library_k():
    """d=3, N=5 (s=35, past the TPU K3's 28): K against the f64 library K
    (Cholesky + two triangular solves), atol 1e-10 as for K3's body."""
    ms, inds = _moments(5, 3, 3, seed=7)
    t = torch.as_tensor(ms)
    K = qnd.nd_k_fused(t, inds)
    idx = torch.as_tensor(inds)
    R = torch.linalg.cholesky(t[:, idx[0]])[:, None]
    X = torch.linalg.solve_triangular(R, t[:, idx[1:]], upper=False)
    Kl = torch.linalg.solve_triangular(R.mT, X, upper=True, left=False)
    assert K.shape == (3, 3, 35, 35)
    np.testing.assert_allclose(K.numpy(), (0.5 * (Kl + Kl.mT)).numpy(), rtol=0, atol=1e-10)


def test_pair_batch_shape_and_nan_trial():
    """A (3, 5) batch equals its trials one by one; a trial with a NaN
    moment comes out NaN from both stages and the others stay finite."""
    ms, inds = _moments(N, D, 15, seed=3)
    t = torch.as_tensor(ms).reshape(3, 5, -1).clone()
    t[2, 4, 3] = float("nan")
    Lu, piv, c, isc = qnd.nd_ldl_fused(t, inds)
    K = qnd.nd_ksolve_fused(t, inds, Lu, c, isc)
    s = inds.shape[1]
    assert Lu.shape == (3, 5, s, s) and isc.shape == (3, 5, s) and K.shape == (3, 5, D, s, s)
    assert torch.equal(K[1, 2], qnd.nd_k_fused(t[1, 2], inds))
    assert bool(torch.isnan(isc[2, 4]).any() and torch.isnan(K[2, 4]).any())
    ok = torch.ones(3, 5, dtype=torch.bool)
    ok[2, 4] = False
    assert bool(torch.isfinite(K[ok]).all() and torch.isfinite(Lu[ok]).all())


def test_wrappers_refuse_what_they_do_not_take():
    """s = 120 > MAX_S_K (2D N=15), gradients, a wrongly shaped
    factor, a non-float64 input."""
    inds15 = multi_indices.gram_and_hankel_indices_graded_lexico(15, 2)
    big = torch.zeros(2, 465, dtype=torch.float64)
    assert inds15.shape[1] == qnd.MAX_S_K + 1
    for fn in (qnd.nd_ldl_fused, qnd.nd_k_fused, qnd.nd_ldl_plain):
        with pytest.raises(ValueError):
            fn(big, inds15)
    ms, inds = _moments(3, 2, 2, seed=5)
    t = torch.as_tensor(ms)
    with pytest.raises(NotImplementedError):
        qnd.nd_ldl_fused(t.clone().requires_grad_(True), inds)
    with pytest.raises(TypeError):
        qnd.nd_ldl_fused(t.float(), inds)
    Lu, _, c, isc = qnd.nd_ldl_fused(t, inds)
    with pytest.raises(ValueError):
        qnd.nd_ksolve_fused(t, inds, Lu[:, :-1], c, isc)
    with pytest.raises(TypeError):
        qnd.nd_ksolve_fused(t, inds, Lu.float(), c, isc)
