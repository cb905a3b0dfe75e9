"""The frozen work formulas against values worked out by hand."""
import pytest

from roofline import work


def test_k1_flops_at_n15():
    # the fused 1D quadrature's count at n = 15 (40,709 a trial, as
    # counted from the kernel's stages when it was written)
    assert work.k1_flops(15) == 40709


def test_ldl_and_ksolve_at_s6():
    # ldl: 2s + s(s+1) = 54, plus sum_j [3j + 3 + (5-j)(2j+1)] over
    # j = 0..5 = 8 + 18 + 24 + 26 + 24 + 18 = 118
    assert work.ldl_flops(6) == 54 + 118
    # ksolve, per dimension: 2 s^2 + s^2 (s-1) + (s-1) s (s+1) / 3 + 2 s (s+1)
    #   = 72 + 180 + 70 + 84 = 406
    assert work.ksolve_flops(6, 2) == 2 * 406


def test_ldl_and_ksolve_at_s28():
    # ldl: 56 + 812 = 868; sum_j (3j + 3) = 3 * 378 + 84 = 1218;
    # sum_j (27 - j)(2j + 1) = sum_k k (55 - 2k) = 55 * 378 - 2 * 6930 = 6930
    assert work.ldl_flops(28) == 868 + 1218 + 6930
    # ksolve: 1568 + 784 * 27 + 27 * 28 * 29 / 3 + 2 * 28 * 29 = 31668 per dimension
    assert work.ksolve_flops(28, 2) == 2 * 31668


def test_quadrature_work_at_the_cells_shapes():
    assert work.quadrature_1d_work(15, 1) == {"flops": 40709, "bytes": 62 * 8}
    # s = 28, d = 2, z = 105: ldl + ksolve + 2 * 9 * 28^3 + 2 * 28^3 + 4 * 784
    w = work.quadrature_nd_work(28, 2, 105, 1)
    assert w["flops"] == 9016 + 63336 + 395136 + 43904 + 3136
    assert w["bytes"] == (105 + 2 + 784 * 3) * 8
    w = work.quadrature_nd_work(6, 2, 21, 10)
    assert w["flops"] == 10 * (172 + 812 + 2 * 9 * 216 + 2 * 216 + 4 * 36)
    assert w["bytes"] == 10 * (21 + 2 + 36 * 3) * 8


@pytest.mark.parametrize("flops,nbytes,bound", [(67e12, 1.0, "flops"), (1.0, 3.35e12, "bytes")])
def test_least_time_takes_the_binding_peak(flops, nbytes, bound):
    assert work.least_seconds({"flops": flops, "bytes": nbytes}) == pytest.approx(1.0)
