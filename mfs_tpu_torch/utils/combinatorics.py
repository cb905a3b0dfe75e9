"""Combinatorial polynomials (port of ``mfs_tpu/utils/combinatorics.py``).

The orders are Python integers; the numeric inputs may be tensors with
leading batch axes.  The Bell-polynomial dynamic programme indexes the
last axis (``xs[..., i - 1]``), so one programme serves every trial and
the number of tensor operations does not grow with the batch.
``_bell_table`` returns the whole triangle B_{m, j}, m <= n, j <= k: it
is the table ``partial_bell(n, k, ...)`` fills on its way, so reading
every B_{m, j} from it gives the values a separate call per (m, j)
would, with one programme instead of one per entry.
"""
import math
from functools import lru_cache
from typing import Callable, List, Sequence, Union

import numpy as np
import torch

from mfs_tpu_torch.typings import Array, FloatScalar

Entries = Union[Array, Sequence]


def gamma(x) -> Array:
    """Continuous gamma function via ``lgamma`` (positive arguments)."""
    return torch.exp(torch.lgamma(torch.as_tensor(x, dtype=torch.float64)))


def factorial(n) -> Array:
    """Continuous factorial ``gamma(n + 1)``."""
    return gamma(torch.as_tensor(n, dtype=torch.float64) + 1.0)


def binom(n, k) -> Array:
    """Continuous binomial coefficient."""
    return factorial(n) / (factorial(k) * factorial(n - k))


def vmap_list_of_funcs(funcs: Sequence[Callable]) -> Callable:
    """``z(x) = stack([f(x) for f in funcs])``: the calls stacked on a new
    leading axis, in order (JAX: ``lax.switch`` under ``vmap``)."""

    def stacked(x):
        return torch.stack([torch.as_tensor(f(x)) for f in funcs])

    return stacked


@lru_cache(maxsize=None)
def _pascal_np(s: int) -> np.ndarray:
    """Lower-triangular Pascal matrix ``P[n, j] = C(n, j)`` of size s."""
    p = np.zeros((s, s), dtype=np.float64)
    p[:, 0] = 1.0
    for n in range(1, s):
        for j in range(1, n + 1):
            p[n, j] = p[n - 1, j - 1] + p[n - 1, j]
    return p


def pascal_lower(s: int) -> np.ndarray:
    """Binomial-coefficient matrix, a NumPy constant."""
    return _pascal_np(s)


def _entry(xs: Entries, i: int):
    return xs[..., i] if torch.is_tensor(xs) else xs[i]


def _length(xs: Entries) -> int:
    return xs.shape[-1] if torch.is_tensor(xs) else len(xs)


def _bell_table(n: int, k: int, xs: Entries) -> List[List]:
    """``table[m][j] = B_{m, j}(x_1, ...)`` for m <= n, j <= k, by the
    recurrence

        B_{m,j} = sum_{i=1}^{m-j+1} C(m-1, i-1) x_i B_{m-i, j-1}

    in the JAX package's order of operations.  Entries outside
    j <= m stay the Python float 0.0, and terms multiplying such a
    structural zero are skipped, as there.  ``xs`` is 1-indexed in the
    mathematical convention (``xs[..., 0]`` is x_1); missing x's count
    as zero."""
    length = _length(xs)
    table = [[0.0] * (k + 1) for _ in range(n + 1)]
    table[0][0] = 1.0
    for j in range(1, k + 1):
        for m in range(j, n + 1):
            acc = 0.0
            for i in range(1, m - j + 2):
                if i - 1 >= length:
                    break
                prev = table[m - i][j - 1]
                if isinstance(prev, float) and prev == 0.0:
                    continue
                acc = acc + math.comb(m - 1, i - 1) * _entry(xs, i - 1) * prev
            table[m][j] = acc
    return table


def partial_bell(n: int, k: int, xs: Entries) -> FloatScalar:
    """Partial Bell polynomial ``B_{n,k}(x_1, ..., x_{n-k+1})``.

    ``xs`` is a tensor ``(..., L)`` (batched over its leading axes) or a
    sequence of scalars or tensors; ``xs[..., 0]`` is x_1."""
    if n == 0 and k == 0:
        return 1.0
    if n == 0 or k == 0 or k > n:
        return 0.0
    return _bell_table(n, k, xs)[n][k]


def complete_bell(n: int, xs: Entries) -> FloatScalar:
    """Complete Bell polynomial ``B_n = sum_k B_{n,k}``."""
    if n == 0:
        return 1.0
    row = _bell_table(n, n, xs)[n]
    return sum(row[k] for k in range(1, n + 1))


def monomials(u: Array, num: int) -> Array:
    """[1, u, ..., u^{num-1}] on a new last axis, by the product chain
    u^j = u^(j-1) u."""
    out = [torch.ones_like(u)]
    for _ in range(num - 1):
        out.append(out[-1] * u)
    return torch.stack(out, dim=-1)


def hermite_probabilist(n: int, x: FloatScalar) -> FloatScalar:
    """Probabilists' Hermite polynomial He_n(x), three-term recurrence,
    elementwise."""
    if n == 0:
        return torch.ones_like(x) if torch.is_tensor(x) else 1.0
    h_prev, h = (1.0, x)
    for m in range(1, n):
        h_prev, h = h, x * h - m * h_prev
    return h


def hermite_probabilist_all(n_max: int, x: Array) -> Array:
    """He_0(x), ..., He_{n_max}(x) stacked on a new last axis:
    ``x.shape + (n_max + 1,)``."""
    x = torch.as_tensor(x, dtype=torch.float64)
    hs = [torch.ones_like(x)]
    if n_max >= 1:
        hs.append(x)
    for m in range(1, n_max):
        hs.append(x * hs[-1] - m * hs[-2])
    return torch.stack(hs, dim=-1)
