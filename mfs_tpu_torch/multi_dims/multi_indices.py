"""Graded lexicographic multi-indices (port of ``mfs_tpu/multi_dims/multi_indices.py``).

Multi-indices order the moments of a d-dimensional random variable:
``ms[rank(k)] = E[X_1^{k_1} ... X_d^{k_d}]``, ranked in *graded
lexicographic* order: by total degree |k| first, then
lexicographically within a grade.

NumPy only.  The tables built here are constants of a filter (index
matrices for the Gram and multiplication-matrix gathers); callers move
them to their device once.  The port keeps its own copy of this module,
so that it needs nothing of the JAX package; the tests hold the tables
equal to the JAX package's.
"""
import math
from functools import lru_cache
from typing import Sequence

import numpy as np


def sizeof_multi_indices(d: int, upper_sum: int, lower_sum: int = 0) -> int:
    """Cardinality of {k in Z_{>=0}^d : lower_sum <= |k| <= upper_sum}."""
    if upper_sum < lower_sum:
        return 0
    total = math.comb(upper_sum + d, d)
    below = math.comb(lower_sum - 1 + d, d) if lower_sum > 0 else 0
    return total - below


def _grade(d: int, total: int):
    """All d-tuples with sum == total, lexicographically ascending."""
    if d == 1:
        yield (total,)
        return
    for first in range(total + 1):
        for rest in _grade(d - 1, total - first):
            yield (first,) + rest


@lru_cache(maxsize=None)
def _generate_cached(d: int, upper_sum: int, lower_sum: int) -> np.ndarray:
    rows = []
    for total in range(lower_sum, upper_sum + 1):
        rows.extend(_grade(d, total))
    return np.asarray(rows, dtype=np.int64)


def generate_graded_lexico_multi_indices(
    d: int, upper_sum: int, lower_sum: int = 0
) -> np.ndarray:
    """All multi-indices with lower_sum <= |k| <= upper_sum, graded-lex,
    as an int64 array of shape (z, d)."""
    return _generate_cached(d, upper_sum, lower_sum).copy()


def graded_lexico_indexof_multi_index(
    multi_index: Sequence[int], lower_sum: int = 0
) -> int:
    """Rank of a multi-index in the graded-lex ordered collection: the
    sizes of all lower grades plus the count of same-grade tuples that
    precede it lexicographically."""
    k = list(int(v) for v in multi_index)
    d = len(k)
    total = sum(k)
    pos = sizeof_multi_indices(d, total - 1, 0) if total > 0 else 0
    rem = total
    for i in range(d - 1):
        for v in range(k[i]):
            # tuples with v at slot i: compositions of rem - v into d - i - 1 parts
            pos += math.comb(rem - v + d - i - 2, d - i - 2)
        rem -= k[i]
    if lower_sum > 0:
        pos -= sizeof_multi_indices(d, lower_sum - 1, 0)
    return pos


def find_indices(multi_indices) -> np.ndarray:
    """Vectorised rank lookup over (..., d) arrays of multi-indices."""
    arr = np.asarray(multi_indices, dtype=np.int64)
    flat = arr.reshape(-1, arr.shape[-1])
    ranks = np.fromiter(
        (graded_lexico_indexof_multi_index(row) for row in flat),
        dtype=np.int64,
        count=flat.shape[0],
    )
    return ranks.reshape(arr.shape[:-1])


def gram_and_hankel_indices_graded_lexico(N: int, d: int) -> np.ndarray:
    """Index matrices of the Gram and the d multiplication matrices.

    With the flat moment vector ``ms`` (orders |k| <= 2N - 1, graded-lex),
    ``G = ms[inds[0]]`` and ``H_i = ms[inds[1 + i]]`` over the basis of
    every multi-index with |k| <= N - 1 (s = C(N - 1 + d, d) of them):
    ``G[a, b] = m^{k_a + k_b}`` and ``H_i[a, b] = m^{k_a + k_b + e_i}``.

    Returns int64 (d + 1, s, s).
    """
    basis = generate_graded_lexico_multi_indices(d, N - 1, 0)  # (s, d)
    pair_sums = basis[:, None, :] + basis[None, :, :]  # (s, s, d)
    out = [find_indices(pair_sums)]
    for i in range(d):
        bumped = pair_sums.copy()
        bumped[:, :, i] += 1
        out.append(find_indices(bumped))
    return np.stack(out, axis=0)
