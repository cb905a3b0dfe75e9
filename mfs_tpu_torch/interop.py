"""State carried across from numpy (and so from the JAX package).

The models have no trained weights: a run's parameters are its initial
condition and its inputs.  These helpers take the JAX package's layouts
as numpy arrays — 1D ``cms0 (B, 2N)``, ``mean0 (B,)``, ``ys (T, B)``;
ND ``cms0 (B, z)``, ``mean0 (B, d)``, ``ys (T, B, 1)`` — so one set of
arrays can feed both packages, and bring outputs back as numpy.
"""
from typing import Any

import numpy as np
import torch

from mfs_tpu_torch.config import as_tensor
from mfs_tpu_torch.utils.gaussian import GaussianSum1D, GaussianSumND


def gaussian_sum_1d_from_numpy(means, variances, weights, N: int, device=None) -> GaussianSum1D:
    """The port's ``GaussianSum1D`` from mixture parameters (numpy or lists)."""
    return GaussianSum1D.new(*(np.array(a, dtype=np.float64) for a in (means, variances, weights)),
                             N=N, device=device)


def filter_inputs_from_numpy(cms0, mean0, ys, device=None):
    """``(cms0 (B, 2N), mean0 (B,), ys (T, B))`` as float64 tensors on ``device``."""
    return tuple(as_tensor(np.array(a, dtype=np.float64), device) for a in (cms0, mean0, ys))


def gaussian_sum_nd_from_numpy(means, covs, weights, multi_indices,
                               device=None) -> GaussianSumND:
    """The port's ``GaussianSumND`` from mixture parameters ``means (c, d)``,
    ``covs (c, d, d)``, ``weights (c,)`` over ``multi_indices (z, d)``."""
    return GaussianSumND.new(*(np.array(a, dtype=np.float64) for a in (means, covs, weights)),
                             np.asarray(multi_indices, dtype=np.int64), device=device)


def nd_filter_inputs_from_numpy(cms0, mean0, ys, device=None):
    """``(cms0 (B, z), mean0 (B, d), ys (T, B, 1))`` as float64 tensors on ``device``."""
    return filter_inputs_from_numpy(cms0, mean0, ys, device)


def to_numpy(x: Any):
    """Tensors (also inside tuples, lists and dicts) as numpy arrays."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x
