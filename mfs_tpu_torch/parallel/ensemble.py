"""Divergence rescue for batched Monte-Carlo filtering.

Port of ``mfs_tpu/parallel/ensemble.py::rescue_diverged``: run the whole
trial ensemble through a fast runner, then re-run only the trials that
diverged through one or more robust runners and splice them back in.
The trial-axis sharding functions wait for ROADMAP E2.
"""
from typing import Any, Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

Runner = Callable[[torch.Tensor], Dict[str, Any]]


def _mask(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def rescue_diverged(
    run_fast: Runner,
    run_robust: Union[Runner, Sequence[Runner]],
    ys: torch.Tensor,
    finite_fn: Callable[[Dict[str, Any]], torch.Tensor],
    trial_axes: Dict[str, int],
    bucket: int = None,
) -> Tuple[Dict[str, Any], np.ndarray, int]:
    """Multi-tier divergence rescue.

    Parameters
    ----------
    run_fast, run_robust : (T, b, ...) observations -> dict of tensors
        Filter runners returning equally-keyed dicts.  ``run_robust``
        may be a sequence, applied in order to the shrinking set of
        still-diverged trials.
    ys : Tensor (T, B, ...)
        Observations, trial axis 1.
    finite_fn : dict -> (b,) bool tensor
        Per-trial finiteness mask of a runner's output.
    trial_axes : {key: axis}
        Trial axis of each output to splice (keys missing from either
        runner's output are skipped).  With more than one robust call
        per tier, ``finite_fn`` sees only these keys, concatenated.
    bucket : int, optional
        Width of each robust call: the diverged trials are padded by
        repeating trial 0 to a multiple of ``bucket`` and run ``bucket``
        at a time.  Default ``B``, one call padded back to the full
        width, as the JAX package does.

    Returns
    -------
    merged : dict, finite : (B,) bool ndarray, rescued : int
    """
    tiers = list(run_robust) if isinstance(run_robust, (list, tuple)) else [run_robust]
    out = run_fast(ys)
    finite = _mask(finite_fn(out))
    n = finite.shape[0]
    bucket = n if bucket is None else bucket
    merged = dict(out)
    total_rescued = 0

    for tier in tiers:
        if finite.all():
            break
        idx = np.where(~finite)[0]
        k = idx.shape[0]
        width = -(-k // bucket) * bucket
        pad = np.concatenate([idx, np.zeros(width - k, dtype=idx.dtype)])
        pad_t = torch.as_tensor(pad, device=ys.device)
        parts = [tier(ys.index_select(1, pad_t[s:s + bucket]))
                 for s in range(0, width, bucket)]
        robust = parts[0] if len(parts) == 1 else {
            key: torch.cat([p[key] for p in parts], dim=ax)
            for key, ax in trial_axes.items() if key in parts[0]
        }
        finite_r = _mask(finite_fn(robust))[:k]
        good = idx[finite_r]
        sel = np.where(finite_r)[0]

        for key, ax in trial_axes.items():
            if key not in merged or key not in robust:
                continue
            a = merged[key].clone()
            b = robust[key]
            a.index_copy_(ax, torch.as_tensor(good, device=a.device),
                          b.index_select(ax, torch.as_tensor(sel, device=b.device)))
            merged[key] = a
        finite = finite.copy()
        finite[good] = True
        total_rescued += int(good.shape[0])
    return merged, finite, total_rescued
