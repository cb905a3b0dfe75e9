"""Sharded Monte-Carlo ensemble execution and divergence rescue (port of
``mfs_tpu/parallel/ensemble.py``).

``run_ensemble_filter`` runs a batch-first filter with the trial axis
sharded over a ``trial_mesh``; ``sharded_nell_grad`` is the distributed
parameter-estimation step (mean per-trial nell and its gradient, with
one all-reduce over the mesh); ``rescue_diverged`` runs the whole trial
ensemble through a fast runner, then re-runs only the trials that
diverged through one or more robust runners and splices them back in.

JAX jits the filter over global arrays and XLA partitions it.  Here each
rank runs the filter eagerly on its own shard as plain tensors (the
CUDA kernels are ``ctypes`` calls, which take no DTensor), and the
outputs are wrapped back into DTensors sharded on the trial axis.
"""
from typing import Any, Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard
from torch.utils._pytree import tree_flatten, tree_map_only, tree_unflatten

from mfs_tpu_torch.parallel.mesh import TRIAL_AXIS, replicate, shard_trials
from mfs_tpu_torch.utils.profiling import count, span

Runner = Callable[[torch.Tensor], Dict[str, Any]]


def _local(tree: Any) -> Any:
    return tree_map_only(DTensor, lambda d: d.to_local(), tree)


def run_ensemble_filter(
    filter_fn: Callable,
    init_moments: Any,
    ys: Any,
    mesh: DeviceMesh,
    donate: bool = False,
    out_trial_axes: Any = None,
) -> Any:
    """Run ``filter_fn(init_moments, ys)`` with trials sharded on ``mesh``.

    Every rank of the mesh calls it with the same whole inputs.

    Parameters
    ----------
    filter_fn : (init (b, ...), ys (T, b, ...)) -> outputs
        A batch-first filter closure (e.g. wrapping ``moment_filter_rms``
        with the model callables bound), called once per rank on that
        rank's b = B / mesh-size trials as plain tensors.
    init_moments : tensor tree with leading trial axis B.
    ys : tensor tree with trial axis at position 1 (time leads).
    mesh : DeviceMesh from ``trial_mesh()``.
    donate : bool
        Kept for the JAX signature, where it lets XLA reuse the input
        buffers.  PyTorch has no buffer donation, so it changes nothing:
        the sharded inputs are this call's own and are freed when it
        returns.
    out_trial_axes : int or tree of int, optional
        The outputs' trial axes, which XLA infers and PyTorch cannot: one
        int for every output, or a tree shaped like the outputs.  Default:
        the moment filters' convention, axis 0 for a 1-D output (nell)
        and axis 1 otherwise (time-stacked moments, means).

    Returns
    -------
    The filter outputs as DTensors, trial axis sharded.
    """
    del donate
    outs = filter_fn(_local(shard_trials(init_moments, mesh, axis=0)),
                     _local(shard_trials(ys, mesh, axis=1)))
    leaves, spec = tree_flatten(outs)
    if out_trial_axes is None:
        axes = [0 if x.ndim == 1 else 1 for x in leaves]
    elif isinstance(out_trial_axes, int):
        axes = [out_trial_axes] * len(leaves)
    else:
        axes = tree_flatten(out_trial_axes)[0]
    return tree_unflatten([DTensor.from_local(x, mesh, [Shard(ax)], run_check=False)
                           for x, ax in zip(leaves, axes)], spec)


def sharded_nell_grad(
    nell_fn: Callable,
    params: Any,
    ys: Any,
    mesh: DeviceMesh,
) -> Tuple[torch.Tensor, Any]:
    """Mean nell over sharded trials and its gradient w.r.t. ``params``.

    ``nell_fn(params, ys) -> (b,)`` per-trial negative log likelihoods.
    ``params`` is replicated and ``ys`` sharded on axis 1; each rank
    differentiates the sum of its own trials' nell by autograd, and one
    all-reduce of [sum, gradient, count] over the mesh gives the mean
    over all B trials.  Every rank returns the same ``(loss, grad)``,
    plain tensors, ``grad`` shaped like ``params``.
    """
    leaves, spec = tree_flatten(_local(replicate(params, mesh)))
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        nell = nell_fn(tree_unflatten(leaves, spec), _local(shard_trials(ys, mesh, axis=1)))
        grads = torch.autograd.grad(nell.sum(), leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    buf = torch.cat([nell.detach().sum().reshape(1)]
                    + [g.reshape(-1).to(nell.dtype) for g in grads]
                    + [nell.new_full((1,), nell.shape[0])])
    dist.all_reduce(buf, group=mesh.get_group(TRIAL_AXIS))
    mean = buf[:-1] / buf[-1]
    parts = mean[1:].split([x.numel() for x in leaves])
    return mean[0], tree_unflatten([g.reshape(x.shape).to(x.dtype)
                                    for g, x in zip(parts, leaves)], spec)


def _mask(finite_fn, out) -> np.ndarray:
    """``finite_fn(out)`` on the host: for a device tensor the host
    waits for the device (``sync.rescue_mask``)."""
    with span("mfs.rescue.mask"):
        x = finite_fn(out)
        if not torch.is_tensor(x):
            return np.asarray(x)
        if not x.is_cpu:
            count("sync.rescue_mask")
        return x.cpu().numpy()


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

    Spans: ``mfs.rescue.tier0`` around ``run_fast``, ``mfs.rescue.tier<k>``
    around tier k's calls, ``mfs.rescue.mask`` and ``mfs.rescue.splice``.
    Counters: ``rescue.kept.tier0``, and for k >= 1 ``rescue.handed.tier<k>``
    and ``rescue.kept.tier<k>``, the trials handed to tier k and kept by it.
    """
    tiers = list(run_robust) if isinstance(run_robust, (list, tuple)) else [run_robust]
    with span("mfs.rescue.tier0"):
        out = run_fast(ys)
    finite = _mask(finite_fn, out)
    count("rescue.kept.tier0", int(finite.sum()))
    n = finite.shape[0]
    bucket = n if bucket is None else bucket
    merged = dict(out)
    total_rescued = 0

    for t, tier in enumerate(tiers, start=1):
        if finite.all():
            break
        idx = np.where(~finite)[0]
        k = idx.shape[0]
        count(f"rescue.handed.tier{t}", k)
        width = -(-k // bucket) * bucket
        pad = np.concatenate([idx, np.zeros(width - k, dtype=idx.dtype)])
        pad_t = torch.as_tensor(pad, device=ys.device)
        with span(f"mfs.rescue.tier{t}"):
            parts = [tier(ys.index_select(1, pad_t[s:s + bucket]))
                     for s in range(0, width, bucket)]
            robust = parts[0] if len(parts) == 1 else {
                key: torch.cat([p[key] for p in parts], dim=ax)
                for key, ax in trial_axes.items() if key in parts[0]
            }
        finite_r = _mask(finite_fn, robust)[:k]
        good = idx[finite_r]
        sel = np.where(finite_r)[0]
        count(f"rescue.kept.tier{t}", int(good.shape[0]))

        with span("mfs.rescue.splice"):
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
