"""Device-mesh utilities for trial-level data parallelism (port of
``mfs_tpu/parallel/mesh.py``).

The workload is embarrassingly parallel across Monte-Carlo trials, so
the parallel design is a 1-D mesh over the trial axis: shard the batch,
run the same program on every device, and reduce only at the end (the
mean nell of a parameter-estimation step: one all-reduce).

JAX drives every device of a host from one process.  PyTorch runs one
process per device, joined by a ``torch.distributed`` process group,
and the caller starts that group; nothing here starts one.  On GPUs
the backend is NCCL, one process per card::

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(local_rank)
    store = dist.FileStore("/path/to/rendezvous-file", world_size)
    dist.init_process_group("nccl", store=store, rank=rank, world_size=world_size)
    mesh = trial_mesh()

A ``FileStore`` on a path every process can see needs no network;
``torchrun --nproc-per-node=4 script.py`` followed by
``dist.init_process_group("nccl")`` does the same through its own
rendezvous.  On the CPU (tests) the backend is gloo and the mesh is
asked for with ``device_type="cpu"``.
"""
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils._pytree import tree_map_only

TRIAL_AXIS = "trials"


def trial_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[int]] = None,
               device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh over the trial axis, named ``TRIAL_AXIS``.

    Every rank of the process group calls it.

    Parameters
    ----------
    n_devices : int, optional
        Number of ranks in the mesh, ranks 0, ..., n_devices - 1
        (default: the whole group).
    devices : sequence of int, optional
        Explicit ranks (overrides ``n_devices``); one rank is one device.
    device_type : "cuda" or "cpu"
        Where the mesh's tensors live.  "cuda" raises without a GPU: it
        never falls back to the CPU.
    """
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("trial_mesh(device_type='cuda') needs a GPU; pass "
                           "device_type='cpu' for a CPU mesh")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("trial_mesh needs a torch.distributed process group: call "
                           "dist.init_process_group(backend, store=..., rank=..., "
                           "world_size=...) first (see this module's docstring)")
    ranks = list(devices) if devices is not None else list(
        range(n_devices or dist.get_world_size()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=(TRIAL_AXIS,))


def shard_trials(tree: Any, mesh: DeviceMesh, axis: int = 0) -> Any:
    """Place every tensor of ``tree`` (tuples, lists, dicts) as a DTensor
    with its trial axis ``axis`` split over the mesh.

    Each rank passes the whole tensor; rank 0's is scattered.  A trial
    count the mesh size does not divide raises ``ValueError``, as JAX's
    ``device_put`` does."""
    size = mesh.size()

    def put(x):
        if x.shape[axis] % size:
            raise ValueError(f"{x.shape[axis]} trials on axis {axis} do not divide over "
                             f"{size} devices")
        return distribute_tensor(x, mesh, [Shard(axis % x.ndim)])

    return tree_map_only(torch.Tensor, put, tree)


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Place every tensor of ``tree`` as a DTensor replicated across the
    mesh (rank 0's copy is broadcast)."""
    return tree_map_only(torch.Tensor, lambda x: distribute_tensor(x, mesh, [Replicate()]), tree)
