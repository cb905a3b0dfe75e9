"""One rank of the CPU gloo world of ``tests/test_torch_parallel.py``.

Imported by the ranks that test spawns; not a test module (no JAX here:
the ranks import only torch and the port).  Rank 0 writes what the test
compares with the JAX package to ``<out_dir>/rank0.npz`` and
``<out_dir>/checks.json``.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from mfs_tpu_torch.one_dim.filtering import moment_filter_rms
from mfs_tpu_torch.parallel import (replicate, run_ensemble_filter, shard_trials,
                                    sharded_nell_grad, trial_mesh)
from mfs_tpu_torch.sde.transitions import sde_cond_moments_tme
from mfs_tpu_torch.utils.gaussian import normal_raw_moments_all

DT, T, N, B = 1e-2, 30, 4, 16
XI = 1.0


def meas(y, x):
    return torch.exp(-0.5 * (y - x) ** 2 / XI) / np.sqrt(2 * np.pi * XI)


def rms0():
    return normal_raw_moments_all(torch.tensor(0.1, dtype=torch.float64), 0.5,
                                  2 * N).expand(B, 2 * N)


def transitions(theta=1.0):
    return sde_cond_moments_tme(lambda x: -theta * x, lambda x: 0.7 + 0.0 * x, DT, 2, N)


def run(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        mesh = trial_mesh(device_type="cpu")
        ys = torch.as_tensor(np.load(os.path.join(out_dir, "inputs.npz"))["ys"])
        trans = transitions()
        rmss, nell = run_ensemble_filter(
            lambda r0, y: moment_filter_rms(trans.rms, meas, r0, y), rms0(), ys, mesh)
        checks = {"mesh_size": mesh.size(), "mesh_dim_names": list(mesh.mesh_dim_names),
                  "out_placements": [str(rmss.placements), str(nell.placements)],
                  "out_types": [type(rmss).__name__, type(nell).__name__],
                  "out_local_shapes": [list(rmss.to_local().shape),
                                       list(nell.to_local().shape)]}

        def nell_fn(theta, y):
            return moment_filter_rms(transitions(theta).rms, meas, rms0()[:y.shape[1]], y)[1]

        loss, grad = sharded_nell_grad(nell_fn, torch.tensor(1.0, dtype=torch.float64), ys,
                                       mesh)
        rmss_full, nell_full = rmss.full_tensor(), nell.full_tensor()

        xs = shard_trials(torch.zeros(B, 3, dtype=torch.float64), mesh)
        r = replicate(torch.zeros(3, dtype=torch.float64), mesh)
        checks.update(
            shard_is_dtensor=isinstance(xs, DTensor),
            shard_placements=list(xs.placements) == [Shard(0)],
            shard_local_shape=list(xs.to_local().shape),
            replicate_placements=list(r.placements) == [Replicate()],
            replicate_local_shape=list(r.to_local().shape),
            grad_shape=list(grad.shape))
        try:
            shard_trials(torch.zeros(B - 1, 3, dtype=torch.float64), mesh)
            checks["uneven"] = "no error"
        except ValueError as e:
            checks["uneven"] = f"ValueError: {e}"
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), rmss=rmss_full.numpy(),
                     nell=nell_full.numpy(), loss=loss.detach().numpy(),
                     grad=grad.detach().numpy())
            with open(os.path.join(out_dir, "checks.json"), "w") as f:
                json.dump(checks, f)
    finally:
        dist.destroy_process_group()
