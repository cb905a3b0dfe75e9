"""Port vs JAX: trial sharding over a device mesh.

The port runs one process per device; here two CPU ranks joined by a
gloo process group (a ``FileStore`` in a temporary directory, no
network), spawned once for the module by ``tests/_torch_parallel_worker.py``.
JAX runs the same model on its 8 virtual CPU devices in this process
(``tests/test_parallel.py``'s model: DT=1e-2, T=30, N=4, B=16).  Both
get the same numpy observations.
"""
import json
import multiprocessing
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mfs_tpu.one_dim.filtering import moment_filter_rms as j_filter_rms  # noqa: E402
from mfs_tpu.parallel import run_ensemble_filter as j_run_ensemble_filter  # noqa: E402
from mfs_tpu.parallel import sharded_nell_grad as j_sharded_nell_grad  # noqa: E402
from mfs_tpu.parallel import trial_mesh as j_trial_mesh  # noqa: E402
from mfs_tpu.sde.transitions import sde_cond_moments_tme as j_tme  # noqa: E402
from mfs_tpu.utils.gaussian import normal_raw_moments_all as j_moments  # noqa: E402

import _torch_parallel_worker as worker  # noqa: E402

WORLD = 2
JOIN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the 2-rank world once; returns rank 0's arrays, its checks
    and the observations.  A rank that hangs is killed at the timeout
    and fails the tests instead of holding the suite."""
    out_dir = tmp_path_factory.mktemp("gloo_world")
    ys = np.random.RandomState(0).randn(worker.T, worker.B) * 0.6
    np.savez(out_dir / "inputs.npz", ys=ys)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(rank, WORLD, str(out_dir / "store"), str(out_dir)))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not alive, f"ranks still running after {JOIN_TIMEOUT_S} s: {alive}"
    assert [p.exitcode for p in procs] == [0] * WORLD
    arrays = dict(np.load(out_dir / "rank0.npz"))
    checks = json.loads((out_dir / "checks.json").read_text())
    return arrays, checks, ys


def _j_meas(y, x):
    return jnp.exp(-0.5 * (y - x) ** 2 / worker.XI) / jnp.sqrt(2 * jnp.pi * worker.XI)


def _j_rms0():
    return jnp.broadcast_to(j_moments(0.1, 0.5, 2 * worker.N), (worker.B, 2 * worker.N))


def test_sharded_filter_matches_jax(world):
    """``run_ensemble_filter`` on 2 ranks against JAX's on 8 devices: nell
    to rtol 1e-12, the moments to rtol 1e-12 with atol 1e-12 (entries are
    O(1); torch's and JAX's LAPACK eigh put entries near zero up to
    7.2e-13 apart, 1.6e-8 of themselves).  Against the port's own
    unsharded filter: rtol 1e-12, no atol.  The outputs are DTensors
    sharded on their trial axes (moments axis 1, nell axis 0), B/2 trials
    a rank."""
    arrays, checks, ys = world
    trans = j_tme(lambda x: -x, lambda x: 0.7, worker.DT, 2, worker.N)
    rmss, nell = j_run_ensemble_filter(
        lambda r0, y: j_filter_rms(trans.rms, _j_meas, r0, y), _j_rms0(), jnp.asarray(ys),
        j_trial_mesh())
    np.testing.assert_allclose(arrays["nell"], np.asarray(nell), rtol=1e-12)
    np.testing.assert_allclose(arrays["rmss"], np.asarray(rmss), rtol=1e-12, atol=1e-12)
    # The sharded run is the unsharded one, trial for trial (JAX's own check).
    p_rmss, p_nell = worker.moment_filter_rms(worker.transitions().rms, worker.meas,
                                              worker.rms0(), torch.as_tensor(ys))
    np.testing.assert_allclose(arrays["rmss"], p_rmss.numpy(), rtol=1e-12)
    np.testing.assert_allclose(arrays["nell"], p_nell.numpy(), rtol=1e-12)
    assert checks["mesh_size"] == WORLD and checks["mesh_dim_names"] == ["trials"]
    assert checks["out_types"] == ["DTensor", "DTensor"]
    assert checks["out_placements"] == ["(Shard(dim=1),)", "(Shard(dim=0),)"]
    half = worker.B // WORLD
    assert checks["out_local_shapes"] == [[worker.T, half, 2 * worker.N], [half]]


def test_sharded_nell_grad_matches_jax(world):
    """``sharded_nell_grad`` (one all-reduce of [sum, gradient, count])
    against JAX's: loss rtol 1e-12, gradient rtol 1e-10."""
    arrays, checks, ys = world

    def nell_fn(theta, y):
        trans = j_tme(lambda x: -theta * x, lambda x: 0.7, worker.DT, 2, worker.N)
        return j_filter_rms(trans.rms, _j_meas, _j_rms0(), y)[1]

    loss, grad = j_sharded_nell_grad(nell_fn, jnp.asarray(1.0), jnp.asarray(ys), j_trial_mesh())
    np.testing.assert_allclose(float(arrays["loss"]), float(loss), rtol=1e-12)
    np.testing.assert_allclose(float(arrays["grad"]), float(grad), rtol=1e-10)
    assert checks["grad_shape"] == []


def test_placements_and_uneven_trials(world):
    """``shard_trials`` places ``Shard(axis)``, ``replicate`` places
    ``Replicate()``, and a trial count the mesh does not divide raises
    ``ValueError`` before any collective, as JAX's ``device_put`` does."""
    _, checks, _ = world
    assert checks["shard_is_dtensor"] and checks["shard_placements"]
    assert checks["shard_local_shape"] == [worker.B // WORLD, 3]
    assert checks["replicate_placements"] and checks["replicate_local_shape"] == [3]
    assert checks["uneven"].startswith("ValueError") and "do not divide" in checks["uneven"]


def test_trial_mesh_needs_a_gpu_or_a_group():
    """No silent CPU fallback: a CUDA mesh without a GPU raises, and so
    does any mesh without a process group (nothing starts one)."""
    from mfs_tpu_torch.parallel import trial_mesh

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        trial_mesh(device_type="cuda")
    with pytest.raises(RuntimeError, match="process group"):
        trial_mesh(device_type="cpu")
    assert not os.environ.get("MASTER_ADDR")
