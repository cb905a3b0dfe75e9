from mfs_tpu_torch.parallel.mesh import trial_mesh, shard_trials, replicate
from mfs_tpu_torch.parallel.ensemble import (
    run_ensemble_filter,
    sharded_nell_grad,
    rescue_diverged,
)
