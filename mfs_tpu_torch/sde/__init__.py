from mfs_tpu_torch.sde.tme import (
    generator,
    generator_1d,
    expectation,
    expectation_1d,
    mean_and_cov,
    mean_and_var_1d,
)
from mfs_tpu_torch.sde.transitions import (
    sde_cond_moments_tme,
    sde_cond_moments_tme_normal,
    sde_cond_moments_euler,
)
