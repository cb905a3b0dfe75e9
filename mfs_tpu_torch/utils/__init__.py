from mfs_tpu_torch.utils.gaussian import (
    normal_raw_moments_all,
    GaussianSum1D,
    GaussianSumND,
    discretise_lti_sde,
)
from mfs_tpu_torch.utils.linalg import ldl, ldl_chol
from mfs_tpu_torch.utils.sdes import simulate_sde, simulate_sde_ensemble
