from mfs_tpu_torch.utils.combinatorics import (
    gamma,
    factorial,
    binom,
    vmap_list_of_funcs,
    partial_bell,
    complete_bell,
    hermite_probabilist,
    hermite_probabilist_all,
    pascal_lower,
)
from mfs_tpu_torch.utils.gaussian import (
    normal_raw_moments_all,
    raw_moment_of_normal,
    raw_moment_of_standard_normal,
    central_moment_of_normal,
    GaussianSum1D,
    GaussianSumND,
    discretise_lti_sde,
)
from mfs_tpu_torch.utils.linalg import ldl, ldl_chol, lanczos, lanczos_ritz
from mfs_tpu_torch.utils.sdes import simulate_sde, simulate_sde_ensemble
from mfs_tpu_torch.utils.pcrlb import posterior_cramer_rao
from mfs_tpu_torch.utils.profiling import timed, trace
