from mfs_tpu_torch.filters.sigma_points import (
    SigmaPoints,
    rk4_m_cov,
    rk4_m_cov_backward,
    gaussian_expectation,
)
from mfs_tpu_torch.filters.gaussian import (
    kf,
    rts,
    ekf,
    eks,
    cd_ekf,
    cd_eks,
    sgp_filter,
    sgp_smoother,
    cd_sgp_filter,
    cd_sgp_smoother,
)
from mfs_tpu_torch.filters.smc import bootstrap_filter, particle_filter
from mfs_tpu_torch.filters.resampling import systematic, stratified, multinomial, continuous_resampling
from mfs_tpu_torch.filters.grid import brute_force_filter
