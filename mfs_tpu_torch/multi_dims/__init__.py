from mfs_tpu_torch.multi_dims.multi_indices import (
    sizeof_multi_indices,
    graded_lexico_indexof_multi_index,
    generate_graded_lexico_multi_indices,
    find_indices,
    gram_and_hankel_indices_graded_lexico,
)
from mfs_tpu_torch.multi_dims.moments import (
    raw_moments_mvn_kan,
    central_moments_mvn_kan,
    raw_moments_mvn_kan_all,
    raw_moments_mvn_mgf,
    moments_nd_uniform,
    extract_moments,
    extract_mean,
    extract_cov,
    marginalise_moments,
    monomials_nd,
    sde_cond_moments_nd_tme,
    sde_cond_moments_nd_tme_normal,
    sde_cond_moments_nd_euler_maruyama,
)
from mfs_tpu_torch.multi_dims.poly_tme import poly_tme_nd
from mfs_tpu_torch.multi_dims.quadrature import moment_quadrature_nd
from mfs_tpu_torch.multi_dims.filtering import (
    moment_filter_nd_rms,
    moment_filter_nd_cms,
    moment_filter_nd_scms,
)
