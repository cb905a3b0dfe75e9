from mfs_tpu_torch.one_dim.quadrature import hankel_indices, moment_quadrature
from mfs_tpu_torch.one_dim.filtering import (
    moment_filter_rms,
    moment_filter_cms,
    moment_filter_scms,
)
