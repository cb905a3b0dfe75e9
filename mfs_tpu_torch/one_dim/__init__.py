from mfs_tpu_torch.one_dim.quadrature import (
    hankel_indices,
    moment_quadrature,
    gauss_quadrature_golub_welsch,
    taylor_quadrature,
    make_derivatives,
)
from mfs_tpu_torch.one_dim.moments import (
    raw_to_central,
    central_to_raw,
    raw_to_scaled,
    scaled_to_central,
    sms_to_cumulants,
    characteristic_fn,
    characteristic_from_pdf,
)
from mfs_tpu_torch.one_dim.filtering import (
    moment_filter_rms,
    moment_filter_cms,
    moment_filter_scms,
    moment_filter_taylor,
)
from mfs_tpu_torch.one_dim.pdf_approximations import (
    gram_charlier,
    edgeworth,
    legendre_poly_expansion,
    truncated_cumulant_generating_function,
    saddle_point,
    inverse_fourier,
)
