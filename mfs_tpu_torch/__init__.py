"""mfs_tpu_torch: the PyTorch/CUDA port of mfs_tpu.

Moment-representation stochastic filters for an NVIDIA H100, in f64.
Module paths and function names mirror ``mfs_tpu``.  The kernels are
hand-written CUDA C++, built with ``nvcc`` at first use: the fused 1D
moment quadrature (``csrc/quadrature_1d.cu``), the 1D Bayes update
(``csrc/posterior_1d.cu``) and the ND fused eigenpairs and K-builder
(``csrc/quadrature_nd.cu``).  Everything else is plain PyTorch.

Entry points run on the GPU unless the caller passes ``device="cpu"``
(see ``mfs_tpu_torch.config.default_device``).
"""
from mfs_tpu_torch.config import DTYPE, default_device
from mfs_tpu_torch.models.multi_dims import ModelND, lotka_volterra_3d, prey_predator
from mfs_tpu_torch.models.one_dim import Model1D, benes_bernoulli
from mfs_tpu_torch.multi_dims import (
    moment_filter_nd_cms,
    moment_filter_nd_rms,
    moment_filter_nd_scms,
    moment_quadrature_nd,
    poly_tme_nd,
)
from mfs_tpu_torch.one_dim.filtering import (
    moment_filter_cms,
    moment_filter_rms,
    moment_filter_scms,
)
from mfs_tpu_torch.one_dim.quadrature import moment_quadrature
from mfs_tpu_torch.parallel.ensemble import rescue_diverged
from mfs_tpu_torch.sde.transitions import (
    sde_cond_moments_euler,
    sde_cond_moments_tme,
    sde_cond_moments_tme_normal,
)

__version__ = "0.1.0"
