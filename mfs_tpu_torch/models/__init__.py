from mfs_tpu_torch.models.one_dim import benes_bernoulli, well_poisson
from mfs_tpu_torch.models.multi_dims import (
    lotka_volterra_3d,
    prey_predator,
    satellite_orbital_stability,
)
