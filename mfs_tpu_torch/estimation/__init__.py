from mfs_tpu_torch.estimation.mle import fit_mle_scipy, fit_mle_optax, fit_mle_batched
from mfs_tpu_torch.estimation.lbfgs_batched import lbfgs_batched
