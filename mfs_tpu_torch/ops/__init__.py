from mfs_tpu_torch.ops.eigh import eigh_batched, eigh_xla, eigh_refined
