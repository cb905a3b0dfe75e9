"""Semantic type aliases, as in ``mfs_tpu.typings``.

- ``rms``  — raw moments ``E[X^n]``.
- ``cms``  — central moments ``E[(X - mean)^n]``.
- ``scms`` — scaled central moments ``E[((X - mean)/scale)^n]``.
- A trailing double-s (e.g. ``cmss``) denotes a time-stacked array of
  moment vectors, shape ``(T, ...)``.

A leading batch axis is always allowed (batch-first design).
"""
from typing import Union

import torch

Array = torch.Tensor
ArrayLike = Union[torch.Tensor, float, int]
FloatScalar = Union[float, torch.Tensor]
IntScalar = Union[int, torch.Tensor]
