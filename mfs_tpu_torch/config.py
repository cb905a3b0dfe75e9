"""Numerical and device policy for the PyTorch/CUDA port.

The moment core runs in ``torch.float64`` throughout: the Hankel
conditioning grows roughly exponentially with the moment order, and the
H100 has a native FP64 ALU, so there is no reduced-precision mode.

Entry points run on the GPU unless the caller asks for another device:
``default_device(None)`` is ``cuda``, and asking for ``cuda`` on a host
without a GPU raises instead of moving to the CPU.  Functions that take
tensors follow the device of their inputs.
"""
import torch

DTYPE = torch.float64


def default_device(device=None) -> torch.device:
    """Resolve a device argument: ``None`` means ``cuda``.

    Raises ``RuntimeError`` when a CUDA device is requested (explicitly
    or by default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mfs_tpu_torch: no CUDA device is available; pass device='cpu' "
            "explicitly to run on the CPU"
        )
    return dev


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor on ``device`` (resolved as above)."""
    return torch.as_tensor(x, dtype=DTYPE, device=default_device(device))


def check_generator(generator: torch.Generator, device) -> None:
    """Raise ``ValueError`` unless ``generator`` lives on ``device``: a
    stream is never moved to the data's device behind the caller's back."""
    g, d = torch.device(generator.device), torch.device(device)
    if g.type != d.type or (g.type == "cuda" and (g.index or 0) != (d.index or 0)):
        raise ValueError(f"mfs_tpu_torch: the generator lives on {g}, the data on {d}")
