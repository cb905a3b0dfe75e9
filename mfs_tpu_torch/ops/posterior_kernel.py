"""The 1D Bayes update as one CUDA kernel, and its plain version.

``posterior_moments_1d`` turns a quadrature rule ``(nodes, weights)`` and
the measurement likelihood at its nodes into the normalised posterior
moments of the three 1D moment filters, the evidence ``pdf_y`` and, by
mode, the posterior mean and scale:

- "raw" (``moment_filter_rms``): ``sum_k x_k^j wp_k / pdf_y``;
- "central" (``moment_filter_cms``): about the posterior mean;
- "scaled" (``moment_filter_scms``): about the mean, over the posterior
  standard deviation;

with ``wp_k = p_k w_k`` and ``pdf_y = sum_k wp_k``.

- On a CUDA tensor it launches ``csrc/posterior_1d.cu`` (f64, one thread
  per trial, the sums in registers, any number of moments), built by
  ``nvcc`` at first use, or raises.
- On a CPU tensor it runs ``posterior_moments_1d_plain``, the update as
  the filters wrote it: the node monomials stacked into a (..., n, num)
  tensor, weighted and summed over the nodes.

It replaces no TPU kernel: the JAX package leaves the update to XLA,
which fuses it.  Eager PyTorch writes and reads the stacked monomials,
~1.9 GB at n = 15, B = 524,288, where the kernel moves ~0.33 GB.

Gradients: on the CPU, autograd through the plain version.  The kernel
runs inside one ``torch.autograd.Function`` (``_Posterior``), whose
forward runs under no grad and whose backward is the VJP of the plain
version, recomputed from the saved inputs.
"""
import ctypes
import functools

import torch

from mfs_tpu_torch.config import DTYPE
from mfs_tpu_torch.ops import build, flops
from mfs_tpu_torch.typings import Array
from mfs_tpu_torch.utils.combinatorics import monomials
from mfs_tpu_torch.utils.profiling import span

MODES = ("raw", "central", "scaled")


def _prepare(nodes: Array, weights: Array, pdf_vals: Array, mode: str, num_moments):
    """The three inputs broadcast to one shape, and the number of moments;
    raises on what neither route takes."""
    for name, t in (("nodes", nodes), ("weights", weights), ("pdf_vals", pdf_vals)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != DTYPE:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != nodes.device:
            raise ValueError(f"{name} is on {t.device}, nodes on {nodes.device}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not nodes.shape == weights.shape == pdf_vals.shape:
        nodes, weights, pdf_vals = torch.broadcast_tensors(nodes, weights, pdf_vals)
    n = nodes.shape[-1] if nodes.dim() else 0
    num = 2 * n if num_moments is None else int(num_moments)
    if n < 1 or num < 1:
        raise ValueError(f"the posterior update takes n >= 1 nodes and at least one moment, "
                         f"got n = {n}, {num} moments")
    return nodes, weights, pdf_vals, num


def posterior_moments_1d(nodes: Array, weights: Array, pdf_vals: Array, mode: str,
                         num_moments: int = None):
    """Posterior moments of the rule ``(nodes, weights)`` (each ``(..., n)``)
    under the likelihood ``pdf_vals`` at the nodes; the three broadcast.

    Returns, by ``mode``: "raw" ``(moments, pdf_y)``; "central"
    ``(moments, mean, pdf_y)``; "scaled" ``(moments, mean, scale,
    pdf_y)``.  ``moments`` is ``(..., num_moments)`` (default ``2n``),
    the others ``(...)``.  Differentiable in all three inputs.
    """
    nodes, weights, pdf_vals, num = _prepare(nodes, weights, pdf_vals, mode, num_moments)
    if nodes.device.type == "cpu":
        return posterior_moments_1d_plain(nodes, weights, pdf_vals, mode, num)
    if nodes.device.type != "cuda":
        raise ValueError(f"no posterior update for device {nodes.device}")
    return _Posterior.apply(nodes, weights, pdf_vals, mode, num)


def _posterior_cuda(nodes: Array, weights: Array, pdf_vals: Array, mode: str, num: int):
    """The kernel's launch on CUDA tensors, with the plain version's
    outputs."""
    batch_shape, n = nodes.shape[:-1], nodes.shape[-1]
    B = nodes[..., 0].numel()
    # (n, B): thread b reads column b.  K1's nodes and weights, and the
    # likelihood computed from its nodes, already lie so: no copy.
    x, w, p = (t.reshape(B, n).T.contiguous() for t in (nodes, weights, pdf_vals))
    empty = lambda *shape: torch.empty(shape, dtype=DTYPE, device=nodes.device)
    moments, pdf_y = empty(B, num), empty(B)
    mean = empty(B) if mode != "raw" else None
    scale = empty(B) if mode == "scaled" else None
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _kernel()
    with span("mfs.kernel.post1d"), torch.cuda.device(nodes.device):
        stream = torch.cuda.current_stream(nodes.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), p.data_ptr(), moments.data_ptr(), ptr(mean),
                 ptr(scale), pdf_y.data_ptr(), n, num, B, MODES.index(mode), stream)
    if err != 0:
        raise RuntimeError(f"posterior_1d launch failed: CUDA error {err}")
    flops.kernel_launch("posterior_1d", B, lambda: flops.post1d_flops(n, num, mode))
    per_trial = [t.reshape(batch_shape) for t in (mean, scale, pdf_y) if t is not None]
    return (moments.reshape(batch_shape + (num,)), *per_trial)


class _Posterior(torch.autograd.Function):
    """The kernel's forward; the backward is the plain version's VJP,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, nodes, weights, pdf_vals, mode, num):
        ctx.save_for_backward(nodes, weights, pdf_vals)
        ctx.mode, ctx.num = mode, num
        return _posterior_cuda(nodes, weights, pdf_vals, mode, num)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outs = posterior_moments_1d_plain(*inputs, ctx.mode, ctx.num)
        wanted = [t for t, need in zip(inputs, needs) if need]
        got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
        return tuple(next(got) if need else None for need in needs) + (None, None)


def posterior_moments_1d_plain(nodes: Array, weights: Array, pdf_vals: Array, mode: str,
                               num: int):
    """The update in plain PyTorch, as the 1D filters wrote it, on any
    device: the kernel's reference and its gradient's."""
    if mode == "raw":
        pdf_y = torch.einsum("...n,...n->...", pdf_vals, weights)
        post = monomials(nodes, num) * (pdf_vals * weights)[..., None]
        return torch.sum(post, dim=-2) / pdf_y[..., None], pdf_y
    wp = pdf_vals * weights
    pdf_y = torch.sum(wp, dim=-1)
    mean = torch.sum(nodes * wp, dim=-1) / pdf_y
    centred = nodes - mean[..., None]
    if mode == "central":
        post = monomials(centred, num) * wp[..., None]
        return torch.sum(post, dim=-2) / pdf_y[..., None], mean, pdf_y
    scale = torch.sqrt(torch.sum(centred**2 * wp, dim=-1) / pdf_y)
    post = monomials(centred / scale[..., None], num) * wp[..., None]
    return torch.sum(post, dim=-2) / pdf_y[..., None], mean, scale, pdf_y


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("posterior_1d").mfs_posterior_1d
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
