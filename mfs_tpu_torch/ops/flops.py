"""FLOP accounting (port of ``mfs_tpu/ops/flops.py``).

``count_flops(fn, *args)`` runs ``fn`` once and tallies its arithmetic
work aten op by aten op, in the JAX package's buckets:

- elementwise arithmetic (add/mul/neg/abs/clamp/...) counts one flop per
  output element; transcendental and other costly elementwise ops
  (div/sqrt/exp/log/pow/...) are counted the same way but reported
  apart in the breakdown;
- matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``dot``) count ``2 * out_size * K``;
- reductions and scans (sum, prod, mean, cumsum, ...) count one flop
  per *input* element;
- views, copies, comparisons, selections and gathers count zero;
- any other op is listed under ``unknown_primitives`` (e.g. the
  LAPACK/cuSOLVER factorisations, as JAX lists ``eigh``).

PyTorch runs eagerly, so a T-step filter loop is counted T times as it
runs, with no trip-count logic (JAX multiplies a ``scan`` body).

The hand-written CUDA kernels are ``ctypes`` calls that no dispatch mode
sees, where JAX enters ``pallas_call`` bodies.  So each kernel wrapper
reports its launch while a count is open (``kernel_launch``): per-trial
operations times the batch, under ``kernel[<name>][float64]``, from the
analytic counts below (``k1_flops``, ``post1d_flops``, ``ldl_flops``,
``ksolve_flops``, ``k2_flops``).  K2's Jacobi sweep count depends on the data, so its
launches are counted at one sweep per dimension, a lower bound as JAX
counts one ``while`` iteration, and their keys are listed under
``lower_bounds``.  On a CPU tensor the wrappers run their plain
versions, whose aten ops are counted like any other (the counterpart of
JAX counting a kernel body in interpret mode).
"""
from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mfs_tpu_torch.utils import profiling

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "neg", "maximum", "minimum", "max", "min", "abs",
    "floor", "ceil", "round", "trunc", "frac", "sign", "sgn", "clamp", "clamp_min",
    "clamp_max", "addcmul", "lerp", "hypot", "copysign", "nan_to_num",
    # autograd's fused backward formulas: multiply-adds of the output
    "tanh_backward", "sigmoid_backward",
}
_TRANSCENDENTAL = {
    "div", "true_divide", "reciprocal", "sqrt", "rsqrt", "exp", "exp2", "log", "log2",
    "log10", "log1p", "expm1", "tanh", "sin", "cos", "tan", "asin", "acos", "atan",
    "atan2", "sinh", "cosh", "pow", "erf", "erfc", "erfinv", "sigmoid", "lgamma",
    "digamma", "square", "logaddexp", "softplus", "xlogy", "addcdiv",
}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "vdot"}
_REDUCE = {
    "sum", "nansum", "prod", "mean", "cumsum", "cumprod", "logcumsumexp", "logsumexp",
    "var", "std", "var_mean", "std_mean", "norm", "linalg_vector_norm", "trace",
}
_ZERO_COST = {
    # views, layout, copies, creation
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "permute", "transpose", "t",
    "unsqueeze", "squeeze", "select", "slice", "narrow", "as_strided", "alias", "detach",
    "clone", "contiguous", "_to_copy", "copy", "lift_fresh", "lift_fresh_copy", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like",
    "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like", "new_full", "fill",
    "arange", "linspace", "scalar_tensor", "cat", "stack", "split", "split_with_sizes",
    "unbind", "chunk", "flip", "roll", "repeat", "tile", "diag", "diag_embed", "diagonal",
    "tril", "triu", "constant_pad_nd", "unfold", "_local_scalar_dense", "item", "zero",
    "resize", "set", "movedim", "real", "imag", "view_as_real", "view_as_complex",
    "complex", "_conj", "conj", "resolve_conj", "resolve_neg", "bernoulli", "uniform",
    "normal", "random", "exponential", "poisson", "rand", "randn", "rand_like",
    "randn_like", "multinomial",
    # comparisons, selections, gathers and scatters
    "where", "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "isfinite",
    "isnan", "isinf", "isposinf", "isneginf", "all", "any", "masked_fill", "masked_select",
    "masked_scatter", "index", "index_put", "index_select", "index_copy", "index_fill",
    "gather", "scatter", "scatter_add", "take", "take_along_dim", "nonzero", "sort",
    "argsort", "topk", "amax", "amin", "aminmax", "argmax", "argmin", "searchsorted",
    "bucketize", "remainder", "fmod", "one_hot", "embedding", "eye",
}


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "") if torch.is_tensor(x) else "unknown"


def _first_tensor(out):
    if torch.is_tensor(out):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            if torch.is_tensor(o):
                return o
    return None


def _matmul_flops(name: str, args) -> float:
    """2 * out_size * K of a matrix product's tensor operands."""
    if name in ("addmm", "addmv", "baddbmm"):
        args = args[1:]
    a, b = args[0], args[1]
    if name in ("dot", "vdot", "mv", "addmv"):
        return 2.0 * a.numel()
    k = a.shape[-1]
    out = a.numel() // k * b.shape[-1]
    return 2.0 * out * k


class _FlopCounter(TorchDispatchMode):
    def __init__(self, tally: Dict[str, float]):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        name = name[:-1] if name.endswith("_") and not name.startswith("_") else name
        tally = self.tally
        if name in _MATMUL:
            key = f"dot_general[{_dtype_name(_first_tensor(out))}]"
            tally[key] = tally.get(key, 0.0) + _matmul_flops(name, args)
        elif name in _REDUCE:
            x = args[0]
            key = f"reduce[{_dtype_name(x)}]"
            tally[key] = tally.get(key, 0.0) + float(x.numel())
        elif name in ("max", "min") and not (len(args) > 1 and torch.is_tensor(args[1])):
            pass  # a reduction to the largest or smallest element: zero, as in JAX
        elif name in _ELEMENTWISE or name in _TRANSCENDENTAL:
            y = _first_tensor(out)
            bucket = "elementwise" if name in _ELEMENTWISE else "transcendental"
            key = f"{bucket}[{_dtype_name(y)}]"
            tally[key] = tally.get(key, 0.0) + float(y.numel())
        elif name not in _ZERO_COST:
            key = f"__unknown__{name}"
            tally[key] = tally.get(key, 0.0) + 1.0
        return out


# Tallies of the counts open now, innermost last (``count_flops`` nests).
_OPEN: List[Dict[str, float]] = []
# A kernel's launch counter where its name differs from its operations' key.
_COUNTER = {"quadrature_1d": "k1", "posterior_1d": "post1d"}


def kernel_launch(name: str, batch: int, per_trial: Callable[[], int],
                  lower_bound: bool = False) -> None:
    """Called by a kernel wrapper where it has launched its CUDA kernel:
    counts the launch under ``kernel.launches.<kernel>`` (K1's as ``k1``,
    the posterior update's as ``post1d``; ``utils/profiling.py``) and
    adds ``per_trial() * batch`` FP64 operations under
    ``kernel[name][float64]`` to every open count (``per_trial`` is
    called only if one is open)."""
    profiling.count("kernel.launches." + _COUNTER.get(name, name))
    if not _OPEN:
        return
    key = f"kernel[{name}][float64]"
    flops = float(per_trial()) * batch
    for tally in _OPEN:
        tally[key] = tally.get(key, 0.0) + flops
        if lower_bound:
            tally[f"__lower_bound__{key}"] = 1.0


def count_flops(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and tally its arithmetic work.

    Returns ``{"total": float, "f32": float, "f64": float,
    "breakdown": {key: flops}, "unknown_primitives": [...],
    "lower_bounds": [...]}``: f32/f64 split by the element dtype of each
    op; ``lower_bounds`` lists the breakdown keys counted below their
    true value (K2's data-dependent sweeps).
    """
    tally: Dict[str, float] = {}
    _OPEN.append(tally)
    try:
        with _FlopCounter(tally):
            fn(*args, **kwargs)
    finally:
        _OPEN.remove(tally)
    unknown = sorted(k.replace("__unknown__", "") for k in tally if k.startswith("__unknown__"))
    lower = sorted(k.replace("__lower_bound__", "") for k in tally
                   if k.startswith("__lower_bound__"))
    counted = {k: v for k, v in tally.items() if not k.startswith("__")}
    return {
        "total": sum(counted.values()),
        "f32": sum(v for k, v in counted.items() if "float32" in k),
        "f64": sum(v for k, v in counted.items() if "float64" in k),
        "breakdown": dict(sorted(counted.items())),
        "unknown_primitives": unknown,
        "lower_bounds": lower,
    }


# ---------------------------------------------------------------------------
# The hand-written kernels' operations per trial
# ---------------------------------------------------------------------------


def k1_flops(n):
    """FP64 operations K1 does per trial at order n, counted from
    ``csrc/quadrature_1d.cu`` (add, sub, mul, div, sqrt one each; no
    iteration depends on the data).  Returns (operations, divisions)."""
    equil = 2 * n + (n - 1)                                  # sqrt, 1/x, ratios
    ldl = sum((n - j) * (3 * j + 2) + (n - j - 1) for j in range(n))
    gw = 2 * (n - 1) + 3 * (n - 1)
    back = 2 * n * (n - 1) // 2 + n + 1
    qform = 3 * n * (n + 1) // 2 + n * (n - 1) // 2
    gersh = 6 * n + 4
    sturm = 1 + 3 * (n - 1)
    bisect = n * 32 * (2 + sturm)
    newton = n * 8 * (8 * n + 2)
    weights = n * (2 + 7 * (n - 1) + 1 + 2)
    ops = equil + ldl + gw + back + qform + gersh + bisect + newton + weights
    divs = (2 * n - 1) + n * (n - 1) // 2 + (n - 1) + 1 + n * 32 * (n - 1) + n * 8 + n * n
    return ops, divs


def post1d_flops(n, num, mode):
    """FP64 operations the 1D posterior update does per trial with n nodes
    and ``num`` moments, counted from ``csrc/posterior_1d.cu`` (add, sub,
    mul, div, sqrt one each): wp and pdf_y (2 a node; the mean's 2 more a
    node and a division outside the raw mode), the scaled mode's second
    pass (5 a node, a division and a sqrt), and in the moment pass, once
    per block of 64 moments starting at order c0, a node's wp again, the
    shift and scale of u, the c0 products that reach u^c0, 1 for order 0
    (2 past the first block) and 3 for each order above it; then a
    division a moment."""
    centred = mode != "raw"
    first = 2 * n + (2 * n + 1 if centred else 0)
    second = 5 * n + 2 if mode == "scaled" else 0
    shift = (1 if centred else 0) + (1 if mode == "scaled" else 0)
    moments = num
    for c0 in range(0, num, 64):
        cn = min(64, num - c0)
        moments += n * (1 + shift + c0 + (2 if c0 else 1) + 3 * (cn - 1))
    return first + second + moments


def ldl_flops(s):
    """FP64 operations the equilibrated LDL needs per trial (add, sub,
    mul, div, sqrt one each; nothing depends on the data): c_j = 1/sqrt(G_jj),
    the lower triangle of G' (2 an entry), and for column j the products
    v_k = L_jk d_k (k < j), the pivot (2j + its guard and scale), and
    each row below it (2j + the division).  nd_ldl does this work: it
    forms each v once a column and updates each entry once from it."""
    equil = 2 * s + s * (s + 1)
    return equil + sum(j + 2 * j + 3 + (s - 1 - j) * (2 * j + 1) for j in range(s))


def ksolve_flops(s, d):
    """FP64 operations the d operators K_m = S^-1 Lu^-1 H'_m Lu^-T S^-1
    need per trial, given the factor: the H'_m gather (2 an entry); the
    whole first unit solve W = Lu^-1 H'_m (an FMA per k < i in each of s
    columns); the second, Y = W Lu^-T, only on the lower triangle, since
    Y is symmetric (entry (i, j <= i) needs j FMAs); the scaling and the
    symmetrisation of the s(s+1)/2 entries kept (2 each).  nd_ksolve
    solves for the whole Y and symmetrises every entry: that extra work
    is the kernel's, not the function's, and is not counted."""
    first = s * s * (s - 1)
    second = (s - 1) * s * (s + 1) // 3
    return d * (2 * s * s + first + second + 2 * s * (s + 1))


def k2_flops(s, d, sweeps):
    """FP64 operations K2 does on one trial whose d Jacobi runs took
    ``sweeps`` (a list of d counts), from ``csrc/quadrature_nd.cu::
    nd_eigh_kernel``: the LDL once per trial, the solves, symmetrisation
    and sweeps once per dimension."""
    equil = 2 * s
    ldl = sum((s - j) * (2 + 3 * j) + 2 + (s - 1 - j) for j in range(s))
    solves = s * sum(3 * r + 3 for r in range(s)) + s * sum(3 * r + 1 for r in range(s))
    sym = s * (s - 1)
    check = 3 * s * s
    sweep = check + s * (s - 1) // 2 * (14 + 18 * s)
    jacobi = sum(n * sweep + check for n in sweeps)
    return equil + ldl + d * (solves + sym) + jacobi
