"""Particle filters (sequential Monte Carlo) — batch-first.

Port of ``mfs_tpu/filters/smc.py``: bootstrap and proposal-based
particle filters.  The state carried through the time loop is
``(..., n)`` for scalar states or ``(..., n, dx)`` for vector states,
where ``...`` are Monte-Carlo trial axes: one call filters a whole trial
ensemble, resampling each trial independently.

Random streams: where JAX takes a PRNG key, these take a
``torch.Generator`` on the measurements' device (another device
raises).  It seeds 2T + 1 child generators, as JAX splits its key: one
for the initial draw, then one for propagation and one for resampling
each step.  A step's draws therefore do not depend on how the loop is
cut into checkpointed segments (``remat_chunk``), whose recomputation
draws them again.
"""
from typing import Any, Callable, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from mfs_tpu_torch.config import check_generator
from mfs_tpu_torch.filters.resampling import continuous_resampling
from mfs_tpu_torch.typings import Array, FloatScalar


def _child_seeds(generator: torch.Generator, count: int, device) -> List[int]:
    check_generator(generator, device)
    return torch.randint(0, 2**62, (count,), generator=generator,
                         device=generator.device).tolist()


def _child(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _gather_particles(samples: Array, idx: Array, vector_state: bool) -> Array:
    if vector_state:
        return torch.gather(samples, -2, idx[..., None].expand(idx.shape + samples.shape[-1:]))
    return torch.gather(samples, -1, idx)


def _expand_y(y: Array, samples: Array, vector_state: bool) -> Array:
    """Insert the particle axis into per-trial measurements: a ``(...,)``
    y broadcasts against ``(..., n)`` samples, a ``(..., dy)`` y against
    ``(..., n, dx)``; scalars and broadcastable shapes pass unchanged."""
    if y.ndim == samples.ndim - 1 and y.ndim > 0:
        return y[..., None, :] if vector_state else y[..., None]
    return y


def _stack(outs: list):
    """Stack per-step outputs over time: tensors, or tuples, lists and
    dicts of tensors."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([o[i] for o in outs]) for i in range(len(first)))
    return torch.stack(outs)


def bootstrap_filter(
    transition_sampler: Callable[[Array, torch.Generator], Array],
    measurement_cond_pdf: Callable[[Array, Array], Array],
    ys: Array,
    init_sampler: Callable[[torch.Generator, int], Array],
    generator: torch.Generator,
    nsamples: int,
    resampling: Callable[[Array, torch.Generator], Array],
    conti_resampling: bool = False,
    vector_state: bool = False,
    remat_chunk: int = 0,
    out_fn: Callable[[Array], Any] = None,
) -> Tuple[Any, FloatScalar]:
    """Bootstrap particle filter over an ensemble of trials.

    Parameters
    ----------
    transition_sampler : ((..., n[, dx]), generator) -> (..., n[, dx])
        Propagates all particles of all trials through the transition.
    measurement_cond_pdf : (y, x) -> (..., n)
        Likelihood of y at each particle; must broadcast y (with the
        particle axis inserted by the filter) against the particles.
    ys : Array (T, ...)
        Measurements: time first, then trial axes (and a trailing dy
        axis when ``vector_state``).
    init_sampler : (generator, n) -> (..., n[, dx])
    generator : torch.Generator
        On ``ys``'s device; the source of every child stream.
    nsamples : int
    resampling : ((..., n), generator) -> (..., n) integer indices.
    conti_resampling : bool
        Use the differentiable continuous resampler (scalar states).
    vector_state : bool
        Particles carry a trailing state axis ``dx``.
    remat_chunk : int
        When > 0 (and dividing T), run the loop as T/chunk segments under
        ``torch.utils.checkpoint``: the backward pass keeps only the
        segment-boundary particle states and recomputes each segment.
        Forward results are unchanged.
    out_fn : callable, optional
        Per-step reduction of the resampled particles (a tensor, or a
        tuple, list or dict of tensors); the stacked reductions replace
        the raw trajectories in the first return value.

    Returns
    -------
    samples : Array (T, ..., n[, dx]) (or stacked ``out_fn`` outputs),
    nell : Array (...)
        Per-trial negative log-likelihoods.
    """
    T = ys.shape[0]
    seeds = _child_seeds(generator, 2 * T + 1, ys.device)
    dev = generator.device
    reduce = out_fn if out_fn is not None else (lambda s: s)

    def segment(samples, nell, t0, t1):
        outs = []
        for t in range(t0, t1):
            samples = transition_sampler(samples, _child(seeds[1 + 2 * t], dev))
            weights = measurement_cond_pdf(_expand_y(ys[t], samples, vector_state), samples)
            nell = nell - torch.log(torch.mean(weights, dim=-1))
            weights = weights / torch.sum(weights, dim=-1, keepdim=True)
            g_res = _child(seeds[2 + 2 * t], dev)
            if conti_resampling:
                samples = continuous_resampling(samples, weights, nsamples, g_res)
            else:
                samples = _gather_particles(samples, resampling(weights, g_res), vector_state)
            outs.append(reduce(samples))
        return samples, nell, outs

    init = init_sampler(_child(seeds[0], dev), nsamples)
    batch_shape = init.shape[: init.ndim - (2 if vector_state else 1)]
    nell = torch.zeros(batch_shape, dtype=init.dtype, device=init.device)
    if remat_chunk and remat_chunk < T:
        if T % remat_chunk:
            raise ValueError(f"remat_chunk {remat_chunk} must divide T {T}")
        samples, outs = init, []
        for t0 in range(0, T, remat_chunk):
            samples, nell, seg = checkpoint(segment, samples, nell, t0, t0 + remat_chunk,
                                            use_reentrant=False)
            outs.extend(seg)
    else:
        _, nell, outs = segment(init, nell, 0, T)
    return _stack(outs), nell


def particle_filter(
    proposal_sampler: Callable[[Array, Array, torch.Generator], Array],
    proposal_density: Callable[[Array, Array, Array], Array],
    transition_density: Callable[[Array, Array], Array],
    measurement_cond_pdf: Callable[[Array, Array], Array],
    ys: Array,
    init_sampler: Callable[[torch.Generator, int], Array],
    generator: torch.Generator,
    nsamples: int,
    resampling: Callable[[Array, torch.Generator], Array],
    vector_state: bool = False,
    out_fn: Callable[[Array], Any] = None,
) -> Any:
    """Proposal-based SMC (importance weights corrected by the
    transition/proposal density ratio), batch-first like
    ``bootstrap_filter``.

    Returns the resampled particle trajectories (T, ..., n[, dx]), or,
    when ``out_fn`` is given, ``out_fn(samples)`` per step stacked over
    time.
    """
    T = ys.shape[0]
    seeds = _child_seeds(generator, 2 * T + 1, ys.device)
    dev = generator.device
    reduce = out_fn if out_fn is not None else (lambda s: s)
    ancestors = init_sampler(_child(seeds[0], dev), nsamples)
    outs = []
    for t in range(T):
        y_b = _expand_y(ys[t], ancestors, vector_state)
        samples = proposal_sampler(ancestors, y_b, _child(seeds[1 + 2 * t], dev))
        weights = (
            measurement_cond_pdf(y_b, samples)
            * transition_density(samples, ancestors)
            / proposal_density(samples, ancestors, y_b)
        )
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)
        ancestors = _gather_particles(
            samples, resampling(weights, _child(seeds[2 + 2 * t], dev)), vector_state)
        outs.append(reduce(ancestors))
    return _stack(outs)
