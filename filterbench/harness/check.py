"""The comparison that decides ``correct``.

After the window has closed, a sample of the answers it produced is
recomputed by the configuration's plain reference (``reference/<system>.py``)
from the same observations.  The reference module says what is compared:

- ``ANSWERS``: the keys of a pass's output that are sampled, each a
  tensor with the trials on its first axis;
- ``NUMBERS``: the names of the numbers it computes;
- ``numbers(program, reference)``: those numbers from the sampled
  answers of both sides;
- ``run(config, traffic, ys, dtype, **control)``: the reference's
  answers for the observations ``ys (T, B, ...)``;
- ``INPUTS``, where given: answers of the program that the reference
  reads as inputs, as a served model's tokens are read (here the rescue
  tier that answered a trial), passed to ``run`` by name;
- ``CONTROLS``: the controls, each the keyword arguments of ``run`` that
  put a lower precision in the program's place.

Here the sample is drawn and each number is held against its limit from
the workload file.  A cell compares the numbers its workload file gives a
limit; the others are recorded, not judged.

The sample is drawn from the seed: ``sample`` (pass, trial) pairs, the
trials distinct, each from a pass of the window; and every trial that
the window's last pass handed to a rescue tier, up to one bucket, since
those answers come through another path.
"""
import torch


def sample(seed: int, batch: int, passes: int, size: int, extra=()) -> tuple:
    """(pass index, trial index) arrays: ``size`` distinct trials drawn
    from the seed, each from a pass drawn from the seed, then ``extra``
    trials from the last pass."""
    g = torch.Generator().manual_seed(seed + 1)
    trials = torch.randperm(batch, generator=g)[:min(size, batch)]
    which = torch.randint(passes, (trials.shape[0],), generator=g)
    extra = torch.as_tensor(list(extra), dtype=torch.long)
    extra = extra[~torch.isin(extra, trials)]
    return (torch.cat([which, torch.full_like(extra, passes - 1)]),
            torch.cat([trials, extra]))


def gather(outputs: list, which, trials, keys) -> dict:
    """The sampled answers ``keys`` of the window's passes, on the CPU."""
    out = {}
    for key in keys:
        first = outputs[0][key]
        rows = torch.empty((trials.shape[0],) + tuple(first.shape[1:]), dtype=first.dtype)
        for p in which.unique().tolist():
            pick = which == p
            rows[pick] = outputs[p][key][trials[pick].to(first.device)].cpu()
        out[key] = rows
    return out


def verdict(found: dict, limits: dict) -> tuple:
    """``(correct, check)``: each compared number beside its limit."""
    if not limits or set(limits) - set(found):
        raise ValueError(f"a cell's limits name some of {sorted(found)}: {limits}")
    check = {k: {"value": found[k], "limit": v} for k, v in limits.items()}
    return all(v["value"] <= v["limit"] for v in check.values()), check
