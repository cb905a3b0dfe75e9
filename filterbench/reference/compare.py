"""How a filter's answers are judged against its plain reference, for the
configurations whose reference is a filter (``benes_bernoulli``,
``prey_predator``); their reference modules take these names.

The answers of a pass, and the reference's, are ``nell (B,)``, each
trial's negative log likelihood, ``mean (B, ...)``, its filtering mean at
the last step, and ``finite (B,)``, whether all of the trial's answers
are finite.  The numbers compared:

- ``nell_rel_gap``: the widest relative gap of a trial's nell, over the
  trials finite on both sides;
- ``mean_abs_gap``: the widest absolute gap of a trial's last mean, over
  the same trials;
- ``nell_rel_gap_q99``, ``mean_abs_gap_q99``: the 99th percentiles of
  the same gaps, which hold steady from seed to seed where the widest gap
  swings with the single worst-conditioned trial;
- ``finite_mismatch``: the share of trials finite on one side only.

A gap that no trial can give (no trial finite on both sides) reads as
infinity.
"""
import math

import torch

ANSWERS = ("nell", "mean", "finite")
NUMBERS = ("nell_rel_gap", "mean_abs_gap", "nell_rel_gap_q99", "mean_abs_gap_q99",
           "finite_mismatch")


def _flat(m):
    return m.reshape(m.shape[0], -1)


def finite(nell, mean):
    return torch.isfinite(nell) & torch.isfinite(_flat(mean)).all(-1)


def numbers(program: dict, reference: dict) -> dict:
    """The compared numbers of one program-reference pair (CPU tensors)."""
    ref_nell = reference["nell"].to(torch.float64)
    ref_mean = reference["mean"].to(torch.float64)
    prog_nell = program["nell"].to(torch.float64)
    prog_mean = program["mean"].to(torch.float64)
    ref_ok, prog_ok = reference["finite"].bool(), program["finite"].bool()
    both = ref_ok & prog_ok
    found = {"finite_mismatch": (ref_ok != prog_ok).double().mean().item()}
    gaps = {"nell_rel_gap": ((prog_nell - ref_nell).abs() / ref_nell.abs())[both],
            "mean_abs_gap": (_flat(prog_mean) - _flat(ref_mean)).abs().amax(-1)[both]}
    for name, gap in gaps.items():
        found[name] = gap.max().item() if gap.numel() else math.inf
        found[name + "_q99"] = torch.quantile(gap, 0.99).item() if gap.numel() else math.inf
    return {k: found[k] for k in NUMBERS}


def spread(program: dict, reference: dict) -> dict:
    """How the relative nell gaps of the trials spread (median, 90th and
    99th percentiles, largest) and on which side trials were lost: a
    record for the run's report, not compared."""
    ref_nell = reference["nell"].to(torch.float64)
    gap = (program["nell"].to(torch.float64) - ref_nell).abs() / ref_nell.abs()
    gap = gap[torch.isfinite(gap)]
    ref_ok, prog_ok = reference["finite"].bool(), program["finite"].bool()
    q = (torch.quantile(gap, torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=gap.dtype)).tolist()
         if gap.numel() else [])
    return {"trials": int(ref_nell.shape[0]), "nell_rel_gap_q50_q90_q99_max": q,
            "lost_by_program_only": int((ref_ok & ~prog_ok).sum()),
            "lost_by_reference_only": int((prog_ok & ~ref_ok).sum())}
