"""The Beneš cell's rescue on the CPU: trials that tier 0 loses go through
the configuration's tiers, come back into the pass's answers through the
splice, land in the check's sample and are judged there.  On the card
the cell's traffic never reaches the tiers (tier 0 keeps every trial), so
tier 0 is made to lose some here."""
import json
import time

import pytest
import torch

from harness import check

NAME = "bb.n15.b524288"
SAMPLE = 8  # fewer than the trials, so the rescued ones reach the sample by ``rerun_idx``
SEED = 2**31 + 5


def lost_by_tier0(b):
    return torch.arange(b) % 5 == 1


def factory(alter_tier=False):
    def make(cell, device, probes):
        system = cell.module("systems").System(cell.config, cell.traffic, device, probes)
        tier0, tier1 = system.tier0, system.tiers[0]

        def lossy(y):
            out = tier0(y)
            lost = lost_by_tier0(y.shape[1]).to(y.device)
            return {k: torch.where(lost.view((-1,) + (1,) * (v.dim() - 1)), torch.nan, v)
                    for k, v in out.items()}

        def altered(y):
            out = tier1(y)
            return dict(out, nell=out["nell"] * (1 + 1e-5))

        system.tier0 = lossy
        if alter_tier:
            system.tiers[0] = altered
        return system
    return make


@pytest.fixture
def small_sample(tiny_bench):
    path = tiny_bench / "workloads" / f"{NAME}.json"
    w = json.loads(path.read_text())
    w["check"]["sample"] = SAMPLE
    path.write_text(json.dumps(w))
    return w["traffic"]["B"]


def test_rescued_trials_are_spliced_sampled_and_judged(small_sample):
    from harness import runner
    B = small_sample
    lost = torch.nonzero(lost_by_tier0(B))[:, 0].tolist()
    result = runner.run(NAME, SEED, 0.05, True, time.perf_counter(), device="cpu",
                        system_factory=factory())
    rec = result["records"]
    assert rec["rerun"] == len(lost) and rec["rerun_idx"] == lost
    assert result["metrics"]["rescue.rerun_pct"]["value"] == 100.0 * len(lost) / B
    which, trials = check.sample(SEED, B, 2, SAMPLE, lost)
    assert set(lost) <= set(trials.tolist()) and rec["check_trials"] == trials.numel() > SAMPLE
    assert result["failed"] == 0 and result["correct"] is True, result["check"]


def test_a_rescue_tier_altering_its_answers_is_not_correct(small_sample):
    from harness import runner
    result = runner.run(NAME, SEED, 0.05, False, time.perf_counter(), device="cpu",
                        system_factory=factory(alter_tier=True))
    assert result["correct"] is False, result["check"]
