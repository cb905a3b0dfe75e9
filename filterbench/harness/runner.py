"""One run of one cell: set-up, the measured window, the check.

``run`` returns the result line's object, or raises; ``run.py`` is the
command-line entry.
"""
import gc
import sys
import time

import torch

from harness import check, trace
from harness.cell import Cell, load_module
from harness.probes import PREFIX, Probes

FORBIDDEN = ("jax", "jaxlib", "flax", "mfs_tpu")
WARM_UP_STEPS = 2


class NoDevice(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_fields(device, chips, peak):
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def _peak(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def run(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", system_factory=None) -> dict:
    """``system_factory(cell, device, probes)``, when given, builds the
    system under test in place of ``systems/<system>.py``'s ``System``
    (the tests plant faults this way)."""
    cell = Cell(workload)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"{workload} needs {cell.chips} CUDA device(s); "
                           f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.cuda.set_device(device)
    model, traffic = cell.config["model"], cell.traffic

    parts = {"imports_and_context": time.perf_counter() - t_start}
    t = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    data = cell.module("traffic").generate(model, traffic, gen)
    ys = data["ys"]
    _sync(device)
    parts["traffic"] = time.perf_counter() - t
    t = time.perf_counter()
    probes = Probes()
    if system_factory is None:
        system = cell.module("systems").System(cell.config, traffic, device, probes)
    else:
        system = system_factory(cell, device, probes)
    _sync(device)
    parts["system_build"] = time.perf_counter() - t
    t = time.perf_counter()
    system.warm_up(ys, WARM_UP_STEPS)
    _sync(device)
    parts["warm_up"] = time.perf_counter() - t
    peak_setup = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    outputs, ends = [], []
    records = {"setup_s": setup_s, "setup_parts": parts, "T": ys.shape[0], "B": ys.shape[1]}
    if not traced:
        t0 = time.perf_counter()
        while not ends or ends[-1] - t0 < seconds:
            outputs.append(system.run_pass(ys))
            _sync(device)
            ends.append(time.perf_counter())
        records["window_s"] = ends[-1] - t0
        records["pass_s"] = [b - a for a, b in zip([t0] + ends[:-1], ends)]
    else:
        outputs.append(system.run_pass(ys))  # the allocator's first pass, untraced
        _sync(device)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with probes.traced(getattr(system, "quadrature_site", None)):
                with torch.profiler.record_function(PREFIX + "window"):
                    outputs.append(system.run_pass(ys))
                    _sync(device)
        records.update(trace.reduce(prof.profiler.kineto_results.events()))
        records["counts"] = dict(probes.counts)
        records["work"] = dict(probes.work)
        records["rerun"] = outputs[-1].get("rerun", 0)
        records["has_rescue"] = "rescue" in cell.config.get("filter", {})
        del prof
    peak_window = _peak(device)
    records["peak_bytes"] = peak_window
    finite = [int(o["finite"].sum()) for o in outputs]
    records["finite_per_pass"] = finite
    B = ys.shape[1]

    # the check: sampled answers against the plain reference, after the
    # program's state is freed
    ref = cell.module("reference")
    which, trials = check.sample(seed, B, len(outputs), int(cell.workload["check"]["sample"]),
                                 outputs[-1].get("rerun_idx", ()))
    program = check.gather(outputs, which, trials, ref.ANSWERS)
    sub_ys = ys[:, trials.to(ys.device)]
    records["check_trials"] = int(trials.numel())
    records["rerun_idx"] = list(outputs[-1].get("rerun_idx", ()))
    del system, outputs, data
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    inputs = {k: program[k] for k in getattr(ref, "INPUTS", ())}
    reference = ref.run(cell.config, traffic, sub_ys, torch.float64, **inputs)
    records["reference_s"] = time.perf_counter() - t
    reference = {k: v.cpu() for k, v in reference.items()}
    found = ref.numbers(program, reference)
    if hasattr(ref, "spread"):
        records["check_spread"] = ref.spread(program, reference)
    correct, compared = check.verdict(found, cell.workload["limits"])
    records["check_numbers"] = found

    metrics = {}
    for spec in (cell.per_layer if traced else cell.end_to_end):
        value = load_module("metrics", spec["name"]).read(records)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = _device_fields(device, cell.chips, max(peak_setup, peak_window))
    result = {"correct": correct, "attempted": B * len(finite),
              "failed": B * len(finite) - sum(finite), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = records["busy_s"]
        dev["window_s"] = records["window_s"]
        result["breakdown"] = records["breakdown"]
    result["check"] = compared
    records.pop("breakdown", None)
    result["records"] = records
    return result


