"""The serve step's split, read from the engine's own spans: how long a
decode step waits for its weights, how long the host takes to issue its
kernels, how long it then waits for the device, and how much of the
card's idle time in decode falls inside that issuing.

  python3 -m perfbench.split --workload <cell> --seeds 1,2 [--seconds 51]

runs the cell on the card as ``perfbench.run --trace 1`` does (set-up,
the window under a ``Tracer``, then one more batch under
``torch.profiler``), but with the profiled batch traced too, so that the
engine's spans land in the profiler's trace as its annotations. It prints
one JSON line a seed: the four readings below, beside the harness's own
``decode_step_ms_p50`` and ``device_idle_share.decode`` from the same
records, which they are checked against (the three medians add up to
about the step; the dispatch idle is at most the idle). No comparison
runs: the numbers are timings, not a verdict.

The benchmark's run does not take these readings: its record holds
neither the window's spans nor a traced profiled batch. Each ``read_*``
below takes a record as ``perfbench/metrics/`` readers do, plus
``record["spans"]`` (``perfbench.trace.spans`` of the window's events).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys

from perfbench import arith, run
from perfbench.trace import intervals

STEP, PREFILL = "serve.decode_step", "serve.prefill"


def _median_ms_in_steps(record, name: str):
    """Median wall, in ms, of the ``name`` spans that lie inside a decode
    step (not inside a prefill) of the window."""
    walls, parent = [], None
    for s in record.get("spans", ()):
        if s["name"] in (STEP, PREFILL):
            parent = s
        elif (s["name"] == name and parent is not None
              and parent["name"] == STEP and s["end"] <= parent["end"]):
            walls.append(s["end"] - s["start"])
    return statistics.median(walls) * 1e3 if walls else None


def read_fetch_ms_p50(record):
    """Median ``offload.fetch`` span in a decode step, in ms: how long a
    step waits for its weights from the host tier (the exposed part, once
    the fetch overlaps compute). None where the weights stay on the
    card."""
    return _median_ms_in_steps(record, "offload.fetch")


def read_decode_dispatch_ms_p50(record):
    """Median ``model.decode`` span, in ms: the host's time to issue a
    decode step's kernels (the model's step and the argmax)."""
    return _median_ms_in_steps(record, "model.decode")


def read_decode_wait_ms_p50(record):
    """Median ``serve.readback`` span in a decode step, in ms: the
    device's work left when the host has issued a step and waits for its
    tokens."""
    return _median_ms_in_steps(record, "serve.readback")


def read_dispatch_idle_share(record):
    """Device-idle time of the profiled decode steps that falls inside
    the program's ``model.decode`` annotations, over the steps' wall, in
    %: the share of decode the card waits on the host issuing kernels.
    Idle is what the union of the kernel, copy and memset intervals leaves
    of the window, as ``device_idle_share.decode`` reads it, so this share
    is at most that one."""
    trace = record.get("trace")
    if not trace or "decode" not in trace["marks"]:
        return None
    lo, hi = trace["marks"]["decode"]
    busy = intervals(trace["device"], lo, hi)
    dispatch = intervals(trace["host"], lo, hi,
                         lambda e: e["name"] == "model.decode")
    if not busy or not dispatch:
        return None
    idle = sum(arith.covered(dispatch, g0, g1)
               for g0, g1 in arith.gaps(busy, lo, hi))
    return 100.0 * idle / (hi - lo)


READINGS = {"fetch_ms_p50.offload": read_fetch_ms_p50,
            "decode_dispatch_ms_p50": read_decode_dispatch_ms_p50,
            "decode_wait_ms_p50": read_decode_wait_ms_p50,
            "dispatch_idle_share.decode": read_dispatch_idle_share}
# the harness's own readers of the same records, the readings' yardsticks
HARNESS = ("decode_step_ms_p50", "device_idle_share.decode")


def split_record(engine, traffic, seconds: float, device) -> dict:
    """The window under a ``Tracer``, then one batch profiled under a
    ``Tracer`` of its own: the record the readings take."""
    from repro_torch.obs import NULL_TRACER, Tracer
    from perfbench.trace import spans
    tracer = Tracer()
    engine.tracer = tracer
    batches, _ = run.serve_window(engine, traffic, seconds)
    engine.tracer = Tracer()
    trace, _ = run.profile_batch(engine, traffic, device)
    engine.tracer = NULL_TRACER
    record = {"spans": spans(tracer.events), "trace": trace}
    record.update(run.span_record(record["spans"], batches))
    return record


def readings(record) -> dict:
    """Every reading that finds something to read, and the harness's two
    yardsticks; ``split_over_step`` is fetch + dispatch + wait over the
    step, in %."""
    out = {name: read(record) for name, read in READINGS.items()}
    for name in HARNESS:
        out[name] = run.reader(name)(record)
    parts = [out["fetch_ms_p50.offload"] or 0.0,
             out["decode_dispatch_ms_p50"], out["decode_wait_ms_p50"]]
    if None not in parts and out["decode_step_ms_p50"]:
        out["split_over_step"] = 100.0 * sum(parts) / \
            out["decode_step_ms_p50"]
    return {k: v for k, v in out.items() if v is not None}


def run_seeds(cell: run.Cell, seeds: list, seconds: float,
              device="cuda") -> list[dict]:
    """One engine, built once; each seed's weights drawn into it and its
    own traffic served and read."""
    import torch
    from repro_torch.launch.serve import ServeEngine
    from perfbench.traffic import Traffic
    c = cell.config
    offload = bool(c.get("serve", {}).get("offload_weights", False))
    engine = ServeEngine(cell.family.port_config(c),
                         offload_weights=offload, rng_seed=0, device=device)
    out = []
    for seed in seeds:
        run.fill_weights(engine.params_home, cell.family, c, seed, device)
        traffic = Traffic(cell.mix, c["vocab_size"], seed)
        run.warm_up(engine, traffic, device)
        out.append({"workload": cell.name, "seed": seed, **readings(
            split_record(engine, traffic, seconds, device))})
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=51)
    args = ap.parse_args(argv)
    run.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("perfbench.split: no CUDA card", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    kind = torch.cuda.get_device_name()
    for line in run_seeds(cell, [int(s) for s in args.seeds.split(",")],
                          args.seconds):
        if run.holds_forbidden("perfbench.split"):
            return 3
        print(json.dumps({**line, "device": kind,
                          "power_limit": run.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
