"""The control, and the readings that a cell's limits are set from.

The control is the plain reference put in the program's place and
computed one precision below the bf16 the configuration states: every
projection's operands in fp8 (the cell's family's ``control_engine``).
It serves the cell's traffic through the harness's own loop and
comparison, greedy, through a K/V cache of its own, and has to read as
not correct there.

  python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \\
      [--fault state_unchanged] [--no-control]

reads, on each seed, one batch at the cell's own load through the
program (or, with ``--fault``, one of ``perfbench/faults.py``'s broken
engines in its place): the numbers the benchmark compares over the
cell's sample (``program_gap``, ``program_mean``) and, unless
``--no-control``, the control's at the same positions (the reference's
gap of the token fp8 puts first there: ``control_gap``,
``control_mean``). The engine is built once and every seed's weights are
drawn into it again, so a dozen seeds cost one set-up.

  python3 -m perfbench.control --workload <cell> --seeds 1,2 --run \\
      {control,<fault>} [--seconds 51]

runs the whole of ``perfbench.run``'s run (window, then comparison) with
that engine in the program's place, one result line per seed.

Both on the card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from perfbench import faults, run


def factory(cell: run.Cell, quant: str | None = "fp8"):
    """(cfg, offload, device) -> the control engine of ``cell``'s
    family for its configuration, as ``run.run_cell`` takes an engine
    factory."""
    return lambda cfg, offload, device: cell.family.control_engine(
        cell.config, device, quant)


def readings(cell: run.Cell, seeds: list[int], device="cuda",
             engine_factory=None, control: bool = True):
    """Each seed's row of served gaps, the program's and, with
    ``control``, the fp8 reference's at the same tokens, as it is read."""
    import torch
    from repro_torch.launch.serve import ServeEngine
    from perfbench.reference.check import (control_gaps, mean, sample,
                                           served_gaps, widest)
    from perfbench.reference.weights import draw_all
    from perfbench.traffic import Traffic
    c, fam = cell.config, cell.family
    cfg = fam.port_config(c)
    offload = bool(c.get("serve", {}).get("offload_weights", False))
    factory_ = engine_factory or (lambda cfg, off, dev: ServeEngine(
        cfg, offload_weights=off, rng_seed=0, device=dev))
    engine = factory_(cfg, offload, device)
    for seed in seeds:
        run.fill_weights(engine.params_home, fam, c, seed, device)
        traffic = Traffic(cell.mix, c["vocab_size"], seed)
        batch = run.serve_batch(engine, traffic.next_batch())
        picked = sample(list(zip(batch["draws"], batch["served"])), seed,
                        cell.settings["sample_tokens"])
        items = [(d.prompt, s) for d, s in picked]
        w = draw_all(fam, c, seed, device)
        ref = fam.reference(c, w)
        gaps = served_gaps(ref, items)
        ctl = control_gaps(ref, fam.reference(c, w, quant="fp8"), items) \
            if control else None
        del w, ref
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        row = {"seed": seed, "tokens": sum(len(s) for _, s in items),
               "program_gap": widest(gaps), "program_mean": mean(gaps)}
        if ctl is not None:
            row.update(control_gap=widest(ctl), control_mean=mean(ctl))
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--run", choices=["control", *sorted(faults.FAULTS)])
    ap.add_argument("--seconds", type=float, default=51)
    args = ap.parse_args(argv)
    run.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.run:
        for seed in seeds:
            make = factory(cell) if args.run == "control" \
                else faults.factory(args.run)
            out = run.run_cell(cell, seed, args.seconds, False, "cuda",
                               engine_factory=make)
            if run.holds_forbidden("perfbench.control"):
                return 3
            print(json.dumps({"run": args.run, "seed": seed, **out}),
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        return 0
    make = args.fault and faults.factory(args.fault)
    for row in readings(cell, seeds, engine_factory=make,
                        control=not args.no_control):
        if run.holds_forbidden("perfbench.control"):
            return 3
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
