"""HEIMDALL's benchmark runner: one entry per paper table or figure.

The port of the reference's ``benchmarks/run.py``. Prints
``name,us_per_call,derived`` CSV, one status line per family on stderr,
and exits 1 if any benchmark or summary raises:

    python -m repro_torch.heimdall.run [--only substring] [--skip-apps]
        [--families micro,kv_quant,qos,obs] [--json-out BENCH_kv_quant.json]
        [--json-out-dir .] [--device cuda|cpu]

``--json-out`` writes the JSON summary of the selected summarizable family
(kv_quant, qos, calibration, obs, resilience or disagg); select exactly one
of them when using it. ``--json-out-dir`` writes ``BENCH_<family>.json``
into the directory for *every* summarizable family selected; a family
whose summary raises is reported (and fails the run) without aborting the
remaining families.

The benchmarks that hold tensors, pagers or a serving engine run on
``--device`` (default ``cuda``; without a card the runner raises before any
family runs); the simulated ones (``SIMULATED``) take no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

from repro_torch.models.context import resolve_device


def _families():
    from repro_torch.heimdall.apps import ALL_APPS
    from repro_torch.heimdall.calibration import ALL_CALIBRATION
    from repro_torch.heimdall.disagg import ALL_DISAGG
    from repro_torch.heimdall.interference import ALL_INTERFERENCE
    from repro_torch.heimdall.kv_quant import ALL_KV_QUANT
    from repro_torch.heimdall.micro import ALL_MICRO
    from repro_torch.heimdall.obs import ALL_OBS
    from repro_torch.heimdall.qos import ALL_QOS
    from repro_torch.heimdall.resilience import ALL_RESILIENCE
    return {"micro": list(ALL_MICRO),
            "interference": list(ALL_INTERFERENCE),
            "kv_quant": list(ALL_KV_QUANT),
            "qos": list(ALL_QOS),
            "calibration": list(ALL_CALIBRATION),
            "obs": list(ALL_OBS),
            "resilience": list(ALL_RESILIENCE),
            "disagg": list(ALL_DISAGG),
            "apps": list(ALL_APPS)}


def _summary_fn(family: str):
    """Family -> JSON summary builder (the BENCH_<family>.json payloads)."""
    if family == "kv_quant":
        from repro_torch.heimdall.kv_quant import bench_summary
        return bench_summary
    if family == "qos":
        from repro_torch.heimdall.qos import qos_summary
        return qos_summary
    if family == "calibration":
        from repro_torch.heimdall.calibration import calibration_summary
        return calibration_summary
    if family == "obs":
        from repro_torch.heimdall.obs import obs_summary
        return obs_summary
    if family == "resilience":
        from repro_torch.heimdall.resilience import resilience_summary
        return resilience_summary
    if family == "disagg":
        from repro_torch.heimdall.disagg import disagg_summary
        return disagg_summary
    return None


SUMMARIZABLE = ("kv_quant", "qos", "calibration", "obs", "resilience",
                "disagg")

# The benchmarks and summaries that are pure simulation (or host-only
# timing) and take no device; every other one takes ``device``.
SIMULATED = frozenset({
    "interference_single_flow_anchor", "interference_noisy_neighbor",
    "interference_offload_vs_prefetch", "interference_bidirectional",
    "interference_loaded_bandwidth",
    "qos_single_flow_anchor", "qos_weighted_split", "qos_priority_shield",
    "qos_prefetch_eta", "qos_summary",
    "calibration_fit_quality", "calibration_recovery",
    "calibration_validation", "calibration_roundtrip",
    "calibration_summary",
    "obs_byte_conservation", "obs_trace_export", "obs_histogram",
    "resilience_detector_overhead"})


def _on(fn, device):
    """Call a benchmark or summary, on ``device`` unless it is simulated."""
    if fn.__name__ in SIMULATED:
        return fn()
    return fn(device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="run benchmarks whose name contains this")
    ap.add_argument("--families", default=None,
                    help="comma-separated families to run "
                         "(micro,interference,kv_quant,qos,calibration,"
                         "obs,resilience,disagg,apps); default: all minus "
                         "--skip-* flags")
    ap.add_argument("--json-out", default=None,
                    help="write the selected summarizable family's JSON "
                         "summary (one of: %s) to this path"
                         % ",".join(SUMMARIZABLE))
    ap.add_argument("--json-out-dir", default=None,
                    help="write BENCH_<family>.json into this directory "
                         "for every summarizable family selected")
    ap.add_argument("--skip-apps", action="store_true")
    ap.add_argument("--skip-interference", action="store_true")
    ap.add_argument("--skip-kv-quant", action="store_true")
    ap.add_argument("--skip-qos", action="store_true")
    ap.add_argument("--skip-calibration", action="store_true")
    ap.add_argument("--skip-obs", action="store_true")
    ap.add_argument("--skip-resilience", action="store_true")
    ap.add_argument("--skip-disagg", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    fams = _families()
    if args.families is not None:
        names = [f.strip() for f in args.families.split(",") if f.strip()]
        unknown = [f for f in names if f not in fams]
        if unknown:
            sys.exit(f"unknown families {unknown}; have {sorted(fams)}")
        selected = {f: fams[f] for f in fams if f in names}
        selected_summaries = [f for f in SUMMARIZABLE if f in names]
    else:
        skips = {"interference": args.skip_interference,
                 "kv_quant": args.skip_kv_quant,
                 "qos": args.skip_qos,
                 "calibration": args.skip_calibration,
                 "obs": args.skip_obs,
                 "resilience": args.skip_resilience,
                 "disagg": args.skip_disagg,
                 "apps": args.skip_apps}
        selected = {f: benches for f, benches in fams.items()
                    if not skips.get(f, False)}
        selected_summaries = [f for f in SUMMARIZABLE
                              if not skips.get(f, False)]
    if args.json_out and len(selected_summaries) != 1:
        sys.exit("--json-out writes one family's JSON summary; select "
                 f"exactly one of {SUMMARIZABLE} (got {selected_summaries}) "
                 "or use --json-out-dir for several")
    if args.json_out_dir and not selected_summaries:
        sys.exit("--json-out-dir needs at least one summarizable family "
                 f"selected (one of {SUMMARIZABLE})")
    # once, before any family: no card means no rows, not rows of ERROR
    device = resolve_device(args.device)
    print("name,us_per_call,derived")
    failures = 0
    fam_stats: dict = {}
    for fam in fams:
        if fam not in selected:
            fam_stats[fam] = None
            continue
        ran = skipped = failed = 0
        for bench in selected[fam]:
            if args.only and args.only not in bench.__name__:
                skipped += 1
                continue
            try:
                for row in _on(bench, device):
                    print(row.csv(), flush=True)
                ran += 1
            except Exception as e:      # noqa: BLE001
                failures += 1
                failed += 1
                print(f"{bench.__name__},ERROR,{type(e).__name__}: {e}",
                      flush=True)
                traceback.print_exc(file=sys.stderr)
        fam_stats[fam] = (ran, skipped, failed)
    # one status line per family, so a CI log makes "what actually ran"
    # auditable at a glance (a silently skipped family reads as green)
    for fam, st in fam_stats.items():
        if st is None:
            print(f"family {fam}: skipped", file=sys.stderr)
        else:
            ran, skipped, failed = st
            print(f"family {fam}: ran={ran} skipped={skipped} "
                  f"failed={failed}", file=sys.stderr)
    failed_summaries = []
    if args.json_out:
        summary = _on(_summary_fn(selected_summaries[0]), device)
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"wrote {args.json_out}", file=sys.stderr)
    if args.json_out_dir:
        os.makedirs(args.json_out_dir, exist_ok=True)
        for fam in selected_summaries:
            # one family's broken summary must not abort the sweep: write
            # every summary that succeeds, report the rest, exit nonzero
            try:
                summary = _on(_summary_fn(fam), device)
            except Exception as e:      # noqa: BLE001
                failed_summaries.append(fam)
                print(f"summary for {fam} FAILED: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
                traceback.print_exc(file=sys.stderr)
                continue
            path = os.path.join(args.json_out_dir, f"BENCH_{fam}.json")
            with open(path, "w") as f:
                json.dump(summary, f, indent=2)
            print(f"wrote {path}", file=sys.stderr)
    if failed_summaries:
        print(f"failed summaries: {','.join(failed_summaries)}",
              file=sys.stderr)
    if failures or failed_summaries:
        sys.exit(1)


if __name__ == "__main__":
    main()
