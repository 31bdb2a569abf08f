"""Run one cell of the benchmark once and print its result as one JSON line.

  python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout on a machine with a CUDA card. The cell is an
entry of ``BENCHMARK.json``'s ``workloads``; everything else is found by
name: the configuration file ``BENCHMARK.json`` names, the traffic mix
``perfbench/traffic/<traffic>.json``, the cell's comparison settings
``perfbench/workloads/<cell>.json`` and a reader ``perfbench/metrics/
<metric>.py`` for every metric the cell reports.

The configuration file names its model family (``"family"``): the module
``perfbench/families/<family>.py`` holds all the harness knows of the
model, from the check of the program's configuration and the weight tree
to the reference, the control and the counts the per-layer readers take.
Outside the families, the reference, ``arith.py`` and ``moe_arith.py`` the
harness reads no key of a configuration but ``family``, ``arch``,
``vocab_size`` and ``serve``.

A run: set-up (the program's ``ServeEngine`` built, every weight drawn
again from ``--seed`` into it, the cell's largest shapes warmed up), then a
closed loop of the mix's clients for ``--seconds``: whenever they wait,
their next requests go to the engine's prefill role and then its decode
role as one batch. A request counts when its batch completes inside the
window; the window ends at the last such completion. ``--trace 1`` turns
on the engine's tracer in the window and then profiles one more batch's
prefill and a few decode steps with ``torch.profiler``; it reports the
per-layer metrics, ``--trace 0`` the end-to-end ones. After the window the
program is freed, the plain fp32 reference (``perfbench/reference/``) is
run over a sample of the completed requests drawn from the seed, and
``correct`` says whether every compared number is within its limit. The
numbers compared are printed beside their limits as the last lines of
standard error and under ``checks``, the last key of the result.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; with jax, jaxlib, flax or the JAX package loaded once
the window has closed, 3.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()     # set-up is timed from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
FAMILIES = HERE / "families"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level names, whole
PROFILED_DECODE_STEPS = 8
PROFILE_ATTEMPTS = 3


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc builds already go to ``build/repro_torch_kernels``)."""
    cache = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                # the configuration file
    family: object              # the module of its model family
    mix: dict                   # the traffic mix file
    settings: dict              # perfbench/workloads/<cell>.json
    end_to_end: dict            # metric name -> its BENCHMARK.json entry
    per_layer: dict


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None,
              families: Path = FAMILIES) -> Cell:
    """The cell ``name`` of ``bench`` (default ``BENCHMARK.json``), its
    configuration's family taken from ``families``."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"perfbench: no workload {name!r} in "
                         f"BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    kind = config.get("family")
    if kind is None:
        raise SystemExit(f"perfbench: {conf['file']} names no model family "
                         f"(its key \"family\"); the families are the "
                         f"modules in {families}")
    if not (Path(families) / f"{kind}.py").is_file():
        raise SystemExit(f"perfbench: {conf['file']} names the model family "
                         f"{kind!r}, but {families} holds no {kind}.py")
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        family=family(kind, families),
        mix=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                       .read_text()),
        settings=json.loads((HERE / "workloads" / f"{name}.json")
                            .read_text()),
        end_to_end={m["name"]: m for m in bench["end_to_end"]
                    if _reports(m, name)},
        per_layer={m["name"]: m for m in bench["per_layer"]
                   if _reports(m, name)})


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str, where: Path = FAMILIES):
    """The module ``<where>/<name>.py`` of the model family ``name``."""
    return _load(Path(where) / f"{name}.py", f"perfbench.families.{name}")


def reader(metric: str):
    """The ``read(record)`` of ``perfbench/metrics/<metric>.py``."""
    return _load(HERE / "metrics" / f"{metric}.py",
                 f"perfbench.metrics.{metric.replace('.', '_')}").read


# --------------------------------------------------------------------------
# The program under test
# --------------------------------------------------------------------------


def fill_weights(params: dict, fam, c: dict, seed: int, device) -> None:
    """Write the benchmark's weights for ``seed`` into the program's tree,
    which has to be the family ``fam``'s for the configuration ``c``: in
    place where a leaf lives on ``device``, through a device buffer where
    it lives in the host tier."""
    import torch
    from perfbench.reference.weights import draw
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v
    walk(params, ())
    want = fam.leaf_shapes(c)
    have = {p: tuple(t.shape) for p, t in flat.items()}
    if have != {p: tuple(s) for p, s in want.items()}:
        raise ValueError(f"the program's weight tree differs from the "
                         f"configuration's: program {sorted(have.items())}"
                         f" benchmark {sorted(want.items())}")
    device = torch.device(device)
    with torch.no_grad():
        for path, leaf in flat.items():
            if leaf.device == device:
                draw(seed, path, want[path], device, out=leaf.data,
                     init=fam.leaf_init)
            else:
                leaf.data.copy_(draw(seed, path, want[path], device,
                                     init=fam.leaf_init))


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` states it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def forbidden_modules(modules: dict | None = None) -> list[str]:
    """The top-level names in ``FORBIDDEN`` that ``modules`` (default
    ``sys.modules``) holds, each compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m, mod in list(modules.items())
                   if m.split(".")[0] in FORBIDDEN and mod is not None})


def holds_forbidden(prog: str = "perfbench") -> bool:
    """Whether this process holds a module of ``FORBIDDEN``, named on
    standard error if it does. A main asks once the window has closed,
    before it prints a result, and prints none where the answer is yes;
    not ``run_cell``, which tests call in processes that hold jax for
    their own."""
    leaked = forbidden_modules()
    if leaked:
        print(f"{prog}: modules loaded that the run may not hold: "
              f"{leaked}", file=sys.stderr)
    return bool(leaked)


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------


def _requests(draws):
    from repro_torch.launch.serve import Request
    return [Request(d.rid, d.prompt, d.max_new) for d in draws]


def warm_up(engine, traffic, device) -> None:
    """Every shape the window will use: the mix's longest prompt padded
    into a full batch with room for its longest answer, then one decode
    step against that cache."""
    import numpy as np
    from perfbench.traffic import Draw
    p, a = traffic.longest_prompt, traffic.longest_answer
    draws = [Draw(-1 - c, np.ones(p, np.int32), a)
             for c in range(traffic.clients)]
    handoff = engine.prefill(_requests(draws))
    engine.decode(dataclasses.replace(handoff, max_new=1))
    del handoff
    _sync(device)


def serve_batch(engine, draws) -> dict:
    """One batch through the engine's prefill role, then its decode role:
    its draws, the tokens served (the first from prefill, the rest from
    decode; none for a request the engine did not answer) and its issue,
    first-token and completion times."""
    t_issue = time.perf_counter()
    handoff = engine.prefill(_requests(draws))
    t_first = time.perf_counter()
    results = engine.decode(handoff)
    t_done = time.perf_counter()
    first = handoff.tok.cpu().view(-1).tolist()
    rows = {r.rid: i for i, r in enumerate(handoff.requests)}
    del handoff
    by_rid = {r.rid: r.tokens for r in results}
    served = [[first[rows[d.rid]]] + list(by_rid[d.rid]) if d.rid in by_rid
              else [] for d in draws]
    return {"draws": draws, "served": served, "t_issue": t_issue,
            "t_first": t_first, "t_done": t_done}


def serve_window(engine, traffic, seconds: float) -> tuple[list, float]:
    """The closed loop: batches of every client's next request until the
    window closes. Returns (batches, start); a batch is ``counted`` when it
    completed inside the window. One that cannot end in the window (less
    time left than half the fastest batch) is not started."""
    start = time.perf_counter()
    deadline = start + seconds
    fastest = 0.0
    batches = []
    while True:
        left = deadline - time.perf_counter()
        if left <= 0 or left < 0.5 * fastest:
            break
        b = serve_batch(engine, traffic.next_batch())
        took = b["t_done"] - b["t_issue"]
        fastest = min(fastest, took) if fastest else took
        b["counted"] = b["t_done"] <= deadline
        batches.append(b)
        if not b["counted"]:
            break
    return batches, start


def window_record(batches: list, start: float) -> tuple[dict, list]:
    """(record for the end-to-end readers, the counted requests as (draw,
    served tokens))."""
    counted = [b for b in batches if b["counted"]]
    requests, done = [], []
    for b in counted:
        for d, s in zip(b["draws"], b["served"]):
            done.append((d, s))
            if len(s) != d.max_new + 1:
                continue
            decode_tokens = len(s) - 1
            requests.append({
                "ttft_s": b["t_first"] - b["t_issue"],
                "tpot_s": ((b["t_done"] - b["t_first"]) / decode_tokens
                           if decode_tokens else None),
                "tokens": d.max_new})
    window_s = (counted[-1]["t_done"] - start) if counted else 0.0
    return {"requests": requests, "window_s": window_s}, done


def span_record(spans: list, batches: list) -> dict:
    """The engine's spans in the window as the per-layer readers take
    them: each prefill with its batch's real prompt lengths, each decode
    step with its batch size and the positions its sequences hold."""
    prefills, steps = [], []
    idx = -1
    for s in spans:
        wall = s["end"] - s["start"]
        if s["name"] == "serve.prefill":
            idx += 1
            b = batches[idx]
            prefills.append({"wall_s": wall, "batch": len(b["draws"]),
                             "plen": s["args"]["prompt_len"],
                             "prompt_lens": [len(d.prompt)
                                             for d in b["draws"]]})
        elif s["name"] == "serve.decode_step" and idx >= 0:
            steps.append({"wall_s": wall, "batch": s["args"]["batch"],
                          "context": prefills[idx]["plen"]
                          + s["args"]["step"]})
    return {"prefills": prefills, "decode_steps": steps}


def profile_batch(engine, traffic, device) -> tuple[dict, dict]:
    """One more batch's prefill and ``PROFILED_DECODE_STEPS`` decode steps
    under ``torch.profiler``, each in a window the harness marks. A
    recording with no device event is made again (the profiler on the
    card has now and then recorded none), up to ``PROFILE_ATTEMPTS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from perfbench.trace import MARK, read_chrome_trace
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    reqs = _requests(traffic.next_batch())
    for _ in range(PROFILE_ATTEMPTS):
        _sync(device)
        with profile(activities=acts) as prof:
            with record_function(MARK + "prefill"):
                handoff = engine.prefill(reqs)
            with record_function(MARK + "decode"):
                engine.decode(dataclasses.replace(
                    handoff, max_new=min(PROFILED_DECODE_STEPS,
                                         handoff.max_new)))
        _sync(device)
        trace = read_chrome_trace(prof)
        plen, B = handoff.plen, len(reqs)
        del handoff
        if trace["device"] or not cuda:
            break
        print("perfbench: the profiler recorded no device event; "
              "profiling again", file=sys.stderr, flush=True)
    return trace, {"batch": B, "plen": plen}


def check_served(cell: Cell, seed: int, done: list, device) -> dict:
    """The reference over a sample of the completed requests: {check:
    (value, limit)}; a value of None could not be read and fails."""
    from perfbench.reference.check import mean, sample, served_gaps, widest
    from perfbench.reference.weights import draw_all
    limits = cell.settings["limits"]
    missing = sum(1 for d, s in done if len(s) != d.max_new + 1)
    picked = [(d.prompt, s) for d, s in
              sample([(d, s) for d, s in done if s], seed,
                     cell.settings["sample_tokens"])]
    checks = {"missing_answers": (missing, limits["missing_answers"])}
    unread = {"served_gap": (None, limits["served_gap"]),
              "served_gap_mean": (None, limits["served_gap_mean"])}
    if not picked:
        return {**checks, **unread}
    vocab = cell.config["vocab_size"]
    out_of_range = sum(1 for _, s in picked for t in s
                       if not 0 <= int(t) < vocab)
    checks["tokens_out_of_vocab"] = (out_of_range, 0)
    if out_of_range:
        return {**checks, **unread}
    fam, c = cell.family, cell.config
    ref = fam.reference(c, draw_all(fam, c, seed, device))
    gaps = served_gaps(ref, picked)
    checks["served_gap"] = (widest(gaps), limits["served_gap"])
    checks["served_gap_mean"] = (mean(gaps), limits["served_gap_mean"])
    print(f"perfbench: the reference compared "
          f"{sum(len(s) for _, s in picked)} served tokens of "
          f"{len(picked)} requests", file=sys.stderr)
    return checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_process: float | None = None,
             engine_factory=None) -> dict:
    """One run of ``cell``; returns the result object. ``engine_factory``
    (cfg, offload, device) -> engine replaces ``ServeEngine`` (the tests
    put a broken engine in its place)."""
    import torch
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.obs import NULL_TRACER, Tracer
    from perfbench.trace import breakdown, busy, spans
    from perfbench.traffic import Traffic

    t_process = time.perf_counter() if t_process is None else t_process
    cuda = torch.device(device).type == "cuda"
    c, fam = cell.config, cell.family
    cfg = fam.port_config(c)
    offload = bool(c.get("serve", {}).get("offload_weights", False))
    factory = engine_factory or (lambda cfg, off, dev: ServeEngine(
        cfg, offload_weights=off, rng_seed=0, device=dev))
    t_start = time.perf_counter()
    engine = factory(cfg, offload, device)
    t_engine = time.perf_counter()
    fill_weights(engine.params_home, fam, c, seed, device)
    _sync(device)
    t_weights = time.perf_counter()
    traffic = Traffic(cell.mix, c["vocab_size"], seed)
    warm_up(engine, traffic, device)
    t_warm = time.perf_counter()
    setup_s = t_warm - t_process
    print(f"perfbench: set-up {setup_s:.2f} s: process start to engine "
          f"{t_start - t_process:.2f}, ServeEngine {t_engine - t_start:.2f}, "
          f"weights {t_weights - t_engine:.2f}, warm-up "
          f"{t_warm - t_weights:.2f}", file=sys.stderr, flush=True)

    tracer = Tracer() if trace else NULL_TRACER
    engine.tracer = tracer
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    batches, start = serve_window(engine, traffic, seconds)
    engine.tracer = NULL_TRACER
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    record, done = window_record(batches, start)
    record.update(setup_s=setup_s, dims=fam.yardstick(c))
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda
                else "cpu", "count": cell.chips,
                "memory_peak_bytes": int(peak),
                "power_limit": power_limit() if cuda else None}
    parts = None
    if trace:
        record.update(span_record(spans(tracer.events), batches))
        record["trace"], record["profiled"] = profile_batch(
            engine, traffic, device)
        dev_info["busy_s"], dev_info["window_s"] = busy(record["trace"])
        parts = breakdown(record["trace"])
    metrics = cell.per_layer if trace else cell.end_to_end
    values = {}
    for name, m in metrics.items():
        v = reader(name)(record)
        if v is not None:
            values[name] = {"value": v, "unit": m["unit"]}

    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check_served(cell, seed, done, device)
    failed = checks["missing_answers"][0]
    correct = bool(done) and all(v is not None and v <= lim
                                 for v, lim in checks.values())
    out = {"correct": correct, "attempted": len(done), "failed": failed,
           "metrics": values, "device": dev_info}
    if parts is not None:
        out["breakdown"] = parts
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has {n}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_PROCESS)
    if holds_forbidden():
        return 3
    for k, c in out["checks"].items():
        print(f"perfbench: check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
