"""What a traced run records, read into plain lists: the engine's spans
from its ``Tracer`` and the device's activity from a ``torch.profiler``
trace, with the windows the harness marked in it.

Device activity is every kernel, copy and memset the profiler saw on the
card; busy time is the union of their intervals (``arith.covered``), so a
copy that overlaps a kernel counts once.
"""

from __future__ import annotations

import json
import os
import tempfile

from perfbench import arith

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
MARK = "perfbench."          # prefix of the harness's own annotations


def spans(events) -> list[dict]:
    """The tracer's begin/end pairs as {name, start, end, args}, in order
    of their start (pairs matched per track, innermost first)."""
    open_: dict = {}
    out = []
    for e in events:
        if e.kind == "B":
            open_.setdefault((e.track, e.name), []).append(e)
        elif e.kind == "E":
            stack = open_.get((e.track, e.name))
            if stack:
                b = stack.pop()
                out.append({"name": e.name, "start": b.ts, "end": e.ts,
                            "args": dict(b.args or {})})
    return sorted(out, key=lambda s: s["start"])


def read_chrome_trace(prof) -> dict:
    """A finished profiler run as {device: [...], host: [...], marks:
    {name: (start, end)}}, times in seconds on the profiler's clock.

    The trace goes through a file under ``TMPDIR`` (deleted here): that
    export is the profiler's documented way to its copy events' bytes."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    device, host, marks = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e["dur"]) * 1e-6
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append({"name": e["name"], "cat": cat, "start": t0,
                           "end": t1,
                           "bytes": (e.get("args") or {}).get("bytes", 0)})
        elif cat == "user_annotation" and e["name"].startswith(MARK):
            marks[e["name"][len(MARK):]] = (t0, t1)
        elif cat in HOST_CATS:
            host.append({"name": e["name"], "start": t0, "end": t1})
    return {"device": device, "host": host, "marks": marks}


def intervals(events, lo: float, hi: float, pick=lambda e: True) -> list:
    """(start, end) of the events ``pick`` keeps that touch [lo, hi]."""
    return [(e["start"], e["end"]) for e in events
            if pick(e) and e["end"] > lo and e["start"] < hi]


def busy(trace: dict) -> tuple[float, float]:
    """(device busy seconds, window seconds) over the marked windows."""
    busy_s = window_s = 0.0
    for lo, hi in trace["marks"].values():
        busy_s += arith.covered(intervals(trace["device"], lo, hi), lo, hi)
        window_s += hi - lo
    return busy_s, window_s


def _host_during(host: list, t: float) -> str:
    """The innermost host event running at ``t`` (the shortest that
    contains it), or a note that none was recorded."""
    best = None
    for e in host:
        if e["start"] <= t <= e["end"] and (
                best is None or e["end"] - e["start"] <
                best["end"] - best["start"]):
            best = e
    return best["name"] if best else "no host op recorded"


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time (summed by name over the
    marked windows) and the longest idle gaps, each named by the window
    and the host op running in its middle."""
    by_name: dict = {}
    idle = []
    for mark, (lo, hi) in trace["marks"].items():
        ivs = []
        for e in trace["device"]:
            if e["end"] > lo and e["start"] < hi:
                t = min(e["end"], hi) - max(e["start"], lo)
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + t
                ivs.append((e["start"], e["end"]))
        idle += [(mark, g0, g1) for g0, g1 in arith.gaps(ivs, lo, hi)]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(idle, key=lambda g: g[1] - g[2])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[f"{mark}: "
                           f"{_host_during(trace['host'], (g0 + g1) / 2)}",
                           g1 - g0] for mark, g0, g1 in idle]}
