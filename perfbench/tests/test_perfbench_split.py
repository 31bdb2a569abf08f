"""The readings of the engine's split of a step (fetch, dispatch, read
back) on synthetic records: nothing where the spans or marks are missing,
the median over the window's decode steps, and the device's idle time put
down to the host's dispatch only where a ``model.decode`` annotation
covers it."""

import json

import pytest

from perfbench import run, split
from perfbench.tests.tiny import tiny_cell


def span(name, start, end, **args):
    return {"name": name, "start": start, "end": end, "args": args}


# (fetch, dispatch, wait) of each decode step, in s; the prefill's own are
# far from their medians, so counting them would move every median
STEPS = [(0.30, 0.050, 0.004), (0.50, 0.070, 0.002), (0.40, 0.060, 0.006)]


def window_spans(offload=True):
    """One batch: its prefill, then a decode step for each of STEPS, each
    parent span enclosing its children as the engine nests them."""
    out, t = [], 0.0
    fetch = [span("offload.fetch", t + 0.01, t + 0.91)] if offload else []
    out += [span("serve.prefill", t, t + 2.0), *fetch,
            span("model.prefill", t + 0.92, t + 1.0),
            span("serve.readback", t + 1.0, t + 1.99)]
    t = 2.0
    for s, (f, d, w) in enumerate(STEPS):
        fetch = [span("offload.fetch", t, t + f)] if offload else []
        f = f if offload else 0.0
        out += [span("serve.decode_step", t, t + f + d + w + 1e-4, step=s),
                *fetch, span("model.decode", t + f, t + f + d, step=s),
                span("serve.readback", t + f + d, t + f + d + w)]
        t += f + d + w + 1e-3
    return sorted(out, key=lambda s: s["start"])


@pytest.mark.parametrize("name, want_ms", [
    ("fetch_ms_p50.offload", 400.0), ("decode_dispatch_ms_p50", 60.0),
    ("decode_wait_ms_p50", 4.0)])
def test_span_readers_take_the_median_over_decode_steps(name, want_ms):
    assert split.READINGS[name]({"spans": window_spans()}) == \
        pytest.approx(want_ms)


@pytest.mark.parametrize("name", ["fetch_ms_p50.offload",
                                  "decode_dispatch_ms_p50",
                                  "decode_wait_ms_p50"])
def test_span_readers_read_nothing_without_the_spans(name):
    read = split.READINGS[name]
    assert read({}) is None
    assert read({"spans": []}) is None
    # the window's spans of a program without the split (the parent's)
    bare = [s for s in window_spans() if s["name"].startswith("serve.")
            and s["name"] != "serve.readback"]
    assert read({"spans": bare}) is None


def test_fetch_reader_reads_nothing_where_the_weights_stay_on_the_card():
    spans = window_spans(offload=False)
    assert split.READINGS["fetch_ms_p50.offload"]({"spans": spans}) is None
    assert split.READINGS["decode_dispatch_ms_p50"]({"spans": spans}) == \
        pytest.approx(60.0)


def device(start, end):
    return {"name": "k", "cat": "kernel", "start": start, "end": end,
            "bytes": 0}


def host(name, start, end):
    return {"name": name, "start": start, "end": end}


def profiled(annotations):
    """The profiled decode window [0, 10] s: the device busy over [1, 3]
    and [5, 6] (idle 7 s of 10), the host in ``annotations``."""
    return {"trace": {"device": [device(1, 3), device(5, 6)],
                      "host": [host("aten::mm", 4, 8), *annotations],
                      "marks": {"prefill": (-5, 0), "decode": (0, 10)}}}


def test_dispatch_idle_counts_only_idle_inside_model_decode():
    rec = profiled([host("model.decode", 0, 4),
                    host("model.decode", 8, 9.5)])
    # idle [0, 1], [3, 4] and [8, 9.5] lie inside the annotations; [4, 5],
    # [6, 8] and [9.5, 10] do not
    share = split.READINGS["dispatch_idle_share.decode"](rec)
    assert share == pytest.approx(35.0)
    assert share <= run.reader("device_idle_share.decode")(rec) == \
        pytest.approx(70.0)


def test_dispatch_idle_leaves_out_a_gap_outside_every_annotation():
    read = split.READINGS["dispatch_idle_share.decode"]
    inside = read(profiled([host("model.decode", 3, 4)]))
    assert inside == pytest.approx(10.0)
    # the same annotation, and the idle [6, 8] under another host op
    assert read(profiled([host("model.decode", 3, 4),
                          host("serve.readback", 6, 8)])) == \
        pytest.approx(inside)
    # an annotation over busy time alone
    assert read(profiled([host("model.decode", 1, 3)])) == 0.0


def test_dispatch_idle_reads_nothing_without_marks_or_annotations():
    read = split.READINGS["dispatch_idle_share.decode"]
    assert read({}) is None
    assert read(profiled([])) is None          # the parent's program
    rec = profiled([host("model.decode", 0, 4)])
    del rec["trace"]["marks"]["decode"]
    assert read(rec) is None
    rec = profiled([host("model.decode", 0, 4)])
    rec["trace"]["device"] = []
    assert read(rec) is None


@pytest.mark.parametrize("name", ["yi9b-flexgen-offload", "yi9b-flexgen-hbm"])
def test_a_run_on_the_cpu_reads_the_split_of_the_engines_step(name):
    [out] = split.run_seeds(tiny_cell(name), [2 ** 31 + 7], 1.0,
                            device="cpu")
    assert out["workload"] == name
    assert ("fetch_ms_p50.offload" in out) == name.endswith("-offload")
    assert out["decode_dispatch_ms_p50"] > 0
    assert out["decode_wait_ms_p50"] >= 0
    # the three children leave only the engine's bookkeeping of the step
    assert 50.0 < out["split_over_step"] <= 100.0
    json.dumps(out)
