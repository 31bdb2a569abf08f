"""The port's interference, qos, disagg and resilience benchmark families
vs the reference's, on the CPU.

Every row and every summary value is a simulation on a fabric preset (the
one wall-clock number, the resilience detector's per-call overhead, is
compared by its row name and threshold only), so the port must give the
reference's rows (as CSV text) and ``BENCH_<family>.json`` payloads
exactly. Pagers inside a family hold their pools on ``device="cpu"``.
The resilience family's reacting runs need the reference's fetch stand-in
(``test_torch_degrade.patch_reference_fetch``: the reference's own fetch
raises under the installed jax).
"""

import importlib
import inspect
import json

import pytest

from test_torch_degrade import patch_reference_fetch

FAMILIES = {"interference": "ALL_INTERFERENCE", "qos": "ALL_QOS",
            "disagg": "ALL_DISAGG", "resilience": "ALL_RESILIENCE"}
WALL_CLOCK = {"resilience_detector_overhead"}


def _family(side: str, name: str):
    return importlib.import_module(f"{side}.heimdall.{name}")


def _call(fn):
    """The port's row functions that build a pager take ``device=``."""
    if "device" in inspect.signature(fn).parameters:
        return fn(device="cpu")
    return fn()


def _rows(fns) -> list:
    return [r.csv() for fn in fns for r in _call(fn)]


@pytest.mark.parametrize("family,fn", [
    (fam, fn.__name__) for fam, lst in FAMILIES.items()
    for fn in getattr(_family("repro", fam), lst)])
def test_family_rows_match_reference(monkeypatch, family, fn):
    patch_reference_fetch(monkeypatch)
    ref, port = _family("repro", family), _family("repro_torch", family)
    assert [f.__name__ for f in getattr(port, FAMILIES[family])] == \
        [f.__name__ for f in getattr(ref, FAMILIES[family])]
    want, got = _rows([getattr(ref, fn)]), _rows([getattr(port, fn)])
    assert got
    if fn in WALL_CLOCK:
        # a measured time: the same row, the same threshold and verdict
        def strip(row):
            name, _, derived = row.split(",", 2)
            return name, derived.split(";n_reruns")[0]
        assert [strip(r) for r in got] == [strip(r) for r in want]
        return
    assert got == want


@pytest.mark.parametrize("family", ["qos", "disagg", "resilience"])
def test_family_summary_matches_reference(monkeypatch, family):
    patch_reference_fetch(monkeypatch)
    summary = f"{family}_summary"
    want = getattr(_family("repro", family), summary)()
    got = _call(getattr(_family("repro_torch", family), summary))
    if family == "resilience":
        assert got.pop("detector_overhead_us") > 0
        want.pop("detector_overhead_us")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_family_summaries_meet_their_thresholds():
    """The thresholds the reference holds each BENCH_<family>.json to,
    on the port's summaries (the resilience family needs no stand-in
    here: the port's fetch runs)."""
    from repro_torch.heimdall import disagg, qos, resilience
    q = qos.qos_summary()
    assert q["eta_improvement"] >= 1.3
    assert q["single_flow_anchor"]["rel_err"] < 1e-9
    d = disagg.disagg_summary(device="cpu")
    assert d["overlap_speedup"] >= disagg.MIN_OVERLAP_SPEEDUP
    assert d["deadline_violations"] == 0
    assert d["route_choice"]["degraded_staging"] is not None
    r = resilience.resilience_summary(device="cpu")
    assert r["recovery"]["frac"] >= resilience.MIN_RECOVERY_FRAC
    assert r["detect"]["latency_rounds"] <= resilience.MAX_DETECT_ROUNDS
    assert r["slo"]["violations_react"] < r["slo"]["violations_baseline"]
    assert r["detector_overhead_us"] < resilience.MAX_DETECTOR_OVERHEAD_US


def test_family_pagers_refuse_a_machine_without_cuda(monkeypatch):
    import torch
    from repro_torch.heimdall import disagg, qos, resilience
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (qos.qos_decode_admission, disagg.disagg_summary,
                 resilience.resilience_summary, disagg.disagg_overlap,
                 resilience.resilience_recovery):
        with pytest.raises(RuntimeError,
                           match="no CUDA device is available"):
            call()
