"""repro_torch.heimdall.obs (the observability family) vs the reference's,
on the CPU.

Everything the family reports is simulated or computed from a simulated
run, except the tracer's overhead: wall-clock times of the traced and
untraced serve engine, schedule loop and fabric simulation. So
``obs_summary()`` must equal the reference's as JSON text but for its
``overhead`` entry (``TIMING_FIELDS``), and every row but the overhead
rows, whose names and keys must match.

The resilience scenario the family replays recovers by fetching spilled
pages, which the reference cannot do under the installed jax (ROADMAP
fault C1): it runs through ``test_torch_degrade.patch_reference_fetch``.
The family's results are cached per process, as the reference's are.
"""

import inspect
import json

import pytest

from test_torch_degrade import patch_reference_fetch
from test_torch_heimdall import _shape

from repro_torch.heimdall import obs

TIMING_FIELDS = ("overhead",)      # obs_summary()'s wall-clock entry
TIMED_ROWS = ("obs_tracer_overhead",)


def _call(fn):
    if "device" in inspect.signature(fn).parameters:
        return fn(device="cpu")
    return fn()


def test_family_list_matches_reference():
    from repro.heimdall import obs as ref
    assert [f.__name__ for f in obs.ALL_OBS] == \
        [f.__name__ for f in ref.ALL_OBS]
    for name in ("MAX_OVERHEAD_FRAC", "MAX_BYTE_REL_ERR", "MAX_HIST_REL_ERR",
                 "MIN_ATTR_TOP_FRAC", "MAX_LEDGER_REL_ERR",
                 "MAX_POST_RECAL_RATIO", "MAX_RECAL_ETA_REL_ERR"):
        assert getattr(obs, name) == getattr(ref, name), name


def test_obs_summary_matches_reference_but_for_timing(monkeypatch):
    from repro.heimdall import obs as ref
    patch_reference_fetch(monkeypatch)
    want = ref.obs_summary()
    got = obs.obs_summary(device="cpu")
    timing = {k: (got.pop(k), want.pop(k)) for k in TIMING_FIELDS}
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)
    g, w = timing["overhead"]
    assert sorted(g) == sorted(w)
    assert sorted(g["null_us"]) == sorted(w["null_us"])
    assert all(v > 0 for v in g["null_us"].values())
    # the family's own verdicts hold on the port
    assert got["byte_conservation"]["max_rel_err"] <= obs.MAX_BYTE_REL_ERR
    assert got["attribution"]["top_degraded_frac"] >= obs.MIN_ATTR_TOP_FRAC
    assert got["recalibration"]["max_post_ratio"] <= \
        obs.MAX_POST_RECAL_RATIO
    assert got["efficiency"]["degraded_is_lowest"]
    assert got["openmetrics"]["valid"]


@pytest.mark.parametrize("name", [f.__name__ for f in obs.ALL_OBS])
def test_obs_rows_match_reference(monkeypatch, name):
    from repro.heimdall import obs as ref
    patch_reference_fetch(monkeypatch)
    want = [r.csv() for r in getattr(ref, name)()]
    got = [r.csv() for r in _call(getattr(obs, name))]
    assert got
    if name in TIMED_ROWS:
        # a noise-guard rerun (";n_reruns=") rides along only when taken
        def shape(row):
            return _shape(row.split(";n_reruns=")[0])
        assert [shape(r) for r in got] == [shape(r) for r in want]
        return
    assert got == want


def test_obs_family_runs_on_cuda_by_default(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        obs.obs_summary()
