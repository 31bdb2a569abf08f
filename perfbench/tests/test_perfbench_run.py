"""A whole run on the CPU at tiny widths, past the harness's look for a
card: the program as it is reads correct, and the program broken
underneath reads not correct, once for each fault a serving cell can
have. The control at a size the CPU holds."""

import json
import sys
import types

import pytest
import torch

from perfbench import control, faults, run
from perfbench.tests.tiny import tiny_cell

CELLS = ["yi9b-flexgen-offload", "yi9b-flexgen-hbm"]
SEED = 2 ** 31 + 99
WINDOW_S = 3.0       # long enough for some batches on a loaded CPU
# widths at which fp8 departs from fp32 as clearly as at the cells' own
# (at TINY's the control's mean gap reads 0.005-0.008, near the limit)
CONTROL_SIZES = dict(hidden_size=128, num_attention_heads=8,
                     intermediate_size=256, vocab_size=4096,
                     num_hidden_layers=4)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_program_reads_correct(name, trace):
    out = run.run_cell(tiny_cell(name), SEED, WINDOW_S, trace, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    json.dumps(out)
    m = out["metrics"]
    if trace:
        assert {"decode_step_ms_p50", "prefill_mfu", "decode_mbu"} <= set(m)
    else:
        assert {"ttft_ms_p95", "tpot_ms_p50", "output_tokens_per_s",
                "setup_s"} == set(m)


# answers as long as the prompts, so that a step's K/V weighs in the next
# token as much as a deployment's long answers make it. At the cells' 512
# and 32 the card reads a cache never written by the mean gap alone
# (0.0072-0.0088 against 0.004; PERF.md); at TINY's widths and those
# proportions the mean reads 0.001-0.0016, under the cells' limit.
FAULT_MIX = {"clients": 4, "prompt": {"fixed": 8}, "answer": {"fixed": 16},
             "pool": 8}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_reads_not_correct(name, fault):
    out = run.run_cell(tiny_cell(name, mix=FAULT_MIX), SEED, WINDOW_S, False,
                       device="cpu", engine_factory=faults.factory(fault))
    assert not out["correct"], out["checks"]


def test_a_run_goes_on_in_a_process_that_holds_jax(monkeypatch):
    """A test process may hold jax for tests of its own: ``run_cell``
    leaves the look for forbidden modules to ``main``, which makes it in
    the process that prints the result."""
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert "jax" in run.forbidden_modules()
    out = run.run_cell(tiny_cell(), SEED, WINDOW_S, False, device="cpu")
    assert out["correct"], out["checks"]


def test_window_counts_only_batches_that_end_inside_it():
    cell = tiny_cell()
    out = run.run_cell(cell, SEED, WINDOW_S, False, device="cpu")
    assert out["attempted"] % cell.mix["clients"] == 0
    tokens = out["metrics"]["output_tokens_per_s"]["value"]
    assert tokens > 0


def test_control_reads_wider_gaps_than_the_program():
    """fp8 at the program's positions, at the widths the CPU holds: on
    every seed its widest and its mean gap are at least three times the
    program's (the cells' limits are set from the same readings at full
    size on the card, PERF.md)."""
    mix = {"clients": 8, "prompt": {"fixed": 32}, "answer": {"fixed": 16},
           "pool": 8}
    cell = tiny_cell(mix=mix, **CONTROL_SIZES)
    cell.settings = dict(cell.settings, sample_tokens=128)
    torch.set_num_threads(4)
    rows = control.readings(cell, [1, 2, 3], device="cpu")
    for r in rows:
        assert r["control_gap"] >= 3 * r["program_gap"], r
        assert r["control_mean"] >= 3 * r["program_mean"], r


@pytest.mark.parametrize("name", CELLS)
def test_control_in_the_programs_place_reads_not_correct(name):
    """The reference in fp8, serving the cell's traffic through the whole
    run in the program's place, fails the run's own comparison."""
    cell = tiny_cell(name, **CONTROL_SIZES)
    out = run.run_cell(cell, SEED, 3 * WINDOW_S, False, device="cpu",
                       engine_factory=control.factory(cell))
    assert out["attempted"] > 0 and out["failed"] == 0
    assert not out["correct"], out["checks"]


def test_reference_engine_in_fp32_serves_the_references_picks():
    """The control's own decoding (its cache, its steps) at the
    reference's precision picks the reference's best token everywhere,
    so what the control's run reads comes of fp8 alone."""
    cell = tiny_cell()
    out = run.run_cell(cell, SEED, WINDOW_S, False, device="cpu",
                       engine_factory=control.factory(cell, None))
    assert out["correct"], out["checks"]
    assert out["checks"]["served_gap"]["value"] == 0.0


@pytest.mark.gpu
def test_tiny_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell(tiny_cell(), SEED, WINDOW_S, True, device="cuda")
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
