"""The deepseek family: its cell runs on the CPU at a tiny DeepSeek shape
and reads correct, its control engine at the reference's precision
serves the reference's best token, a program without the published
router is refused where the configuration is turned into the program's,
and the new readers take the family's yardstick at the cell's shapes."""

import dataclasses

import pytest

from perfbench import arith, control, deepseek_arith, run
from perfbench.tests.deepseek_tiny import tiny_config

CELL = "deepseekv3-flexgen256-hbm"
SEED = 2 ** 31 + 77
WINDOW_S = 10.0   # a batch has to complete inside it on a busy CPU
MIX = {"clients": 4, "prompt": {"fixed": 20}, "answer": {"fixed": 5},
       "pool": 8}


def _cell() -> run.Cell:
    """The cell at the tiny shape, served in fp32 on the bf16 weights: at
    64 wide, bf16 flips a routing near-tie often enough that the cell's
    limits, set at the published widths, do not carry over."""
    cell = run.load_cell(CELL)
    cell.config = tiny_config()
    cell.mix = dict(MIX)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_on_the_cpu_and_reads_correct(trace):
    out = run.run_cell(_cell(), SEED, WINDOW_S, trace, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if not trace:
        assert {"ttft_ms_p95", "tpot_ms_p50", "output_tokens_per_s",
                "setup_s"} == set(out["metrics"])


def test_the_control_engine_at_the_references_precision():
    cell = _cell()
    out = run.run_cell(cell, SEED, WINDOW_S, False, device="cpu",
                       engine_factory=control.factory(cell, None))
    assert out["correct"], out["checks"]
    assert out["checks"]["served_gap"]["value"] == 0.0


def test_a_program_without_the_published_router_is_refused(monkeypatch):
    """The parent's program: ``MoEConfig`` without the router's fields."""
    from repro_torch.config import base
    fields = [f for f in dataclasses.fields(base.MoEConfig)
              if f.name != "scoring_func"]
    legacy = dataclasses.make_dataclass(
        "MoEConfig", [(f.name, f.type, dataclasses.field(default=f.default))
                      for f in fields], frozen=True)
    monkeypatch.setattr(base, "MoEConfig", legacy)
    fam = run.load_cell(CELL).family
    with pytest.raises(SystemExit, match="lacks"):
        fam.port_config(run.load_cell(CELL).config)


def test_the_held_rooflines_read_the_familys_yardstick():
    c = run.load_cell(CELL).config
    d = deepseek_arith.Dims.from_config(c)
    assert d.decode_expert_bytes(0) == 4 * 8 * 3 * 7168 * 2048 * 2
    assert d.kv_bytes_per_token == 7 * (512 + 64) * 2
    B, plen = 256, 512
    dev = [{"name": "GroupProblemShape", "cat": "kernel", "start": 0.1,
            "end": 0.11, "bytes": 0},
           {"name": "cutlass grouped_gemm", "cat": "kernel", "start": 1.0,
            "end": 1.002, "bytes": 0},
           {"name": "Memcpy DtoH (Device -> Pageable)", "cat": "gpu_memcpy",
            "start": 1.003, "end": 1.0031, "bytes": 0}]
    rec = {"dims": d, "profiled": {"batch": B, "plen": plen},
           "trace": {"device": dev, "host": [],
                     "marks": {"prefill": (0.0, 0.5),
                               "decode": (1.0, 1.01)}}}
    got = run.reader("moe_held_roofline.decode")(rec)
    rows = 4 * 2 * B * 8 * 8 / 256 * 7168 * 2
    want = 100 * (d.decode_expert_bytes(0) + rows) \
        / arith.HBM_BYTES_PER_S / 0.002
    assert got == pytest.approx(want, rel=1e-9)
    got = run.reader("moe_held_roofline.prefill")(rec)
    flops = 2 * 3 * 7168 * 2048 * B * plen * 8 * 8 / 256 * 4
    assert got == pytest.approx(
        100 * flops / arith.PEAK_FLOPS["bfloat16"] / 0.01, rel=1e-9)
