"""Model families: a configuration file names its family, and the harness
takes all it knows of the model from ``perfbench/families/<family>.py``.

A family added as one file runs a cell on the CPU and reads correct; a
configuration with no family, or with one that has no module, is refused
where the cell is loaded; every cell finds its family's module by the
name its configuration gives; and the decoder family gives the program's
configuration, the draws of every leaf, and, through the yardstick, each
per-layer reader's number as ``arith`` and ``moe_arith`` count it, at the
cells' shapes.
"""

import dataclasses
import json
import statistics
from pathlib import Path

import pytest
import torch

from perfbench import arith, control, moe_arith, run
from perfbench.reference import weights
from perfbench.tests import relabelled
from perfbench.tests.tiny import DECODER, MIX, tiny_config

TESTS = Path(__file__).resolve().parent
CELL = "yi9b-flexgen-hbm"
SEED = 2 ** 31 + 99
WINDOW_S = 3.0
CONFIGS = ["yi-9b-offload", "yi-9b", "mixtral-8x22b-7of56"]
WORKLOADS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]
# what a family module supplies
FAMILY_API = ["port_config", "leaf_shapes", "leaf_init", "reference",
              "control_engine", "yardstick"]
# the cells' shapes: 64 prompts of 512, answers of 32
BATCH, PLEN, CONTEXTS = 64, 512, range(512, 544)


def _config(name: str) -> dict:
    return json.loads(
        (run.HERE / "configs" / f"{name}.json").read_text())


def _tiny(name: str) -> dict:
    c = tiny_config(_config(name), intermediate_size=32)
    if c.get("num_local_experts"):
        c["overrides"]["moe"] = {"d_ff_expert": c["intermediate_size"]}
    return c


def _bench(tmp_path, config: dict) -> dict:
    """BENCHMARK.json with ``CELL``'s configuration file replaced by
    ``config``, written under ``tmp_path``."""
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    name = {w["name"]: w for w in bench["workloads"]}[CELL]["config"]
    for conf in bench["configs"]:
        if conf["name"] == name:
            conf["file"] = str(path)
    return bench


def _relabelled_cell(tmp_path) -> run.Cell:
    c = relabelled.relabel(_tiny("yi-9b"))
    assert not set(relabelled.KEYS.values()) & set(c)
    cell = run.load_cell(CELL, _bench(tmp_path, c), families=TESTS)
    assert Path(cell.family.__file__) == TESTS / "relabelled.py"
    cell.mix = dict(MIX)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_a_family_in_one_file_runs_a_cell(tmp_path, trace):
    out = run.run_cell(_relabelled_cell(tmp_path), SEED, WINDOW_S, trace,
                       device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    m = out["metrics"]
    if trace:
        assert {"decode_step_ms_p50", "prefill_mfu", "decode_mbu"} <= set(m)
    else:
        assert {"ttft_ms_p95", "tpot_ms_p50", "output_tokens_per_s",
                "setup_s"} == set(m)


def test_a_familys_control_engine_serves_in_the_programs_place(tmp_path):
    """The family's control engine at the reference's precision serves
    the reference's best token everywhere."""
    cell = _relabelled_cell(tmp_path)
    out = run.run_cell(cell, SEED, WINDOW_S, False, device="cpu",
                       engine_factory=control.factory(cell, None))
    assert out["correct"], out["checks"]
    assert out["checks"]["served_gap"]["value"] == 0.0


@pytest.mark.parametrize("kind", [None, "nosuch"])
def test_a_configuration_without_a_known_family_is_refused(tmp_path, kind):
    c = _config("yi-9b")
    if kind is None:
        del c["family"]
    else:
        c["family"] = kind
    with pytest.raises(SystemExit) as e:
        run.load_cell(CELL, _bench(tmp_path, c))
    msg = str(e.value)
    assert str(tmp_path / "config.json") in msg
    assert str(run.FAMILIES) in msg
    assert (f"{kind!r}" if kind else "no model family") in msg


@pytest.mark.parametrize("name", WORKLOADS)
def test_each_cell_finds_its_family_by_name(name):
    cell = run.load_cell(name)
    want = run.FAMILIES / f"{cell.config['family']}.py"
    assert Path(cell.family.__file__) == want
    for f in FAMILY_API:
        assert callable(getattr(cell.family, f, None)), (want, f)


# ---------------------------------------------------------------------------
# The decoder family gives the numbers the harness's functions give
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_port_config(name):
    """The program's registered configuration with the file's overrides;
    a file that departs from the program is refused, naming the key."""
    from repro_torch.config.base import get_config
    c = _config(name)
    want = get_config(c["arch"])
    want = dataclasses.replace(want, **c["overrides"])
    assert DECODER.port_config(c) == want
    with pytest.raises(ValueError, match="num_key_value_heads"):
        DECODER.port_config(dict(c, num_key_value_heads=3))


def _drawn_as_before(c: dict, seed: int) -> dict:
    """Every leaf drawn as ``reference.weights.draw`` draws it: a normal of
    ``leaf_init``'s mean and scale from a generator seeded by
    ``leaf_seed``, in bf16."""
    out = {}
    for path, shape in weights.leaf_shapes(c).items():
        gen = torch.Generator().manual_seed(weights.leaf_seed(seed, path))
        mean, std = weights.leaf_init(path, shape)
        out[path] = torch.empty(shape, dtype=torch.bfloat16).normal_(
            mean, std, generator=gen)
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_draws_and_filled_weights_are_bit_equal(name):
    c, seed = _tiny(name), 2 ** 31 + 5
    want = _drawn_as_before(c, seed)
    got = weights.draw_all(DECODER, c, seed, "cpu")
    assert set(got) == set(want)
    for p in want:
        assert torch.equal(got[p], want[p]), p
    tree: dict = {}
    for path, shape in DECODER.leaf_shapes(c).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros(shape, dtype=torch.bfloat16)
    run.fill_weights(tree, DECODER, c, seed, "cpu")
    for path, t in want.items():
        node = tree
        for k in path:
            node = node[k]
        assert torch.equal(node, t), path


def _ev(name, start, end, cat="kernel"):
    return {"name": name, "cat": cat, "start": start, "end": end, "bytes": 0}


READBACK = "Memcpy DtoH (Device -> Pageable)"


def _traced_record(dims) -> dict:
    """A traced run's record at the cells' shapes: window spans of two
    prefills and the decode steps of their contexts, and a profiled
    prefill and three decode steps with attention and expert kernels."""
    prefills = [{"wall_s": w, "batch": BATCH, "plen": PLEN,
                 "prompt_lens": [PLEN] * BATCH} for w in (0.61, 0.64)]
    steps = [{"wall_s": 0.015 + 1e-5 * i, "batch": BATCH, "context": ctx}
             for i, ctx in enumerate(CONTEXTS)]
    device = [_ev("flash_fwd_kernel", 0.01, 0.05),
              _ev("GroupProblemShape", 0.05, 0.4)]
    for s in range(3):
        t = 1.0 + 0.02 * s
        device += [_ev("decode_attention_kernel_split", t, t + 0.001),
                   _ev("grouped_gemm", t + 0.001, t + 0.013),
                   _ev(READBACK, t + 0.015, t + 0.0151, cat="gpu_memcpy")]
    return {"prefills": prefills, "decode_steps": steps, "dims": dims,
            "trace": {"device": device, "host": [],
                      "marks": {"prefill": (0.0, 0.6),
                                "decode": (1.0, 1.06)}},
            "profiled": {"batch": BATCH, "plen": PLEN}}


def _as_before(d: arith.Dims) -> dict:
    """Each reader's number from ``arith`` and ``moe_arith`` called on the
    configuration's ``Dims``, over ``_traced_record``'s times."""
    prefill = statistics.median(
        100.0 * arith.prefill_flops(d, [PLEN] * BATCH) / w
        / arith.PEAK_FLOPS["bfloat16"] for w in (0.61, 0.64))
    mbu = statistics.median(
        100.0 * arith.decode_step_bytes(d, BATCH, ctx)
        / (0.015 + 1e-5 * i) / arith.HBM_BYTES_PER_S
        for i, ctx in enumerate(CONTEXTS))
    shape = (BATCH, d.heads, d.kv_heads, PLEN, d.head_dim, True, d.window)
    attn = 100.0 * d.layers * arith.attention_bound(shape)["bound_s"] / 0.04
    positions = sum(PLEN + i + 1 for i in range(3))
    k8 = 100.0 * (BATCH * positions * d.kv_bytes_per_token
                  / arith.HBM_BYTES_PER_S) / 0.003
    out = {"prefill_mfu": prefill, "decode_mbu": mbu,
           "attn_prefill_roofline": attn, "attn_decode_roofline": k8,
           "moe_experts_roofline.decode": None,
           "moe_experts_roofline.prefill": None}
    if d.experts:
        out["moe_experts_roofline.decode"] = 100.0 * (
            3 * moe_arith.decode_expert_bytes(d, BATCH)
            / arith.HBM_BYTES_PER_S) / 0.036
        out["moe_experts_roofline.prefill"] = 100.0 * \
            moe_arith.prefill_expert_flops(d, BATCH * PLEN) \
            / arith.PEAK_FLOPS["bfloat16"] / 0.35
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_readers_take_the_yardstick_as_they_took_arith(name):
    c = _config(name)
    rec = _traced_record(DECODER.yardstick(c))
    for metric, want in _as_before(arith.Dims.from_config(c)).items():
        got = run.reader(metric)(rec)
        if want is None:
            assert got is None, metric
        else:
            assert got == pytest.approx(want, rel=1e-12), metric
