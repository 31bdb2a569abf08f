"""The Mixtral cell's files and yardstick on the CPU: the configuration
fits the program (shrunk to tiny widths), the program's dropless serving
roles give the plain reference's logits where the capacity body would
drop pairs, and the expert layers' counts in ``perfbench/moe_arith.py``
against hand counts."""

import dataclasses
import json

import pytest
import torch

from perfbench import arith, moe_arith, run
from perfbench.reference.model import Reference
from perfbench.reference.weights import draw_all, leaf_shapes
from perfbench.tests.tiny import DECODER, tiny_config
from perfbench.tests.test_perfbench_reference import _tree

CONFIG = run.ROOT / "perfbench" / "configs" / "mixtral-8x22b-7of56.json"
CELL = "mixtral8x22b-flexgen-hbm"


def _tiny():
    """The configuration file at tiny widths, its 8 experts and top 2 as
    published, with the override that shrinks the program's experts."""
    c = tiny_config(json.loads(CONFIG.read_text()), intermediate_size=32)
    c["overrides"]["moe"] = {"d_ff_expert": c["intermediate_size"]}
    return c


def test_configuration_keeps_the_published_widths():
    c = json.loads(CONFIG.read_text())
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    entry = {x["name"]: x for x in bench["configs"]}["mixtral-8x22b-7of56"]
    assert entry["reduced"] == c["reduced"] == ["num_hidden_layers"]
    assert (c["num_hidden_layers"], c["published"]["num_hidden_layers"]) \
        == (7, 56)
    assert (c["hidden_size"], c["intermediate_size"], c["num_local_experts"],
            c["num_experts_per_tok"], c["num_attention_heads"],
            c["num_key_value_heads"], c["head_dim"], c["vocab_size"]) == \
        (6144, 16384, 8, 2, 48, 8, 128, 32768)
    assert "capacity_factor" not in json.dumps(c["overrides"])
    cfg = DECODER.port_config(c)
    assert cfg.num_layers == 7 and cfg.moe.num_experts == 8
    d = arith.Dims.from_config(c)
    assert d.weight_count * 2 == 35_862_171_648
    assert d.kv_bytes_per_token == 28_672


def test_tiny_configuration_fits_port_config_and_leaf_shapes():
    c = _tiny()
    cfg = DECODER.port_config(c)
    from repro_torch.models.model import Model
    model = Model.create(cfg, device="cpu")
    have = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                have[path + (k,)] = tuple(v.shape)
    walk(model.specs, ())
    assert {p: tuple(s) for p, s in leaf_shapes(c).items()} == have
    assert have[("moe", "moe", "w_gate")] == (2, 8, 64, 32)


def test_cell_reads_the_configuration_and_the_flexgen_mix():
    cell = run.load_cell(CELL)
    assert cell.chips == 1 and cell.mix["clients"] == 64
    assert cell.config["arch"] == "mixtral-8x22b"
    assert set(cell.per_layer) == {"moe_experts_roofline.decode",
                                   "moe_experts_roofline.prefill",
                                   "attn_decode_roofline"}
    assert set(cell.end_to_end) == {"ttft_ms_p95", "tpot_ms_p50",
                                    "output_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("skew", [0.0, 4.0], ids=["random", "skewed"])
def test_serving_roles_match_the_reference_where_capacity_drops(skew):
    """At a capacity factor of 0.5 the capacity body drops pairs in the
    forward pass; the serving roles drop none and give the reference's
    logits (no capacity) through prefill and decode. ``skew`` scales the
    router's column 0, piling pairs onto expert 0."""
    from repro_torch.config.base import ParallelConfig
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import forward_hidden
    c = _tiny()
    c["overrides"]["moe"]["capacity_factor"] = 0.5
    cfg = dataclasses.replace(DECODER.port_config(c), dtype="float32")
    w = {p: t.float()
         for p, t in draw_all(DECODER, c, 2 ** 31 + 11, "cpu").items()}
    if skew:
        w[("moe", "moe", "router")][..., 0] *= skew
    model = Model.create(cfg, ParallelConfig(attention_kernel="eager"), "cpu")
    params = _tree(w)
    B, S, steps = 2, 12, 4
    toks = torch.randint(1, c["vocab_size"], (B, S + steps),
                         generator=torch.Generator().manual_seed(3))
    model.mctx.stats = {}
    with torch.no_grad():
        forward_hidden(params, cfg, model.mctx, {"tokens": toks[:, :S]})
        assert int(model.mctx.stats["moe_dropped"]) > 0
        logits, cache = model.prefill(params, {"tokens": toks[:, :S]},
                                      S + steps)
        got = [logits[:, 0]]
        for s in range(steps - 1):
            logits, cache = model.decode(params, cache,
                                         toks[:, S + s:S + s + 1], S + s)
            got.append(logits[:, 0])
    from repro_torch.models import moe
    assert model.mctx.stats[moe.COUNTS][1] == 0
    got = torch.stack(got, 1)
    want = torch.stack(Reference(c, w).logits(
        [t.tolist() for t in toks], [list(range(S - 1, S - 1 + steps))] * B))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


DIMS = arith.Dims(layers=7, d=6144, heads=48, kv_heads=8, head_dim=128,
                  ff=16384, vocab=32768, experts=8, top_k=2)


def test_expert_weight_bytes_by_hand():
    # 7 layers x 8 experts x (gate, up, down) x 6144 x 16384 x 2 bytes
    assert moe_arith.expert_weight_bytes(DIMS) == 33_822_867_456
    assert moe_arith.expert_weight_bytes(DIMS) < DIMS.weight_count * 2


def test_decode_expert_bytes_by_hand():
    # 64 tokens x 2 pairs: 128 rows of 6144 bf16 in and 128 out, 7 layers
    rows = 7 * 2 * 128 * 6144 * 2
    assert rows == 22_020_096
    assert moe_arith.decode_expert_bytes(DIMS, 64) == \
        33_822_867_456 + rows
    assert moe_arith.decode_expert_bytes(DIMS, 1) == \
        33_822_867_456 + 7 * 2 * 2 * 6144 * 2


def test_prefill_expert_flops_by_hand():
    # 64 x 512 tokens, 2 pairs each, 3 matrices of 6144 x 16384, 2 flop a
    # weight, 7 layers: 277 TFLOP
    assert moe_arith.prefill_expert_flops(DIMS, 64 * 512) == \
        2 * 3 * 6144 * 16384 * 65536 * 7
    assert round(moe_arith.prefill_expert_flops(DIMS, 64 * 512) / 1e12) \
        == 277
    # the routed pairs are the active expert weights of arith's count
    active = 2.0 * 7 * (DIMS.active_ffn_params - 8 * 6144) * 100
    assert moe_arith.prefill_expert_flops(DIMS, 100) == active


GROUPED = ("void cutlass::device_kernel<at::cuda::detail::enable_3x_kernel_"
           "for_sm9x<cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::"
           "GroupProblemShape<cute::tuple<int, int, int> > > > >")
PREPARE = ("void at::cuda::detail::prepare_grouped_gemm_data<cutlass::"
           "bfloat16_t>(...)")
NVJET = "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN"


def _ev(name, start, end, cat="kernel"):
    return {"name": name, "cat": cat, "start": start, "end": end, "bytes": 0}


def _record(device, marks):
    return {"trace": {"device": device, "host": [], "marks": marks},
            "dims": DIMS, "profiled": {"batch": 64, "plen": 512}}


def test_decode_roofline_counts_steps_by_readback_and_experts_only():
    step = moe_arith.decode_expert_bytes(DIMS, 64) / arith.HBM_BYTES_PER_S
    device = []
    for s in range(2):                  # two steps, 0.1 s apart
        t = 0.1 * s
        device += [_ev(PREPARE, t, t + 0.0001),
                   _ev(GROUPED, t + 0.0001, t + 0.0101),
                   _ev(GROUPED, t + 0.0101, t + 0.0201),   # touches the last
                   _ev(NVJET, t + 0.02, t + 0.05),          # not an expert
                   _ev("Memcpy DtoH (Device -> Pageable)", t + 0.05,
                       t + 0.0501, cat="gpu_memcpy")]
    device.append(_ev("Memcpy DtoD (Device -> Device)", 0.0, 0.001,
                      cat="gpu_memcpy"))
    rec = _record(device, {"decode": (0.0, 0.2)})
    got = run.reader("moe_experts_roofline.decode")(rec)
    assert got == pytest.approx(100.0 * 2 * step / (2 * 0.0201))


def test_prefill_roofline_is_routed_flops_over_the_expert_kernels():
    device = [_ev(GROUPED, 0.0, 0.2), _ev(GROUPED, 0.1, 0.3),  # overlap once
              _ev(PREPARE, 0.3, 0.31), _ev(NVJET, 0.31, 0.5)]
    rec = _record(device, {"prefill": (0.0, 1.0)})
    got = run.reader("moe_experts_roofline.prefill")(rec)
    flops = moe_arith.prefill_expert_flops(DIMS, 64 * 512)
    assert got == pytest.approx(100.0 * flops / 989e12 / 0.31)


@pytest.mark.parametrize("metric", ["moe_experts_roofline.decode",
                                    "moe_experts_roofline.prefill"])
def test_roofline_reads_nothing_without_expert_kernels(metric):
    """The capacity body's batched GEMMs (and a dense model) give no
    expert kernel: nothing is read, nothing raises."""
    mark = metric.split(".")[1]
    device = [_ev(NVJET, 0.0, 0.1),
              _ev("Memcpy DtoH (Device -> Pageable)", 0.1, 0.11,
                  cat="gpu_memcpy")]
    read = run.reader(metric)
    assert read(_record(device, {mark: (0.0, 1.0)})) is None
    assert read({"dims": DIMS}) is None
    dense = dataclasses.replace(DIMS, experts=0, top_k=0)
    rec = _record([_ev(GROUPED, 0.0, 0.1)], {mark: (0.0, 1.0)})
    rec["dims"] = dense
    assert read(rec) is None
