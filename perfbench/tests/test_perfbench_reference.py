"""The plain reference against the program at tiny widths on the CPU, in
fp32: the program's prefill and its decode steps through the cache give
the reference's logits at every position; and the weights the benchmark
draws fit the program's tree."""

import dataclasses

import pytest
import torch

from perfbench.reference.model import Reference, fake_fp8
from perfbench.reference.weights import draw_all, leaf_shapes
from perfbench.tests.tiny import DECODER, tiny_config

YI = tiny_config({"arch": "yi-9b", "rope_theta": 1e4, "rms_norm_eps": 1e-6})
MIXTRAL = tiny_config({"arch": "mixtral-8x22b", "rope_theta": 1e6,
                       "rms_norm_eps": 1e-5, "num_local_experts": 4,
                       "num_experts_per_tok": 2},
                      intermediate_size=32)


def _port(c: dict):
    from repro_torch.config.base import ParallelConfig, get_config
    from repro_torch.models.model import Model
    cfg = get_config(c["arch"])
    over = dict(c["overrides"], dtype="float32",
                rope_theta=c["rope_theta"], norm_eps=c["rms_norm_eps"])
    if cfg.moe is not None:
        over.update(attn_type="full", window=0, d_ff=c["intermediate_size"])
        # capacity for every token at every expert: no pair is dropped
        over["moe"] = dataclasses.replace(
            cfg.moe, num_experts=c["num_local_experts"],
            top_k=c["num_experts_per_tok"],
            d_ff_expert=c["intermediate_size"],
            capacity_factor=c["num_local_experts"] / c["num_experts_per_tok"])
    cfg = dataclasses.replace(cfg, **over)
    return Model.create(cfg, ParallelConfig(attention_kernel="eager"), "cpu")


def _tree(flat: dict) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


@pytest.mark.parametrize("c", [YI, MIXTRAL], ids=["yi", "mixtral"])
def test_leaf_shapes_are_the_programs_tree(c):
    model = _port(c)
    want = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                want[path + (k,)] = tuple(v.shape)
    walk(model.specs, ())
    assert {p: tuple(s) for p, s in leaf_shapes(c).items()} == want


@pytest.mark.parametrize("c", [YI, MIXTRAL], ids=["yi", "mixtral"])
def test_reference_matches_the_program_prefill_and_decode(c):
    torch.manual_seed(0)
    w = {p: t.float()
         for p, t in draw_all(DECODER, c, 2 ** 31 + 7, "cpu").items()}
    model = _port(c)
    B, S, steps = 2, 12, 4
    toks = torch.randint(1, c["vocab_size"], (B, S + steps))
    params = _tree(w)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks[:, :S]},
                                      S + steps)
        got = [logits[:, 0]]
        for s in range(steps - 1):
            logits, cache = model.decode(params, cache, toks[:, S + s:S + s + 1],
                                         S + s)
            got.append(logits[:, 0])
    got = torch.stack(got, 1)                         # (B, steps, V)
    ref = Reference(c, w).logits([t.tolist() for t in toks],
                                 [list(range(S - 1, S - 1 + steps))] * B)
    want = torch.stack(ref)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_reference_runs_from_bf16_weights_and_the_control_differs():
    w = draw_all(DECODER, YI, 3, "cpu")
    seq = [list(range(1, 20))]
    ref = Reference(YI, w).logits(seq, [[18]])[0]
    ctl = Reference(YI, w, quant="fp8").logits(seq, [[18]])[0]
    assert ref.dtype == torch.float32 and torch.isfinite(ref).all()
    assert 0 < (ref - ctl).abs().max() < ref.abs().max()


def test_fake_fp8_keeps_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 448.0, -3.3]])
    q = fake_fp8(x, dim=-1)
    assert q[0, 0] == 1.0 and q[0, 2] == 448.0
    assert q[0, 1] in (1.0, 1.125)
    assert abs(q[0, 3] + 3.3) <= 0.13


def test_draws_are_deterministic_by_seed_and_path():
    a, b = draw_all(DECODER, YI, 5, "cpu"), draw_all(DECODER, YI, 5, "cpu")
    c = draw_all(DECODER, YI, 6, "cpu")
    for p in a:
        assert torch.equal(a[p], b[p])
    assert not torch.equal(a[("embed", "tok")], c[("embed", "tok")])
    assert not torch.equal(a[("decoder", "ln1")], a[("decoder", "ln2")])
