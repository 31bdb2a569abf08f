"""DeepSeek-V3 as the benchmark serves it, held to its plain reference
(``perfbench/reference/deepseek.py``) on the CPU at a tiny DeepSeek-shaped
size: 16 routed experts in 4 groups of which 2 are kept, top 4, this
layer's share 4 of them (experts 4-7), a shared expert, 1 dense and 2 MoE
layers, MLA, and YaRN at the published factor and context, whose ramp
falls inside the 8-wide rope part (low 1, high 3).

The JAX package routes DeepSeek by softmax over every expert and has no
YaRN, so the published forms are held to the benchmark's reference, and
the registered ``deepseek-v3-671b`` to the JAX package as before (its
softmax routing is checked here too).
"""

import copy
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run as bench  # noqa: E402
from perfbench.reference import deepseek as ref_ds  # noqa: E402
from perfbench.reference.weights import draw_all  # noqa: E402
from perfbench.tests.deepseek_tiny import tiny_config  # noqa: E402
from repro_torch.config.base import (MoEConfig, YaRNConfig,  # noqa: E402
                                     get_config)
from repro_torch.models import layers, moe  # noqa: E402
from repro_torch.models.attention import mla_scale  # noqa: E402
from repro_torch.models.context import MCtx  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

FAMILY = bench.family("deepseek")
CONFIG = ROOT / "perfbench" / "configs" / "deepseek-v3-ep32-7of61.json"
SEED = 2 ** 31 + 35
# both sides in fp32: they differ only in the order of fp32 sums (the
# program's absorbed decode and grouped products against the reference's
# plain MLA and per-expert loop), ~1e-6 of a logit of order 1 a layer
TOL = 1e-4


def _tree(flat: dict) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _model(c: dict, w: dict) -> Model:
    """The program's model for ``c`` holding the weights ``w`` (the
    benchmark's draws), in the configuration's dtype."""
    cfg = FAMILY.port_config(c)
    m = Model.create(cfg, device="cpu")
    m.init(torch.Generator().manual_seed(0),
           dtype=getattr(torch, c["torch_dtype"]))
    have = {}
    for path, leaf in _flat(m.params).items():
        have[path] = tuple(leaf.shape)
        leaf.data.copy_(w[path])
    assert have == {p: tuple(s) for p, s in FAMILY.leaf_shapes(c).items()}
    return m


def _flat(tree: dict, path=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# The served path against the reference's full forward
# ---------------------------------------------------------------------------


def test_prefill_then_latent_decode_match_the_reference_forward():
    """Prefill over the prompts, then greedy steps through the MLA latent
    cache: the logits of every step against the reference's full forward
    over the prompt and the tokens served."""
    c = tiny_config()
    w = draw_all(FAMILY, c, SEED, "cpu")
    m = _model(c, w)
    B, S, steps = 3, 12, 5
    toks = torch.randint(1, c["vocab_size"], (B, S),
                         generator=torch.Generator().manual_seed(1))
    got = []
    with torch.no_grad():
        logits, cache = m.prefill(m.params, {"tokens": toks}, S + steps)
        got.append(logits[:, -1])
        tok = logits[:, -1:].argmax(-1)
        served = [tok]
        for s in range(steps - 1):
            logits, cache = m.decode(m.params, cache, tok, S + s)
            got.append(logits[:, -1])
            tok = logits[:, -1:].argmax(-1)
            served.append(tok)
    seqs = torch.cat([toks] + served[:-1], 1).tolist()
    want = ref_ds.Reference(c, w).logits(seqs, [list(range(S - 1,
                                                            S + steps - 1))]
                                         * B)
    got = torch.stack(got, 1)
    for b in range(B):
        np.testing.assert_allclose(got[b].numpy(), want[b].numpy(),
                                   rtol=TOL, atol=TOL)


def test_served_tokens_through_the_engine_read_near_the_reference():
    """bf16 through ``ServeEngine`` with the benchmark's weights: every
    served token's reference logit within 0.05 of the reference's best
    (bf16 rounding at these widths moves a logit by ~1e-2), and the traced
    MoE counters hold the share: every pair routed, the held pairs fewer,
    none dropped."""
    from repro_torch.launch import serve
    from repro_torch.obs.trace import Tracer
    from perfbench.reference.check import served_gaps
    c = tiny_config(dtype="bfloat16")
    tracer = Tracer()
    engine = serve.ServeEngine(FAMILY.port_config(c), device="cpu",
                               tracer=tracer)
    bench.fill_weights(engine.params_home, FAMILY, c, SEED, "cpu")
    rng = np.random.default_rng(0)
    reqs = [serve.Request(i, rng.integers(1, 256, 16).astype(np.int32), 4)
            for i in range(4)]
    out = engine.serve(reqs)
    first = [r.tokens for r in out]
    assert [len(t) for t in first] == [4] * 4
    ref = FAMILY.reference(c, draw_all(FAMILY, c, SEED, "cpu"))
    handoff = engine.prefill(reqs)
    items = [(r.prompt, [int(handoff.tok[i, 0])] + first[i][:3])
             for i, r in enumerate(reqs)]
    assert max(g.max() for g in served_gaps(ref, items)) < 0.05
    spans = [e.args["moe"] for e in tracer.events
             if e.kind == "B" and e.name in ("model.prefill", "model.decode")]
    pairs = 2 * 4                         # MoE layers x top 4
    assert [s["routed_pairs"] for s in spans] == \
        [pairs * 4 * 16] + [pairs * 4] * 4 + [pairs * 4 * 16]
    assert all(0 < s["held_pairs"] < s["routed_pairs"] for s in spans)
    assert all(s["dropped_pairs"] == 0 for s in spans)
    m = tracer.metrics
    assert m.counter("moe.held_pairs") == sum(s["held_pairs"]
                                              for s in spans)
    assert m.gauge("moe.expert_load_max") >= 1 / 4


# ---------------------------------------------------------------------------
# The router, YaRN and the scale as published
# ---------------------------------------------------------------------------


S_HAND = [0.9, 0.1, 0.6, 0.55, 0.7, 0.2, 0.8, 0.05]
B_HAND = [0.0, 0.0, 0.0, 0.2, -0.3, 0.0, 0.0, 0.0]


def test_router_by_hand():
    """8 experts in 4 groups of 2, 2 groups kept, top 2. Choice scores
    s + b = [.9, .1, .6, .75, .4, .2, .8, .05]; group sums 1.0, 1.35,
    0.6, 0.85 keep groups 1 and 0, so expert 6 (0.8, the second best) is
    out; the bias puts expert 3 (0.75) before expert 2 (0.6). The gates
    are the unbiased scores 0.9 and 0.55 over their sum, times 2.5."""
    s = torch.tensor([S_HAND])
    b = torch.tensor(B_HAND)
    e = MoEConfig(num_experts=8, top_k=2, scoring_func="sigmoid",
                  n_group=4, topk_group=2, routed_scaling_factor=2.5)
    want_g = torch.tensor([[0.9, 0.55]]) / 1.45 * 2.5
    logit = torch.log(s / (1 - s))
    gates, eids, probs = moe._route_sigmoid(logit, torch.eye(8), b, e)
    assert eids.tolist() == [[0, 3]]
    torch.testing.assert_close(gates, want_g)
    torch.testing.assert_close(probs, s)
    c = {"n_group": 4, "topk_group": 2, "num_experts_per_tok": 2,
         "norm_topk_prob": True, "routed_scaling_factor": 2.5}
    g_ref, e_ref = ref_ds.route(s, b, c)
    assert e_ref.tolist() == [[0, 3]]
    torch.testing.assert_close(g_ref, want_g)
    # without the bias experts 0 and 2; without the groups 0 and 6
    assert moe._route_sigmoid(logit, torch.eye(8), torch.zeros(8),
                              e)[1].tolist() == [[0, 2]]
    flat = MoEConfig(num_experts=8, top_k=2, scoring_func="sigmoid",
                     n_group=1, topk_group=1, routed_scaling_factor=2.5)
    assert moe._route_sigmoid(logit, torch.eye(8), b,
                              flat)[1].tolist() == [[0, 6]]


def test_yarn_table_and_scale_at_the_published_sizes():
    """DeepSeek-V3's rope part (64 wide, theta 1e4) under YaRN (factor
    40, original context 4096, beta 32 and 1): the correction dims give
    low 10 and high 23, below which the frequencies are RoPE's and above
    which they are RoPE's over 40, with a linear ramp between; the softmax
    scale is 192 ** -0.5 * (0.1 ln 40 + 1) ** 2."""
    c = json.loads(CONFIG.read_text())
    y = c["rope_scaling"]
    yarn = YaRNConfig(factor=y["factor"],
                      original_max_position_embeddings=y[
                          "original_max_position_embeddings"],
                      beta_fast=y["beta_fast"], beta_slow=y["beta_slow"],
                      mscale=y["mscale"], mscale_all_dim=y["mscale_all_dim"])
    D, theta = 64, 1e4

    def corr(r):
        return D * math.log(4096 / (2 * math.pi * r)) / (2 * math.log(theta))
    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    i = np.arange(D // 2, dtype=np.float64)
    extra = theta ** (-2 * i / D)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    got = layers.yarn_freqs(
        (1.0 / theta ** (np.arange(D // 2) / (D // 2))).astype(np.float32),
        theta, yarn)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.array_equal(ramp[:11], np.zeros(11))
    assert np.array_equal(ramp[23:], np.ones(9))
    np.testing.assert_allclose(ref_ds.yarn_freqs(c).numpy(), want,
                               rtol=1e-12)
    cfg = FAMILY.port_config(c)
    scale = 192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2
    assert mla_scale(cfg) == pytest.approx(scale, rel=1e-12)
    assert ref_ds.softmax_scale(c) == pytest.approx(scale, rel=1e-12)
    assert mla_scale(get_config("deepseek-v3-671b")) == 192 ** -0.5


def test_tiny_yarn_ramp_falls_inside_the_rope_part():
    c = tiny_config()
    f = ref_ds.yarn_freqs(c).numpy()
    extra = 1e4 ** (-2 * np.arange(4) / 8)
    np.testing.assert_allclose(f[:2], extra[:2], rtol=1e-12)   # low 1
    np.testing.assert_allclose(f[3], extra[3] / 40, rtol=1e-12)  # high 3
    assert extra[2] / 40 < f[2] < extra[2]


# ---------------------------------------------------------------------------
# The share: every chip's part adds up to the whole layer
# ---------------------------------------------------------------------------


def _moe_layer(c: dict, w: dict, layer: int = 0) -> dict:
    """The program's parameters of one MoE layer of ``w``."""
    return {k: (v[layer] if not isinstance(v, dict)
                else {kk: vv[layer].float() for kk, vv in v.items()})
            for k, v in _tree(w)["moe"]["moe"].items()}


@pytest.mark.parametrize("S", [1, 5])
def test_the_shares_add_up_to_the_uncut_layer(S):
    """Four disjoint shares of 4 experts: their outputs, each less the
    shared expert that every chip adds, plus the shared expert once, equal
    the reference's uncut layer (all 16 experts held); each share equals
    the reference's layer at that share. S 1 is a decode step (a static
    gather), S 5 a prefill (the held pairs counted)."""
    whole = tiny_config(first=0, held=16)
    w_all = draw_all(FAMILY, whole, SEED, "cpu")
    x = torch.randn(3, S, 64, generator=torch.Generator().manual_seed(2))
    want = ref_ds.Reference(whole, w_all).ffn(x, ("moe", 0), True)
    total = None
    for first in (0, 4, 8, 12):
        c = tiny_config(first=first, held=4)
        w = dict(w_all)
        for name in ("w_gate", "w_up", "w_down"):
            w[("moe", "moe", name)] = w_all[("moe", "moe", name)][
                :, first:first + 4]
        p = {k: v.float() if torch.is_tensor(v) else v
             for k, v in _moe_layer(c, w).items()}
        cfg = FAMILY.port_config(c)
        stats: dict = {}
        with torch.no_grad():
            y, _ = moe.moe_ffn(p, x, cfg, MCtx(stats=stats, dropless=True))
        mine = ref_ds.Reference(c, w).ffn(x, ("moe", 0), True)
        torch.testing.assert_close(y, mine, rtol=TOL, atol=TOL)
        sp = p["shared"]
        shared = (torch.nn.functional.silu(x @ sp["w_gate"])
                  * (x @ sp["w_up"])) @ sp["w_down"]
        part = y - shared
        total = part + shared if total is None else total + part
        routed, dropped, _, held = stats[moe.COUNTS].tolist()
        assert (routed, dropped) == (3 * S * 4, 0) and held <= routed
    torch.testing.assert_close(total, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S", [1, 7])
def test_only_the_held_pairs_rows_are_gathered(S, monkeypatch):
    """A prefill's grouped products take exactly the held pairs' rows; a
    decode step's take T * min(k, held) rows whatever the routing, so the
    step reads nothing back to the host."""
    c = tiny_config()
    w = draw_all(FAMILY, c, SEED, "cpu")
    p = {k: v.float() if torch.is_tensor(v) else v
         for k, v in _moe_layer(c, w).items()}
    seen = []
    real = moe._grouped_mm

    def spy(a, wt, ends):
        seen.append((a.shape[0], int(ends[-1])))
        return real(a, wt, ends)
    monkeypatch.setattr(moe, "_grouped_mm", spy)
    x = torch.randn(4, S, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        moe.moe_ffn(p, x, FAMILY.port_config(c), MCtx(dropless=True))
    rows = {r for r, _ in seen}
    held = {h for _, h in seen}
    assert len(rows) == 1 and len(held) == 1
    T = 4 * S
    assert rows == ({T * 4} if S == 1 else held)
    assert 0 < held.pop() < T * 4


def test_the_capacity_body_refuses_the_share_and_the_sigmoid_router():
    c = tiny_config()
    cfg = FAMILY.port_config(c)
    w = draw_all(FAMILY, c, SEED, "cpu")
    p = {k: v.float() if torch.is_tensor(v) else v
         for k, v in _moe_layer(c, w).items()}
    with pytest.raises(ValueError, match="capacity MoE body"):
        moe.moe_ffn(p, torch.zeros(1, 2, 64), cfg, MCtx())


# ---------------------------------------------------------------------------
# The registered configuration is as it was
# ---------------------------------------------------------------------------


def test_registered_deepseek_routes_by_softmax_over_every_expert():
    cfg = get_config("deepseek-v3-671b")
    e = cfg.moe
    assert (e.scoring_func, e.held, e.num_experts) == ("softmax", 256, 256)
    assert cfg.rope_scaling is None
    small = cfg.reduced(dtype="float32")
    specs = moe.moe_specs(small)
    assert "e_score_correction_bias" not in specs
    assert specs["w_gate"].shape[0] == small.moe.num_experts
    g = torch.Generator().manual_seed(4)
    x = torch.randn(6, small.d_model, generator=g)
    p = {"router": torch.randn(small.d_model, small.moe.num_experts,
                               generator=g)}
    gates, eids, probs = moe.route(x, p, small)
    want = moe._route(x, p["router"], small.moe.top_k)
    for a, b in zip((gates, eids, probs), want):
        assert torch.equal(a, b)
    torch.testing.assert_close(probs, torch.softmax(x @ p["router"], -1))


def test_benchmark_file_holds_the_catalog_config():
    """The configuration file is the catalog's DeepSeek-V3 config but for
    its two reduced keys, the published values of which it states."""
    c = json.loads(CONFIG.read_text())
    assert c["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert c["published"] == {"num_hidden_layers": 61,
                              "n_routed_experts": 256}
    cfg = FAMILY.port_config(copy.deepcopy(c))
    assert (cfg.num_layers, cfg.moe.held, cfg.moe.num_experts) == (7, 8, 256)
    assert (cfg.moe.scoring_func, cfg.moe.n_group, cfg.moe.topk_group,
            cfg.moe.routed_scaling_factor) == ("sigmoid", 8, 4, 2.5)
    assert cfg.rope_scaling.factor == 40
