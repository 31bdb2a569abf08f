"""The decode step as one CUDA graph: its position as a device tensor,
when the engine replays a graph, and the replay against the eager path.

On the CPU: GQA attention's and MLA's decode with the position as a
one-element int64 tensor (``models/attention.attn_decode`` and
``mla_decode``) against the int-position steps they replaced, kept here
as ``_attn_decode_int`` and ``_mla_decode_int``, bit for bit in the
logits and every cache leaf; the engagement predicate over the ten archs
and three placements; CPU and offloaded engines that never capture. On a
card (``gpu``, skipped without one): the replayed tokens against the eager
path's (mixtral's dropless experts under skewed routing too), the
counters, the dense decode attention kernel's launches (one a layer in
each warm-up step and at capture, none in a replay, one a layer in each
eager step), a re-capture on a new batch shape, and a replaced
``model.decode`` replayed. Nothing here imports JAX, so the ``gpu`` cases
run on a card without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_serve_graph.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.config.base import get_config, list_archs
from repro_torch.launch import serve
from repro_torch.models import decode as decode_mod
from repro_torch.models.attention import (NEG_INF, _mla_latents, _mla_q,
                                          _out_proj, _project_qkv,
                                          decode_attention)
from repro_torch.models.layers import apply_rope
from repro_torch.models.model import Model
from repro_torch.models.params import tree_flatten
from repro_torch.obs.trace import Tracer

B, S, POS = 2, 48, 40      # POS past the reduced window (32): rings wrap


def _attn_decode_int(p, x, pos: int, cache, cfg, *, window=0,
                     use_rope=True):
    """``attn_decode`` as it was with an int position."""
    q, k_new, v_new = _project_qkv(p, x)
    if use_rope:
        positions = torch.full((x.shape[0], 1), pos, device=x.device)
        if cfg.mrope:
            positions = positions.expand(3, *positions.shape)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
        k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.mrope)
    k_cache, v_cache = cache["k"], cache["v"]
    n = k_cache.shape[1]
    slot = pos % n if window > 0 else pos
    k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)
    valid = torch.arange(n, device=x.device) <= pos
    if window > 0:
        valid |= pos >= n
    ctx = decode_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype), valid)
    return _out_proj(ctx, p["w_o"]), cache


def _mla_decode_int(p, x, pos: int, cache, cfg):
    """``mla_decode`` as it was with an int position."""
    m = cfg.mla
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    ckv_new, krope_new = _mla_latents(p, x, positions, cfg)
    ckv, k_rope = cache["ckv"], cache["k_rope"]
    ckv[:, pos] = ckv_new[:, 0].to(ckv.dtype)
    k_rope[:, pos] = krope_new[:, 0].to(k_rope.dtype)
    S = ckv.shape[1]
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(x.dtype))
    scores = (torch.einsum("bshr,bkr->bhsk", q_abs.float(), ckv.float())
              + torch.einsum("bshr,bkr->bhsk", q_rope.float(),
                             k_rope.float()))
    scores = scores * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    valid = torch.arange(S, device=x.device) <= pos
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhsk,bkr->bshr", pr, ckv.float())
    out_h = torch.einsum("bshr,rhv->bshv", ctx_lat.to(x.dtype),
                         p["w_uv"].to(x.dtype))
    return _out_proj(out_h, p["w_o"]), cache


# (arch, reduced() overrides): gemma3 at 8 layers holds a whole
# local:global group beside its tail; mixtral's window makes ring caches
GRAPH_ARCHS = [("yi-9b", {}), ("gemma3-27b", {"num_layers": 8}),
               ("mixtral-8x22b", {}), ("qwen2-vl-72b", {})]
# and deepseek-v3's MLA, whose step no graph replays yet
POSITION_ARCHS = GRAPH_ARCHS + [("deepseek-v3-671b", {})]


def _model_and_cache(arch, overrides, dtype):
    cfg = get_config(arch).reduced(dtype=dtype, **overrides)
    model = Model.create(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    cache = model.init_cache(B, S)
    for _, leaf in tree_flatten(cache):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
    return model, cache, tok


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,overrides", POSITION_ARCHS,
                         ids=[a for a, _ in POSITION_ARCHS])
def test_tensor_position_step_equals_int_step(arch, overrides, dtype,
                                              monkeypatch):
    model, cache, tok = _model_and_cache(arch, overrides, dtype)
    params = model.params
    if arch == "gemma3-27b":
        assert {s.kind for s in decode_mod.segment_plan(model.cfg)} == \
            {"gemma", "attn"}
    got = {}
    with torch.inference_mode():
        for given in ("tensor", "int"):
            c = _copy(cache)
            pos = torch.tensor([POS]) if given == "tensor" else POS
            got[given] = (model.decode(params, c, tok, pos)[0], c)
        monkeypatch.setattr(
            decode_mod, "attn_decode",
            lambda p, x, pos, c, cfg, **kw: _attn_decode_int(
                p, x, int(pos), c, cfg, **kw))
        monkeypatch.setattr(
            decode_mod, "mla_decode",
            lambda p, x, pos, c, cfg: _mla_decode_int(p, x, int(pos), c,
                                                      cfg))
        c = _copy(cache)
        want = (model.decode(params, c, tok, POS)[0], c)
    for given, (logits, c) in got.items():
        assert torch.equal(logits, want[0]), given
        for (path, a), (_, b) in zip(tree_flatten(c),
                                     tree_flatten(want[1])):
            assert torch.equal(a, b), (given, path)
    # the step wrote its token's K/V: the cache moved
    assert not all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(tree_flatten(want[1]), tree_flatten(cache)))


# ---------------------------------------------------------------------------
# When the decode role replays a graph
# ---------------------------------------------------------------------------

ENGAGED = {"yi-9b", "gemma3-27b", "mixtral-8x22b", "qwen2-72b",
           "qwen1.5-110b", "qwen2-vl-72b"}
PLACEMENTS = ("resident", "offloaded", "mesh")


def test_the_ten_archs_are_the_grid():
    assert len(list_archs()) == 10 and ENGAGED < set(list_archs())


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_engagement_by_arch_and_placement(arch, placement):
    """GQA attention blocks alone (dense or MoE, windowed, M-RoPE), on
    cuda with the weights resident and no mesh: MLA (deepseek-v3),
    Mamba2 (zamba2), xLSTM and whisper decode eagerly; so does every
    arch offloaded or on a mesh."""
    cfg = get_config(arch)
    got = serve.decode_graph_engages(
        cfg, torch.device("cuda"), offload_weights=placement == "offloaded",
        mesh=object() if placement == "mesh" else None)
    assert got == (placement == "resident" and arch in ENGAGED)


@pytest.mark.parametrize("arch", sorted(ENGAGED))
def test_no_graph_off_cuda(arch):
    assert not serve.decode_graph_engages(get_config(arch),
                                          torch.device("cpu"), False)


def _prompts(lens=(16, 15, 14)):
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("offload", [False, True],
                         ids=["resident", "offloaded"])
def test_cpu_engines_never_capture(offload):
    tracer = Tracer()
    engine = serve.ServeEngine(get_config("yi-9b").reduced(dtype="float32"),
                               device="cpu", offload_weights=offload,
                               tracer=tracer)
    assert not engine.graphs
    engine.serve([serve.Request(i, p, 3) for i, p in enumerate(_prompts())])
    m = tracer.metrics
    assert m.counter("serve.decode_graph.captures") == 0
    assert m.counter("serve.decode_graph.replays") == 0
    assert m.counter("serve.decode_steps") == 3
    decodes = [e for e in tracer.events
               if e.kind == "B" and e.name == "model.decode"]
    assert len(decodes) == 3 and all(e.args["graph"] == 0 for e in decodes)
    assert "serve.graph_capture" not in {e.name for e in tracer.events}
    assert engine._graph is None


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

STEPS = 8


def _card_engine(arch="yi-9b", overrides=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = serve.ServeEngine(get_config(arch).reduced(**(overrides or {})),
                               tracer=Tracer())
    assert engine.graphs
    return engine


def _serve(engine, lens=(16, 15, 14, 16), steps=STEPS):
    out = engine.serve([serve.Request(i, p, steps)
                        for i, p in enumerate(_prompts(lens))])
    return [r.tokens for r in out]


def _eager(engine, *a):
    engine.graphs = False
    try:
        return _serve(engine, *a)
    finally:
        engine.graphs = True


def _counts(engine):
    m = engine.tracer.metrics
    return (m.counter("serve.decode_graph.captures"),
            m.counter("serve.decode_graph.replays"))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,overrides", GRAPH_ARCHS,
                         ids=[a for a, _ in GRAPH_ARCHS])
def test_graph_tokens_equal_eager_tokens_on_card(arch, overrides):
    """yi-9b, gemma3's rings past their window (prompts of 30 and 8
    steps: positions 30-37 in a 32-slot ring), mixtral's MoE and
    qwen2-vl's M-RoPE."""
    engine = _card_engine(arch, overrides)
    layers = engine.cfg.num_layers          # every layer attends
    start = kernels.LAUNCHES["decode_attention"]
    replayed = _serve(engine, (30, 29, 28, 30))
    # the warm-up steps and the capture run the layers' Python; a replay
    # launches the captured kernels without it
    captured = kernels.LAUNCHES["decode_attention"] - start
    assert captured == (serve.DecodeGraph.WARMUP + 1) * layers
    assert replayed == _eager(engine, (30, 29, 28, 30))
    assert kernels.LAUNCHES["decode_attention"] - start == \
        captured + STEPS * layers
    assert _serve(engine, (30, 29, 28, 30)) == replayed   # no new capture
    assert kernels.LAUNCHES["decode_attention"] - start == \
        captured + STEPS * layers
    assert _counts(engine) == (1, 2 * STEPS)
    decodes = [e.args["graph"] for e in engine.tracer.events
               if e.kind == "B" and e.name == "model.decode"]
    assert decodes == [1] * STEPS + [0] * STEPS + [1] * STEPS


@pytest.mark.gpu
def test_graph_tokens_equal_eager_tokens_with_skewed_experts_on_card():
    """Mixtral's dropless layer replayed, its routing skewed: the router
    reads one column alone, so every token takes expert 1, about half of
    them expert 0 or 2, and none expert 3 (an empty group in the grouped
    GEMMs). Every pair is routed in both paths; the counters a traced step
    reads back add up."""
    engine = _card_engine("mixtral-8x22b", {"num_layers": 4})
    router = engine.params_home["moe"]["moe"]["router"]
    keep = router[..., 0].clone()
    router.zero_()
    router[..., 0] = keep
    start = kernels.LAUNCHES["decode_attention"]
    replayed = _serve(engine)
    assert kernels.LAUNCHES["decode_attention"] - start == \
        (serve.DecodeGraph.WARMUP + 1) * 4
    assert replayed == _eager(engine)
    assert _counts(engine) == (1, STEPS)
    m = engine.tracer.metrics
    cfg = engine.cfg
    pairs = cfg.num_layers * cfg.moe.top_k
    assert m.counter("moe.dropped_pairs") == 0
    assert m.counter("moe.routed_pairs") == \
        2 * pairs * 4 * 16 + 2 * pairs * 4 * STEPS
    assert m.gauge("moe.expert_load_max") == 0.5
    steps = [e.args["moe"] for e in engine.tracer.events
             if e.kind == "B" and e.name == "model.decode"]
    assert [s["routed_pairs"] for s in steps] == [pairs * 4] * (2 * STEPS)


@pytest.mark.gpu
def test_one_capture_then_a_replay_a_step_on_card():
    engine = _card_engine()
    _serve(engine)
    assert _counts(engine) == (1, STEPS)
    _serve(engine)
    assert _counts(engine) == (1, 2 * STEPS)
    spans = [e for e in engine.tracer.events
             if e.kind == "B" and e.name == "serve.graph_capture"]
    assert [(e.args["B"], e.args["cache_len"]) for e in spans] == \
        [(4, 16 + STEPS)]


@pytest.mark.gpu
def test_a_new_batch_shape_captures_again_on_card():
    engine = _card_engine()
    _serve(engine)
    lens = (20, 9)
    replayed = _serve(engine, lens, 5)
    assert _counts(engine) == (2, STEPS + 5)
    assert engine._graph.key == (2, 25)
    assert replayed == _eager(engine, lens, 5)


@pytest.mark.gpu
def test_a_replaced_decode_is_what_replays_on_card():
    """As ``perfbench/faults.py`` replaces ``model.decode``: the graph
    captures the replacement, also one installed after a capture."""
    engine = _card_engine()
    _serve(engine)
    step = engine.model.decode

    def biased(params, cache, tok, pos):
        logits, cache = step(params, cache, tok, pos)
        return logits + 1e4 * (torch.arange(logits.shape[-1],
                                            device=logits.device) == 7), cache
    engine.model.decode = biased
    assert _serve(engine) == [[7] * STEPS] * 4
    assert _counts(engine) == (2, 2 * STEPS)
