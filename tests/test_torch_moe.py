"""The port's MoE layer: twins of ``tests/test_moe.py``, and routing,
dispatch and ``moe_ffn`` against the reference's, drops included.

The reference runs its expert-parallel body on the one-device host mesh;
the port computes the same arithmetic with no collective. Which (token,
slot) pairs an expert drops for want of capacity must be the reference's
exactly, so the expert ids, the dispatch order and slots, and the kept
mask are compared themselves, not only the outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.config.base import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh
from repro.models import moe as jmoe
from repro.models.context import MCtx as JaxMCtx
from repro.models.params import init_params as jax_init_params
from repro_torch.config.base import ParallelConfig, get_config
from repro_torch.models import moe
from repro_torch.models.context import MCtx
from repro_torch.models.params import init_params, params_from_jax

TOL = 2e-4


def _cfg(get, **moe_changes):
    cfg = get("mixtral-8x22b").reduced()
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, **moe_changes))


def test_dispatch_indices_complete_when_capacity_suffices():
    rng = np.random.default_rng(0)
    T, k, E = 64, 2, 4
    eids = torch.from_numpy(rng.integers(0, E, (T, k)))
    C = T * k    # no drops possible
    se, st, pos, keep, order = moe._dispatch_indices(eids, E, C)
    assert bool(keep.all())
    # every (token, slot) appears exactly once
    assert len(set(zip(st.tolist(), se.tolist(), pos.tolist()))) == T * k
    # positions within expert are unique
    assert len(set(zip(se.tolist(), pos.tolist()))) == T * k


def test_dispatch_drops_overflow():
    T, k, E = 16, 1, 2
    eids = torch.zeros((T, k), dtype=torch.long)    # all to expert 0
    C = 4
    se, st, pos, keep, order = moe._dispatch_indices(eids, E, C)
    assert int(keep.sum()) == C
    assert st[keep].tolist() == [0, 1, 2, 3]        # the first tokens stay


def test_route_normalized():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    gates, eids, probs = moe._route(x, w, 2)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert bool((eids >= 0).all()) and bool((eids < 4).all())


def test_route_breaks_ties_by_expert_index_as_reference():
    """Equal router probabilities (here: a zero router, every expert at
    1/E) go to the lower expert index first, in both packages."""
    x = np.ones((5, 16), np.float32)
    w = np.zeros((16, 6), np.float32)
    _, jeids, _ = jmoe._route(jnp.asarray(x), jnp.asarray(w), 3)
    _, eids, _ = moe._route(torch.from_numpy(x), torch.from_numpy(w), 3)
    assert eids.tolist() == np.asarray(jeids).tolist() == [[0, 1, 2]] * 5


def test_moe_ffn_matches_dense_expert_eval():
    """With top_k == num_experts and generous capacity, MoE output equals
    the gate-weighted sum of every expert's FFN (an analytic oracle)."""
    cfg = _cfg(get_config, num_experts=4, top_k=4, capacity_factor=8.0)
    p = init_params(moe.moe_specs(cfg), torch.Generator().manual_seed(0),
                    "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(2, 8, cfg.d_model)) * 0.3)
                         .astype(np.float32))
    y, aux = moe.moe_ffn(p, x, cfg)

    xt = x.reshape(-1, cfg.d_model)
    gates, eids, _ = moe._route(xt, p["router"], 4)
    outs = torch.stack([
        (torch.nn.functional.silu(xt @ p["w_gate"][e]) * (xt @ p["w_up"][e]))
        @ p["w_down"][e] for e in range(4)], 1)             # (T, E, d)
    w_full = torch.zeros((xt.shape[0], 4)).scatter(1, eids, gates)
    ref = torch.einsum("te,ted->td", w_full, outs).reshape(x.shape)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_combine_is_the_sorted_scatter_add_in_bf16(cf):
    """In bf16 the layer adds each token's gated expert outputs in the
    order the reference's scatter-add over the expert-sorted pairs meets
    them, rounding after each add: equal, bit for bit, to a sequential
    scatter-add over those pairs, drops included (cf 0.5 drops)."""
    cfg = _cfg(get_config, num_experts=4, top_k=3, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    p = init_params(moe.moe_specs(cfg), torch.Generator().manual_seed(4),
                    "cpu", torch.bfloat16)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 16, cfg.d_model))
                         .astype(np.float32)).bfloat16()
    y, _ = moe.moe_ffn(p, x, cfg)

    xt = x.reshape(-1, cfg.d_model)
    T, E, k = xt.shape[0], 4, 3
    C = moe._capacity(T, k, E, cf)
    gates, eids, _ = moe._route(xt, p["router"], k)
    se, st, pos, keep, order = moe._dispatch_indices(eids, E, C)
    assert bool((~keep).any()) == (cf < 1.0)
    buf = torch.zeros((E, C, cfg.d_model), dtype=x.dtype)
    buf[se[keep], pos[keep]] = xt[st[keep]]
    out = moe._expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
    w = gates.reshape(-1)[order].to(x.dtype)
    ref = torch.zeros_like(xt)
    for i in range(T * k):                 # one add at a time, sorted
        if keep[i]:
            ref[st[i]] += out[se[i], pos[i]] * w[i]
    assert torch.equal(y.reshape(T, -1), ref)


def test_capacity_rounding():
    assert moe._capacity(100, 2, 8, 1.25) % 4 == 0
    assert moe._capacity(1, 1, 256, 1.25) == 4       # floor
    for args in [(100, 2, 8, 1.25), (8192, 2, 8, 1.25), (7, 8, 256, 1.25),
                 (64, 2, 4, 0.25)]:
        assert moe._capacity(*args) == jmoe._capacity(*args)


@pytest.mark.parametrize("cf,shared", [(0.25, False), (0.5, True),
                                       (4.0, False)])
def test_moe_ffn_matches_reference(cf, shared):
    """Routing, dispatch (drops at a small capacity factor) and the layer's
    output and aux loss, on the reference's weights and inputs."""
    changes = dict(capacity_factor=cf, num_shared_experts=int(shared))
    jcfg, cfg = _cfg(jax_get_config, **changes), _cfg(get_config, **changes)
    mesh = make_host_mesh()
    jp = jax_init_params(jmoe.moe_specs(jcfg, ep=jmoe.use_ep(jcfg, mesh)),
                         jax.random.key(3))
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    T, E, k = 32, cfg.moe.num_experts, cfg.moe.top_k

    jgates, jeids, jprobs = jmoe._route(jnp.asarray(x.reshape(T, -1)),
                                        jp["router"], k)
    gates, eids, probs = moe._route(torch.from_numpy(x.reshape(T, -1)),
                                    p["router"], k)
    assert eids.tolist() == np.asarray(jeids).tolist()
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=1e-6,
                               atol=1e-6)
    C = moe._capacity(T, k, E, cf)
    want = jmoe._dispatch_indices(jeids, E, C)
    got = moe._dispatch_indices(eids, E, C)
    for name, g, w in zip(("se", "st", "pos", "keep", "order"), got, want):
        assert g.tolist() == np.asarray(w).tolist(), name
    dropped = int((~got[3]).sum())
    assert (dropped > 0) == (cf < 1.0)

    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg,
                            JaxMCtx(mesh, JaxParallelConfig()))
    stats = {}
    y, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg,
                         MCtx(ParallelConfig(), stats=stats))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert int(stats["moe_dropped"]) == dropped


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_loss_fn_with_aux_matches_reference(arch):
    """ce and the summed load-balancing aux of the whole model, on the
    reference's weights (deepseek: a dense layer before the MoE ones)."""
    from repro.models.model import Model as JaxModel
    from repro.models.transformer import loss_fn as jax_loss_fn
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import loss_fn
    jcfg = jax_get_config(arch).reduced(dtype="float32")
    cfg = get_config(arch).reduced(dtype="float32")
    jm = JaxModel.create(jcfg, make_host_mesh(),
                         JaxParallelConfig(remat="none"))
    jparams = jm.init(jax.random.key(2))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jparts = jax_loss_fn(jparams, jcfg, jm.mctx,
                                jax.tree.map(jnp.asarray, batch))
    m = Model.create(cfg, ParallelConfig(remat="none"), device="cpu")
    loss, parts = loss_fn(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          "cpu"), cfg, m.mctx,
                          {k: torch.from_numpy(v).long()
                           for k, v in batch.items()})
    assert float(jparts["aux"]) > 0
    for name, got, want in (("loss", loss, jloss), ("ce", parts["ce"],
                                                    jparts["ce"]),
                            ("aux", parts["aux"], jparts["aux"])):
        assert float(got) == pytest.approx(float(want), rel=1e-5), name


# ---------------------------------------------------------------------------
# The dropless serving layer
# ---------------------------------------------------------------------------


def _skewed(cfg, seed=5, T=48):
    """Weights and tokens whose routing piles onto expert 0: every token
    shares a direction that the router's column 0 reads, so at capacity
    factor 1.25 the capacity body drops pairs."""
    p = init_params(moe.moe_specs(cfg), torch.Generator().manual_seed(seed),
                    "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    base = torch.randn(cfg.d_model, generator=g)
    x = base + 0.3 * torch.randn(T, cfg.d_model, generator=g)
    p["router"] = p["router"].clone()
    p["router"][:, 0] = 4.0 * base / base.norm()
    return p, x


def _loop(p, x, k):
    """Every (token, slot) pair through its expert, one expert at a time,
    in fp32: the layer's meaning with no capacity."""
    gates, eids, _ = moe._route(x, p["router"], k)
    y = torch.zeros_like(x)
    for e in range(p["w_gate"].shape[0]):
        rows, slot = torch.nonzero(eids == e, as_tuple=True)
        xe = x[rows]
        h = (torch.nn.functional.silu(xe @ p["w_gate"][e])
             * (xe @ p["w_up"][e]))
        y[rows] += (h @ p["w_down"][e]) * gates[rows, slot][:, None]
    return y


@pytest.mark.parametrize("shared", [False, True])
def test_dropless_drops_nothing_where_capacity_drops(shared):
    cfg = _cfg(get_config, capacity_factor=1.25,
               num_shared_experts=int(shared))
    p, x = _skewed(cfg)
    T, k = x.shape[0], cfg.moe.top_k
    _, eids, _ = moe._route(x, p["router"], k)
    C = moe._capacity(T, k, cfg.moe.num_experts, 1.25)
    keep = moe._dispatch_indices(eids, cfg.moe.num_experts, C)[3]
    assert int((~keep).sum()) > 0          # the capacity body drops here

    stats = {}
    y, aux = moe.moe_ffn(p, x[None], cfg,
                         MCtx(ParallelConfig(), stats=stats, dropless=True))
    want = _loop(p, x, k)
    if shared:
        sp = p["shared"]
        want = want + (torch.nn.functional.silu(x @ sp["w_gate"])
                       * (x @ sp["w_up"])) @ sp["w_down"]
    np.testing.assert_allclose(y[0].numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    assert float(aux) == 0.0
    routed, dropped, busiest, held = stats[moe.COUNTS].tolist()
    assert (routed, held, dropped) == (T * k, T * k, 0)
    assert busiest == int((eids == 0).sum()) > C
    capped, _ = moe.moe_ffn(p, x[None], cfg, MCtx(ParallelConfig()))
    assert not torch.allclose(capped, y, rtol=TOL, atol=TOL)


def test_dropless_combine_is_the_sorted_add_in_bf16():
    """bf16: each token's gated expert outputs added in ascending expert
    order, rounding after each add, as the capacity body adds them."""
    cfg = _cfg(get_config, num_experts=4, top_k=3)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    p = init_params(moe.moe_specs(cfg), torch.Generator().manual_seed(4),
                    "cpu", torch.bfloat16)
    x = torch.randn(32, cfg.d_model,
                    generator=torch.Generator().manual_seed(4)).bfloat16()
    y = moe._dropless(x, p, cfg)
    gates, eids, _ = moe._route(x, p["router"], 3)
    flat = eids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ends = torch.searchsorted(flat[order], torch.arange(1, 5),
                              out_int32=True)
    rows = x[order // 3]
    h = (torch.nn.functional.silu(moe._grouped_mm(rows, p["w_gate"], ends))
         * moe._grouped_mm(rows, p["w_up"], ends))
    out = moe._grouped_mm(h, p["w_down"], ends)
    w = gates.reshape(-1)[order].bfloat16()
    ref = torch.zeros_like(x)
    for i in range(32 * 3):                # one add at a time, sorted
        ref[order[i] // 3] += out[i] * w[i]
    assert torch.equal(y, ref)


def test_grouped_mm_loop_takes_each_experts_rows():
    g = torch.Generator().manual_seed(0)
    a, w = torch.randn(10, 8, generator=g), torch.randn(4, 8, 6, generator=g)
    ends = torch.tensor([3, 3, 9, 10], dtype=torch.int32)   # expert 1: none
    got = moe._grouped_mm(a, w, ends)
    want = torch.cat([a[:3] @ w[0], a[3:9] @ w[2], a[9:] @ w[3]])
    assert torch.equal(got, want)


def test_the_serving_roles_are_dropless_and_training_is_not():
    """``Model.prefill`` / ``Model.decode`` run the dropless layer (no
    ``moe_dropped`` counted, every pair routed), the loss the capacity
    body; the model's own context stays as it was."""
    from repro_torch.models.model import Model
    cfg = get_config("mixtral-8x22b").reduced(dtype="float32")
    m = Model.create(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    m.mctx.stats = {}
    toks = torch.randint(1, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, cache = m.prefill(params, {"tokens": toks[:, :8]}, 12)
        m.decode(params, cache, toks[:, 8:], 8)
    assert not m.mctx.dropless and m.serve_mctx.dropless
    routed, dropped, _, held = m.mctx.stats[moe.COUNTS].tolist()
    pairs = cfg.num_layers * cfg.moe.top_k * 2
    assert (routed, held, dropped) == (pairs * 8 + pairs,) * 2 + (0,)
    assert "moe_dropped" not in m.mctx.stats
    m.loss(params, {"tokens": toks[:, :8], "labels": toks[:, 1:]})
    assert "moe_dropped" in m.mctx.stats


def test_warm_up_batch_of_one_token_serves():
    """The harness's warm-up: every prompt the same token, so every token
    routes to the same two experts; the layer's memory is T * k rows all
    the same, and the engine serves it."""
    from repro_torch.launch import serve
    from repro_torch.obs.trace import Tracer
    cfg = get_config("mixtral-8x22b").reduced(dtype="float32")
    tracer = Tracer()
    engine = serve.ServeEngine(cfg, device="cpu", tracer=tracer)
    out = engine.serve([serve.Request(i, np.ones(16, np.int32), 2)
                        for i in range(4)])
    assert [len(r.tokens) for r in out] == [2] * 4
    m = tracer.metrics
    assert m.counter("moe.dropped_pairs") == 0
    assert m.counter("moe.routed_pairs") == \
        cfg.num_layers * cfg.moe.top_k * 4 * (16 + 2)
    assert m.gauge("moe.expert_load_max") == 0.5      # two experts, all
    spans = [e.args["moe"] for e in tracer.events
             if e.kind == "B" and e.name in ("model.prefill", "model.decode")]
    assert [s["routed_pairs"] for s in spans] == \
        [cfg.num_layers * 2 * 64, cfg.num_layers * 2 * 4,
         cfg.num_layers * 2 * 4]
