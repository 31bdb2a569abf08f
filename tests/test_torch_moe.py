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
