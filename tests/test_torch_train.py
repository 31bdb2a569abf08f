"""repro_torch training (loss, train step, compressed step, train()) vs the
reference's, on reduced yi-9b.

Weights and optimizer state are carried from the reference with
``params_from_jax`` and ``opt_state_from_jax``; batches are the reference's
synthetic stream (bit-equal in the two packages, ``tests/test_torch_data.py``).

Tolerances:

- ``loss_fn`` and its gradients: ``tests/test_torch_model.py``'s, 2e-4
  (rtol = atol) with fp32 activations; in bf16, 2e-2 of each tensor's
  largest magnitude.
- Train steps run with fp32 activations (the algorithm is the point): loss
  within 1e-5 relative (fp32 summation order), the gradient norm within the
  norm of one bf16 ulp of every gradient element (``_ulp_norm``); ``master``
  within 1e-5 absolute, 1% of one step's update at lr 1e-3; ``mu``/``nu``
  within 2e-3 of each leaf's largest magnitude, except at most 1e-3 of the
  values, which stay within 1e-2 of it: the gradients are bf16, and after
  the first update a master value that lies within 1e-6 of a bf16 rounding
  boundary can round the compute copy the other way in one package, which
  moves a few gradients of the next step by about a bf16 ulp (2**-8 of the
  value). How many depends on the fp32 summation order, which changes with
  the number of CPU threads: over 1-8 threads the worst value came to
  0.25e-3 to 2.004e-3 of its leaf's largest magnitude.
- The compressed step against the reference **jitted** (its eager
  ``shard_map`` raises under jax 0.9.0): inside jit, XLA turns ``/ 127``
  into a reciprocal multiply, so an int8 value on a rounding tie can move by
  one and its gradient by one scale; at most 1e-3 of the master values may
  then differ by more than the bound above, and none by more than
  2 * lr * steps (Adam's normalized step is at most about 1 per step).
"""

import dataclasses
import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.config.base import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh, make_mesh
from repro.models.model import Model as JaxModel
from repro_torch.config.base import (MLAConfig, MoEConfig, ParallelConfig,
                                     RunConfig, ShapeConfig, get_config)
from repro_torch.core.placement import plan_training_placement
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.launch.train import train
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_jax, tree_flatten
from repro_torch.optim import adamw, schedule
from repro_torch.training.step import (compute_grads, init_train_state,
                                       make_train_step)

SHAPE = (32, 4)                  # seq, batch
STEPS = 3
LR = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
MODEL_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(dtype="float32"):
    return (jax_get_config("yi-9b").reduced(dtype=dtype),
            get_config("yi-9b").reduced(dtype=dtype))


def _batches(cfg, n):
    return [synthetic_batch(cfg, ShapeConfig("t", *SHAPE, "train"), i)
            for i in range(n)]


def _jax_batch(b):
    return {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def _flat_np(tree) -> dict:
    """{path string: fp32 numpy} of a port tree or a reference tree."""
    if isinstance(tree, dict) and tree and not isinstance(
            next(iter(tree.values())), (dict, torch.Tensor)):
        tree = jax.tree.map(np.asarray, tree)
    out = {}
    for path, v in tree_flatten(tree):
        out["/".join(path)] = (v.float().numpy() if isinstance(
            v, torch.Tensor) else np.asarray(v, np.float32))
    return out


def _assert_close(got, want, what, rtol=0.0, atol=0.0, of_max=0.0):
    got, want = _flat_np(got), _flat_np(want)
    assert got.keys() == want.keys(), what
    for k in want:
        tol = atol + of_max * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=tol,
                                   err_msg=f"{what}/{k}")


def _assert_moments_close(got, want, what, of_max=2e-3, share=1e-3,
                          outlier_of_max=1e-2):
    """Within ``of_max`` of each leaf's largest magnitude, but for at most
    ``share`` of the values, which stay within ``outlier_of_max``."""
    got, want = _flat_np(got), _flat_np(want)
    assert got.keys() == want.keys(), what
    for k in want:
        top = float(np.abs(want[k]).max())
        diff = np.abs(got[k] - want[k])
        assert (diff > of_max * top).mean() <= share, f"{what}/{k}"
        assert diff.max() <= outlier_of_max * top, f"{what}/{k}"


@pytest.fixture(scope="module")
def pod_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _stable_hash(name: str) -> int:
    return zlib.crc32(name.encode())


def _ref_run(mesh, compress: bool, steps: int):
    """The reference's jitted train step from a seeded init: the initial
    state as numpy, and each step's metrics and the final state.

    The reference folds each parameter's path into its key with Python's
    ``hash`` of the path's names (``repro/models/params.py:90``), which is
    salted per process: every test process would draw other weights, and
    in about one draw in sixteen a bf16 rounding flip of the compute copy
    moves the third step's gradient norm past 1e-5 (the module
    docstring's mechanism). The init here folds in a stable hash of the
    same names instead, so every run starts from the same weights. The
    gradient norm is held to the gap one bf16 ulp of every gradient opens
    (``_ulp_norm``), which holds on any draw: a relative 1e-5 sat at the
    edge of the noise (over 16 draws the difference was 1.7e-7 to 5.8e-6,
    and 1.26e-5 on one)."""
    from repro.models import params as jparams
    from repro.optim import adamw as jadamw
    from repro.optim import schedule as jschedule
    from repro.training.step import (init_train_state as jinit,
                                     make_train_step as jmake)
    jcfg, cfg = _cfgs()
    jm = JaxModel.create(jcfg, mesh, JaxParallelConfig(remat="full"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jparams, "hash", _stable_hash, raising=False)
        state = jinit(jm, jax.random.key(0))
    init = _np(state)
    step = jax.jit(jmake(jm, jadamw.AdamWConfig(),
                         partial(jschedule.warmup_cosine, **LR),
                         compress_pod_grads=compress))
    metrics = []
    for b in _batches(cfg, steps):
        *state, m = step(*state, _jax_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, _np(state)


@pytest.fixture(scope="module")
def ref_steps():
    return _ref_run(make_host_mesh(), compress=False, steps=STEPS)


@pytest.fixture(scope="module")
def ref_compressed_steps():
    return _ref_run(make_mesh((1, 1, 1), ("pod", "data", "model")),
                    compress=True, steps=2)


def _port_state(init):
    params_c, master, opt = init
    return (params_from_jax(params_c, "cpu"), params_from_jax(master, "cpu"),
            adamw.opt_state_from_jax(opt, "cpu"))


def _ulp_norm(grads) -> float:
    """The norm of one bf16 rounding step (ulp) of every gradient element:
    two gradient norms differ by at most this much when each element of
    one is within one bf16 ulp of the other's (|‖a‖ - ‖b‖| ≤ ‖a - b‖)."""
    total = 0.0
    for _, g in tree_flatten(grads):
        a = g.float().abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
        ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)   # 8-bit mantissa
        total += float(torch.sum(ulp.double() ** 2))
    return total ** 0.5


def _port_run(init, steps, pod_group=None, compress=False, plan=None,
              ulps=None):
    """The port's steps from ``init``; with a list ``ulps``, each step's
    ``_ulp_norm`` of the gradients it moves is appended to it."""
    _, cfg = _cfgs()
    model = Model.create(cfg, ParallelConfig(remat="full"), device="cpu",
                         pod_group=pod_group)
    step = make_train_step(model, adamw.AdamWConfig(),
                           partial(schedule.warmup_cosine, **LR),
                           compress_pod_grads=compress, offload_plan=plan)
    state = _port_state(init)
    metrics = []
    for b in _batches(cfg, steps):
        if ulps is not None:
            ulps.append(_ulp_norm(compute_grads(model, state[0], b)[1]))
        *state, m = step(*state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_value_and_grads_match_reference(dtype):
    from repro.models.transformer import loss_fn as jax_loss_fn
    from repro.training.step import init_train_state as jinit
    jcfg, cfg = _cfgs(dtype)
    jm = JaxModel.create(jcfg, make_host_mesh(),
                         JaxParallelConfig(remat="full"))
    params_c, master, _ = jinit(jm, jax.random.key(1))
    params = master if dtype == "float32" else params_c
    batch = _batches(cfg, 1)[0]
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, jm.mctx, _jax_batch(batch)),
        has_aux=True)(params)
    model = Model.create(cfg, ParallelConfig(remat="full"), device="cpu")
    (loss, parts), grads = compute_grads(
        model, params_from_jax(_np(params), "cpu"), batch)
    tol = MODEL_TOL[dtype]
    assert float(loss) == pytest.approx(float(jloss), rel=tol)
    assert float(parts["ce"]) == pytest.approx(float(jparts["ce"]), rel=tol)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    if dtype == "float32":
        _assert_close(grads, jgrads, "grads", rtol=tol, atol=tol)
    else:
        _assert_close(grads, jgrads, "grads", of_max=tol)


def test_remat_changes_no_value():
    """Recomputing each block in the backward gives the same loss and
    gradients, bit for bit, as keeping its activations."""
    _, cfg = _cfgs()
    batch = _batches(cfg, 1)[0]
    gen = torch.Generator().manual_seed(0)
    out = {}
    for remat in ("none", "full"):
        model = Model.create(cfg, ParallelConfig(remat=remat), device="cpu")
        params = init_train_state(model, gen.manual_seed(0))[0]
        out[remat] = compute_grads(model, params, batch)
    (l0, _), g0 = out["none"]
    (l1, _), g1 = out["full"]
    assert torch.equal(l0, l1)
    for (_, a), (_, b) in zip(tree_flatten(g0), tree_flatten(g1)):
        assert torch.equal(a, b)


def test_train_steps_match_reference(ref_steps):
    """Loss and cross-entropy within 1e-5; the gradient norm within one
    bf16 ulp of every moved gradient element (``_ulp_norm``), the gap a
    rounding flip of the bf16 gradients can open, on any draw of weights."""
    init, jmetrics, (jparams_c, jmaster, jopt) = ref_steps
    ulps = []
    metrics, (params_c, master, opt) = _port_run(init, STEPS, ulps=ulps)
    for got, want, ulp in zip(metrics, jmetrics, ulps):
        for k in ("loss", "ce"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
        assert abs(got["grad_norm"] - want["grad_norm"]) <= ulp, (
            got["grad_norm"], want["grad_norm"], ulp)
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        assert got["aux"] == want["aux"] == 0.0
    assert int(opt.count) == int(jopt.count) == STEPS
    _assert_close(master, jmaster, "master", atol=1e-5)
    _assert_moments_close(opt.mu, jopt.mu, "mu")
    _assert_moments_close(opt.nu, jopt.nu, "nu")
    # the compute copy is the master's bf16 cast, bit for bit
    for (_, c), (_, p) in zip(tree_flatten(params_c), tree_flatten(master)):
        assert c.dtype == torch.bfloat16 and torch.equal(c, p.bfloat16())


def test_offloaded_state_streams_to_the_same_values(ref_steps):
    """With master, mu and nu planned in pinned_host (plain CPU memory for
    a CPU model), the step streams them one layer slice at a time; the
    state after the steps equals the all-on-device run's bit for bit."""
    init = ref_steps[0]
    _, cfg = _cfgs()
    plan = plan_training_placement(cfg, 1, policy="always")
    assert {plan.kinds[g] for g in ("master", "mu", "nu")} == \
        {"pinned_host"}
    m0, s0 = _port_run(init, 2)
    m1, s1 = _port_run(init, 2, plan=plan)
    assert m0 == m1
    for a, b in zip([*s0[:2], s0[2].mu, s0[2].nu],
                    [*s1[:2], s1[2].mu, s1[2].nu]):
        for (_, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)):
            assert torch.equal(x, y)


def test_compressed_step_matches_reference_jitted(ref_compressed_steps,
                                                  pod_group):
    init, jmetrics, (_, jmaster, _) = ref_compressed_steps
    metrics, (_, master, _) = _port_run(init, 2, pod_group=pod_group,
                                        compress=True)
    for got, want in zip(metrics, jmetrics):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-4)
    got, want = _flat_np(master), _flat_np(jmaster)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * LR["peak_lr"] * 2, k
        assert (diff > 1e-5).mean() < 1e-3, k


def test_compressed_grads_are_the_int8_round_trip(pod_group):
    """One pod: the compressed gradients are the uncompressed ones through
    quantize and dequantize, within the reference's bound per block
    (0.51 x scale: scale/2 plus the rounding of x/scale and of q*scale),
    and the loss is the uncompressed loss."""
    from repro_torch.core.compression import quantize_int8, roundtrip_int8
    _, cfg = _cfgs()
    model = Model.create(cfg, ParallelConfig(remat="full"), device="cpu",
                         pod_group=pod_group)
    params = init_train_state(model, torch.Generator().manual_seed(2))[0]
    batch = _batches(cfg, 1)[0]
    (l0, _), g0 = compute_grads(model, params, batch)
    (l1, _), g1 = compute_grads(model, params, batch,
                                compress_pod_grads=True)
    assert torch.equal(l0, l1)
    for (_, a), (_, b) in zip(tree_flatten(g0), tree_flatten(g1)):
        assert b.dtype == torch.float32 and b.shape == a.shape
        assert torch.equal(b, roundtrip_int8(a))
        _, s, _ = quantize_int8(a)
        err = (b - a.float()).reshape(-1)
        err = torch.nn.functional.pad(err, (0, (-err.numel()) % 256))
        assert (err.reshape(-1, 256).abs().amax(1) <= s * 0.51).all()


def test_train_microbatch_equivalence(tmp_path):
    """lr=0: microbatched loss must equal full-batch loss
    (tests/test_system.py's bound)."""
    _, cfg = _cfgs("bfloat16")
    shape = ShapeConfig("t", 64, 4, "train")

    def run_with(n, sub):
        run = RunConfig(steps=3, learning_rate=0.0, warmup_steps=1,
                        checkpoint_dir=str(tmp_path / sub),
                        checkpoint_every=0, log_every=100)
        return train(cfg, shape, run,
                     ParallelConfig(remat="none", microbatches=n),
                     device="cpu", log=lambda *a: None)["history"]
    np.testing.assert_allclose(run_with(1, "a"), run_with(2, "b"),
                               rtol=2e-2)


def test_train_resume_equals_uninterrupted_run(tmp_path):
    """Six steps with a checkpoint at step 3; a second train() resumes from
    it and repeats steps 4 and 5 of the first run (rtol 1e-5, the bound the
    card run holds it to)."""
    _, cfg = _cfgs("bfloat16")
    shape = ShapeConfig("t", 32, 2, "train")
    run = RunConfig(steps=6, learning_rate=1e-3, warmup_steps=2,
                    checkpoint_dir=str(tmp_path), checkpoint_every=3,
                    log_every=100)
    first = train(cfg, shape, run, device="cpu", log=lambda *a: None)
    assert len(first["history"]) == 6
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003"]
    second = train(cfg, shape, run, device="cpu", log=lambda *a: None)
    assert len(second["history"]) == 2
    np.testing.assert_allclose(second["history"], first["history"][4:],
                               rtol=1e-5)


@pytest.mark.parametrize("checkpointed", [True, False])
def test_train_timeout_restores_the_state_in_place(tmp_path, monkeypatch,
                                                  checkpointed):
    """Step 3 runs (updating the state in place) and is then declared hung.
    With a checkpoint from step 2, step 4 starts from it, written into the
    same tensors; with none, from a fresh draw of the initial state."""
    import repro_torch.launch.train as train_mod
    from repro_torch.runtime.fault import StepSupervisor, StepTimeout
    _, cfg = _cfgs("bfloat16")
    hung = 3
    seen = []             # per step: (master leaf, its values at the start)
    build = train_mod.train_step_fn

    def recording(*args, **kwargs):
        fn = build(*args, **kwargs)

        def step(params_c, master, opt_state, batch):
            seen.append([(t, t.clone()) for _, t in tree_flatten(master)])
            return fn(params_c, master, opt_state, batch)
        return step

    class HangsOnce(StepSupervisor):
        def run(self, fn, *args):
            out = super().run(fn, *args)
            if len(seen) == hung + 1:
                raise StepTimeout("declared hung after it ran")
            return out

    monkeypatch.setattr(train_mod, "train_step_fn", recording)
    monkeypatch.setattr(train_mod, "StepSupervisor", HangsOnce)
    run = RunConfig(steps=5, learning_rate=1e-3, warmup_steps=1,
                    checkpoint_dir=str(tmp_path),
                    checkpoint_every=2 if checkpointed else 0, log_every=100)
    out = train(cfg, ShapeConfig("t", 32, 2, "train"), run, device="cpu",
                log=lambda *a: None)
    assert len(out["history"]) == 4 and len(seen) == 5
    start = seen[hung] if checkpointed else seen[0]
    for (t, v), (t_want, v_want) in zip(seen[hung + 1], start):
        torch.testing.assert_close(v, v_want, rtol=0, atol=0)
        assert (t is t_want) == checkpointed
    assert any(not torch.equal(t, v) for t, v in seen[hung])    # step 3 ran


def _port_cfg(jcfg):
    """The reference's ModelConfig as the port's (nested configs too)."""
    kw = dataclasses.asdict(jcfg)
    if kw["moe"] is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    if kw["mla"] is not None:
        kw["mla"] = MLAConfig(**kw["mla"])
    return type(get_config("yi-9b"))(**kw)


def test_plan_training_placement_matches_reference():
    """Every architecture the reference registers, full and reduced, on
    1, 8 and 256 chips, under each policy: the same plan."""
    from repro.config.base import list_archs as jax_list_archs
    from repro.core.placement import \
        plan_training_placement as jax_plan
    n = 0
    for arch in jax_list_archs():
        for jcfg in (jax_get_config(arch), jax_get_config(arch).reduced()):
            cfg = _port_cfg(jcfg)
            assert cfg.num_params == jcfg.num_params
            for chips in (1, 8, 256):
                for policy in ("auto", "never", "always"):
                    got = plan_training_placement(cfg, chips, policy=policy)
                    want = jax_plan(jcfg, chips, policy=policy)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (arch, chips, policy)
                    n += 1
    assert n >= 9 * 2 * len(jax_list_archs())
    # yi-9b on one chip: the reference's 16 GiB topology offloads all three
    plan = plan_training_placement(get_config("yi-9b"), 1)
    assert [plan.kinds[g] for g in ("params", "master", "mu", "nu")] == \
        ["device", "pinned_host", "pinned_host", "pinned_host"]


def test_opt_state_from_jax_round_trip(ref_steps):
    init = ref_steps[0]
    opt = adamw.opt_state_from_jax(init[2], "cpu")
    assert opt.count.dtype == torch.int32 and int(opt.count) == 0
    for (_, got), want in zip(tree_flatten(opt.mu),
                              jax.tree.leaves(init[2].mu)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_train_config_copy_matches_reference():
    from repro.config.base import RunConfig as JaxRunConfig
    got, want = dataclasses.asdict(RunConfig()), \
        dataclasses.asdict(JaxRunConfig())
    assert got.pop("checkpoint_dir").endswith("repro_ckpt")
    want.pop("checkpoint_dir")
    assert got == want
    jp = JaxParallelConfig()
    p = ParallelConfig()
    assert dataclasses.asdict(p) == {**dataclasses.asdict(jp),
                                     "attention_kernel": "eager"}
    assert jp.attention_kernel == "xla"          # the port's "eager"
    ParallelConfig(remat="dots")                 # the reference's third
    for bad in (dict(remat="layers"), dict(microbatches=0)):
        with pytest.raises(ValueError):
            ParallelConfig(**bad)
