"""Training over the model zoo, on the CPU: the loss and every parameter's
gradient against the reference's (``jax.value_and_grad`` of its
``loss_fn``, each block under ``jax.checkpoint`` as the port's is under
``torch.utils.checkpoint``), recomputation that changes no value, and the
train CLI for each architecture. Reduced gemma3 has a segment of no layers
(its 2 layers are all tail): its empty leaves get zero gradients, as under
``jax.grad``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.config.base import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh
from repro.models.model import Model as JaxModel
from repro.models.transformer import loss_fn as jax_loss_fn
from repro_torch.config.base import ParallelConfig, get_config
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_jax, tree_flatten
from repro_torch.training.step import compute_grads

TOL = 2e-4
ARCHS = ["gemma3-27b", "mixtral-8x22b", "deepseek-v3-671b", "zamba2-7b",
         "xlstm-350m"]


def _batch(vocab: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg = jax_get_config(arch).reduced(dtype="float32")
    cfg = get_config(arch).reduced(dtype="float32")
    jm = JaxModel.create(jcfg, make_host_mesh(),
                         JaxParallelConfig(remat="full"))
    jparams = jm.init(jax.random.key(4))
    batch = _batch(cfg.vocab_size)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, jm.mctx,
                              jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jparams)
    m = Model.create(cfg, ParallelConfig(remat="full"), device="cpu")
    (loss, parts), grads = compute_grads(
        m, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    assert float(parts["aux"]) == pytest.approx(float(jparts["aux"]),
                                                rel=1e-5, abs=1e-12)
    want = dict(tree_flatten(jax.tree.map(np.asarray, jgrads)))
    got = dict(tree_flatten(grads))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path].numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    """Recomputing each block in the backward gives the same loss and
    gradients, bit for bit, as keeping its activations."""
    cfg = get_config(arch).reduced(dtype="float32")
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(cfg.vocab_size, 1).items()}
    out = {}
    for remat in ("none", "full"):
        m = Model.create(cfg, ParallelConfig(remat=remat), device="cpu")
        params = m.init(torch.Generator().manual_seed(0))
        out[remat] = compute_grads(m, params, batch)
    (l0, _), g0 = out["none"]
    (l1, _), g1 = out["full"]
    assert torch.equal(l0, l1)
    for (_, a), (_, b) in zip(tree_flatten(g0), tree_flatten(g1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_arch_on_cpu(arch, tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
          "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final_loss"]) and out["final_loss"] > 0
