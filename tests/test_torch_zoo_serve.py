"""The port's ServeEngine and serve CLI over the model zoo, on the CPU.

Each decoder-only architecture (qwen2-vl by tokens, with M-RoPE's equal
position rows, as the reference's engine serves it) serves through ``python -m
repro_torch.launch.serve --arch <name> --reduced --device cpu``; on the
reference's weights the port's engine generates the reference engine's
tokens (both cast their weights to bf16 and run fp32 activations, the
reference's attention through its Pallas kernel in interpret mode, the
port's through the kernel's plain version); and the weight-offloaded
engine gives the tokens of the engine that keeps its weights on the
device.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.config.base import get_config as jax_get_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import ServeEngine as JaxServeEngine
from repro_torch.config.base import get_config
from repro_torch.launch import serve
from repro_torch.models.params import params_from_jax, tree_map

ARCHS = ["gemma3-27b", "mixtral-8x22b", "deepseek-v3-671b", "zamba2-7b",
         "xlstm-350m", "qwen2-72b", "qwen1.5-110b", "qwen2-vl-72b"]
PROMPT_LENS, MAX_NEW = (20, 19, 17), 4


def _prompts(vocab: int):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_arch_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt", "12", "--gen", "3"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["requests"] == 2 and report["device"] == "cpu"
    vocab = get_config(arch).reduced().vocab_size
    assert len(report["sample"]) == 3
    assert all(0 <= t < vocab for t in report["sample"])


@pytest.mark.parametrize("arch", ["gemma3-27b", "mixtral-8x22b",
                                  "deepseek-v3-671b", "zamba2-7b",
                                  "xlstm-350m", "qwen2-vl-72b"])
def test_engine_tokens_match_reference(arch):
    overrides = dict(num_layers=8) if arch == "gemma3-27b" else {}
    jcfg = jax_get_config(arch).reduced(dtype="float32", **overrides)
    ref = JaxServeEngine(jcfg, parallel=JaxParallelConfig(
        fsdp=False, attention_kernel="pallas"))
    port = serve.ServeEngine(
        get_config(arch).reduced(dtype="float32", **overrides),
        device="cpu")
    port.model.set_params(params_from_jax(
        jax.tree.map(np.asarray, ref.params_home), "cpu"))
    prompts = _prompts(jcfg.vocab_size)
    want = ref.serve([JaxRequest(i, p, MAX_NEW)
                      for i, p in enumerate(prompts)])
    got = port.serve([serve.Request(i, p, MAX_NEW)
                      for i, p in enumerate(prompts)])
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(len(r.tokens) == MAX_NEW for r in got)


@pytest.mark.parametrize("arch", ["gemma3-27b", "zamba2-7b", "xlstm-350m",
                                  "deepseek-v3-671b"])
def test_offloaded_engine_serves_arch(arch):
    """Every segment kind's weights (group stacks, shared_attn) go to the
    host tier and come back whole on each call: the same tokens as the
    engine that keeps them on the device."""
    cfg = get_config(arch).reduced(dtype="float32")
    hbm = serve.ServeEngine(cfg, device="cpu")
    off = serve.ServeEngine(cfg, device="cpu", offload_weights=True)
    off.model.set_params(tree_map(torch.clone, hbm.params_home))
    prompts = _prompts(cfg.vocab_size)
    reqs = [serve.Request(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    assert [r.tokens for r in off.serve(reqs)] == \
        [r.tokens for r in hbm.serve(reqs)]
