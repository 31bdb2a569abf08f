"""Config system: model, shape, parallelism and run configs and the arch
registry.

A copy of the reference's ``repro/config/base.py`` (model configs, the
registry, ``ShapeConfig`` and the four assigned shapes in ``SHAPES``,
``ParallelConfig``, ``RunConfig``), kept here so
the port imports nothing from ``repro``. Configs are frozen dataclasses.

``ParallelConfig.attention_kernel`` selects the prefill attention path:
``"eager"`` (plain chunked attention, the reference's ``"xla"``) or
``"kernel"`` (the hand-written flash attention kernel, the reference's
``"pallas"``). ``remat``, ``microbatches`` and ``gradient_compression`` are
read by the training step; ``fsdp``, ``seq_parallel`` and
``serve_2d_weights`` by the sharding rules (``models/sharding.py``), and only
with a mesh. The other fields are carried as the reference carries them and
read by nothing, in either package.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Optional


# --------------------------------------------------------------------------
# Model configuration
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0
    d_ff_expert: int = 0          # per-expert FFN width
    # slots an expert has per T * k / E routed pairs in the training step
    # and the mesh bodies, which drop the pairs that overflow; serving
    # (Model.prefill / Model.decode off a mesh) is dropless and ignores it
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    first_dense_layers: int = 0   # deepseek: first k layers are dense


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned arch."""

    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # Attention flavor -----------------------------------------------------
    attn_type: str = "full"         # full | swa | local_global | mla
    window: int = 0                 # sliding-window size (swa / local layers)
    local_global_ratio: int = 0     # gemma3: N local layers per 1 global
    qkv_bias: bool = False
    rope_theta: float = 1e6
    mrope: bool = False             # qwen2-vl multimodal rope (3 position axes)

    # MoE -------------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    moe_every: int = 1              # MoE layer stride (1 = every layer)

    # MLA -------------------------------------------------------------------
    mla: Optional[MLAConfig] = None

    # SSM / hybrid ----------------------------------------------------------
    ssm_state: int = 0              # Mamba2 state dim per head
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    attn_every: int = 0             # hybrid: attention block every N layers
    # xLSTM -------------------------------------------------------------
    slstm_every: int = 0            # xlstm: sLSTM block every N layers (rest mLSTM)

    # Encoder-decoder ---------------------------------------------------
    encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # Modality frontend (STUB: input_specs provides embeddings) ----------
    frontend: str = "none"          # none | audio | vision

    # Numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ----------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch supports long_500k (no full-attention blow-up)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.attn_type == "swa":
            return True
        if self.attn_type == "local_global":
            return True  # local layers ring-buffered; few global layers
        return False

    @property
    def num_params(self) -> int:
        """Approximate parameter count (used by the placement capacity model)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.mla is not None:
            m = self.mla
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim)
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.num_heads * (
                m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.num_heads * m.v_head_dim * d
        elif self.family == "ssm":
            # xLSTM-style blocks: qkv + gates + out, rough 4*d*d
            per_layer += 4 * d * d
        else:
            per_layer += d * (self.num_heads * hd)            # q
            per_layer += 2 * d * (self.num_kv_heads * hd)     # k, v
            per_layer += (self.num_heads * hd) * d            # o
        if self.moe is not None:
            e = self.moe
            ff = e.d_ff_expert or self.d_ff
            per_layer += (e.num_experts + e.num_shared_experts) * 3 * d * ff
            per_layer += d * e.num_experts                    # router
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff                    # gated mlp
        if self.family == "hybrid" and self.ssm_state:
            inner = self.ssm_expand * d
            per_layer = 2 * d * inner + inner * d + inner * self.ssm_state * 2
        total = emb + L * per_layer
        if self.encoder_decoder:
            total += self.num_encoder_layers * per_layer
        return int(total)

    @property
    def active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.num_params
        e = self.moe
        d = self.d_model
        ff = e.d_ff_expert or self.d_ff
        dense_total = self.num_params
        all_expert = self.num_layers * e.num_experts * 3 * d * ff
        active_expert = self.num_layers * (e.top_k + e.num_shared_experts) * 3 * d * ff
        return int(dense_total - all_expert + active_expert)

    def reduced(self, **overrides: Any) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests."""
        small: dict[str, Any] = dict(
            num_layers=min(self.num_layers, 4 if self.attn_every else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
        )
        if self.moe is not None:
            # capacity_factor=4: no token dropping at smoke scale, so
            # full-forward and incremental decode agree exactly
            # (capacity-dropping is a train-time-only effect).
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_ff_expert=64 if self.moe.d_ff_expert else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                capacity_factor=4.0,
            )
        if self.mla is not None:
            small["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_heads=4, ssm_head_dim=32)
        if self.window:
            small["window"] = 32
        if self.encoder_decoder:
            small["num_encoder_layers"] = 2
        if self.attn_every:
            small["attn_every"] = 2
        if self.slstm_every:
            small["slstm_every"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)


# --------------------------------------------------------------------------
# Input shapes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name, min(self.seq_len, 64),
                           min(self.global_batch, 2), self.kind)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# --------------------------------------------------------------------------
# Parallelism / run configuration
# --------------------------------------------------------------------------

ATTENTION_KERNELS = ("eager", "kernel")
REMAT = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a step is sharded and run, with the reference's fields and
    defaults. Without a mesh none of the sharding fields changes what a
    step computes. ``remat`` other than ``"none"`` checkpoints every block:
    the reference reads only ``remat != "none"``, so ``"dots"`` acts as
    ``"full"`` there and here."""

    fsdp: bool = True              # shard weights/opt-state over 'data'
    remat: str = "full"            # none | full | dots (checkpoint blocks)
    offload_optimizer: str = "auto"   # carried, read by nothing
    offload_master: str = "auto"      # carried, read by nothing
    scan_layers: bool = True          # carried, read by nothing
    seq_shard_decode: bool = True     # carried, read by nothing
    gradient_compression: bool = False   # int8 cross-pod gradient mean
    attention_kernel: str = "eager"  # eager | kernel
    seq_parallel: bool = True      # activations seq-sharded over 'model'
    microbatches: int = 1          # gradient-accumulation steps
    serve_2d_weights: bool = False    # weights on both mesh axes
    logits_fp32: bool = False         # carried, read by nothing
    cast_params_bf16: bool = True     # carried, read by nothing

    def __post_init__(self):
        if self.attention_kernel not in ATTENTION_KERNELS:
            raise ValueError(
                f"attention_kernel={self.attention_kernel!r}; the port takes "
                f"one of {ATTENTION_KERNELS}")
        if self.remat not in REMAT:
            raise ValueError(f"remat={self.remat!r}; the port takes one of "
                             f"{REMAT}")
        if self.microbatches < 1:
            raise ValueError(f"microbatches={self.microbatches} < 1")


def _default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The reference's ``RunConfig``; its default checkpoint directory
    (``/tmp/repro_ckpt``) lives under the temporary directory that
    ``TMPDIR`` names."""

    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(
        default_factory=_default_checkpoint_dir)
    log_every: int = 10


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def cells(include_skips: bool = True):
    """All (arch, shape, skip) cells, the reference's: long_500k is skipped
    for an arch without sub-quadratic attention."""
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skip = None
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                skip = "skip(full-attn)"
            if skip is None or include_skips:
                out.append((arch, shape.name, skip))
    return out
