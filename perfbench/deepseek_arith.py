"""The yardstick of the ``deepseek`` family: what DeepSeek-V3's layers
must move and compute, from the configuration's shapes, at the chip's
share of the routed experts. Beside ``arith.py``, whose peaks and
attention pairs it uses, and, like it, in the benchmark's own folder.

A token's share of the routed work is its expected one: of its ``top_k``
(token, expert) pairs, ``held / routed_over`` reach the experts held here
(top 8 of 256, 8 held: a quarter of a pair a token, a layer).
"""

from __future__ import annotations

import dataclasses

from perfbench import arith
from perfbench.arith import BF16_BYTES


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes a DeepSeek configuration file states, under short
    names."""
    layers: int
    dense_layers: int
    d: int
    heads: int
    q_lora: int
    kv_lora: int
    nope: int
    rope: int
    v: int
    ff: int                    # the dense layers' SwiGLU
    ff_expert: int
    routed_over: int           # experts the router scores
    held: int                  # experts this chip holds
    top_k: int
    shared: int
    vocab: int

    @classmethod
    def from_config(cls, c: dict) -> "Dims":
        return cls(layers=c["num_hidden_layers"],
                   dense_layers=c["first_k_dense_replace"],
                   d=c["hidden_size"], heads=c["num_attention_heads"],
                   q_lora=c["q_lora_rank"], kv_lora=c["kv_lora_rank"],
                   nope=c["qk_nope_head_dim"], rope=c["qk_rope_head_dim"],
                   v=c["v_head_dim"], ff=c["intermediate_size"],
                   ff_expert=c["moe_intermediate_size"],
                   routed_over=c["expert_share"]["routed_over"],
                   held=c["n_routed_experts"],
                   top_k=c["num_experts_per_tok"],
                   shared=c["n_shared_experts"], vocab=c["vocab_size"])

    @property
    def moe_layers(self) -> int:
        return self.layers - self.dense_layers

    @property
    def attn_params(self) -> int:
        """One layer's MLA projections: down to the query latent, up to
        the heads' q, down to the KV latent and k_rope, up to the heads'
        k_nope and v, out."""
        H, qk = self.heads, self.nope + self.rope
        return (self.d * self.q_lora + self.q_lora * H * qk
                + self.d * (self.kv_lora + self.rope)
                + self.kv_lora * H * (self.nope + self.v)
                + H * self.v * self.d)

    @property
    def expert_params(self) -> int:
        """One expert's gate, up and down matrices."""
        return 3 * self.d * self.ff_expert

    @property
    def held_pairs_per_token(self) -> float:
        """The expected pairs of one token that reach the held experts,
        in one MoE layer."""
        return self.top_k * self.held / self.routed_over

    @property
    def weight_count(self) -> int:
        """Every parameter held: layers with their norms, the router and
        its correction bias, the held and shared experts, the embedding
        table, the output matrix and the final norm."""
        norms = 2 * self.d + self.q_lora + self.kv_lora
        dense = self.attn_params + norms + 3 * self.d * self.ff
        moe = (self.attn_params + norms
               + (self.d + 1) * self.routed_over
               + (self.held + self.shared) * self.expert_params)
        return (self.dense_layers * dense + self.moe_layers * moe
                + 2 * self.vocab * self.d + self.d)

    @property
    def kv_bytes_per_token(self) -> int:
        """The latent cache of one position over every layer, bf16: the
        KV latent and k_rope (DeepSeek-V3: (512 + 64) x 2 B a layer)."""
        return self.layers * (self.kv_lora + self.rope) * BF16_BYTES

    def _attention_pairs(self, batch: int, plen: int) -> tuple:
        """(operations, bytes) of a prefill's attention over ``batch``
        prompts of ``plen``, every layer: 2 * (qk + v) per unmasked
        (query, key) pair a head; q, k, v read once and the output
        written once, bf16."""
        H, qk = self.heads, self.nope + self.rope
        pairs = arith.attended_pairs(plen)
        flops = 2.0 * (qk + self.v) * H * pairs * batch * self.layers
        nbytes = float(BF16_BYTES * batch * plen * H * (2 * qk + 2 * self.v)
                       * self.layers)
        return flops, nbytes

    # the six counts the per-layer readers take (``record["dims"]``)

    def prefill_flops(self, prompt_lens) -> float:
        """Model operations of a prefill over the real prompts: two per
        matmul weight a token multiplies by (its expected held pairs'
        experts among them), the attention's pairs, and the unembedding of
        each prompt's last token."""
        per_token = 2.0 * (
            self.layers * self.attn_params
            + self.dense_layers * 3 * self.d * self.ff
            + self.moe_layers * (self.d * self.routed_over
                                 + (self.shared + self.held_pairs_per_token)
                                 * self.expert_params))
        total = 0.0
        for p in prompt_lens:
            total += per_token * p + self._attention_pairs(1, p)[0]
            total += 2.0 * self.d * self.vocab
        return total

    def decode_step_bytes(self, batch: int, context: int) -> float:
        """Bytes one decode step must move at ``batch`` sequences that each
        hold ``context`` cached positions: every weight read once (of the
        token table only the ``batch`` rows looked up; every held expert,
        as a batch of hundreds of tokens leaves next to none unhit), the
        live latents read once and the new ones written once, bf16."""
        weights = (self.weight_count - self.vocab * self.d
                   + batch * self.d) * BF16_BYTES
        return float(weights + batch * (context + 1)
                     * self.kv_bytes_per_token)

    def prefill_attention_bound(self, batch: int, plen: int) -> float:
        """Least time of a prefill's attention over ``batch`` prompts
        padded to ``plen``, every layer, at the card's bf16 peaks."""
        flops, nbytes = self._attention_pairs(batch, plen)
        return max(flops / arith.PEAK_FLOPS["bfloat16"],
                   nbytes / arith.HBM_BYTES_PER_S)

    def decode_expert_bytes(self, batch: int) -> float:
        """Bytes the held experts of one decode step must move at
        ``batch`` sequences: each MoE layer's held experts' weights read
        once (DeepSeek-V3's 8: 2.82 GB over 4 layers) and its expected
        held pairs' rows read once and their outputs written once, bf16."""
        weights = self.moe_layers * self.held * self.expert_params
        rows = (self.moe_layers * 2 * batch * self.held_pairs_per_token
                * self.d)
        return float((weights + rows) * BF16_BYTES)

    def prefill_expert_flops(self, tokens: int) -> float:
        """Operations of the held experts over ``tokens`` routed tokens:
        2 * 3 * d * ff per expected held pair, every MoE layer."""
        return (2.0 * self.expert_params * tokens
                * self.held_pairs_per_token * self.moe_layers)
