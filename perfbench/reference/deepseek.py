"""The plain reference of the ``deepseek`` family: DeepSeek-V3's forward
pass (arXiv:2412.19437; the configuration of
https://huggingface.co/deepseek-ai/DeepSeek-V3) in fp32, with TF32 off,
from the published description, at one chip's share of the routed
experts.

Pre-norm blocks with RMSNorm gains. Multi-head latent attention in its
plain (not absorbed) form: per head q = [q_nope ; q_rope] from the
normed query latent, k = [W_uk c ; k_rope] and v = W_uv c from the normed
KV latent c, k_rope one 64-wide part shared by every head; q_rope and
k_rope turned by YaRN's frequencies (``yarn_freqs``; cos and sin scaled
by mscale(factor, mscale) / mscale(factor, mscale_all_dim)); causal
softmax attention with scale (qk_nope + qk_rope) ** -0.5 times
mscale(factor, mscale_all_dim) squared. The first
``first_k_dense_replace`` layers end in a SwiGLU FFN; the others in the
MoE layer: the router of ``route`` over every routed expert, the held
experts' part of the routed result (experts ``expert_share["first"]`` on,
``n_routed_experts`` of them; the pairs of experts held elsewhere add
nothing) and the shared experts added once. A final norm and an untied
output matrix. No cache, no batching across requests beyond
right-padding, which a causal mask keeps from any position that counts,
and no kernel.

Departures from the published model, each also under the configuration
file's ``assumed``: bf16 weights in place of FP8 (drawn from the seed);
rope on split halves where the published code turns interleaved pairs (a
fixed permutation of the 64 rope columns of ``w_kr`` and ``w_uq``, which
seeded weights do not see); no multi-token-prediction module; the
correction bias drawn, not learned.

``quant="fp8"`` is the control: every projection's two operands rounded to
float8 e4m3 (``model.fake_fp8``) before an fp32 product.

``leaf_shapes`` and ``leaf_init`` are the family's weight tree and draws:
the layout of the program's tree (layers stacked on a leading axis in a
``dense`` and a ``moe`` segment, projections as (in, heads, head dim),
experts on an axis of their own).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.model import fake_fp8, fp32_products

NORMS = ("ln1", "ln2", "final_norm", "q_norm", "kv_norm")
BIAS = "e_score_correction_bias"
BIAS_STD = 0.02       # the correction bias's draw (its reason: PERF.md §4)
SCORE_BYTES = 1 << 30      # fp32 scores, keys and values of one slice


def segments(c: dict) -> list[tuple[str, int, bool]]:
    """(name, layers, MoE) of the stacked segments, in order."""
    fd, L = c["first_k_dense_replace"], c["num_hidden_layers"]
    return ([("dense", fd, False)] if fd else []) + [("moe", L - fd, True)]


def leaf_shapes(c: dict) -> dict:
    """{path: shape} of every weight of the configuration ``c``."""
    d, H, V = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    qr, kvr = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rope, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    mla = {"w_dq": (d, qr), "q_norm": (qr,), "w_uq": (qr, H, nope + rope),
           "w_dkv": (d, kvr), "kv_norm": (kvr,), "w_kr": (d, rope),
           "w_uk": (kvr, H, nope), "w_uv": (kvr, H, dv), "w_o": (H, dv, d)}
    shapes = {("embed", "tok"): (V, d), ("embed", "out"): (d, V),
              ("final_norm",): (d,)}
    for seg, n, moe in segments(c):
        shapes[(seg, "ln1")] = shapes[(seg, "ln2")] = (n, d)
        for k, s in mla.items():
            shapes[(seg, "attn", k)] = (n, *s)
        if not moe:
            ff = c["intermediate_size"]
            shapes.update({(seg, "mlp", "w_gate"): (n, d, ff),
                           (seg, "mlp", "w_up"): (n, d, ff),
                           (seg, "mlp", "w_down"): (n, ff, d)})
            continue
        E, held = c["expert_share"]["routed_over"], c["n_routed_experts"]
        ff = c["moe_intermediate_size"]
        ffs = ff * c["n_shared_experts"]
        shapes.update({(seg, "moe", "router"): (n, d, E),
                       (seg, "moe", BIAS): (n, E),
                       (seg, "moe", "w_gate"): (n, held, d, ff),
                       (seg, "moe", "w_up"): (n, held, d, ff),
                       (seg, "moe", "w_down"): (n, held, ff, d),
                       (seg, "moe", "shared", "w_gate"): (n, d, ffs),
                       (seg, "moe", "shared", "w_up"): (n, d, ffs),
                       (seg, "moe", "shared", "w_down"): (n, ffs, d)})
    return shapes


def leaf_init(path: tuple, shape: tuple) -> tuple[float, float]:
    """(mean, standard deviation) of a leaf's normal draw: norm gains
    around 1, the token table at unit scale, the correction bias at
    ``BIAS_STD``, every matrix at one over the root of the dimension its
    product sums over."""
    name = path[-1]
    if name in NORMS:
        return 1.0, 0.1
    if path == ("embed", "tok"):
        return 0.0, 1.0
    if name == BIAS:
        return 0.0, BIAS_STD
    if name == "w_o":
        return 0.0, 1.0 / math.sqrt(shape[-3] * shape[-2])
    if name in ("w_uq", "w_uk", "w_uv"):
        return 0.0, 1.0 / math.sqrt(shape[-3])
    return 0.0, 1.0 / math.sqrt(shape[-2])


def yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_freqs(c: dict) -> torch.Tensor:
    """YaRN's inverse frequencies (float64) for the rope dim D: RoPE's
    theta ** (-2i / D) (extra) and the same over ``factor`` (inter),
    blended by the ramp m_i = clamp((i - low) / (high - low), 0, 1) as
    inter * m + extra * (1 - m), where low and high are the floor and the
    ceiling of the correction dims D ln(L / (2 pi r)) / (2 ln theta) at r
    = beta_fast and beta_slow, L the original context, held to [0, D - 1].
    Without ``rope_scaling``, RoPE's own."""
    D, theta = c["qk_rope_head_dim"], float(c["rope_theta"])
    i = torch.arange(D // 2, dtype=torch.float64)
    extra = theta ** (-2 * i / D)
    y = c.get("rope_scaling")
    if not y:
        return extra

    def dim(r):
        return D * math.log(y["original_max_position_embeddings"]
                            / (2 * math.pi * r)) / (2 * math.log(theta))
    low = max(math.floor(dim(y["beta_fast"])), 0)
    high = min(math.ceil(dim(y["beta_slow"])), D - 1)
    ramp = ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    return extra / y["factor"] * ramp + extra * (1 - ramp)


def softmax_scale(c: dict) -> float:
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    y = c.get("rope_scaling")
    if y and y.get("mscale_all_dim"):
        scale *= yarn_mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return scale


def route(s: torch.Tensor, b: torch.Tensor, c: dict):
    """DeepSeek-V3's router on sigmoid scores ``s`` (T, E) with the
    correction bias ``b`` (E,): (gates (T, k), experts (T, k)). The choice
    scores are s + b; each of ``n_group`` groups scores the sum of its two
    best; the ``topk_group`` best groups are kept and the top k experts
    by choice score among them chosen (ties to the lower index: stable
    sorts); the gates are their s, over their sum where
    ``norm_topk_prob``, times ``routed_scaling_factor``."""
    T, E = s.shape
    G, k = c["n_group"], c["num_experts_per_tok"]
    choice = s + b
    grp = torch.sort(choice.view(T, G, E // G), dim=-1,
                     descending=True).values[..., :2].sum(-1)
    keep = torch.sort(grp, dim=-1, descending=True,
                      stable=True).indices[:, :c["topk_group"]]
    kept = torch.zeros(T, G, dtype=torch.bool, device=s.device)
    kept[torch.arange(T, device=s.device)[:, None], keep] = True
    choice = torch.where(kept.repeat_interleave(E // G, dim=1), choice,
                         torch.full_like(choice, float("-inf")))
    eids = torch.sort(choice, dim=-1, descending=True,
                      stable=True).indices[:, :k]
    gates = s.gather(1, eids)
    if c["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    return gates * c["routed_scaling_factor"], eids


class Reference:
    """The forward pass of configuration ``c`` over the weights ``w``
    ({path: tensor}, any float dtype; each leaf is taken to fp32 where it
    is used)."""

    def __init__(self, c: dict, w: dict, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown reference precision {quant!r}")
        self.c = c
        self.w = w
        self.quant = quant
        self.layers = [(seg, i, moe) for seg, n, moe in segments(c)
                       for i in range(n)]
        y = c.get("rope_scaling")
        self.rope_mscale = (yarn_mscale(y["factor"], y["mscale"])
                            / yarn_mscale(y["factor"], y["mscale_all_dim"])
                            if y else 1.0)

    def _mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a (..., k) @ w (k, n) in fp32 (the control: both rounded to
        fp8 first)."""
        if self.quant == "fp8":
            a = fake_fp8(a, dim=-1)
            w = fake_fp8(w, dim=0)
        return a @ w

    def _leaf(self, *path, layer=None) -> torch.Tensor:
        """A leaf in fp32: ``layer`` (segment, index) picks a layer of the
        stacked ``path`` under that segment."""
        if layer is None:
            return self.w[path].float()
        seg, i = layer
        return self.w[(seg, *path)][i].float()

    def _norm(self, x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.c["rms_norm_eps"]) * gain

    def _rope(self, x: torch.Tensor, start: int) -> torch.Tensor:
        """x (B, n, ..., D) at positions ``start`` on, turned on split
        halves by ``yarn_freqs``."""
        B, n, D = x.shape[0], x.shape[1], x.shape[-1]
        half = D // 2
        ang = (torch.arange(start, start + n, dtype=torch.float64,
                            device=x.device)[:, None]
               * yarn_freqs(self.c).to(x.device)[None, :]).float()
        shape = (1, n) + (1,) * (x.dim() - 3) + (half,)
        cos = (torch.cos(ang) * self.rope_mscale).view(shape)
        sin = (torch.sin(ang) * self.rope_mscale).view(shape)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def latents(self, h: torch.Tensor, layer, start: int = 0):
        """The KV latent of ``h`` (B, n, d) at positions ``start`` on: the
        normed c (B, n, kv_lora) and the turned k_rope (B, n, rope)."""
        ckv = self._norm(self._mm(h, self._leaf("attn", "w_dkv",
                                                layer=layer)),
                         self._leaf("attn", "kv_norm", layer=layer))
        k_rope = self._rope(self._mm(h, self._leaf("attn", "w_kr",
                                                   layer=layer)), start)
        return ckv, k_rope

    def attend(self, h: torch.Tensor, layer, ckv: torch.Tensor,
               k_rope: torch.Tensor, start: int = 0) -> torch.Tensor:
        """Attention of the queries of ``h`` (B, n, d) at positions
        ``start`` on to the keys at positions 0 .. start + n - 1, whose
        latents are ``ckv`` and ``k_rope`` (B, >= start + n, ...); each
        key's k and v up-projected from its latent. Over slices of the
        batch, so that one slice's fp32 scores, keys and values stay
        within ``SCORE_BYTES``."""
        c = self.c
        B, n, d = h.shape
        H, nope, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                       c["v_head_dim"])
        qr, kvr = c["q_lora_rank"], c["kv_lora_rank"]
        T = start + n
        cq = self._norm(self._mm(h, self._leaf("attn", "w_dq", layer=layer)),
                        self._leaf("attn", "q_norm", layer=layer))
        q = self._mm(cq, self._leaf("attn", "w_uq", layer=layer)
                     .reshape(qr, -1)).view(B, n, H, -1)
        q = torch.cat([q[..., :nope], self._rope(q[..., nope:], start)], -1)
        w_uk = self._leaf("attn", "w_uk", layer=layer).reshape(kvr, H * nope)
        w_uv = self._leaf("attn", "w_uv", layer=layer).reshape(kvr, H * dv)
        keys = torch.arange(T, device=h.device)
        mask = keys[None, :] <= torch.arange(start, T,
                                             device=h.device)[:, None]
        per = max(1, SCORE_BYTES // (4 * H * T * (n + nope + dv + 64)))
        ctx = torch.empty((B, n, H, dv), device=h.device)
        for b in range(0, B, per):
            lat = ckv[b:b + per, :T]
            m = lat.shape[0]
            k = torch.cat([self._mm(lat, w_uk).view(m, T, H, nope),
                           k_rope[b:b + per, :T, None, :].expand(
                               m, T, H, k_rope.shape[-1])], -1)
            v = self._mm(lat, w_uv).view(m, T, H, dv)
            s = torch.einsum("bqhd,bkhd->bhqk", q[b:b + per], k) \
                * softmax_scale(c)
            s = s.masked_fill(~mask, float("-inf"))
            ctx[b:b + per] = torch.einsum("bhqk,bkhd->bqhd",
                                          torch.softmax(s, -1), v)
        w_o = self._leaf("attn", "w_o", layer=layer).reshape(H * dv, d)
        return self._mm(ctx.reshape(B, n, H * dv), w_o)

    def _swiglu(self, h, w_gate, w_up, w_down):
        return self._mm(F.silu(self._mm(h, w_gate)) * self._mm(h, w_up),
                        w_down)

    def ffn(self, h: torch.Tensor, layer, moe: bool) -> torch.Tensor:
        """The dense SwiGLU, or the MoE layer: the held experts' part of
        the routed result plus the shared experts."""
        if not moe:
            return self._swiglu(h, *(self._leaf("mlp", n, layer=layer)
                                     for n in ("w_gate", "w_up", "w_down")))
        c = self.c
        shape = h.shape
        x = h.reshape(-1, shape[-1])
        s = torch.sigmoid(x @ self._leaf("moe", "router", layer=layer))
        gates, eids = route(s, self._leaf("moe", BIAS, layer=layer), c)
        first = c["expert_share"]["first"]
        seg, i = layer
        y = torch.zeros_like(x)
        for j in range(c["n_routed_experts"]):
            rows, slot = torch.nonzero(eids == first + j, as_tuple=True)
            if rows.numel() == 0:
                continue
            out = self._swiglu(x[rows], *(
                self.w[(seg, "moe", n)][i, j].float()
                for n in ("w_gate", "w_up", "w_down")))
            y.index_add_(0, rows, out * gates[rows, slot][:, None])
        y = y + self._swiglu(x, *(self._leaf("moe", "shared", n, layer=layer)
                                  for n in ("w_gate", "w_up", "w_down")))
        return y.reshape(shape)

    def block(self, x: torch.Tensor, layer, moe: bool, cache=None,
              start: int = 0):
        """One layer on x (B, n, d) at positions ``start`` on: attention
        to x's own keys, or, with a ``cache`` (ckv, k_rope) of earlier
        positions' latents, x's latents written into it at ``start`` and
        attention to all it holds up to x's last position; then the
        FFN."""
        h = self._norm(x, self._leaf("ln1", layer=layer))
        ckv, k_rope = self.latents(h, layer, start)
        if cache is not None:
            n = x.shape[1]
            cache[0][:, start:start + n] = ckv
            cache[1][:, start:start + n] = k_rope
            ckv, k_rope = cache
        x = x + self.attend(h, layer, ckv, k_rope, start)
        return x + self.ffn(self._norm(x, self._leaf("ln2", layer=layer)),
                            layer, moe)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self._mm(self._norm(x, self._leaf("final_norm")),
                        self._leaf("embed", "out"))

    @torch.no_grad()
    def logits(self, seqs: list, want: list) -> list[torch.Tensor]:
        """fp32 logits (len(want[i]), vocab) of sequence ``seqs[i]`` (token
        ids) at its positions ``want[i]``."""
        dev = self.w[("embed", "tok")].device
        S = max(len(s) for s in seqs)
        toks = torch.zeros((len(seqs), S), dtype=torch.long, device=dev)
        for i, s in enumerate(seqs):
            toks[i, :len(s)] = torch.as_tensor(list(s), device=dev)
        with fp32_products():
            x = self.w[("embed", "tok")][toks].float()
            for seg, i, moe in self.layers:
                x = self.block(x, (seg, i), moe)
            return [self.head(x[i, torch.as_tensor(p, device=dev)])
                    for i, p in enumerate(want)]
