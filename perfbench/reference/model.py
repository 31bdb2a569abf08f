"""The plain reference: a llama-style (Yi) or Mixtral-style decoder's
forward pass in fp32, with TF32 off, from the published description.

Pre-norm blocks with RMSNorm gains, rotary embeddings on split halves
(theta from the configuration, positions from 0), grouped-query causal
attention (with a window where the configuration states one), a SwiGLU
FFN, or a router that takes the top-k of a softmax over the experts and
renormalizes their gates (Mixtral: no capacity, no token dropped), a
final norm and an untied output matrix. No cache, no batching across
requests beyond right-padding, which a causal mask keeps from any
position that counts, and no kernel.

``quant="fp8"`` is the control: every projection's two operands rounded to
float8 e4m3 (per row of the activations and per output column of the
weights, each scaled to its largest magnitude) before an fp32 product.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from perfbench.reference.weights import segment

FP8_MAX = 448.0


@contextlib.contextmanager
def fp32_products():
    """fp32 products on the tensor cores' own precision path off: TF32
    would round the operands to 10 bits."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to e4m3's largest, 448)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    """The forward pass of configuration ``c`` over the weights ``w``
    ({path: tensor}, any float dtype; each layer is taken to fp32 when it
    runs)."""

    def __init__(self, c: dict, w: dict, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown reference precision {quant!r}")
        self.c = c
        self.w = w
        self.quant = quant
        self.seg = segment(c)

    def _mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a (..., k) @ w (k, n) in fp32 (the control: both rounded to
        fp8 first)."""
        if self.quant == "fp8":
            a = fake_fp8(a, dim=-1)
            w = fake_fp8(w, dim=0)
        return a @ w

    def _leaf(self, *path, layer: int | None = None) -> torch.Tensor:
        t = self.w[path]
        return (t if layer is None else t[layer]).float()

    def _norm(self, x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.c["rms_norm_eps"]) * gain

    def _rope(self, x: torch.Tensor, start: int = 0) -> torch.Tensor:
        """x (B, S, H, dh) at positions ``start`` on, turned by each
        position's angles."""
        S, dh = x.shape[1], x.shape[-1]
        half = dh // 2
        inv = 1.0 / (self.c["rope_theta"] ** (
            torch.arange(half, dtype=torch.float64, device=x.device) / half))
        ang = (torch.arange(start, start + S, dtype=torch.float64,
                            device=x.device)[:, None]
               * inv[None, :]).float()
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _attention(self, h: torch.Tensor, l: int) -> torch.Tensor:
        c, seg = self.c, self.seg
        B, S, d = h.shape
        Hq, Hkv, dh = (c["num_attention_heads"], c["num_key_value_heads"],
                       c["head_dim"])
        q = self._mm(h, self._leaf(seg, "attn", "w_q", layer=l)
                     .reshape(d, Hq * dh)).view(B, S, Hq, dh)
        k = self._mm(h, self._leaf(seg, "attn", "w_k", layer=l)
                     .reshape(d, Hkv * dh)).view(B, S, Hkv, dh)
        v = self._mm(h, self._leaf(seg, "attn", "w_v", layer=l)
                     .reshape(d, Hkv * dh)).view(B, S, Hkv, dh)
        q, k = self._rope(q), self._rope(k)
        group = Hq // Hkv
        pos = torch.arange(S, device=h.device)
        mask = pos[None, :] <= pos[:, None]
        window = c.get("sliding_window") or 0
        if window:
            mask &= pos[None, :] > pos[:, None] - window
        ctx = torch.empty_like(q)
        for b in range(B):            # one sequence's scores at a time
            kb = k[b].repeat_interleave(group, dim=1)        # (S, Hq, dh)
            vb = v[b].repeat_interleave(group, dim=1)
            s = torch.einsum("qhd,khd->hqk", q[b], kb) / dh ** 0.5
            s = s.masked_fill(~mask, float("-inf"))
            ctx[b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), vb)
        w_o = self._leaf(seg, "attn", "w_o", layer=l).reshape(Hq * dh, d)
        return self._mm(ctx.reshape(B, S, Hq * dh), w_o)

    def _ffn(self, h: torch.Tensor, l: int) -> torch.Tensor:
        seg = self.seg
        if not self.c.get("num_local_experts"):
            g = self._mm(h, self._leaf(seg, "mlp", "w_gate", layer=l))
            u = self._mm(h, self._leaf(seg, "mlp", "w_up", layer=l))
            return self._mm(F.silu(g) * u,
                            self._leaf(seg, "mlp", "w_down", layer=l))
        shape = h.shape
        x = h.reshape(-1, shape[-1])
        probs = torch.softmax(x @ self._leaf(seg, "moe", "router", layer=l),
                              -1)
        gates, eids = torch.topk(probs, self.c["num_experts_per_tok"], -1)
        gates = gates / gates.sum(-1, keepdim=True)
        y = torch.zeros_like(x)
        for e in range(self.c["num_local_experts"]):
            rows, slot = torch.nonzero(eids == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            g = self._mm(xe, self.w[(seg, "moe", "w_gate")][l, e].float())
            u = self._mm(xe, self.w[(seg, "moe", "w_up")][l, e].float())
            out = self._mm(F.silu(g) * u,
                           self.w[(seg, "moe", "w_down")][l, e].float())
            y.index_add_(0, rows, out * gates[rows, slot][:, None])
        return y.reshape(shape)

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
            for l in range(self.c["num_hidden_layers"]):
                x = x + self._attention(
                    self._norm(x, self._leaf(self.seg, "ln1", layer=l)), l)
                x = x + self._ffn(
                    self._norm(x, self._leaf(self.seg, "ln2", layer=l)), l)
            out = self._leaf("embed", "out")
            gain = self._leaf("final_norm")
            return [self._mm(self._norm(x[i, torch.as_tensor(p, device=dev)],
                                        gain), out)
                    for i, p in enumerate(want)]
