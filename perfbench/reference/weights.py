"""The weights of a run, drawn from ``--seed``.

The benchmark draws every leaf itself, on the device, in bf16, from a
generator seeded by (seed, leaf path), in one call per leaf, and hands the
same values to the program (written into its parameter tree) and to the
reference (drawn again after the program is gone). ``draw``, ``leaf_seed``
and ``draw_all`` serve every model family; the tree (``leaf_shapes``) and
each leaf's mean and scale (``leaf_init``) are the family's.

Those of the ``decoder`` family are here: the layout a llama-style or
Mixtral-style decoder's weights take in the program's tree (layers stacked
on a leading axis, projections as (in, heads, head dim), experts on an
axis of their own). Norm gains are drawn around 1 (so that a norm applied
wrongly shows); the token table has unit scale; every other matrix is
scaled by one over the square root of the dimension it contracts.
"""

from __future__ import annotations

import hashlib
import math

import torch

NORMS = ("ln1", "ln2", "final_norm")


def segment(c: dict) -> str:
    """The name of the stacked layers' group in the tree."""
    return "moe" if c.get("num_local_experts") else "decoder"


def leaf_shapes(c: dict) -> dict:
    """{path: shape} of every weight of the configuration ``c``."""
    L, d = c["num_hidden_layers"], c["hidden_size"]
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    dh, ff, V = c["head_dim"], c["intermediate_size"], c["vocab_size"]
    seg = segment(c)
    shapes = {("embed", "tok"): (V, d), ("embed", "out"): (d, V),
              ("final_norm",): (d,),
              (seg, "ln1"): (L, d), (seg, "ln2"): (L, d),
              (seg, "attn", "w_q"): (L, d, Hq, dh),
              (seg, "attn", "w_k"): (L, d, Hkv, dh),
              (seg, "attn", "w_v"): (L, d, Hkv, dh),
              (seg, "attn", "w_o"): (L, Hq, dh, d)}
    E = c.get("num_local_experts", 0)
    if E:
        shapes.update({(seg, "moe", "router"): (L, d, E),
                       (seg, "moe", "w_gate"): (L, E, d, ff),
                       (seg, "moe", "w_up"): (L, E, d, ff),
                       (seg, "moe", "w_down"): (L, E, ff, d)})
    else:
        shapes.update({(seg, "mlp", "w_gate"): (L, d, ff),
                       (seg, "mlp", "w_up"): (L, d, ff),
                       (seg, "mlp", "w_down"): (L, ff, d)})
    return shapes


def _contracted(path: tuple, shape: tuple) -> int:
    """The length of the dimension a leaf's matmul sums over."""
    if path[-1] == "w_o":
        return shape[-3] * shape[-2]
    if path[-1] in ("w_q", "w_k", "w_v"):
        return shape[-3]
    return shape[-2]


def leaf_init(path: tuple, shape: tuple) -> tuple[float, float]:
    """(mean, standard deviation) of a leaf's normal draw."""
    if path[-1] in NORMS:
        return 1.0, 0.1
    if path == ("embed", "tok"):
        return 0.0, 1.0
    return 0.0, 1.0 / math.sqrt(_contracted(path, shape))


def leaf_seed(seed: int, path: tuple) -> int:
    """A generator seed for one leaf, from the run's seed and its path."""
    key = f"{seed}:{'/'.join(path)}".encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                          "little") & (2 ** 63 - 1)


def draw(seed: int, path: tuple, shape: tuple, device,
         out: torch.Tensor | None = None, *, init) -> torch.Tensor:
    """The leaf at ``path``, drawn on ``device`` in bf16 (into ``out`` when
    given: a contiguous bf16 tensor of ``shape`` on ``device``) from the
    normal that ``init(path, shape)`` (a family's ``leaf_init``) gives."""
    device = torch.device(device)
    if out is None:
        out = torch.empty(shape, dtype=torch.bfloat16, device=device)
    elif (tuple(out.shape) != tuple(shape) or out.dtype != torch.bfloat16
          or out.device != device or not out.is_contiguous()):
        raise ValueError(f"cannot draw {'/'.join(path)} {shape} into a "
                         f"{out.dtype} {tuple(out.shape)} tensor on "
                         f"{out.device}")
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    mean, std = init(path, shape)
    return out.normal_(mean, std, generator=gen)


def draw_all(family, c: dict, seed: int, device) -> dict:
    """{path: bf16 tensor} of every leaf of ``family``'s tree for the
    configuration ``c``."""
    return {path: draw(seed, path, shape, device, init=family.leaf_init)
            for path, shape in family.leaf_shapes(c).items()}
