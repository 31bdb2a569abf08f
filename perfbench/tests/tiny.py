"""Tiny stand-ins for the benchmark's cells, for runs on the CPU: the
same files and code paths at a few widths, with the program's registered
configuration shrunk to match."""

import copy

from perfbench import run

TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "intermediate_size": 128, "vocab_size": 256,
        "num_hidden_layers": 2}
PORT = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
        "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
        "intermediate_size": "d_ff", "vocab_size": "vocab_size",
        "num_hidden_layers": "num_layers"}
MIX = {"clients": 4, "prompt": {"fixed": 24}, "answer": {"fixed": 6},
       "pool": 8}
DECODER = run.family("decoder")


def tiny_config(c: dict, **sizes) -> dict:
    """The configuration file ``c`` at tiny sizes (``sizes`` overrides
    TINY), with the overrides that shrink the program's config to it."""
    c = copy.deepcopy(c)
    sizes = {**TINY, **sizes}
    c.update(sizes)
    c["overrides"] = {**c.get("overrides", {}),
                      **{PORT[k]: v for k, v in sizes.items()}}
    return c


def tiny_cell(name: str = "yi9b-flexgen-hbm", mix: dict = MIX,
              **sizes) -> run.Cell:
    cell = run.load_cell(name)
    cell.config = tiny_config(cell.config, **sizes)
    cell.mix = dict(mix)
    return cell
