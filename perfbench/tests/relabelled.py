"""A model family for the tests: the decoder family's model, with every
key of the model stated under a name of its own in a group ``model``.

A cell whose configuration names this family runs only if the harness
takes all it knows of the model from the family: outside it, a read of a
decoder key (``num_hidden_layers``, ``head_dim``, ...) finds nothing.
"""

from perfbench import run

DECODER = run.family("decoder")
# the decoder's key of each of this family's names
KEYS = {"width": "hidden_size", "q_heads": "num_attention_heads",
        "kv_heads": "num_key_value_heads", "head": "head_dim",
        "ffn": "intermediate_size", "depth": "num_hidden_layers",
        "experts": "num_local_experts", "top_k": "num_experts_per_tok",
        "window": "sliding_window", "theta": "rope_theta",
        "eps": "rms_norm_eps", "tied": "tie_word_embeddings",
        "bias": "attention_bias", "dtype": "torch_dtype"}


def relabel(c: dict) -> dict:
    """A decoder configuration file in this family's terms."""
    own = {v: k for k, v in KEYS.items()}
    out = {k: v for k, v in c.items() if k not in own}
    out["model"] = {own[k]: v for k, v in c.items() if k in own}
    out["family"] = "relabelled"
    return out


def as_decoder(c: dict) -> dict:
    """The decoder family's configuration file for ``c``."""
    out = {k: v for k, v in c.items() if k != "model"}
    out.update({KEYS[k]: v for k, v in c["model"].items()})
    out["family"] = "decoder"
    return out


def port_config(c: dict):
    return DECODER.port_config(as_decoder(c))


def leaf_shapes(c: dict) -> dict:
    return DECODER.leaf_shapes(as_decoder(c))


leaf_init = DECODER.leaf_init


def reference(c: dict, w: dict, quant=None):
    return DECODER.reference(as_decoder(c), w, quant)


def control_engine(c: dict, device, quant):
    return DECODER.control_engine(as_decoder(c), device, quant)


def yardstick(c: dict):
    return DECODER.yardstick(as_decoder(c))
