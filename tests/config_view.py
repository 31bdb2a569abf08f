"""The port's configs beside the JAX package's: the port's dataclasses
carry every field of the JAX package's copies, and fields of their own
(the published DeepSeek-V3 router, an expert share, YaRN) whose defaults
keep the JAX package's behaviour.

``same_config(got, want)`` is ``dataclasses.asdict(got)`` held to the
fields of ``want``: each field that ``want``'s class lacks is checked to
hold its default and left out; nested configs alike.
"""

import dataclasses


def same_config(got, want) -> dict:
    names = {f.name for f in dataclasses.fields(want)}
    out = {}
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        if f.name not in names:
            assert v == f.default, (type(got).__name__, f.name, v)
            continue
        w = getattr(want, f.name)
        if dataclasses.is_dataclass(v) and dataclasses.is_dataclass(w):
            out[f.name] = same_config(v, w)
        else:
            out[f.name] = v
    return out
