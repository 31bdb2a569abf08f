"""MetricsRegistry: labeled counters and gauges with a JSON snapshot.

The port's copy of the reference's ``repro/obs/metrics.py``, unchanged,
so ``repro_torch`` imports nothing from ``repro``.

The aggregate half of the observability substrate (``repro.obs.trace`` is
the event half): counters accumulate (bytes moved per tier, pages hit/miss,
decode steps fired), gauges hold last-written values (straggler p95, decode
makespan). Labels are folded into the metric key deterministically, so
``to_json()`` is stable across runs with the same activity — the property
the BENCH_obs golden checks rely on.

Zero-dependency by design; the hot path pays one dict update per touch.
``NULL_METRICS`` is the no-op twin the ``NullTracer`` hands out so
instrumented code never branches on "is observability on".
"""

from __future__ import annotations

import re

# Characters that play a structural role in the flat key grammar
# ``name[k=v|k2=v2]``: a label key/value containing one raw would make two
# different label sets collide on one key (``a="x|b=y"`` vs ``a=x, b=y``),
# so they are backslash-escaped on write and unescaped by ``parse_key``.
_ESCAPE_RE = re.compile(r"[\\=|\[\]]")
_UNESCAPE_RE = re.compile(r"\\(.)")


def _escape(s: str) -> str:
    """Backslash-escape the key grammar's delimiters in one label part."""
    if _ESCAPE_RE.search(s) is None:       # fast path: almost every label
        return s
    return _ESCAPE_RE.sub(lambda m: "\\" + m.group(), s)


def _key(name: str, labels: dict) -> str:
    """Deterministic flat key: ``name`` or ``name[k=v|k2=v2]`` (sorted).

    Label keys/values are delimiter-escaped so distinct label sets can
    never collide on one key (the ``parse_key`` round-trip property)."""
    if not labels:
        return name
    inner = "|".join(f"{_escape(k)}={_escape(str(labels[k]))}"
                     for k in sorted(labels))
    return f"{name}[{inner}]"


def parse_key(key: str) -> tuple:
    """Inverse of ``_key``: ``(name, labels_dict)``.

    The consumer-side half of the escaping contract — the OpenMetrics
    exporter (``repro.obs.timeseries``) parses registry keys back into
    labeled samples, so the round trip must be exact for any label value.
    """
    if not key.endswith("]"):
        return key, {}
    i = key.find("[")
    if i < 0:
        return key, {}
    name, inner = key[:i], key[i + 1:-1]
    labels = {}
    # split on unescaped "|" then unescaped "=" (escapes survive re.split
    # because the delimiters are matched only when not backslash-prefixed)
    for part in re.split(r"(?<!\\)\|", inner):
        k, _, v = part.partition("=")
        while k.endswith("\\"):              # the "=" we split on was escaped
            k2, _, v2 = v.partition("=")
            k = f"{k}={k2}"
            v = v2
        labels[_UNESCAPE_RE.sub(r"\1", k)] = _UNESCAPE_RE.sub(r"\1", v)
    return name, labels


class MetricsRegistry:
    """Labeled counters (monotonic adds) and gauges (last write wins)."""

    def __init__(self):
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}

    # -- writes --------------------------------------------------------------
    def add(self, name: str, value: float = 1.0, **labels) -> None:
        k = _key(name, labels)
        self._counters[k] = self._counters.get(k, 0.0) + value

    def set(self, name: str, value, **labels) -> None:
        self._gauges[_key(name, labels)] = value

    # -- reads ---------------------------------------------------------------
    def counter(self, name: str, **labels) -> float:
        return self._counters.get(_key(name, labels), 0.0)

    def gauge(self, name: str, default=None, **labels):
        return self._gauges.get(_key(name, labels), default)

    def to_json(self) -> dict:
        """Snapshot payload: sorted keys, counters and gauges separated."""
        return {
            "counters": {k: self._counters[k]
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k] for k in sorted(self._gauges)},
        }


class NullMetrics:
    """No-op twin of ``MetricsRegistry`` (the ``NullTracer``'s registry)."""

    def add(self, name, value=1.0, **labels):
        pass

    def set(self, name, value, **labels):
        pass

    def counter(self, name, **labels) -> float:
        return 0.0

    def gauge(self, name, default=None, **labels):
        return default

    def to_json(self) -> dict:
        return {"counters": {}, "gauges": {}}


NULL_METRICS = NullMetrics()
