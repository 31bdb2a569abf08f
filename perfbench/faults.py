"""The program broken underneath, once for each fault a serving cell can
have: what the benchmark's comparison has to read as not correct. Each is
a factory (cfg, offload, device) -> engine, as ``run.run_cell`` and
``control.readings`` take it."""

from __future__ import annotations


def _engine_class():
    from repro_torch.launch.serve import ServeEngine
    return ServeEngine


def altered_token():
    """Every answer's third token is not the one the step produced."""
    class Engine(_engine_class()):
        def decode(self, handoff):
            out = super().decode(handoff)
            for r in out:
                if len(r.tokens) > 2:         # not the warm-up's one step
                    r.tokens[2] = (r.tokens[2] + 1) % self.cfg.vocab_size
            return out
    return Engine


def state_unchanged():
    """A decode step that computes on a copy of the KV cache and hands the
    old cache back: no generated token's K/V ever lands."""
    class Engine(_engine_class()):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            step = self.model.decode

            def clone(tree):
                if isinstance(tree, dict):
                    return {key: clone(v) for key, v in tree.items()}
                return tree.clone()

            def stale(params, cache, tok, pos):
                logits, _ = step(params, clone(cache), tok, pos)
                return logits, cache
            self.model.decode = stale
    return Engine


def half_batch():
    """Only the first half of each batch is served."""
    class Engine(_engine_class()):
        def prefill(self, requests):
            return super().prefill(requests[:len(requests) // 2])
    return Engine


FAULTS = {"altered_token": altered_token, "state_unchanged": state_unchanged,
          "half_batch": half_batch}


def factory(name: str):
    cls = FAULTS[name]()
    return lambda cfg, offload, device: cls(
        cfg, offload_weights=offload, rng_seed=0, device=device)
