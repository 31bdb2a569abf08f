"""Serving: the tiered paged KV cache and disaggregated prefill/decode."""
