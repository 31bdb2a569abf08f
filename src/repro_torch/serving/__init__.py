"""Serving: the tiered paged KV cache."""
