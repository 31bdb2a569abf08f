"""Model layers, assembly and the prefill/decode path."""
