"""HEIMDALL benchmark families: the timing harness and the kv_quant,
interference, qos, disagg and resilience families.

The reference's other families come with the slices that port their
layers.
"""
