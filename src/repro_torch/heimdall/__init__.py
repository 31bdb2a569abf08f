"""HEIMDALL benchmark families: the timing harness and the kv_quant family.

The reference's other families come with the slices that port their
layers.
"""
