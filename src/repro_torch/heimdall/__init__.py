"""HEIMDALL benchmark families: the timing harness, the micro, apps,
interference, kv_quant, qos, calibration, obs, resilience and disagg
families, and their runner (``python -m repro_torch.heimdall.run``, the
reference's ``benchmarks/run.py``).
"""
