"""The reference's examples on the port: ``python -m
repro_torch.examples.<name>`` for quickstart, serve_batched,
offload_tuning and train_tiny_lm. Each runs on ``cuda`` unless given
``--device cpu`` (offload_tuning is pure cost model and takes no device).
"""
