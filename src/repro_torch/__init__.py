"""PyTorch and CUDA port of ``repro`` for NVIDIA Hopper (H100).

Module paths mirror ``src/repro/``: each file here has its JAX reference at
the same relative path. The port imports ``torch`` and ``numpy`` only, never
``jax`` and nothing of ``repro``; what it needs from the reference's JAX-free
modules it keeps as its own copy.

Entry points (``ServeEngine``, ``Model.create``, ``train``, ``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``) run on
``cuda`` unless the caller passes ``device="cpu"``. On a CUDA tensor every kernel wrapper launches its
hand-written kernel or raises; on a CPU tensor it runs its plain PyTorch
version.
"""
