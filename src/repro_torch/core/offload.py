"""Offload engine: model state across device and pinned host memory.

The port's copy of the reference's ``repro/core/offload.py``. Where the
reference names a JAX memory kind, the port places tensors itself:

  * ``"device"``: on the model's device;
  * ``"pinned_host"``: CPU memory, page-locked when the device is CUDA (so
    copies to and from the card are DMA transfers that can run
    asynchronously), plain CPU memory when the device is the CPU.

Page-locked state is allocated at its exact size and registered with the
CUDA runtime (``cudaHostRegister``), not drawn from PyTorch's pinned
allocator, which rounds every block up to a power of two: a 180 MB layer
slice would take 268 MB, and a 8.7 GB stacked leaf 17.2 GB. If pinning
fails, ``pinned_zeros`` raises.

Two modes, as in the reference:

  * sync (paper-faithful §6.1.5): ``fetch_to_device`` copies a whole tree
    to the card on every use, on the compute stream, so each use pays the
    link transfer on the critical path (the paper measured >99% of step
    time in these copies for vLLM CPU offload). Weight-offloaded serving
    (``ServeEngine(offload_weights=True)``) uses it.
  * stream: ``StreamingParamServer`` fetches stacked layer slices one layer
    ahead on a copy stream of its own, so the copy of layer ``i + 1``
    overlaps the compute of layer ``i``.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.params import tree_flatten, tree_map

KINDS = ("device", "pinned_host")


def _unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


def pinned_zeros(shape, dtype: torch.dtype) -> torch.Tensor:
    """A zero-filled CPU tensor of exactly ``shape`` in page-locked memory.

    The bytes come from numpy (whose zeroed pages the kernel hands out
    lazily) and are registered with the CUDA runtime, which faults them in
    and pins them; they are unregistered when the last tensor viewing them
    is freed. Raises if registration fails.
    """
    nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = np.zeros(nbytes, np.uint8)
    if nbytes:
        err = torch.cuda.cudart().cudaHostRegister(buf.ctypes.data, nbytes, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed "
                               f"with CUDA error {int(err)}: cannot pin host "
                               f"memory for offloaded state")
        weakref.finalize(buf, _unregister, buf.ctypes.data)
    return torch.from_numpy(buf).view(dtype).view(shape)


def host_zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Zeros in the host tier of a tree that lives on ``device``: pinned
    when ``device`` is CUDA, plain CPU memory when it is the CPU."""
    if torch.device(device).type == "cuda":
        return pinned_zeros(shape, dtype)
    return torch.zeros(shape, dtype=dtype)


def _put(x: torch.Tensor, kind: str, device) -> torch.Tensor:
    if kind == "device":
        return x.to(device)
    if kind != "pinned_host":
        raise ValueError(f"unknown memory kind {kind!r}; the port places "
                         f"state in one of {KINDS}")
    if x.device.type == "cpu" and (x.is_pinned() or
                                   torch.device(device).type == "cpu"):
        return x
    out = host_zeros(x.shape, x.dtype, device)
    out.copy_(x)
    return out


def put_tree(tree, kind: str, device):
    """A tree's leaves in memory ``kind`` for a model on ``device``; a leaf
    already there is returned as it is."""
    return tree_map(lambda x: _put(x, kind, device), tree)


def fetch_to_device(tree, device):
    """Synchronous tier fetch (paper-faithful copy-on-demand)."""
    return put_tree(tree, "device", device)


class StreamingParamServer:
    """Double-buffered layer streaming for weight-offloaded serving.

    Host-resident stacked layer params are fetched one layer ahead of the
    compute: ``get(i)`` prefetches layers ``i`` and ``i + 1`` and waits for
    ``i``, so at most two layers are buffered. On a CUDA ``device`` a
    prefetch issues ``non_blocking`` copies from the (pinned) host slices
    on a copy stream of its own and records an event; ``get`` makes the
    current stream wait on that event (the host does not wait) and hands
    the layer's tensors to that stream with ``record_stream``, so the
    caching allocator does not reuse their memory before the compute that
    reads them has run. On the CPU the copies are plain and synchronous.
    ``device`` defaults to ``cuda`` and raises without one.
    """

    def __init__(self, host_params: Any, n_layers: int,
                 slice_fn: Callable[[Any, int], Any], device=None):
        from repro_torch.models.context import resolve_device
        self.host_params = host_params
        self.n_layers = n_layers
        self.slice_fn = slice_fn
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._buf: dict[int, tuple] = {}

    def prefetch(self, i: int):
        if 0 <= i < self.n_layers and i not in self._buf:
            layer = self.slice_fn(self.host_params, i)
            if self._stream is None:
                self._buf[i] = (fetch_to_device(layer, self.device), None)
                return
            with torch.cuda.stream(self._stream):
                dev = tree_map(
                    lambda x: x.to(self.device, non_blocking=True), layer)
                done = torch.cuda.Event()
                done.record(self._stream)
            self._buf[i] = (dev, done)

    def get(self, i: int):
        self.prefetch(i)
        self.prefetch(i + 1)                            # overlap next layer
        layer, done = self._buf.pop(i)
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for _, x in tree_flatten(layer):
                x.record_stream(stream)
        return layer


@dataclasses.dataclass
class OffloadStats:
    bytes_to_host: int = 0
    bytes_to_device: int = 0
    transfers: int = 0

    def record(self, tree, direction: str):
        """Count one transfer of ``tree`` (a tensor or a nested dict of
        them) in ``direction`` ('to_host' or 'to_device')."""
        nbytes = sum(x.numel() * x.element_size()
                     for _, x in tree_flatten(tree))
        if direction == "to_host":
            self.bytes_to_host += nbytes
        else:
            self.bytes_to_device += nbytes
        self.transfers += 1
