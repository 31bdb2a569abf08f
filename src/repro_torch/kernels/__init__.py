"""Hand-written Hopper kernels: dispatch policy, build helper, launch counts.

Dispatch (the port's counterpart of ``repro.kernels.default_interpret``):
a wrapper given CPU tensors runs its kernel's plain PyTorch version; given
CUDA tensors it launches the hand-written kernel or raises. There is no
fallback from a CUDA tensor to the plain version.

Build: each kernel family's CUDA sources (``<family>/csrc/*.cu``, with
plain C entry points) are compiled on first use by ``nvcc`` for ``sm_90a``
into one shared library per family under ``build/repro_torch_kernels/`` at
the repository root, and loaded with ``ctypes``. Nothing is built when a
module is imported; ``build_all`` builds every stale family at once, one
``nvcc`` per family, all started together.

Launch counts: ``LAUNCHES[name]`` is a plain integer that a wrapper raises
by one each time it launches its kernel, and nowhere else, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel family -> the kernels its library holds
FAMILIES = {"flash_attention": ("flash_attention",),
            "paged_attention": ("paged_attention", "paged_attention_quant"),
            "quant": ("quantize_pages", "dequantize_pages", "quantize",
                      "dequantize"),
            "probes": ("pointer_chase", "tier_sum", "tier_scatter_add",
                       "tier_copy")}
LAUNCHES: dict[str, int] = {k: 0 for ks in FAMILIES.values() for k in ks}

# name -> {"seconds": build wall time, "log": nvcc's output (ptxas usage)}
BUILD_INFO: dict[str, dict] = {}
_LOADED: dict[str, ctypes.CDLL] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every tensor lies on the CPU (run the plain version)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs must all be on the CPU or all on CUDA; "
                     f"got devices {sorted(str(t.device) for t in tensors)}")


def launch(fn, *args, device: torch.device) -> None:
    """Call the C entry point ``fn(*args, stream)`` with ``device``'s
    current stream; raise if it returns a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed with CUDA "
                           f"error {err}")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA toolkit is needed to build the kernels")
    return nvcc


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_library(name: str, sources: list[Path]) -> Path:
    """Compile ``sources`` into ``lib<name>.so`` for sm_90a; return its path.

    The library is written to a temporary file and renamed into place, so a
    concurrent loader never sees a half-written file. Raises with nvcc's
    output if the compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(name)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr}
    return out


def _stale(name: str, sources: list[Path]) -> bool:
    """True when ``lib<name>.so`` is missing or older than a source."""
    path = library_path(name)
    return (not path.exists() or
            path.stat().st_mtime < max(s.stat().st_mtime for s in sources))


def load_library(name: str, sources: list[Path]) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if it is missing or older
    than any of its sources. Loaded once per process."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    if _stale(name, sources):
        build_library(name, sources)
    lib = ctypes.CDLL(str(library_path(name)))
    _LOADED[name] = lib
    return lib


def build_all(force: bool = False) -> None:
    """Build every family's library that is missing or older than its
    sources (every one with ``force``), the ``nvcc`` runs all started
    together; ``BUILD_INFO`` then holds each build's time and ptxas log.
    Raises if any build fails."""
    import importlib
    from concurrent.futures import ThreadPoolExecutor
    mods = [importlib.import_module(f"repro_torch.kernels.{f}.ops")
            for f in FAMILIES]
    mods = [m for m in mods if force or _stale(m.LIBRARY, m.SOURCES)]
    if not mods:
        return
    with ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: build_library(m.LIBRARY, m.SOURCES), mods))
