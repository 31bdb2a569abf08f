"""Checkpointing: per-leaf .npy shards + manifest, async save.

The port of the reference's ``repro/checkpoint/ckpt.py``, in its on-disk
layout: ``step_<8 digits>/`` holding ``shard_<5 digits>.npy`` per leaf (in
the reference's flatten order) and ``manifest.json`` with each leaf's file,
shape, dtype name and the first 16 hex digits of its bytes' sha256.
Atomicity via write-to-tmp + rename. bfloat16 leaves are stored as their
raw 16 bits (``uint16``) under the dtype name ``"bfloat16"``, as the
reference stores them, without ``ml_dtypes``.

Restore writes each leaf's values into the matching tensor of ``like`` (in
place, keeping its device, dtype and pinned host memory) and returns
``like``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    elif hasattr(tree, "_fields"):            # NamedTuple
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), prefix + (name,))
    else:
        yield prefix, tree


def _path_key(path: tuple) -> str:
    return "/".join(path)


def _snapshot(tree) -> list:
    """[(key, host array, dtype name)] of every leaf, in flatten order: a
    copy, so a later in-place update of the tree does not reach it;
    bfloat16 as its raw uint16 bits."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()    # pending non-blocking copies to host
    out = []
    for path, leaf in _flatten(tree):
        t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            out.append((_path_key(path),
                        t.view(torch.int16).numpy().view(np.uint16),
                        "bfloat16"))
        else:
            arr = t.numpy()
            out.append((_path_key(path), arr, str(arr.dtype)))
    return out


def _write(ckpt_dir: str | Path, step: int, records: list,
           extra: Optional[dict]) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "time": time.time(), "leaves": {},
                "extra": extra or {}}
    for i, (key, arr, dtype_name) in enumerate(records):
        fname = f"shard_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype_name,
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extra: Optional[dict] = None) -> Path:
    """Synchronous save. Returns the final checkpoint path."""
    return _write(ckpt_dir, step, _snapshot(tree), extra)


def save_async(ckpt_dir, step, tree, extra=None) -> threading.Thread:
    """Fire-and-join-later save: the values are copied to host memory on
    the calling thread (the training step updates its state in place),
    the files are written on the worker."""
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, _snapshot(tree), extra),
                         daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / "manifest.json").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, step: int, like: Any,
            verify: bool = True) -> Any:
    """Write checkpoint ``step`` into the tensors of ``like`` (a tree of
    tensors of the saved structure) and return ``like``."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    for path, leaf in _flatten(like):
        key = _path_key(path)
        meta = manifest["leaves"][key]
        arr = np.load(d / meta["file"])
        if verify:
            got = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
            if got != meta["sha256"]:
                raise IOError(f"checksum mismatch for {key}")
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        leaf.copy_(t)
    return like


def manifest_extra(ckpt_dir, step) -> dict:
    d = Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((d / "manifest.json").read_text()).get("extra", {})
