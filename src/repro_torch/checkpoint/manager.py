"""Checkpoint manager: retention, async saves, resume-or-init.

The port of the reference's ``repro/checkpoint/manager.py``.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Callable, Optional

from repro_torch.checkpoint import ckpt


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 save_async: bool = True):
        self.dir = Path(directory)
        self.keep = keep
        self.save_async = save_async
        self._pending = []

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        if self.save_async:
            self._pending.append(ckpt.save_async(self.dir, step, tree,
                                                 extra=extra))
        else:
            ckpt.save(self.dir, step, tree, extra=extra)
        self._gc()

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def _gc(self):
        steps = sorted(
            int(d.name.split("_")[1]) for d in self.dir.iterdir()
            if d.name.startswith("step_") and (d / "manifest.json").exists()
        ) if self.dir.exists() else []
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def restore_or_init(self, init_fn: Callable[[], Any]
                        ) -> tuple[Any, int]:
        """Returns (state, start_step). Falls back to init_fn() at step 0;
        otherwise the latest checkpoint is written into init_fn()'s
        tensors."""
        step = ckpt.latest_step(self.dir)
        if step is None:
            return init_fn(), 0
        like = init_fn()
        state = ckpt.restore(self.dir, step, like)
        return state, step + 1
