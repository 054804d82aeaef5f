"""Checkpointing: atomic, async, restore onto a device — the port of
``repro.checkpoint.manager``, in the same on-disk format, so a checkpoint
written by either package restores into the other.

Format: one directory ``step_XXXXXXXX`` a step, holding ``arrays.npz``
(the tree's leaves keyed by their '/'-joined JAX paths: ``0/emb``,
``1/mu/layers/attn/wq/w``, ``1/step`` for a (params, AdamWState) pair) and
``meta.json`` (step, time, extra).  A write goes to ``.tmp_step_XXXXXXXX``,
then ``os.rename``: a checkpoint is either complete or absent, and the last
``keep`` are kept.  A bf16 leaf is written as f32 (numpy has no bf16), which
restores exactly into a bf16 template in either package.

``save_async`` takes a completed host copy of every leaf before it returns
(the training step updates the parameters in place right after), then
writes on a background thread.  ``restore`` takes a device where the JAX
one takes shardings.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.tree import named_leaves, tree_map_with_path_names


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of a leaf that nothing else holds (a CPU tensor is
    copied too), bf16 widened to f32."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.to("cpu", copy=True).numpy()


def _flatten_named(tree: Any) -> dict:
    return {name: _host(leaf) for name, leaf in named_leaves(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        # one outstanding background write; the handle is the training
        # loop's, the error slot the writer's, read back only after join()
        self._thread: Optional[threading.Thread] = None  # owned-by: ckpt-caller
        self._last_error: Optional[BaseException] = None  # owned-by: ckpt-writer

    # ------------------------------------------------------------- saving --

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> Path:
        return self._write(step, _flatten_named(tree), extra or {})

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:  # thread: ckpt-caller
        """Copy to the host synchronously, write in the background."""
        self.wait()  # one outstanding write at most
        arrays = _flatten_named(tree)

        def work():  # thread: ckpt-writer
            try:
                self._write(step, arrays, extra or {})
            except BaseException as e:  # surfaced on the next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:  # thread: ckpt-caller
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # the join is the happens-before edge for the writer's error slot
        if self._last_error is not None:  # analysis: allow(lock:thread) — read after join()
            err, self._last_error = self._last_error, None  # analysis: allow(lock:thread) — read after join()
            raise err

    def _write(self, step: int, arrays: dict, extra: dict) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "meta.json").write_text(json.dumps({"step": step, "time": time.time(), **extra}))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------ restore --

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> tuple[Any, int]:
        """Restore ``step`` (the latest by default) into the structure of
        ``template``: each leaf in its template leaf's dtype, on ``device``
        (by default the template leaf's)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        with np.load(self.dir / f"step_{step:08d}" / "arrays.npz") as data:
            arrays = {k: data[k] for k in data.files}

        def load(p, t):
            a = arrays[p]
            assert a.shape == tuple(t.shape), (p, a.shape, t.shape)
            out = torch.from_numpy(np.array(a, order="C")).to(t.dtype)  # np.array keeps a 0-d leaf 0-d
            return out.to(t.device if device is None else device)

        return tree_map_with_path_names(load, template), step
