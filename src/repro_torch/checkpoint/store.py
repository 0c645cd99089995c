"""Step-atomic checkpointing with elastic restore.

Port of ``repro/checkpoint/store.py``, with its layout:

    <dir>/step_<N>/
        manifest.json        — step, flat array paths, shapes/dtypes, extra
        arrays.npz           — one entry per flat path (this host's arrays)
        _COMMITTED           — written last; restore ignores dirs without it

* **Atomicity**: the commit marker makes a half-written checkpoint (a
  process that died mid-save) invisible to restore: a restart picks the
  newest committed step.
* **Elastic restore**: arrays are loaded on the host and placed on the
  ``device`` asked for, or else on the device of the template's leaf, so a
  rank of a mesh restores a checkpoint onto its own device whatever wrote
  it.
* **Async**: ``save(..., blocking=False)`` hands the host copies to a
  writer thread; the caller goes on while the previous step is written.

A state is nested dicts, lists and tuples whose leaves are torch tensors
(on any device) or numpy arrays.  Flat paths are the reference's: dict
keys in sorted order, sequence indices ``0``, ``1``, …, joined by ``/``,
so either package reads a checkpoint the other wrote.  numpy has no
bfloat16: a bf16 tensor is stored as its 16-bit patterns, with
``"bfloat16"`` as its dtype in the manifest, and restored bit for bit as a
bf16 tensor.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_BF16 = "bfloat16"


def _leaf_paths(tree: Any, prefix: str = ""):
    """(path, leaf) of every leaf, in the reference's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _host_copy(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` that nothing else holds, and its manifest
    dtype (bf16 as its bit patterns)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _place(arr: np.ndarray, dtype: str, like: Any, device) -> Any:
    """``arr`` as the leaf ``like`` was: a tensor on ``device`` or on
    ``like``'s device, a numpy array for a numpy template leaf (a bf16
    array always comes back as a tensor, on the CPU by default)."""
    if device is None and isinstance(like, torch.Tensor):
        device = like.device
    if dtype == _BF16:
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16)) \
            .view(torch.bfloat16)
        return t.to(device or "cpu")
    if device is None:
        return arr
    return torch.from_numpy(np.asarray(arr, order="C")).to(device)


def _unflatten_like(template: Any, flat: Dict[str, np.ndarray],
                    dtypes: Dict[str, str], device=None, prefix: str = ""
                    ) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], flat, dtypes, device,
                                   f"{prefix}{k}/")
                for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_like(v, flat, dtypes, device, f"{prefix}{i}/")
            for i, v in enumerate(template))
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing array {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{key}: shape {arr.shape} != expected "
                         f"{template.shape}")
    return _place(arr, dtypes.get(key, str(arr.dtype)), template, device)


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(
        self,
        step: int,
        state: Dict[str, Any],
        *,
        extra: Optional[Dict[str, Any]] = None,
        blocking: bool = True,
    ) -> str:
        self.wait()
        copies = {k: _host_copy(v) for k, v in _leaf_paths(state)}
        host_arrays = {k: a for k, (a, _) in copies.items()}
        manifest = {
            "step": int(step),
            "extra": extra or {},
            "arrays": {
                k: {"shape": list(a.shape), "dtype": dtype}
                for k, (a, dtype) in copies.items()
            },
        }
        path = os.path.join(self.dir, f"step_{step:08d}")

        def write():
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host_arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return path

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def committed_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "_COMMITTED")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        template: Any,
        *,
        step: Optional[int] = None,
        device=None,
    ) -> Tuple[int, Any, Dict[str, Any]]:
        """Load a checkpoint into ``template``'s structure.

        Each array goes to ``device`` when it is given (the restoring
        rank's own device, whatever device saved it), else to the device
        of the template's leaf; a numpy template leaf gets a numpy array.
        """
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        dtypes = {k: v["dtype"] for k, v in manifest["arrays"].items()}
        state = _unflatten_like(template, flat, dtypes, device)
        return manifest["step"], state, manifest.get("extra", {})
