"""Checkpointing: atomic, async, with the reference's on-disk layout.

The port of ``repro.checkpoint.checkpointer``. Leaves are copied to host
numpy and written as one ``.npz`` keyed by the tree path, plus a
``manifest.json`` (step, shapes, dtypes, wall time): ``<dir>/step-N/
leaves.npz`` and ``manifest.json``. Writes go to ``<dir>/tmp-<step>`` and
are renamed atomically, so a killed job never sees a torn checkpoint;
``keep`` old steps are retained for rollback. A tree is nested dicts,
lists and tuples of tensors or arrays; a leaf's key is its path, dict
keys and sequence indices joined by ``/`` (``a/b/0``), with dict keys in
sorted order as the reference's tree flattening takes them, so either
package reads the other's files.

``restore`` takes a *template* tree of the same structure and fills every
leaf from the file: a tensor leaf comes back as a tensor of its dtype on
its device, any other leaf as a numpy array. A bfloat16 leaf is written
as its 2-byte words (numpy's ``|V2``, as numpy writes the reference's
``ml_dtypes`` bfloat16 leaves) and read back into a bfloat16 template
leaf bit for bit. ``shardings``, a tree of
the same structure, places each leaf instead, the counterpart of
``jax.device_put(a, sharding)``: a device (a name or ``torch.device``)
puts the leaf there whole; a mark (``api.backends.MACHINE`` or
``REPLICATED``) places it through a backend's ``put``: a ``MeshBackend``
when a process group is initialized, so each rank takes its own
machine's row of a ``MACHINE`` leaf, else the virtual backend, which
keeps the leaf whole; a function places the leaf as it returns it
(``launch/train.py`` takes each rank's shard so).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _items(node):
    """(key, child) pairs of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of a nested dict/list/tuple tree."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, child in items:
        out.update(flatten(child, f"{prefix}/{key}" if prefix else key))
    return out


def _map(tree: Any, fn: Callable[[str, Any], Any], prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(v, fn, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(prefix, tree)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device; 2-byte
    words (a bfloat16 leaf's) into a bfloat16 leaf bit for bit."""
    if like.dtype == torch.bfloat16 and arr.dtype.kind == "V":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(like.device)
    return torch.as_tensor(arr, device=like.device).to(like.dtype)


def _place_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` placed as the same path of ``shardings``
    says: a device, or a placement mark through the backend's ``put``."""
    import torch.distributed as dist
    from repro_torch.api import backends
    backend = (backends.MeshBackend() if dist.is_available()
               and dist.is_initialized() else backends.VirtualBackend())
    marks = (backends.MACHINE, backends.REPLICATED)

    def place(path: str, leaf):
        spec = shardings
        for key in path.split("/") if path else ():
            spec = spec[key] if isinstance(spec, dict) else spec[int(key)]
        if callable(spec):
            return spec(leaf)
        if isinstance(spec, str) and spec in marks:
            return backend.put(leaf, spec)
        if isinstance(leaf, torch.Tensor):
            return leaf.to(torch.device(spec))
        return torch.as_tensor(np.asarray(leaf), device=torch.device(spec))

    return _map(tree, place)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 use_async: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.use_async = use_async
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False):
        """Copy every leaf to the host now, then write (on a thread unless
        ``blocking`` or the checkpointer is synchronous)."""
        host = {k: _host(v) for k, v in flatten(tree).items()}
        self.wait()
        if self.use_async and not blocking:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host: Dict[str, np.ndarray]):
        tmp = self.dir / f"tmp-{step}"
        final = self.dir / f"step-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "leaves.npz", **host)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in host.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step-{s}", ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------------------------------------------------- restore
    def all_steps(self):
        return [int(p.name.split("-")[1]) for p in self.dir.glob("step-*")
                if (p / "manifest.json").exists()]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        data = np.load(self.dir / f"step-{step}" / "leaves.npz")

        def fill(key, leaf):
            arr = data[key]
            want = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {key}: {arr.shape} != {want}")
            if isinstance(leaf, torch.Tensor):
                return _tensor(arr, leaf)
            return arr

        out = _map(template, fill)
        if shardings is None:
            return out
        return _place_tree(out, shardings)
