"""Checkpoints in the JAX package's format (port of
``repro/train/checkpoint.py``): one ``.npy`` file per tree leaf, a JSON
manifest with each leaf's path, shape, dtype and sha256, published
atomically.

Layout:
    <dir>/step_000120/
        manifest.json        # step, leaf paths, shapes, dtypes, sha256
        leaf_00000.npy ...   # one file per tree leaf
    <dir>/LATEST             # atomic pointer (rename) to the newest step

Each leaf's path is JAX's path string for the same tree (``train/tree``:
``[0]/['table']``, ``[1]/.mu/['table']``, ``[1]/.step``), so a checkpoint
written by either package restores in the other.  Leaves are tensors
(copied to the host), numpy arrays and host ints (the optimizers' step,
saved as an int32 scalar as JAX's step array is, and restored as an int).
bf16 and fp8 leaves are stored as their raw bits (uintN) with the logical
dtype in the manifest, as JAX stores them.

Guarantees, as JAX's: atomic publish (a checkpoint is visible only after
its directory and the ``LATEST`` pointer are renamed into place);
integrity (sha256 per leaf, verified on restore); ``restore`` puts the
leaves on ``device`` (default CUDA); ``AsyncCheckpointer`` copies the tree
to the host on the caller's thread and writes it on a worker thread, so
the train loop does not wait for the disk.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train import tree as tree_lib

Tree = Any

#: dtypes numpy saves as they are; any other is stored as its raw bits
_NATIVE = tuple(np.dtype(d) for d in (
    "float32", "float64", "int32", "int64", "uint32", "int8", "uint8", "int16",
    "uint16", "uint64", "float16", "bool"))
#: the logical dtypes stored as raw bits, by their manifest name
_BITS = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
         "float8_e5m2": torch.float8_e5m2}


def _host(leaf) -> tuple[np.ndarray, str]:
    """(the array numpy saves, the manifest's dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).removeprefix("torch.")
        if name in _BITS:
            bits = {1: torch.uint8, 2: torch.int16}[t.element_size()]
            arr = t.view(bits).cpu().numpy()
            return arr.view(np.dtype(f"u{arr.dtype.itemsize}")), name
        return t.cpu().numpy(), name
    if isinstance(leaf, (bool, int)) and not isinstance(leaf, np.generic):
        return np.asarray(leaf, np.int32), "int32"
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def host_leaves(tree: Tree) -> list:
    """(path, (array, dtype name)) of every leaf as ``save`` writes it: the
    device-to-host copy, on the calling thread."""
    return [(path, _host(leaf)) for path, leaf in tree_lib.paths(tree)]


def save(ckpt_dir: str, step: int, tree: Tree, *, extra: Optional[dict] = None) -> str:
    """Blocking save.  Returns the published step directory."""
    return _write(ckpt_dir, step, host_leaves(tree), extra)


def _write(ckpt_dir: str, step: int, flat, extra: Optional[dict]) -> str:
    """Write (path, (array, dtype name)) leaves and publish them."""
    step_name = f"step_{step:08d}"
    tmp = tempfile.mkdtemp(prefix=f".{step_name}.tmp", dir=_ensure(ckpt_dir))
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (path, (arr, dtype)) in enumerate(flat):
        fname = f"leaf_{i:05d}.npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr if arr.dtype in _NATIVE else arr.view(
            np.dtype(f"u{arr.dtype.itemsize}")))
        with open(fpath, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["leaves"].append({"path": path, "file": fname, "shape": list(arr.shape),
                                   "dtype": dtype, "sha256": digest})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    final = os.path.join(ckpt_dir, step_name)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _write_latest(ckpt_dir, step_name)
    return final


def _ensure(d: str) -> str:
    os.makedirs(d, exist_ok=True)
    return d


def _write_latest(ckpt_dir: str, step_name: str) -> None:
    tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(step_name)
    os.rename(tmp, os.path.join(ckpt_dir, "LATEST"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def _shape(leaf) -> Optional[tuple]:
    if isinstance(leaf, (bool, int)) and not isinstance(leaf, np.generic):
        return ()
    return tuple(leaf.shape) if hasattr(leaf, "shape") else None


def restore(
    ckpt_dir: str,
    target_tree: Tree,
    *,
    step: Optional[int] = None,
    device: DeviceLike = None,
    verify: bool = True,
) -> tuple[Tree, int]:
    """Restore into the structure of ``target_tree`` (shapes must match):
    tensor leaves as tensors on ``device`` (default CUDA) in the stored
    dtype, int leaves as host ints.  Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    _, spec = tree_lib.flatten(target_tree)
    out = []
    for key, leaf in tree_lib.paths(target_tree):
        entry = by_path[key]
        fpath = os.path.join(d, entry["file"])
        if verify:
            with open(fpath, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != entry["sha256"]:
                raise IOError(f"checksum mismatch for {key} in step {step}")
        arr = np.load(fpath)
        expect = _shape(leaf)
        if expect is not None and tuple(arr.shape) != expect:
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs {expect}")
        if isinstance(leaf, (bool, int)) and not isinstance(leaf, np.generic):
            out.append(int(arr))
            continue
        if str(arr.dtype) != entry["dtype"]:  # raw bits of a bf16 / fp8 leaf
            bits = arr.view({1: np.uint8, 2: np.int16}[arr.dtype.itemsize])
            t = torch.from_numpy(np.ascontiguousarray(bits)).view(_BITS[entry["dtype"]])
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        out.append(t.to(dev))
    return tree_lib.unflatten(spec, out), step


def garbage_collect(ckpt_dir: str, keep: int = 3) -> None:
    steps = sorted(
        [d for d in os.listdir(ckpt_dir) if d.startswith("step_")], reverse=True
    )
    for d in steps[keep:]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


class AsyncCheckpointer:
    """Background saver: ``save`` copies the tree to the host on the
    caller's thread (as JAX's ``np.asarray`` does) and writes it on a
    worker thread; one save in flight at a time."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Tree, *, extra: Optional[dict] = None) -> None:
        self.wait()  # one in flight at a time
        flat = host_leaves(tree)

        def work():
            try:
                _write(self.ckpt_dir, step, flat, extra)
                garbage_collect(self.ckpt_dir, self.keep)
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
