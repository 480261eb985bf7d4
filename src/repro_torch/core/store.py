"""Snapshot persistence for every registry engine — port of
``repro.core.store``, writing and reading the same files, so each package
loads the other's snapshots.

One directory per snapshot:

* ``arrays-<id>.npz`` — every array leaf of the engine, flattened to
  ``/``-joined path keys (nested dicts and lists of dicts — e.g. the Phi
  MLP's ``layers/0/w`` — round-trip through the same paths).  Format v2
  namespaces the engine's tree under ``engine/`` and, when the engine
  carries a ``core/attrs`` attribute store, its columns under ``attrs/``;
  format v3 adds the ``core/quant`` int8 codes + scales under ``quant/``.
* ``meta.json``   — ``{"format_version", "engine", "arrays", "statics",
  "attrs_statics", "quant_statics", "sha256"}``; ``arrays`` names the npz
  generation this meta commits.  Statics are plain-JSON engine config
  (tuples become lists; the engine's ``from_snapshot`` re-tuples what it
  needs; ``Infinity`` floats survive via Python json's literal).

Engines participate through two hooks: ``snapshot_state() ->
(arrays_tree, statics)`` — tensors on any device; ``save`` copies them to
the host — and ``from_snapshot(arrays_tree, statics, *, device=)``, which
puts the numpy arrays on ``device``.  Arrays are in the JAX package's
layouts (Phi's ``w`` is (din, dout), ``convert.params_from_phi``).  The
attribute and quant stores are persisted here, once for every engine;
``load`` re-attaches them through ``index.attach_store`` /
``attach_quant_store``.

Versioning: the reader accepts versions 1-3 and rejects a snapshot whose
``format_version`` exceeds ``FORMAT_VERSION``.  Crash safety: each save
writes a fresh ``arrays-<id>.npz`` and commits by atomically replacing
``meta.json``; stale arrays files are swept after the commit.  Integrity:
``save`` records a sha256 manifest; ``load`` and ``verify`` check the
member up front and raise one ``SnapshotCorruption`` naming it.  Chaos:
when the engine carries a ``core/chaos.FaultPlan`` with a ``snapshot``
rule, ``save`` corrupts the just-committed arrays member.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import tempfile
import uuid
from typing import Any

import numpy as np
import torch

from repro_torch.core import attrs as attrs_lib
from repro_torch.core import index as index_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import telemetry as telem
from repro_torch.device import DeviceLike


def _snap_span(op: str):
    """Time a snapshot operation under the telemetry ``snapshot`` stage —
    the span closes with ``error=True`` when the body raises."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with telem.span("snapshot", op=op):
                return fn(*a, **kw)
        return wrapper
    return deco


FORMAT_VERSION = 3
_META = "meta.json"


class SnapshotCorruption(ValueError):
    """A snapshot member is missing, empty, or fails its sha256 — the
    restore path's single corruption signal."""


# ---------------------------------------------------------------------------
# array-tree <-> flat npz keys
# ---------------------------------------------------------------------------

def flatten_arrays(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts / lists of arrays (numpy or tensors on any device) ->
    {path: numpy array}.  List positions become numeric path parts,
    restored as lists by ``unflatten_arrays``."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for key, val in tree.items():
            if "/" in str(key):
                raise ValueError(f"snapshot keys may not contain '/': {key!r}")
            out.update(flatten_arrays(val, f"{prefix}{key}/"))
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            out.update(flatten_arrays(val, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_arrays(flat: dict[str, np.ndarray]) -> Any:
    """Inverse of ``flatten_arrays``: all-numeric sibling keys become a list
    (in index order), everything else a dict."""
    if list(flat.keys()) == [""]:
        return flat[""]
    groups: dict[str, dict] = {}
    for key, val in flat.items():
        head, _, rest = key.partition("/")
        groups.setdefault(head, {})[rest] = val
    if groups and all(k.isdigit() for k in groups):
        return [unflatten_arrays(groups[k]) for k in sorted(groups, key=int)]
    return {k: unflatten_arrays(v) for k, v in groups.items()}


# ---------------------------------------------------------------------------
# engine hooks
# ---------------------------------------------------------------------------

def engine_snapshot_state(engine) -> tuple[Any, dict]:
    """(arrays_tree, statics) of any registered engine instance."""
    hook = getattr(engine, "snapshot_state", None)
    if hook is None:
        raise TypeError(
            f"{type(engine).__name__} does not support snapshots "
            "(no snapshot_state)"
        )
    return hook()


def engine_from_snapshot(name: str, arrays: Any, statics: dict, *,
                         device: DeviceLike = None):
    """Rebuild an engine instance on ``device`` from its snapshot pieces."""
    cls = index_lib.get_index(name)
    hook = getattr(cls, "from_snapshot", None)
    if hook is None:
        raise TypeError(f"{cls.__name__} does not support snapshots (no from_snapshot)")
    return hook(arrays, statics, device=device)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

@_snap_span("save")
def save(engine, path: str) -> str:
    """Write ``engine`` to the snapshot directory ``path``; returns it."""
    name = getattr(engine, "registry_name", None)
    if name is None:
        raise TypeError(f"{type(engine).__name__} is not a registered engine")
    arrays, statics = engine_snapshot_state(engine)
    payload = {"engine": arrays}
    attrs_statics = quant_statics = None
    store = getattr(engine, "attrs", None)
    if store is not None:
        attr_arrays, attrs_statics = store.snapshot_state()
        payload["attrs"] = attr_arrays
    qstore = getattr(engine, "quant", None)
    if qstore is not None:
        quant_arrays, quant_statics = qstore.snapshot_state()
        payload["quant"] = quant_arrays
    arrays_file = f"arrays-{uuid.uuid4().hex[:12]}.npz"

    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flatten_arrays(payload))
        digest = _file_sha256(tmp)
        os.replace(tmp, os.path.join(path, arrays_file))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    meta = {"format_version": FORMAT_VERSION, "engine": name,
            "arrays": arrays_file, "statics": statics,
            "attrs_statics": attrs_statics, "quant_statics": quant_statics,
            "sha256": {arrays_file: digest}}
    # json round-trip now: a non-serializable static should fail the save,
    # not the eventual load
    meta_str = json.dumps(meta, indent=1, default=_json_static)
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(meta_str)
        os.replace(tmp, os.path.join(path, _META))  # the commit point
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    for stale in os.listdir(path):  # sweep pre-commit generations
        if stale.startswith("arrays-") and stale.endswith(".npz") \
                and stale != arrays_file:
            os.unlink(os.path.join(path, stale))
    plan = getattr(engine, "chaos", None)
    if plan is not None:
        # scripted bit-rot lands AFTER the commit: the snapshot looks
        # published, and only the sha256 check on restore/verify exposes it
        plan.corrupt_snapshot(path, arrays_file)
    return path


def _file_sha256(fpath: str) -> str:
    h = hashlib.sha256()
    with open(fpath, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def check_members(path: str, meta: dict) -> None:
    """Up-front integrity gate shared by ``load`` and ``verify``: the
    arrays member named by ``meta`` must exist, be non-empty, and (when the
    meta carries a sha256 manifest) match its recorded digest."""
    arrays_file = meta.get("arrays")
    if not arrays_file:
        raise SnapshotCorruption(
            f"snapshot {path}: meta.json names no arrays member"
        )
    member = os.path.join(path, arrays_file)
    if not os.path.exists(member):
        raise SnapshotCorruption(
            f"snapshot {path}: arrays member {arrays_file!r} is missing "
            "(partially-written snapshot?)"
        )
    if os.path.getsize(member) == 0:
        raise SnapshotCorruption(
            f"snapshot {path}: arrays member {arrays_file!r} is zero-length "
            "(truncated write)"
        )
    recorded = (meta.get("sha256") or {}).get(arrays_file)
    if recorded is not None and _file_sha256(member) != recorded:
        raise SnapshotCorruption(
            f"snapshot {path}: arrays member {arrays_file!r} fails its "
            f"sha256 manifest (on-disk corruption); re-save or restore an "
            "older snapshot"
        )


@_snap_span("verify")
def verify(path: str) -> dict:
    """Validate the snapshot at ``path`` without materializing arrays:
    member presence, size, and sha256 manifest.  Returns the meta dict;
    raises ``SnapshotCorruption`` (member damage) or ``ValueError``
    (malformed/future format)."""
    meta = peek(path)
    _check_version(path, meta)
    check_members(path, meta)
    return meta


def _check_version(path: str, meta: dict) -> None:
    version = meta.get("format_version")
    if not isinstance(version, int) or version < 1:
        raise ValueError(
            f"snapshot {path}: malformed format_version {version!r}"
        )
    if version > FORMAT_VERSION:
        raise ValueError(
            f"snapshot {path}: format_version {version} was written by a "
            f"newer release than this reader (v{FORMAT_VERSION}) — refusing "
            "to misread it; upgrade, or re-save with this version"
        )


@_snap_span("restore")
def load(path: str, *, device: DeviceLike = None):
    """Rebuild the engine stored at ``path`` (a ``save`` directory) on
    ``device`` (default CUDA).  Integrity runs before any array is
    touched."""
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    version = meta.get("format_version")
    _check_version(path, meta)
    check_members(path, meta)
    try:
        with np.load(os.path.join(path, meta["arrays"])) as z:
            tree = unflatten_arrays({k: z[k] for k in z.files})
    except Exception as e:
        # pre-manifest snapshots have no sha256 to catch damage above; a
        # zip/np parse failure here is still one clear corruption signal
        raise SnapshotCorruption(
            f"snapshot {path}: arrays member {meta['arrays']!r} is "
            f"unreadable ({type(e).__name__}: {e})"
        ) from e
    if version == 1:  # pre-attrs layout: the engine tree sat at the root
        engine_arrays, attr_arrays, quant_arrays = tree, None, None
    else:
        engine_arrays = tree["engine"]
        attr_arrays = tree.get("attrs")
        quant_arrays = tree.get("quant")  # v3; absent from v2 snapshots
    inst = engine_from_snapshot(meta["engine"], engine_arrays, meta["statics"],
                                device=device)
    if attr_arrays is not None:
        index_lib.attach_store(
            inst, attrs_lib.AttributeStore.from_snapshot(attr_arrays,
                                                         meta["attrs_statics"]))
    if quant_arrays is not None:
        index_lib.attach_quant_store(
            inst, quant_lib.QuantStore.from_snapshot(
                quant_arrays, meta.get("quant_statics"), device=device))
    return inst


def peek(path: str) -> dict:
    """The snapshot's meta.json without loading arrays (ops tooling)."""
    with open(os.path.join(path, _META)) as f:
        return json.load(f)


def _json_static(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    raise TypeError(f"snapshot static not JSON-serializable: {type(obj).__name__}")
