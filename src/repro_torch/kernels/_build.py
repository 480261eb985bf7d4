"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), the objects are linked into ONE shared
library with a plain C interface, and the library is loaded with
``ctypes``.  The library sits under ``<repo>/build/`` and its name carries
a hash of the sources and flags, so an edit rebuilds and an unchanged tree
loads the existing file.  Nothing is built at import: the first kernel
launch builds.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
Kernel wrappers call ``note_launch`` after each launch, so a run can show
which kernels its path went through (``launches`` / ``reset_launches``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel regime -> launches since the last ``reset_launches``: each
#: distance family and each semiring mode counts apart (one template
#: instance, or one kernel, each)
_LAUNCHES: dict[str, int] = {
    "topk/f32": 0, "topk/cube": 0, "topk/int8": 0,
    "pdist/matmul": 0, "pdist/cube": 0,
    "qpath/minplus": 0, "qpath/minmax": 0, "qpath/logminplus": 0,
    "bag": 0, "bag_backward": 0, "beam/levels": 0, "rescore": 0,
}
#: the loaded library and what building it took
_STATE: dict = {"lib": None, "info": None}
#: (C entry, its arguments) -> blocks of a kernel one SM holds
_RESIDENT: dict[tuple, int] = {}


def note_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launches() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launches() -> None:
    for key in _LAUNCHES:
        _LAUNCHES[key] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    """Hash of the flags and every source and header under ``csrc/``."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile and link the kernels if the library for this source hash is
    missing.  Returns ``{"path", "seconds", "ptxas"}`` — the build's wall
    time (0 when the library already existed) and nvcc's ``-Xptxas -v``
    report (registers, shared memory and spills per kernel)."""
    if _STATE["info"] is not None:
        return _STATE["info"]
    sources = sorted(CSRC.glob("*.cu"))
    tag = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"repro_torch_kernels-{tag}.so"
    log = so.with_suffix(".log")
    t0 = time.perf_counter()
    built = False
    if not so.exists():
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sources:
            obj = BUILD_DIR / f"{src.stem}-{tag}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        reports = [p.communicate()[0] for p in procs]
        failed = [(s, r) for s, p, r in zip(sources, procs, reports)
                  if p.returncode != 0]
        if failed:
            msg = "\n".join(f"--- {s.name}\n{r}" for s, r in failed)
            raise RuntimeError(f"nvcc failed:\n{msg}")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        for obj in objs:
            obj.unlink()
        log.write_text("".join(reports))
        os.replace(tmp, so)
        built = True
    info = {
        "path": str(so),
        "seconds": time.perf_counter() - t0 if built else 0.0,
        "ptxas": log.read_text() if log.exists() else "",
    }
    _STATE["lib"] = ctypes.CDLL(str(so))
    _STATE["lib"].rt_error_string.restype = ctypes.c_char_p
    _STATE["lib"].rt_error_string.argtypes = [ctypes.c_int]
    _STATE["info"] = info
    return info


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the built library, typed: pointers and
    the stream are ``c_void_p``, sizes ``c_int``, the result the CUDA
    error code."""
    build()
    fn = getattr(_STATE["lib"], name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = _STATE["lib"].rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def resident_slots(entry: str, args: tuple[int, ...], device) -> int:
    """Blocks the card holds at once: the C entry ``entry`` (an occupancy
    query taking ``args`` and writing the blocks one SM holds) times the
    SMs."""
    import torch

    key = (entry, *args)
    if key not in _RESIDENT:
        blocks = ctypes.c_int(0)
        fn = function(entry, [ctypes.c_int] * len(args) + [ctypes.c_void_p])
        check(fn(*args, ctypes.byref(blocks)), entry)
        _RESIDENT[key] = max(1, blocks.value)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _RESIDENT[key] * sms
