"""Build, load and count the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use every source
is compiled by its own ``nvcc`` process, all started together, into
``build/kernels/`` at the root of the checkout, and loaded with ``ctypes``.
A library is named by the hash of its source and flags, so a checkout
rebuilds only what changed. A missing ``nvcc`` or a failed build raises.

``LAUNCHES`` counts kernel launches by name. Each wrapper adds one to its
count where it launches its kernel and nowhere else, so a caller can zero
the counts, run a path, and see which kernels the path went through.
``launch_total`` is the running total of all launches, which a reset does
not zero: a span (``utils/profiling.py``) reads it at entry and exit.

The build, the binding of a function's argument types and the counts are
guarded by locks: a threaded server may send two first requests at once.
``sm_count`` gives a card's multiprocessor count, by which the launch plans
size their grids.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decoder", "fused_block", "preprocess", "stem", "stencil_floor")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

LAUNCHES: Dict[str, int] = {}
_launch_total = 0
BUILD_INFO: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count(name: str) -> None:
    global _launch_total
    with _COUNT_LOCK:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
        _launch_total += 1


def launch_total() -> int:
    return _launch_total


def reset_launches() -> None:
    with _COUNT_LOCK:
        LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source not yet built (one nvcc per source, in
    parallel) and load all libraries. Returns ``BUILD_INFO``: per source,
    the library path, build seconds (0 when reused) and the ``-Xptxas -v``
    report, which is printed to stderr once per build and kept beside the
    library."""
    import time

    with _LOCK:
        if len(_LIBS) == len(SOURCES):
            return BUILD_INFO
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in SOURCES:
            target = _target(name)
            if name in _LIBS or target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ), tmp, target)
        for name, (proc, tmp, target) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}\n{err}")
            target.with_suffix(".ptxas.txt").write_text(err)
            os.replace(tmp, target)
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0}
            print(f"[kernels] built {target.name}\n{err}", file=sys.stderr)
        for name in SOURCES:
            if name not in _LIBS:
                target = _target(name)
                _LIBS[name] = ctypes.CDLL(str(target))
                info = BUILD_INFO.setdefault(name, {"seconds": 0.0})
                info["path"] = str(target)
                info["ptxas"] = target.with_suffix(".ptxas.txt").read_text()
        return BUILD_INFO


def bind(source: str, fn: str, argtypes: List) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of ``source``, with its argument types set
    (``c_void_p`` for every pointer and the stream, ``c_int`` for ints)
    and an ``int`` result (a ``cudaError_t``)."""
    build_all()
    f = getattr(_LIBS[source], fn)
    if f.argtypes is None:
        with _COUNT_LOCK:
            f.restype = ctypes.c_int
            f.argtypes = argtypes
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


_SM_COUNTS: Dict[int, int] = {}


def sm_count(device) -> int:
    """The multiprocessor count of CUDA ``device`` (cached)."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNTS:
        _SM_COUNTS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNTS[idx]


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
