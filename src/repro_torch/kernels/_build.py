"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``.
All sources compile in parallel (one ``nvcc`` each, started together) at
first use. Libraries are keyed by a hash of their source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source or header
rebuilds and an unchanged one is reused. The build
directory is ``build/repro_torch`` at the root of the checkout. A build
holds an exclusive lock on ``build/repro_torch/build.lock`` (``flock``),
so processes that start at once (the ranks of a TP group) build each
source once: the others wait and then find the libraries.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signatures: name -> (library, argtypes)
SIGNATURES = {
    "ternary_cim_mac": ("ternary_mac", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "packed_cim_mac": ("packed_mac", [_P, _P, _P, _P] + [_I] * 11 + [_P]),
    "packed_decode_mac": ("packed_mac", [_P, _P, _P, _P] + [_I] * 10 + [_P]),
    "packed_stream_mac": ("packed_stream", [_P, _P, _P] + [_I] * 9 + [_P]),
    "ternary_exact_mac": ("ternary_exact", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: the last build's report: seconds, sources built, library paths, nvcc log
last_build: Dict[str, object] = {}


def build_dir() -> Path:
    return CSRC.parents[2] / "build" / "repro_torch"


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set $NVCC or $CUDA_HOME, or put "
                       "nvcc on PATH (the CUDA kernels build on the card's host)")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on the build directory's lock file, held by
    this process until the block ends (the kernel releases it if the
    process dies)."""
    build_dir().mkdir(parents=True, exist_ok=True)
    with open(build_dir() / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing, all in
    parallel; returns ``{stem: library path}``. Raises with the compiler
    output when a build fails. Safe for several processes at once (the
    build lock)."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    t0 = time.perf_counter()
    if all(t.exists() for t in targets.values()):
        return _report(t0, [], targets, [])
    with _build_lock():
        return _build(sources, targets, t0)


def _report(t0: float, todo, targets, logs) -> Dict[str, Path]:
    last_build.clear()
    last_build.update(seconds=time.perf_counter() - t0,
                      built=[s.name for s in todo],
                      libraries={k: str(v) for k, v in targets.items()},
                      log="\n".join(logs))
    return targets


def _build(sources, targets, t0: float) -> Dict[str, Path]:
    todo = [src for src in sources if not targets[src.stem].exists()]
    logs: List[str] = []
    if todo:
        nvcc = nvcc_path()
        procs = []
        for src in todo:
            tmp = targets[src.stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{src.name} (rc {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, targets[src.stem])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return _report(t0, todo, targets, logs)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (builds every
    source on first use), with its C signatures declared."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            for name, path in build_all().items():
                _LIBS[name] = _load(ctypes.CDLL(str(path)))
            lib = _LIBS[stem]
        return lib


def _load(lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, (_stem, argtypes) in SIGNATURES.items():
        f = getattr(lib, fn, None)
        if f is not None:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return lib


def launch(fn: str, *args) -> None:
    """Call the C launcher ``fn`` and raise on a nonzero CUDA error."""
    stem = SIGNATURES[fn][0]
    rc = getattr(library(stem), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


def stream_ptr(device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
