"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` source with a plain C interface, kept in a
``csrc/`` directory beside the module that wraps it. It is compiled at
first use with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at
the repository root (the shared library's name carries a hash of its
source and of the ``.cuh`` headers beside it, which a source may include,
so an edited source or header is rebuilt and an unchanged one is loaded
as is) and loaded with ``ctypes``. ``-fmad=false`` keeps every multiply and
add separately rounded, as the plain PyTorch versions compute them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[Path, ctypes.CDLL] = {}
#: kernel name (the source's stem) -> (seconds, ptxas register / spill
#: report, see :func:`ptxas_report`) of builds in this process
BUILD_LOG: Dict[str, Tuple[float, str]] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _start(src: Path):
    lib = _target(src)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib, time.perf_counter()


def _finish(src: Path, job) -> None:
    proc, tmp, lib, t0 = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{out}")
    os.replace(tmp, lib)
    BUILD_LOG[src.stem] = (time.perf_counter() - t0, ptxas_report(out))


def ptxas_report(out: str) -> str:
    """Each kernel's registers and spilled bytes from ``ptxas -v`` output:
    "name: N registers, S bytes spill stores, L bytes spill loads; ..."
    (names demangled where ``c++filt`` is found)."""
    entries, name, spill = [], None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"{m.group(1)} bytes spill stores, {m.group(2)} bytes spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            entries.append((name, f"{m.group(1)} registers, {spill or 'spills not reported'}"))
            name = None
    filt = shutil.which("c++filt")
    if filt and entries:
        names = subprocess.run([filt], input="\n".join(n for n, _ in entries),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(entries):
            short = (re.sub(r"^void |\(.*\)$", "", n.replace("(anonymous namespace)::", ""))
                     for n in names)
            entries = [(n, r) for n, (_, r) in zip(short, entries)]
    return "; ".join(f"{n}: {r}" for n, r in entries)


def build(sources: Iterable[Path]) -> None:
    """Compile every ``.cu`` source that is not built yet, one ``nvcc``
    per source, all started together."""
    with _lock:
        jobs = [(src, _start(src)) for src in sources]
        for src, job in jobs:
            if job is not None:
                _finish(src, job)


def check(t, name: str, dtype, shape: tuple, device) -> int:
    """Validate one kernel operand and return its data pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def load(src: Path) -> ctypes.CDLL:
    """The loaded shared library of the ``.cu`` source ``src`` (built on
    demand)."""
    lib = _libs.get(src)
    if lib is None:
        build([src])
        with _lock:
            lib = _libs.get(src)
            if lib is None:
                lib = _libs[src] = ctypes.CDLL(str(_target(src)))
    return lib
