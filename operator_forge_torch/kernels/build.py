"""Build the port's CUDA sources into shared libraries loaded with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and is
compiled by ``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so``,
where ``<hash>`` covers the source, every header it includes with quotes
(``#include "common.cuh"``, followed through the headers' own includes)
and the flags: a changed source or header builds anew, an unchanged one
loads the library already there.  The build runs at
first use, under a file lock, so processes that start together build once.
``ptxas``'s report of each kernel's registers and spills is kept beside the
library (``resources`` reads it).  Every C entry returns
``cudaGetLastError()``; ``check`` raises on a non-zero status.  Kernels
whose last block sums what the others left (cross entropy's mean,
RMSNorm's backward) take integer ticket counters on the device:
``counters`` makes each source's once a device.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
QUOTED_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def sources() -> list[str]:
    """Names of the CUDA sources under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found: building the port's CUDA kernels needs the CUDA "
            "toolkit (on PATH or under CUDA_HOME)"
        )
    return path


def inputs(src: Path) -> list[Path]:
    """``src`` and every header it includes with quotes, directly or
    through another header, each once: what ``nvcc`` reads of the tree."""
    found, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path not in found:
            found.append(path)
            todo += [path.parent / name for name in QUOTED_INCLUDE.findall(path.read_text())]
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library of ``<csrc>/<name>.cu`` goes: named by a hash of
    the flags and of each input's name and bytes, so that a changed source
    or header gives a new path.  Needs no ``nvcc``."""
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for path in inputs(csrc / f"{name}.cu"):
        digest.update(b"\0" + path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same inputs and
    flags exists with its report; return the library's path."""
    src = CSRC / f"{name}.cu"
    out = library_path(name)
    # a library built without its report (by an older build) builds anew
    if out.exists() and report(out).exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out.exists() and report(out).exists()):
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed on {src.name} (rc {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            report(out).write_text(proc.stderr)
            os.replace(tmp, out)
    return out


def report(library: Path) -> Path:
    """Where ``ptxas``'s report of ``library``'s build lies."""
    return library.with_name(library.name + ".ptxas.txt")


def _kernel_name(symbol: str) -> str:
    """``ring_step_wide_kernel<float, true>`` for a kernel's mangled symbol,
    where ``c++filt`` is on the path; else the symbol."""
    filt = shutil.which("c++filt")
    if not filt:
        return symbol
    name = subprocess.run([filt], input=symbol, capture_output=True, text=True).stdout.strip()
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name[:name.index("(")] if "(" in name else name


def resources(name: str, csrc: Path = CSRC) -> dict:
    """Each kernel of ``<csrc>/<name>.cu``'s built library: its registers a
    thread and the bytes it spills to local memory, stores and loads, from
    ``ptxas``'s report (a device function a kernel calls rather than
    inlines has its own spills there, which are not the kernel's)."""
    found, kernel, symbol, owner = {}, None, None, None
    for line in report(library_path(name, csrc)).read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            symbol = owner = entry.group(1)
            kernel = _kernel_name(symbol)
            found[kernel] = {}
        elif properties := re.search(r"Function properties for (\w+)", line):
            owner = properties.group(1)
        elif owner != symbol:
            continue
        elif kernel and (spill := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            found[kernel].update(spill_stores=int(spill.group(1)), spill_loads=int(spill.group(2)))
        elif kernel and (used := re.search(r"Used (\d+) registers", line)):
            found[kernel]["registers"] = int(used.group(1))
    return found


def build_all() -> list[Path]:
    """Build every CUDA source, one ``nvcc`` per source, all at once."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Load (building first if needed) the library of ``csrc/<name>.cu``."""
    lib = ctypes.CDLL(str(build(name)))
    lib.of_error_string.argtypes = [ctypes.c_int]
    lib.of_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if status != 0:
        message = lib.of_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({message})")


@functools.cache
def counters(name: str, device: torch.device, n: int) -> torch.Tensor:
    """The ``n`` int32 ticket counters of ``csrc/<name>.cu``'s kernels on
    ``device``: 0 between launches, as each launch's last block sets them
    back.  Made at the first call for the device, with ``torch.zeros``,
    which a CUDA graph's capture may not hold: raises if that first call
    comes during a capture."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{name}'s first launch on a device cannot be captured into a CUDA graph: "
            "call it once outside the capture"
        )
    return torch.zeros(n, dtype=torch.int32, device=device)
