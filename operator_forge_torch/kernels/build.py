"""Build the port's CUDA sources into shared libraries loaded with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and is
compiled by ``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so``,
where ``<hash>`` covers the source and the flags: a changed source builds
anew, an unchanged one loads the library already there.  The build runs at
first use, under a file lock, so processes that start together build once.
Every C entry returns ``cudaGetLastError()``; ``check`` raises on a
non-zero status.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


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


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; return the library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed on {src.name} (rc {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
    return out


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
