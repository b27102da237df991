"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into its own
shared library with a plain C interface, under ``_build/`` beside the
package (listed in ``.gitignore``), and loaded with ``ctypes``.  A library's
file name carries the hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source or header is rebuilt and
an unchanged one is loaded as it is.  ``build_all`` starts one
``nvcc`` per source, all at once.

Every C entry point returns a ``cudaError_t`` as an int: ``check`` raises on
a non-zero code, so a refused launch never passes silently.  ``on_card``
and ``require`` are the checks every wrapper makes before it passes raw
pointers to a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = target.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, target


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, target = job
    if proc.wait() != 0:
        tmp.unlink(missing_ok=True)
        log = target.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent process loads a whole file


def build_all() -> float:
    """Compile every source that has no current library, one ``nvcc`` per
    source started together; returns the seconds taken."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in sources()}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) from the library's build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass(name: str) -> str:
    """``cuobjdump --dump-sass`` of the built library of ``csrc/<name>.cu``."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "--dump-sass", str(_target(name))], check=True,
                          capture_output=True, text=True).stdout  # fmt: skip


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def require(what: str, name: str, t, dtype, shape: tuple, dev) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``dev``: what a kernel's raw pointer arithmetic assumes."""
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def on_card(what: str, dev) -> None:
    """Raise unless ``dev`` is a CUDA device: a wrapper launches a kernel or
    refuses, it never computes on the CPU."""
    if dev.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got tensors on {dev}")
