"""Build a kernel source with ``nvcc`` at first use and load it with ctypes.

Each ``csrc/*.cu`` exports plain ``extern "C"`` launchers, so it compiles
in seconds without PyTorch's headers.  The shared library goes to
``build/repro_torch/`` at the repository root (git-ignored), named after a
hash of the source, the flags and any preprocessor defines: a changed
source builds anew, an unchanged one is loaded as it is.  No CUDA
compiler means an error, never a fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "find_nvcc", "library_path",
           "load_library"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[Path, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install path; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(source: Path, defines: tuple[str, ...] = ()) -> Path:
    """Where ``source`` builds to: keyed on its bytes and the flags."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(source: Path, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``source`` unless its library exists; returns the library.

    ``defines`` (``NAME=VALUE``) go to nvcc as ``-D``.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside the library as ``<name>.log``.
    """
    out = library_path(source, defines)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def load_library(source: Path,
                 defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``source`` if needed and load it (once per process)."""
    path = build(source, defines)
    lib = _LOADED.get(path)
    if lib is None:
        lib = _LOADED[path] = ctypes.CDLL(str(path))
    return lib
