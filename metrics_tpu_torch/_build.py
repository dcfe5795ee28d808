"""Build of the hand-written CUDA kernels, at first use, from the checkout's sources.

Each source under ``csrc/`` compiles with ``nvcc`` into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. Libraries go to ``build/kernels/`` at the root of the checkout and are
named by a hash of their source, so an edited source builds anew. Nothing here runs
when a module is imported: the CPU tests import every module on machines without
``nvcc``.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
# one entry per kernel source; later kernels add theirs here
KERNEL_SOURCES = {
    "histogram": CSRC_DIR / "histogram.cu",
    "segment_scan": CSRC_DIR / "segment_scan.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(KERNEL_SOURCES[name].read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libtm_{name}-{digest}.so"


def _start(name: str) -> "tuple[subprocess.Popen, Path, Path]":
    target = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(KERNEL_SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), target


def build(names: List[str] = None) -> List[Path]:
    """Compile the named kernels (all by default) that are not built yet, in parallel.

    One ``nvcc`` per source, all started together; raises with the compiler's
    output if any build fails. Returns the libraries' paths.
    """
    names = list(KERNEL_SOURCES) if names is None else names
    jobs = [_start(n) for n in names if not library_path(n).exists()]
    errors = []
    for proc, tmp, target in jobs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"{target.name}: nvcc exited {proc.returncode}\n{out}")
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _LOADED[name] = lib
        return lib
