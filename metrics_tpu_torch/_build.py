"""Build of the hand-written CUDA kernels, at first use, from the checkout's sources.

Each source under ``csrc/`` compiles with ``nvcc`` into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. Libraries go to ``build/kernels/`` at the root of the checkout (or to the
directory of ``serve.excache.enable_persistent_cache``) and are named by a hash of
their source, so an edited source builds anew. Nothing here runs
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
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, List

from metrics_tpu_torch.obs import registry as _obs

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
#: libraries :func:`build` found built and built with ``nvcc``, since the process began
BUILD_COUNTS = {"found": 0, "built": 0}
# one entry per kernel source; later kernels add theirs here
KERNEL_SOURCES = {
    "histogram": CSRC_DIR / "histogram.cu",
    "segment_scan": CSRC_DIR / "segment_scan.cu",
    "greedy_match": CSRC_DIR / "greedy_match.cu",
    "kendall_merge": CSRC_DIR / "kendall_merge.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C interface of each kernel's library: function -> (argument types, result type)
SIGNATURES = {
    "histogram": {
        "tm_histogram": ([_PTR, _PTR, _INT, _LONG, _INT, _PTR, _PTR], _INT),
        "tm_histogram_batched": ([_PTR, _PTR, _INT, _LONG, _LONG, _LONG, _INT, _PTR, _PTR], _INT),
    },
    "segment_scan": {
        "tm_segment_scan": (
            [_INT, ctypes.POINTER(_PTR), ctypes.POINTER(_PTR), ctypes.POINTER(_INT), _INT, _PTR, _LONG, _INT, _PTR, _PTR],
            _INT,
        ),
        "tm_segment_scan_scratch_bytes": ([_INT, _INT, _LONG], _LONG),
        "tm_segment_scan_tile_rows": ([_INT, _INT], _LONG),
    },
    "greedy_match": {
        "tm_greedy_match": ([_PTR] * 7 + [_LONG, _INT, _INT, _INT, _INT] + [_PTR] * 4, _INT),
        "tm_greedy_match_variant": ([_PTR] * 7 + [_LONG, _INT, _INT, _INT, _INT] + [_PTR] * 4 + [_INT], _INT),
    },
    "kendall_merge": {
        "tm_kendall_tile_rows": ([], _LONG),
        "tm_kendall_keys": ([_PTR, _PTR, _LONG, _INT, _PTR, _PTR, _PTR], _INT),
        "tm_kendall_count": ([_PTR, _LONG, _INT, _PTR, _PTR, _LONG, _PTR, _PTR, _PTR], _INT),
    },
}

# Each kernel wrapper keeps a ``launches`` count; a replayed CUDA graph adds to it the
# launches that its capture recorded (``core/fused.py:CapturedStep``), since a replay
# bypasses the wrapper.
_LAUNCH_LOCK = threading.Lock()
#: per thread: the tally of the CUDA-graph capture this thread is running, if any
_CAPTURE = threading.local()


#: per thread: the obs scope that this thread's launches are credited to, if any
_CREDIT = threading.local()


def note_launch(wrapper, n: int = 1) -> None:
    """Count ``n`` launches of ``wrapper``'s kernel, where a wrapper launches and where a
    replay runs what a capture recorded. On a thread inside :func:`capture_tally` they go
    to the capture's tally instead (a captured launch has not run); elsewhere to
    ``wrapper.launches``, under a lock, since several threads launch (a tick thread, the
    health monitor's flushes on request threads). While the obs gate is on they are also
    credited, as ``kernel_launches``, to the innermost :func:`crediting` scope of this
    thread (a metric's eager update, an engine's compiled step), which
    ``obs/costcheck.py`` holds against the launch budget."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + n
        return
    with _LAUNCH_LOCK:
        wrapper.launches += n
    if _obs._ENABLED:
        scope = getattr(_CREDIT, "scope", None)
        if scope is not None:
            _obs.REGISTRY.inc(scope, "kernel_launches", n)


@contextmanager
def crediting(scope: str) -> Iterator[None]:
    """Credit this thread's kernel launches inside the block to the obs scope ``scope``
    (the innermost block wins)."""
    prev = getattr(_CREDIT, "scope", None)
    _CREDIT.scope = scope
    try:
        yield
    finally:
        _CREDIT.scope = prev


@contextmanager
def capture_tally() -> Iterator[Dict[object, int]]:
    """The launches this thread records while a CUDA graph is captured, by wrapper."""
    prev = getattr(_CAPTURE, "tally", None)
    _CAPTURE.tally = tally = {}
    try:
        yield tally
    finally:
        _CAPTURE.tally = prev


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
    missing = [n for n in names if not library_path(n).exists()]
    BUILD_COUNTS["found"] += len(names) - len(missing)
    BUILD_COUNTS["built"] += len(missing)
    jobs = [_start(n) for n in missing]
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


def call_on_device(device, call):
    """``call(stream)`` with ``device`` current and ``stream`` the raw handle of its
    current CUDA stream, for a C launch; returns what ``call`` returns.

    Host time per launch matters at small sizes: the device switch is skipped when
    ``device`` is already current, and the handle comes from
    ``torch._C._cuda_getCurrentRawStream`` (present in the CUDA builds of torch 2.x,
    and what torch's own generated kernels launch on), which builds no
    ``torch.cuda.Stream``.
    """
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    if index == torch.cuda.current_device():
        return call(torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return call(torch._C._cuda_getCurrentRawStream(index))


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declares on ``lib``, a library built from kernel ``name``'s source (of this
    tree or an older one), the argument and result types of its C functions; a
    function the library lacks is left out. Returns ``lib``."""
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, its C interface
    declared."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            (path,) = build([name])
            lib = bind(ctypes.CDLL(str(path)), name)
            _LOADED[name] = lib
        return lib
