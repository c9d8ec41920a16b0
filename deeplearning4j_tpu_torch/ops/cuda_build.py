"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into its
own shared library with a plain C interface, and loaded with
``ctypes``. No PyTorch header is included, so a build takes seconds.
Libraries land in ``build/torch_kernels/`` at the root of the checkout,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags: an edit to any of them builds anew, an unchanged tree loads
what is there. Different sources may build at the same time (one lock
per source), so a caller can start every nvcc at once.

A :class:`Kernel` names one kernel: its source, the TPU kernel it
replaces, and ``launches``, the count of launches its wrapper made.
Wrappers call :meth:`Kernel.launched` right after a successful launch
and nowhere else, so a run can show that its path went through the
kernel. A wrapper also hands over its launch's analytic cost (the bytes
it must move and the operations it does, evaluated only while a launch
listener is registered: :func:`add_launch_listener`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

#: sm_90a keeps wgmma/setmaxnreg available to the kernels that need them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks_lock = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time (0.0 when loaded from disk),
#: "log": nvcc's output, "path": the library}
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build on a machine with the CUDA "
            "toolkit")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    records the wall time and nvcc's output in :data:`build_info` and
    returns the library's path."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        out = _library_path(name)
        if out.exists():
            build_info.setdefault(name, {"seconds": 0.0, "log": "",
                                         "path": str(out)})
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            "log": proc.stdout, "path": str(out)}
        return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs.setdefault(name, ctypes.CDLL(str(build(name))))
    return lib


def c_function(library: str, name: str, argtypes, restype=ctypes.c_int):
    """The C function ``name`` of ``csrc/<library>.cu`` with its
    ``argtypes`` and ``restype`` declared (without them ctypes passes a
    64-bit pointer as a 32-bit int)."""
    fn = getattr(load_library(library), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


#: a launch's analytic ``(bytes, operations)``, computed on demand
Cost = Callable[[], Tuple[float, float]]
#: ``fn(kernel_name, cost)`` called at every launch
_listeners: List[Callable[[str, Optional[Cost]], None]] = []


def add_launch_listener(fn: Callable[[str, Optional[Cost]], None]) -> None:
    _listeners.append(fn)


def remove_launch_listener(fn: Callable[[str, Optional[Cost]], None]
                           ) -> None:
    _listeners.remove(fn)


class Kernel:
    """One hand-written kernel of the port, with its launch count."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source          # path in the repo
        self.replaces = replaces      # the TPU kernel, file:line
        self.launches = 0
        self._lock = threading.Lock()

    def launched(self, cost: Optional[Cost] = None) -> None:
        """Count one launch and tell the listeners; ``cost()`` gives the
        launch's ``(bytes, operations)``: each input read once, each
        output written once, 2 operations a multiply-add."""
        with self._lock:
            self.launches += 1
        for fn in tuple(_listeners):
            fn(self.name, cost)


#: every kernel of the port, by name
KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel
