"""Building and loading the port's hand-written CUDA kernels, and counting
their launches.

Every kernel library is one `.cu` file under `gala_tpu_torch/csrc/` with a
plain C interface.  `build_library` compiles it with nvcc for sm_90a into
a shared library in `gala_tpu_torch/_build/` (git-ignored) at first use,
loads it with ctypes and declares the argument types of its functions.
The library's name carries a hash of the source, so an edited source is
rebuilt.  Builds may run in parallel threads (each is one nvcc process
writing its own temporary file, renamed into place when done).

`counts_for(name)` is the launch record of one kernel: its wrapper adds
one to `launches` where it launches the kernel, and one to
`reference_calls_on_cuda` where the plain version runs on CUDA tensors,
so a run can show that its work went through the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclasses.dataclass
class Counts:
    name: str
    launches: int = 0                 # kernel launches
    reference_calls_on_cuda: int = 0  # plain-version calls on CUDA tensors

    def reset(self) -> None:
        self.launches = 0
        self.reference_calls_on_cuda = 0


_COUNTS: dict[str, Counts] = {}


def counts_for(name: str) -> Counts:
    """The launch record of kernel `name` (created on first use)."""
    if name not in _COUNTS:
        _COUNTS[name] = Counts(name)
    return _COUNTS[name]


def all_counts() -> dict[str, Counts]:
    return dict(_COUNTS)


def reset_counts() -> None:
    for c in _COUNTS.values():
        c.reset()


@dataclasses.dataclass
class Build:
    lib: ctypes.CDLL
    path: str
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register and spill report)


_BUILDS: dict[str, Build] = {}  # by source path: the wrappers call build() per launch


def build_library(source: str, stem: str, functions: dict[str, list]) -> Build:
    """Compile `source` into lib<stem>_<hash>.so (unless a library of
    this source version is there), load it and set argtypes
    (`functions`: C name -> ctypes argtypes; every function returns an
    int, the CUDA error code); once per process and source.  Raises when
    nvcc is missing or the build fails."""
    if source in _BUILDS:
        return _BUILDS[source]
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: {source} cannot be built")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, source],
            capture_output=True, text=True, timeout=600,
        )
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source}:\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    for name, argtypes in functions.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _BUILDS[source] = Build(lib=lib, path=path, seconds=seconds, log=log)
    return _BUILDS[source]
