"""Building and loading the port's hand-written CUDA kernels, and counting
their launches.

Every kernel library is one `.cu` file under `gala_tpu_torch/csrc/` with a
plain C interface.  `build_library` compiles it with nvcc for sm_90a into
a shared library in `gala_tpu_torch/_build/` (git-ignored) at first use,
loads it with ctypes and declares the argument types of its functions.
The library's name carries a hash of the source and of the headers
beside it (`csrc/*.cuh`), so an edited source or header is rebuilt.
Builds may run in parallel threads (each is one nvcc process writing its
own temporary file, renamed into place when done).

`counts_for(name)` is the launch record of one kernel: its wrapper adds
one to `launches` where it launches the kernel, and one to
`reference_calls_on_cuda` where the plain version runs on CUDA tensors,
so a run can show that its work went through the kernels.  A kernel with
a bf16 form counts that form's launches under `name`_bf16
(`dtype_counts`).

`toolchain_available()` is the port of gala_tpu's `mosaic_available`: a
child process builds and launches `csrc/probe.cu` (x * 2, through
`probe_x2`, whose launches count under "toolchain_probe") and checks the
result.  Only `chip_smoke.py`'s build phase asks it; no module of the
package chooses an executor by it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
import warnings

import torch

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


DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}  # the kernels' element types


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in at least f32 (bf16 upcast exactly; f32 and f64 as they are):
    the plain versions compute in it."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rounding_slack(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """What two results that each round an f32 sum once to their dtype may
    differ by beyond the sums' own error: one bf16 unit in the last place
    at the larger magnitude (0 where both are 0) for bf16 results, 0 for
    f32 ones.  A kernel and its plain version sum in different orders, so
    their f32 sums differ in the last bits and may round to neighbouring
    bf16 values."""
    if got.dtype != torch.bfloat16:
        return torch.zeros((), device=got.device)
    big = torch.maximum(got.float().abs(), want.float().abs())
    _, exp = torch.frexp(big)  # big = mantissa * 2^exp, mantissa in [0.5, 1)
    return torch.where(big > 0, torch.ldexp(torch.ones_like(big), exp - 8), 0.0)


def dtype_counts(name: str, dtype: torch.dtype) -> Counts:
    """The launch record of kernel `name`'s form for `dtype`: `name` at
    float32, `name`_bf16 at bfloat16 (a run can show which form it
    launched; plain-version calls count under `name` alone)."""
    return counts_for(name if dtype == torch.float32 else f"{name}_{DTYPES[dtype]}")


def all_counts() -> dict[str, Counts]:
    return dict(_COUNTS)


def reset_counts() -> None:
    for c in _COUNTS.values():
        c.reset()


LIMIT_KEYS = ("registers", "static_smem", "dynamic_smem", "blocks_per_sm")


def read_limits(fn, *args) -> dict:
    """A library's launch-limit function (`gala_*_limits(..., int out[4])`)
    as {registers per thread, static and dynamic shared memory bytes per
    block, resident blocks per SM}.  Raises on a CUDA error."""
    out = (ctypes.c_int * 4)()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"launch-limit query failed with CUDA error {err}")
    return dict(zip(LIMIT_KEYS, out))


@dataclasses.dataclass
class Build:
    lib: ctypes.CDLL
    path: str
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register and spill report), kept beside the library


_BUILDS: dict[str, Build] = {}  # by source: the wrappers call build() per launch


def build_library(source: str, stem: str, functions: dict[str, list]) -> Build:
    """Compile `source` into lib<stem>_<hash>.so (unless a library of
    this source version is there), load it and set argtypes
    (`functions`: C name -> ctypes argtypes; every function returns an
    int, the CUDA error code); once per process and source.  nvcc's
    output is kept in lib<stem>_<hash>.so.log, so a library built earlier
    still reports its registers and spills.  Raises when nvcc is missing
    or the build fails."""
    if source in _BUILDS:
        return _BUILDS[source]
    sha = hashlib.sha1()
    for path in [source] + sorted(glob.glob(os.path.join(os.path.dirname(source), "*.cuh"))):
        with open(path, "rb") as f:
            sha.update(f.read())
    digest = sha.hexdigest()[:12]
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
        with open(f"{tmp}.log", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.log", f"{path}.log")
        os.replace(tmp, path)
    elif os.path.exists(f"{path}.log"):
        with open(f"{path}.log") as f:
            log = f.read()
    lib = ctypes.CDLL(path)
    for name, argtypes in functions.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _BUILDS[source] = Build(lib=lib, path=path, seconds=seconds, log=log)
    return _BUILDS[source]


def probe_library() -> Build:
    """The toolchain probe's library (csrc/probe.cu: gala_probe_f32, out =
    2 * x), built like every kernel library."""
    return build_library(os.path.join(CSRC_DIR, "probe.cu"), "probe", {
        "gala_probe_f32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    })


_probe_fn = None  # gala_probe_f32, looked up at the first launch
_probe_counts = counts_for("toolchain_probe")


def probe_x2(x: torch.Tensor) -> torch.Tensor:
    """2 * x by the probe kernel (x a contiguous f32 tensor of < 2^31
    elements); adds one to the "toolchain_probe" launch count.  A CPU
    tensor takes the plain product.  Raises on a failed launch.

    At the probe's 128 x 128 tile the host's work per call, not the
    kernel, sets the time, so the launch path is kept short: the C
    function is looked up once, and the stream is read as a raw handle
    (torch.cuda.current_stream() builds a Stream object per call)."""
    global _probe_fn
    if x.device.type != "cuda":
        return x * 2.0
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() >= 2**31:
        raise ValueError("probe_x2 takes a contiguous float32 tensor of < 2^31 elements")
    if _probe_fn is None:
        _probe_fn = probe_library().lib.gala_probe_f32
    out = torch.empty_like(x)
    err = _probe_fn(x.data_ptr(), out.data_ptr(), x.numel(),
                    torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"the probe kernel failed to launch: CUDA error {err}")
    _probe_counts.launches += 1
    return out


# The toolchain probe, run in a child process: build csrc/probe.cu, launch
# it on a 128 x 128 tile, check 2 * x and report the launches.
_PROBE_SRC = """
import torch
from gala_tpu_torch.ops.kernels._build import counts_for, probe_library, probe_x2
probe_library()  # the build first: a missing nvcc is the first thing to report
x = torch.arange(128 * 128, dtype=torch.float32, device="cuda").view(128, 128)
assert torch.equal(probe_x2(x), 2 * x), "wrong result"
print("toolchain-ok", counts_for("toolchain_probe").launches)
"""

_toolchain_ok: bool | None = None


def toolchain_available(timeout: float = 150.0) -> bool:
    """True when nvcc builds a trivial sm_90a kernel (csrc/probe.cu, out =
    2 * x on a 128 x 128 f32 tile) and it launches on the card with the
    right result: the counterpart of gala_tpu's mosaic_available.

    Probed once per process, in a child process that can be killed at
    `timeout` seconds (a broken CUDA install may hang rather than fail).  On
    failure it returns False and warns with the reason; it never raises.
    Nothing in the port chooses an executor by it: a CUDA tensor runs
    its kernel or raises."""
    global _toolchain_ok
    if _toolchain_ok is not None:
        return _toolchain_ok
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE_SRC], cwd=os.path.dirname(_PKG),
                              timeout=timeout, capture_output=True, text=True)
        answer = proc.stdout.split()
        _toolchain_ok = proc.returncode == 0 and answer[:1] == ["toolchain-ok"]
        if _toolchain_ok:  # the child's launches count in this process too
            counts_for("toolchain_probe").launches += int(answer[1])
        lines = (proc.stderr or proc.stdout).strip().splitlines()
        reason = lines[-1] if lines else f"exit code {proc.returncode}"
    except (subprocess.TimeoutExpired, OSError) as exc:
        _toolchain_ok = False
        reason = str(exc)
    if not _toolchain_ok:
        warnings.warn(f"CUDA toolchain probe failed: {reason}", stacklevel=2)
    return _toolchain_ok
