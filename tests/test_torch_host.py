"""The port's host layer and its boundaries.

- Every copied host module equals gala_tpu's once the package rename is
  reversed, so the DSL, IR, passes and host layouts stay identical by
  construction; so does the native C++ source (native/csr_ops.cpp), which
  native/__init__.py builds into the port's build directory.
- The port imports neither jax nor optax, nor gala_tpu.
- chip_smoke.py refuses to run without a GPU.
"""
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOST_FILES = """
dsl/__init__.py dsl/parser.py dsl/spec.py
ir/__init__.py ir/build.py ir/compute_ir.py ir/data_ir.py
passes/__init__.py passes/attention_fusion.py passes/code_motion.py passes/pipeline.py
passes/reorder.py passes/sparsify.py passes/subgraph.py
lowering/__init__.py lowering/autoschedule.py
data/__init__.py data/csr.py data/ell.py data/datasets.py data/io.py data/synthetic.py
data/subgraph.py data/reordering.py data/sampling.py data/minibatch.py data/mtx.py
utils/stats.py
native/csr_ops.cpp
""".split()


def _read(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return f.read()


@pytest.mark.parametrize("path", HOST_FILES)
def test_copied_host_module_equals_original(path):
    port = _read("gala_tpu_torch", path)
    assert re.sub(r"\bgala_tpu_torch\b", "gala_tpu", port) == _read("gala_tpu", path)


@pytest.mark.parametrize("sub", ["dsl", "ir", "passes", "data"])
def test_copied_packages_hold_only_copies(sub):
    files = sorted(f for f in os.listdir(os.path.join(ROOT, "gala_tpu_torch", sub))
                   if f.endswith(".py"))
    assert [f"{sub}/{f}" for f in files] == sorted(p for p in HOST_FILES if p.startswith(sub + "/"))


def test_port_imports_no_jax():
    code = ("import runpy, sys, gala_tpu_torch, gala_tpu_torch.api, "
            "gala_tpu_torch.lowering.lower, gala_tpu_torch.train_minibatch, "
            "gala_tpu_torch.__main__, gala_tpu_torch.checkpoint, gala_tpu_torch.resilience, "
            "gala_tpu_torch.data.mtx, gala_tpu_torch.utils.stats, "
            "gala_tpu_torch.utils.profiling; "
            "runpy.run_path('scripts/evaluate_torch.py', run_name='evaluate_torch'); "
            "bad = [m for m in ('jax', 'optax', 'gala_tpu') if m in sys.modules]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_no_port_file_imports_jax_or_gala_tpu():
    pat = re.compile(r"^\s*(import|from)\s+(jax|optax|gala_tpu)(\.|\s|$)", re.M)
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "gala_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    if pat.search(fh.read()):
                        bad.append(os.path.join(dirpath, f))
    scripts = [os.path.join("scripts", f) for f in os.listdir(os.path.join(ROOT, "scripts"))
               if "_torch" in f and f.endswith(".py")]
    assert {"scripts/bench_minibatch_torch.py", "scripts/evaluate_torch.py"} <= set(scripts)
    for path in ["chip_smoke.py", *scripts]:
        with open(os.path.join(ROOT, path)) as fh:
            if pat.search(fh.read()):
                bad.append(path)
    assert not bad


def test_no_port_file_reads_the_jax_package():
    """No port module, port script or chip_smoke.py names a path into the
    JAX package (`"gala_tpu"` as a path component): what the port needs of
    it, it keeps a copy of."""
    pat = re.compile(r"""["']gala_tpu["']""")
    paths = [os.path.join(d, f) for d, _, files in os.walk(os.path.join(ROOT, "gala_tpu_torch"))
             for f in files if f.endswith((".py", ".cu", ".cuh", ".cpp"))]
    paths += [os.path.join(ROOT, "chip_smoke.py")]
    paths += [os.path.join(ROOT, "scripts", f) for f in os.listdir(os.path.join(ROOT, "scripts"))
              if "_torch" in f and f.endswith(".py")]
    bad = [p for p in paths if pat.search(open(p).read())]
    assert not bad


def test_native_builds_outside_the_shared_source():
    from gala_tpu_torch import native

    assert os.path.dirname(native._SO) == os.path.join(ROOT, "gala_tpu_torch", "_build")
    assert native._SRC == os.path.join(ROOT, "gala_tpu_torch", "native", "csr_ops.cpp")


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py is expected to run")
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    res = _smoke(cwd)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
