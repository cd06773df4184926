"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (gala_tpu_torch begins with gala_tpu), and the
reference imports nothing of the port."""
import json
import os
import subprocess
import sys
import textwrap

from gala_bench import cell as cells

RUN_SMALL = textwrap.dedent("""
    import dataclasses, json, sys
    sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
    import torch
    torch.set_num_threads(2)
    from conftest import SMALL
    from gala_bench import cell as cells
    c = dataclasses.replace(cells.find_cell({workload!r}), traffic=SMALL)
    res = cells.run_cell(c, 3, 0.1, False, "cpu")
    print(json.dumps({{"correct": res["correct"], "modules": sorted(sys.modules)}}))
""")


def _python(code: str) -> dict:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_banned_names_are_whole_top_level_names(monkeypatch):
    for name in ("gala_tpu_torch", "gala_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    before = cells.banned_modules()
    assert not any(m.startswith(("gala_tpu_torch", "jaxtyping", "flaxen")) for m in before)
    monkeypatch.setitem(sys.modules, "gala_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert {"gala_tpu.ops", "jax"} <= set(cells.banned_modules())


def test_a_run_loads_no_jax_and_no_jax_package():
    tests = os.path.dirname(os.path.abspath(__file__))
    got = _python(RUN_SMALL.format(root=cells.ROOT, tests=tests, workload="gcn2-h32.reddit"))
    assert got["correct"]
    tops = {m.split(".")[0] for m in got["modules"]}
    assert "gala_tpu_torch" in tops
    assert not tops & set(cells.BANNED)


def test_the_reference_imports_nothing_of_the_port():
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {cells.ROOT!r})
        from gala_bench import check, reference, work
        import importlib.util, glob
        for path in glob.glob({os.path.join(cells.HERE, "configs", "*.py")!r}):
            spec = importlib.util.spec_from_file_location("ref", path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print(json.dumps({{"modules": sorted(sys.modules)}}))
    """)
    tops = {m.split(".")[0] for m in _python(code)["modules"]}
    assert not tops & {"gala_tpu_torch", *cells.BANNED}
