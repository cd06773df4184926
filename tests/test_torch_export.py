"""gala_tpu_torch.export against gala_tpu.export, and the custom ops the
artifact runs (ops.kernels.library), on the CPU.

The program is tests/test_export.py's fixture (a 2-layer GCN on the Cora
stand-in at scale 0.3) on `dense`, as auto picks there, and on `bell`,
plus its GAT on `bell` (the fused attention).  Each is exported, loaded
and replayed: the loaded forward is bitwise the live port forward and
within 1e-5 of gala_tpu's under the same weights, and the replay's
losses are bitwise those of a live full-graph loop (the port's
cm.forward, masked cross-entropy and make_optimizer's Adam).
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gala_tpu
import gala_tpu_torch
from gala_tpu.export import _chunk_plan as jax_chunk_plan
from gala_tpu_torch.data.datasets import load_dataset
from gala_tpu_torch.export import (
    FORMAT_VERSION, _chunk_plan, export_compiled, load_exported,
)
from gala_tpu_torch.ops.graph import Graph, moved
from gala_tpu_torch.ops.kernels import bell_spmm as kernel
from gala_tpu_torch.ops.kernels import library
from gala_tpu_torch.train import make_optimizer, masked_cross_entropy
from gala_tpu_torch.weights import params_from_jax
from tests.test_export import GAT, GCN

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = 0.3
# (program, strategy) of each artifact
PROGRAMS = {"gcn-dense": (GCN, "dense"), "gcn-bell": (GCN, "bell"), "gat-bell": (GAT, "bell")}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{name: (CompiledModel, artifact directory)}."""
    out = {}
    for name, (source, strategy) in PROGRAMS.items():
        cm = gala_tpu_torch.compile_source(source, mode="train", scale=SCALE,
                                           strategy=strategy, device="cpu")
        assert cm.full_graphs[0].strategy == strategy
        out[name] = (cm, export_compiled(cm, str(tmp_path_factory.mktemp(name))))
    return out


def _carry(cm):
    with torch.no_grad():
        return cm.invariant(cm.full_graphs, cm.x)


@pytest.mark.parametrize("name", PROGRAMS)
def test_artifact_files_and_manifest(artifacts, name):
    cm, d = artifacts[name]
    assert set(os.listdir(d)) == {"manifest.json", "state.pt", "fwd.cpu.pt2"}
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    # gala_tpu's keys, plus the optimizer's settings the replay needs
    assert set(m) == {"version", "iters", "valid_step", "chunk", "warmup", "print_accuracy",
                      "print_memory", "platforms", "dtypes", "dataset", "lr", "weight_decay"}
    assert m["version"] == FORMAT_VERSION and m["platforms"] == ["cpu"]
    assert (m["iters"], m["valid_step"], m["chunk"], m["warmup"]) == (100, 5, 4, 5)
    assert (m["lr"], m["weight_decay"]) == (cm.program.loop.lr, cm.program.loop.weight_decay)
    assert m["dataset"] == "Cora" and m["dtypes"]["params"]["weight1"]["w"] == "float32"


@pytest.mark.parametrize("name", PROGRAMS)
def test_loaded_forward_is_the_live_forward_and_gala_tpus(artifacts, name):
    """Bitwise the live port forward under the artifact's weights (with
    gradients on, as the artifact was traced); within 1e-5 of gala_tpu's
    forward under gala_tpu's initial weights, copied over."""
    cm, d = artifacts[name]
    em = load_exported(d)
    live = cm.forward(cm.make_params(0), cm.full_graphs, _carry(cm))
    assert torch.equal(em.forward(), live)

    source, strategy = PROGRAMS[name]
    jcm = gala_tpu.compile_source(source, mode="train", scale=SCALE, strategy=strategy)
    jparams = jax.device_get(jcm.make_params(0))
    jcarry = jax.jit(jcm.invariant)(jcm.full_graphs, jcm.x)
    want = np.asarray(jax.jit(jcm.forward)(jparams, jcm.full_graphs, jcarry))
    got = em.forward(params_from_jax(jparams)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["gcn-dense", "gcn-bell"])
def test_replayed_losses_are_a_live_loops(artifacts, name):
    cm, d = artifacts[name]
    params = cm.make_params(0)
    opt = make_optimizer(params, cm.program.loop.lr, cm.program.loop.weight_decay)
    carry, want = _carry(cm), []
    for _ in range(12):
        opt.zero_grad(set_to_none=True)
        loss = masked_cross_entropy(cm.forward(params, cm.full_graphs, carry), cm.labels,
                                    cm.train_mask)
        loss.backward()
        opt.step()
        want.append(loss.item())
    assert load_exported(d).train(iters=12).losses == want


def test_exported_training_reaches_accuracy(artifacts):
    """gala_tpu's test_exported_training_reaches_accuracy: 40 epochs, then
    the CSV line of 12 more from where they left off."""
    em = load_exported(artifacts["gcn-dense"][1])
    res = em.train(iters=40)
    assert res.max_accuracy > 0.8, res.max_accuracy
    assert np.isfinite(res.losses).all()
    parts = em.run(iters=12).split(",")
    assert len(parts) == 2 and all(float(p) >= 0 for p in parts)


def test_gat_export_roundtrip(artifacts):
    res = load_exported(artifacts["gat-bell"][1]).train(iters=25)
    assert res.max_accuracy > 0.6, res.max_accuracy
    assert np.isfinite(res.losses).all()


@pytest.mark.parametrize("valid_step", [0, 1, 5])
@pytest.mark.parametrize("warmup", [0, 5])
def test_chunk_plan_is_gala_tpus(valid_step, warmup):
    for iters in (1, 7, 12, 23, 100):
        for k in (1, 3, 4):
            assert (_chunk_plan(iters, valid_step, warmup, k)
                    == jax_chunk_plan(iters, valid_step, warmup, k)), (iters, k)


def test_version_guard(artifacts, tmp_path):
    d = tmp_path / "newer"
    shutil.copytree(artifacts["gcn-dense"][1], d)
    m = json.loads((d / "manifest.json").read_text())
    m["version"] = FORMAT_VERSION + 1
    (d / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="newer"):
        load_exported(str(d))


def test_older_artifact_is_refused(artifacts, tmp_path):
    """A v1 artifact packs its layouts without the warp tables: loading it
    raises and asks for a new export instead of misreading them."""
    d = tmp_path / "older"
    shutil.copytree(artifacts["gcn-dense"][1], d)
    m = json.loads((d / "manifest.json").read_text())
    m["version"] = 1
    (d / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="older.*export the program again"):
        load_exported(str(d))


def test_dynamic_sampling_refuses_export(tmp_path):
    cm = gala_tpu_torch.compile_source(GCN + "aggrFn=aggrFn.sample(5).dynamic();", mode="train",
                                       scale=SCALE, device="cpu")
    with pytest.raises(NotImplementedError, match="dynamic-sampling"):
        export_compiled(cm, str(tmp_path / "dyn"))
    assert not os.path.exists(tmp_path / "dyn")


def test_cuda_artifact_refuses_to_load_without_cuda(artifacts, tmp_path, monkeypatch):
    """The counterpart of gala_tpu's test_pallas_bell_export_lowers_tpu_only:
    an artifact for a platform this machine lacks raises, naming the
    platforms, and no plain version runs in the kernels' place."""
    d = tmp_path / "cuda_only"
    shutil.copytree(artifacts["gcn-bell"][1], d)
    m = json.loads((d / "manifest.json").read_text())
    m["platforms"] = ["cuda"]
    (d / "manifest.json").write_text(json.dumps(m))
    os.rename(d / "fwd.cpu.pt2", d / "fwd.cuda.pt2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def plain(*args, **kw):
        raise AssertionError("a plain version ran")

    monkeypatch.setattr(kernel, "bell_spmm_plain", plain)
    with pytest.raises(RuntimeError, match=r"\['cuda'\]"):
        load_exported(str(d))
    with pytest.raises(RuntimeError, match=r"\['cuda'\]"):
        load_exported(str(d), device="cpu")


def test_loader_imports_no_compiler(artifacts):
    """gala_tpu's promise: loading and replaying an artifact imports no
    parser, IR, passes or lowering module (a fresh process)."""
    code = (
        "import sys\n"
        "from gala_tpu_torch.export import load_exported\n"
        f"load_exported({artifacts['gat-bell'][1]!r}).run(iters=7)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[:2] in "
        "[['gala_tpu_torch', p] for p in ('dsl', 'ir', 'passes', 'lowering')]))\n"
        "print('jax' in sys.modules, 'gala_tpu' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout.splitlines()
    assert out[-2:] == ["[]", "False False"]


def test_graph_to_moves_every_tensor_and_keeps_views_and_aliases(artifacts):
    cm, _ = artifacts["gcn-bell"]
    g = cm.full_graphs[0]
    on_meta = moved(cm.full_graphs, "meta")
    assert on_meta[0] is on_meta[1] and on_meta[0].device == torch.device("meta")
    m = on_meta[0]
    assert m.bell.flat_vals.is_meta and m.bell.units.start.is_meta and m.deg.is_meta
    assert (m.t_bell is m.bell) == (g.t_bell is g.bell)
    assert all(v._base is m.bell.flat_vals for v in m.bell.bin_vals)
    assert m.bell.bin_ks == g.bell.bin_ks and m.n_pad == g.n_pad


# --------------------------------------------------------------------------- #
# the custom ops (torch.library.opcheck: schema, fake form, autograd
# registration, AOT dispatch) on small layouts
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def small():
    """A Cora stand-in at scale 0.05 on bell with the fused attention
    layout, and on ell with the edge lists."""
    data = load_dataset("Cora", scale=0.05, seed=0)
    bell = Graph.from_host(data[0], strategy="bell", device="cpu", attention=True)
    ell = Graph.from_host(data[0], strategy="ell", device="cpu", edge_vals=True)
    return bell, ell


def _rand(shape, seed, grad=False):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).requires_grad_(grad)


def _op_cases(bell, ell):
    la = library.layout_args
    x = _rand((bell.c_pad, 8), 0, True)
    xe = _rand((ell.c_pad, 8), 1, True)
    vals = torch.rand(ell.ell.flat_vals.shape, generator=torch.Generator().manual_seed(2))
    evals = _rand((ell.e_pad,), 3, True)
    hf, nh = 8, 2
    vl, vr = _rand((bell.c_pad, nh), 4, True), _rand((bell.n_pad, nh), 5, True)
    w_tab = _rand((bell.n_pad, hf + 4 * nh), 6).abs() + 0.5
    a, b = _rand((ell.c_pad, 8), 7), _rand((ell.n_pad, 8), 8)
    return {
        "bell_spmm-bell": (library.bell_spmm_op,
                           (x, *la(bell.bell), None, bell.n_pad, *la(bell.t_bell), bell.c_pad)),
        "bell_spmm-ell": (library.bell_spmm_op,
                          (xe, *la(ell.ell), None, ell.n_pad, *la(ell.t_ell), ell.c_pad)),
        "bell_spmm-values": (library.bell_spmm_op,
                             (xe.detach(), *la(ell.ell), vals, ell.n_pad, [], [], 0)),
        "spmm_ev": (library.spmm_ev_op, (evals, xe, *la(ell.ell), *la(ell.t_ell), ell.src,
                                         ell.dst, ell.n_pad, ell.c_pad)),
        "sddmm": (library.sddmm_op, (ell.src, ell.dst, a, b)),
        "attn_fwd-flash": (library.attn_fwd_op,
                           (x, vl, vr, *la(bell.attn.fwd), *la(bell.attn.t), 0.2, bell.n_pad,
                            bell.c_pad, True)),
        "attn_fwd": (library.attn_fwd_op,
                     (x.detach(), vl.detach(), vr.detach(), *la(bell.attn.fwd),
                      *la(bell.attn.t), 0.2, bell.n_pad, bell.c_pad, False)),
        "attn_bwd2": (library.attn_bwd2_op,
                      (x.detach(), vl.detach(), w_tab, *la(bell.attn.t), 0.2, bell.c_pad)),
    }


OP_CASES = ["bell_spmm-bell", "bell_spmm-ell", "bell_spmm-values", "spmm_ev", "sddmm",
            "attn_fwd-flash", "attn_fwd", "attn_bwd2"]


@pytest.mark.parametrize("case", OP_CASES)
def test_opcheck(small, case):
    op, args = _op_cases(*small)[case]
    torch.library.opcheck(op, args)


def test_ops_are_the_direct_bindings_on_the_cpu(small):
    """Each op on CPU tensors equals its direct wrapper (the plain
    version), bitwise, and the layouts survive the op boundary."""
    from gala_tpu_torch.ops.kernels import attn_bell, sddmm

    bell, ell = small
    cases = _op_cases(bell, ell)
    x, *_ = cases["bell_spmm-bell"][1]
    assert torch.equal(library.spmm(x, bell.bell, bell.t_bell, bell.n_pad, bell.c_pad),
                       kernel.bell_spmm(bell.bell, x, bell.n_pad))
    args = cases["bell_spmm-values"][1]
    xe, vals = args[0], args[3]
    assert torch.equal(library.bell_spmm_op(xe, *library.layout_args(ell.ell), vals, ell.n_pad,
                                            [], [], 0),
                       kernel.bell_spmm(ell.ell, xe, ell.n_pad, vals))
    src, dst, a, b = cases["sddmm"][1]
    assert torch.equal(library.sddmm_op(src, dst, a, b), sddmm.sddmm(src, dst, a, b))
    x, vl, vr = (t.detach() for t in cases["attn_fwd-flash"][1][:3])
    got = library.attn_fwd_op(x, vl, vr, *library.layout_args(bell.attn.fwd),
                              *library.layout_args(bell.attn.t), 0.2, bell.n_pad, bell.c_pad,
                              True)
    want = attn_bell.attn_fwd(bell.attn.fwd, x, vl, vr, 0.2, bell.n_pad, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for lay in (bell.bell, bell.t_bell, ell.ell, ell.t_ell, bell.attn.fwd):
        back = library.layout_of(*library.layout_args(lay))
        assert type(back) is type(lay) and library.layout_args(back)[1] == \
            library.layout_args(lay)[1]


@pytest.mark.parametrize("name", ["bell", "t_bell", "ell", "attn_fwd"])
def test_layout_packed_the_old_way_is_refused(small, name):
    """A layout packed as before the warp tables (seven unit fields, no
    table offsets, no n_written) raises in layout_of instead of giving the kernels a
    first optional tensor as their table."""
    bell, ell = small
    lay = {"bell": bell.bell, "t_bell": bell.t_bell, "ell": ell.ell,
           "attn_fwd": bell.attn.fwd}[name]
    tensors, ints = library.layout_args(lay)
    n_unit = len(library._UNIT_FIELDS)
    old_tensors = tensors[: 4 + n_unit] + tensors[5 + n_unit :]
    old_ints = ints[:5] + ints[6 + len(lay.units.warp_off) :]
    with pytest.raises(ValueError, match="export it again"):
        library.layout_of(old_tensors, old_ints)
    with pytest.raises(ValueError, match="export it again"):
        library.layout_of(tensors[:-1] if len(tensors) > 5 + n_unit else tensors + [tensors[0]],
                          ints)
    assert type(library.layout_of(tensors, ints)) is type(lay)
