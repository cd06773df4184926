"""scripts/evaluate_torch.py, the port's twin of scripts/evaluate.py: the
same DSL text for every model and schedule, the same jobs and CSV
headers, well-formed rows from tiny CPU runs, table5's labelled
`all-tiled` row, and the card as the default device."""
import argparse
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


evaluate = _load("evaluate")
twin = _load("evaluate_torch")


def headers(path):
    """{job: the header of the stat CSV its job function appends to}."""
    src = open(path).read()
    blocks = re.split(r"^def job_", src, flags=re.M)[1:]
    return {b.split("(", 1)[0]: re.search(r'append_csv\(\s*out,\s*"([^"]+)"', b).group(1)
            for b in blocks}


def test_every_job_writes_the_same_header():
    want = headers(os.path.join(REPO, "scripts", "evaluate.py"))
    assert sorted(want) == sorted(evaluate.JOBS) == sorted(twin.JOBS)
    assert headers(os.path.join(REPO, "scripts", "evaluate_torch.py")) == want


@pytest.mark.parametrize("model", ["gcn", "gat", "gin", "sage"])
def test_make_dsl_text_equals_evaluate(model):
    schedules = ["", "print_memory(true);\n", "G=G.sample(20);\n",
                 "aggrFn=aggrFn.sample(20).dynamic();\n", 'G=G.opt_input("Arxiv");\n',
                 "aggrFn=aggrFn.coarsen(2);\nG=G.col_tile(37000);\n"]
    for layers, hidden, iters, heads in ((2, 32, 100, 1), (3, 64, 30, 4), (8, 1024, 6, 2)):
        for schedule in schedules:
            kw = dict(layers=layers, hidden=hidden, iters=iters, schedule=schedule, heads=heads)
            assert twin.make_dsl(model, "Cora", **kw) == evaluate.make_dsl(model, "Cora", **kw)


def test_flags_are_evaluate_s_with_device_for_platform():
    ours = {a.dest: a.default for a in twin.parser()._actions if a.dest != "help"}
    assert ours.pop("device") == "cuda" and ours.pop("outdir") == "results_torch"
    src = open(os.path.join(REPO, "scripts", "evaluate.py")).read()
    theirs = set(re.findall(r'add_argument\("--([a-z0-9-]+)"', src))
    theirs = {d.replace("-", "_") for d in theirs} - {"platform", "outdir"}
    assert set(ours) == theirs


def _args(tmp_path, **kw):
    base = dict(iters=6, scale=0.02, datasets=["Cora"], models=["gcn"], fractions=[0.01],
                layers=[2], hidden=[8], outdir=str(tmp_path), device="cpu", t6_dataset="Cora",
                torch_dtype=None, data_root=None, heads=1, strategy="auto", tag="")
    base.update(kw)
    return argparse.Namespace(**base)


def _rows(tmp_path, name, job):
    lines = open(os.path.join(str(tmp_path), name)).read().strip().splitlines()
    assert lines[0] == headers(os.path.join(REPO, "scripts", "evaluate.py"))[job]
    return [ln.split(",") for ln in lines[1:]]


def test_fig16_rows_at_auto_and_pallas_bell(tmp_path, monkeypatch):
    """gcn and gat at 'auto' ('dense' at this size) and at 'pallas_bell'
    (the bell layout, the fused attention on the GAT) with the tag on
    the label."""
    layouts = []
    real = twin.run_one

    def run_one(src, **kw):
        cm, res = real(src, **kw)
        g = cm.full_graphs[0]
        layouts.append((g.strategy, g.attn is not None))
        return cm, res

    monkeypatch.setattr(twin, "run_one", run_one)
    twin.job_fig16(_args(tmp_path, models=["gcn", "gat"]))
    twin.job_fig16(_args(tmp_path, models=["gcn", "gat"], strategy="pallas_bell", tag="pallas"))
    assert layouts == [("dense", False), ("dense", False), ("bell", False), ("bell", True)]
    rows = _rows(tmp_path, "stat_fig16.csv", "fig16")
    assert [r[1] for r in rows] == ["gcn", "gat", "gcn-pallas", "gat-pallas"]
    for r in rows:
        assert r[0] == "Cora" and r[5] == "synthetic"
        assert all(np.isfinite(float(v)) for v in r[2:5]) and 0.0 <= float(r[4]) <= 1.0


def test_table7_rows(tmp_path):
    twin.job_table7(_args(tmp_path))
    rows = _rows(tmp_path, "stat_table7.csv", "table7")
    assert [r[1] for r in rows] == ["none", "data", "kernel", "dynamic"]
    assert all(r[4] == "synthetic" and np.isfinite(float(r[2])) for r in rows)


def test_table5_labels_its_tiled_all_row(tmp_path, monkeypatch):
    """The port tiles as written: no GALA_FORCE_COL_TILE is set, and the
    last row, cir and dir together, says so in its label."""
    seen = []
    real = twin.run_one

    def run_one(src, **kw):
        seen.append((os.environ.get("GALA_FORCE_COL_TILE"), "col_tile(37000)" in src,
                     kw["strategy"]))
        return real(src, **kw)

    monkeypatch.setattr(twin, "run_one", run_one)
    twin.job_table5(_args(tmp_path, iters=3))
    rows = _rows(tmp_path, "stat_table5.csv", "table5")
    assert [r[1] for r in rows] == ["none", "cir", "dir", "all-tiled"]
    assert seen == [(None, False, "segment"), (None, False, "bell"),
                    (None, True, "segment_scan"), (None, True, "bell")]


def test_the_twin_runs_on_the_card_unless_asked_and_records_the_device(tmp_path):
    assert twin.parser().parse_args(["--job", "fig16"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            twin.main(["--job", "fig16", "--outdir", str(tmp_path)])
        assert not os.path.exists(tmp_path / "stat_fig16.csv")
    twin.main(["--job", "fig18", "--device", "cpu", "--datasets", "Cora", "--scale", "0.02",
               "--iters", "2", "--layers", "2", "--hidden", "8", "--outdir", str(tmp_path)])
    lines = open(tmp_path / "devices.csv").read().splitlines()
    assert lines[0] == "job,datasets,scale,iters,strategy,tag,device,torch,cuda"
    assert lines[1].startswith('fig18,Cora,0.02,2,auto,,"cpu",')
    # the run ends by rendering its RESULTS.md, titled with the device it ran on
    title = open(tmp_path / "RESULTS.md").read().splitlines()[0]
    assert title.startswith("# Results — gala_tpu_torch on cpu") and "TPU" not in title


CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.mark.parametrize("cards", [[CARD], [CARD, "NVIDIA H100 80GB HBM3, 500.00 W"]],
                         ids=["one-card", "two-cards"])
def test_results_md_names_the_card_of_devices_csv(tmp_path, cards):
    """render() writes RESULTS.md from a results_torch-shaped folder:
    report.py's tables of the stat CSVs under a title and header that
    name every card of devices.csv (name and power limit as nvidia-smi
    gives them), with no TPU in the title, header or notes."""
    with open(tmp_path / "devices.csv", "w") as f:
        f.write("job,datasets,scale,iters,strategy,tag,device,torch,cuda\n")
        for job, card in zip(("fig16", "table5"), cards * 2):
            f.write(f'{job},Arxiv,1.0,30,auto,,"{card}",2.11.0+cu128,12.8\n')
    with open(tmp_path / "stat_fig16.csv", "w") as f:
        f.write("dataset,model,inference_time,total_time,accuracy,data\n"
                "Arxiv,gcn,0.0002,0.0021,0.834,synthetic\n"
                "Arxiv,gcn,0.0003,0.0024,0.833,synthetic\n")
    with open(tmp_path / "stat_table5.csv", "w") as f:
        f.write("dataset,opt,inference_time,total_time\nArxiv,all-tiled,0.001,0.002\n")
    path = twin.render(str(tmp_path))
    text = open(path).read()
    title, body = text.split("\n", 1)
    assert path == str(tmp_path / "RESULTS.md")
    want = f"# Results — gala_tpu_torch on {'; '.join(cards)}, host-timed per-epoch means"
    assert title == want
    head = body.split("\n## ")[0]
    assert all(card in head for card in cards) and "torch 2.11.0+cu128, CUDA 12.8" in head
    assert "TPU" not in text and "v5e" not in text
    # report.py's tables: the newest row per config, its number formats
    assert "| Arxiv | gcn | 0.0003 | 0.0024 | 0.833 | synthetic |" in text
    assert "| Arxiv | gcn | 0.0002 |" not in text and "all-tiled" in text
