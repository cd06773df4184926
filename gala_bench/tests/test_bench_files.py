"""Every configuration, traffic, metric and limits file of BENCHMARK.json
is found by name, and the declaration keeps to its own rules."""
import json
import os
import re

import pytest

from gala_bench import cell as cells

ROOT = cells.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(workload):
    c = cells.find_cell(workload)
    assert c.config["name"] == next(w for w in BENCH["workloads"]
                                    if w["name"] == workload)["config"]
    for attr in ("LAYERS", "shapes", "prefix", "forward"):
        assert hasattr(c.model, attr)
    assert {"nodes", "features", "classes", "draws", "nonzeros_target", "graph_seed",
            "split"} <= set(c.traffic)
    assert {"loss_gap", "change_gap"} <= set(c.limits) <= {
        "loss_gap", "grad_gap", "grad_gap_med", "change_gap"}
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "epoch_ms"}
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    mod = cells.load_module(os.path.join(cells.HERE, "metrics", f"{metric}.py"), metric)
    assert callable(mod.read)


def test_names_units_and_keys():
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert c["file"].startswith("gala_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024
