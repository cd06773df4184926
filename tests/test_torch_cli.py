"""The port's command line (`python -m gala_tpu_torch ...`, driven
in-process through gala_tpu_torch.__main__.main) and the device default of
its entry points: each runs on the card unless the caller asks for the
CPU, and without a card a call that leaves the device out fails with
torch's own CUDA error."""
import importlib.util
import inspect
import math
import os

import pytest
import torch

import gala_tpu_torch.api as api
from gala_tpu_torch.__main__ import main
from gala_tpu_torch.data.synthetic import synthetic_dataset
from gala_tpu_torch.lowering.lower import lower
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.train_minibatch import train_sage_minibatch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "evaluate_torch", os.path.join(REPO, "scripts", "evaluate_torch.py"))
evaluate_torch = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(evaluate_torch)
GIN = os.path.join(REPO, "examples", "gin.txt")
GCN = os.path.join(REPO, "examples", "gcn.txt")
SMALL = ["--scale", "0.005"]  # the Arxiv stand-in at 846 nodes


@pytest.mark.parametrize("command,n_fields", [("inference_sample", 3), ("train", 2),
                                             ("train_memory", 3), ("inference_long", 2)])
def test_cli_prints_the_csv_line(command, n_fields, capsys):
    main([command, GIN, "--device", "cpu", *SMALL, "--iters", "3"])
    fields = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert len(fields) == n_fields
    assert all(math.isfinite(float(v)) for v in fields)


@pytest.mark.parametrize("program", [GIN, GCN])
def test_cli_export_then_run_exported(program, tmp_path, capsys):
    """gala_tpu's test_cli_export_and_run: `export` prints the artifact's
    directory, `run_exported` replays it and prints the CSV line of
    gala_tpu's shape (two fields for a program without print flags)."""
    out = str(tmp_path / "artifact")
    main(["export", program, "-o", out, "--device", "cpu", *SMALL])
    assert capsys.readouterr().out.strip().splitlines()[-1] == out
    main(["run_exported", out, "--device", "cpu", "--iters", "7"])
    fields = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert len(fields) == 2 and all(math.isfinite(float(v)) for v in fields)


def test_cli_bf16_raises_as_lower_does(capsys):
    """`--dtype bf16` reaches lower as dtype=torch.bfloat16, which now runs
    (bf16 activations, f32 params): the CSV line of inference_sample, three
    finite fields, as in the command the README gives."""
    main(["inference_sample", GIN, "--device", "cpu", "--dtype", "bf16", "--scale", "0.01",
          "--iters", "3"])
    fields = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert len(fields) == 3 and all(math.isfinite(float(v)) for v in fields)


@pytest.mark.parametrize("fn", [lower, api.compile_source, api.compile_file, api.compile_model,
                                Graph.from_host, train_sage_minibatch, evaluate_torch.run_one],
                         ids=lambda fn: fn.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")


def test_leaving_out_the_device_fails_without_a_card():
    _no_card()
    g, feats, labels, masks = synthetic_dataset(n=64, avg_degree=4, n_feats=4, n_classes=2,
                                                seed=0)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        Graph.from_host(g, strategy="dense")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        api.compile_file(GIN, data=(g, feats, labels, masks))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        main(["inference", GIN, *SMALL, "--iters", "1"])
