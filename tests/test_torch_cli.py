"""The port's command line (`python -m gala_tpu_torch ...`, driven
in-process through gala_tpu_torch.__main__.main) and the device default of
its entry points: each runs on the card unless the caller asks for the
CPU, and without a card a call that leaves the device out fails with
torch's own CUDA error."""
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
GIN = os.path.join(REPO, "examples", "gin.txt")
SMALL = ["--scale", "0.005"]  # the Arxiv stand-in at 846 nodes


@pytest.mark.parametrize("command,n_fields", [("inference_sample", 3), ("train", 2),
                                             ("train_memory", 3)])
def test_cli_prints_the_csv_line(command, n_fields, capsys):
    main([command, GIN, "--device", "cpu", *SMALL, "--iters", "3"])
    fields = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert len(fields) == n_fields
    assert all(math.isfinite(float(v)) for v in fields)


@pytest.mark.parametrize("command,item", [("inference_long", "Queue 1 item 9"),
                                         ("export", "Queue 1 item 11"),
                                         ("run_exported", "Queue 1 item 11")])
def test_cli_unported_commands_raise(command, item):
    with pytest.raises(NotImplementedError, match=item):
        main([command, GIN, "--device", "cpu", *SMALL])


def test_cli_bf16_raises_as_lower_does(capsys):
    """`--dtype bf16` reaches lower as dtype=torch.bfloat16, which now runs
    (bf16 activations, f32 params): the CSV line of inference_sample, three
    finite fields, as in the command the README gives."""
    main(["inference_sample", GIN, "--device", "cpu", "--dtype", "bf16", "--scale", "0.01",
          "--iters", "3"])
    fields = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert len(fields) == 3 and all(math.isfinite(float(v)) for v in fields)


@pytest.mark.parametrize("fn", [lower, api.compile_source, api.compile_file, api.compile_model,
                                Graph.from_host, train_sage_minibatch],
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
