"""The port's pipeline parallelism (gala_tpu_torch.parallel.pp) against
gala_tpu's, on the CPU.

gala_tpu runs on the conftest's 8 virtual CPU devices; the port runs as 4
gloo ranks on the CPU, spawned once for the module (parallel.multihost.
spawn with parallel.worker.run_jobs, a FileStore in tmp_path, a 60 s
group timeout), each rank writing its results for the tests to compare.
The spawned ranks import neither JAX nor gala_tpu.

Tolerances: gpipe's output and per-stage gradients at rtol 1e-5, atol
1e-6 (f32, sums in another order); the SAGE pipeline's first loss at rtol
1e-5, its gradients at rtol 1e-5, atol 1e-6 (against jax.grad of the
sequential program), its updated params at rtol 1e-4, atol 1e-5
(tests/test_pp.py's), 8 steps' losses at rtol 1e-4; the merged params'
full-graph logits at rtol 1e-5, atol 1e-6.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gala_tpu.data.synthetic import synthetic_dataset as jax_dataset
from gala_tpu.models import sage as jax_sage
from gala_tpu.ops.graph import Graph as JaxGraph
from gala_tpu.parallel.pp import gpipe as jax_gpipe
from gala_tpu.parallel.pp import make_pipe_mesh as jax_pipe_mesh
from gala_tpu.parallel.pp import make_sage_pipeline as jax_sage_pipeline
from gala_tpu.parallel.pp import merge_sage_params as jax_merge
from gala_tpu.parallel.pp import stack_stage_params
from gala_tpu.train_minibatch import forward_minibatch as jax_forward_minibatch
from gala_tpu_torch.data.minibatch import NeighborSampler
from gala_tpu_torch.data.synthetic import synthetic_dataset as torch_dataset
from gala_tpu_torch.parallel import multihost, pp, worker
from gala_tpu_torch.weights import stage_params_from_jax, stage_params_to_jax

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
TIMEOUT = 60  # seconds: a shift no rank matches fails the spawn after it
DATA = dict(n=300, avg_degree=8, n_feats=24, n_classes=5, seed=7)
GPIPE = dict(stages=4, b=8, w=16, seed=0)
# name: (n_micro, w_out): tests/test_pp.py's case, a narrower output, a
# stream shorter than the pipeline
GPIPE_CASES = {"full": (6, 16), "narrow": (6, 10), "short": (2, 16)}
SAGE = dict(f1=4, f2=3, b=16, hidden=8, seed=3, steps=8)


def _jax_stage(pl, h, idx):
    return jax.nn.relu(h @ pl["w"])


def _jax_gpipe(n_micro, w_out):
    """gala_tpu's gpipe on gpipe_inputs: the output, the gradient of
    sum(out^2) per stage (P, W, W), and the sequential NumPy product."""
    mats, xs = worker.gpipe_inputs(GPIPE["stages"], GPIPE["b"], GPIPE["w"], n_micro,
                                   GPIPE["seed"])
    mesh = jax_pipe_mesh(GPIPE["stages"])
    stacked = stack_stage_params([{"w": jnp.asarray(m)} for m in mats])

    def run(sp):
        return jax_gpipe(mesh, _jax_stage, sp, jnp.asarray(xs), w_out=w_out)

    grads = jax.grad(lambda sp: jnp.sum(run(sp) ** 2))(stacked)
    ref = xs
    for m in mats:
        ref = np.maximum(ref @ m, 0.0)
    return np.asarray(run(stacked)), np.asarray(grads["w"]), ref[..., :w_out]


@pytest.fixture(scope="module")
def gpipe_refs():
    return {name: _jax_gpipe(*case) for name, case in GPIPE_CASES.items()}


@pytest.fixture(scope="module")
def micro():
    """One epoch of the shared sampler on the port's copy of the data
    (tests/test_pp.py's stream), as numpy."""
    g, feats, labels, masks = torch_dataset(**DATA)
    sampler = NeighborSampler(g, (SAGE["f1"], SAGE["f2"]), SAGE["b"])
    train = np.flatnonzero(np.asarray(masks["train"]))
    if train.size < 2 * SAGE["b"]:
        train = np.arange(g.n_rows)
    eb = sampler.epoch(train, 0, seed=0, dynamic=False)
    y = np.asarray(labels, np.int64)[eb.targets].astype(np.int32)
    return {"t": eb.targets, "n1": eb.n1, "n2": eb.n2, "y": y, "m": eb.mask}


@pytest.fixture(scope="module")
def sage_ref(micro):
    """gala_tpu's make_sage_pipeline on make_pipe_mesh(2): the initial
    stacked params, 8 losses, the merged params after step 1, and
    models.sage.forward's full-graph logits of the merged initial params."""
    g_host, feats, labels, _ = jax_dataset(**DATA)
    xt = jnp.asarray(feats, jnp.float32)
    params, opt, step = jax_sage_pipeline(jax_pipe_mesh(2), xt, f1=SAGE["f1"],
                                          hidden=SAGE["hidden"],
                                          n_classes=int(labels.max()) + 1, seed=SAGE["seed"])
    init = jax.device_get(params)
    g = JaxGraph.from_host(g_host)
    logits0 = np.asarray(jax_sage.forward(jax_merge(init), [g, g],
                                          g.pad_nodes(np.asarray(feats, np.float32))))
    batch = {k: jnp.asarray(v) for k, v in micro.items()}
    grads = jax.device_get(jax.grad(_sequential_loss)(
        jax_sage.init(jax.random.key(SAGE["seed"]), feats.shape[1], [SAGE["hidden"]],
                      int(labels.max()) + 1), xt, batch))
    losses = []
    for i in range(SAGE["steps"]):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        if i == 0:
            merged1 = jax.device_get(jax_merge(params))
    return {"init": init, "losses": losses, "merged1": merged1, "grads": grads,
            "logits0": logits0[: g_host.n_rows]}


def _sequential_loss(params, xt, batch):
    """tests/test_pp.py's sequential oracle: the mean over microbatches of
    each one's masked mean NLL, gala_tpu's forward_minibatch."""
    total = 0.0
    n_micro = batch["t"].shape[0]
    for i in range(n_micro):
        logits = jax_forward_minibatch(params, xt, batch["t"][i], batch["n1"][i],
                                       batch["n2"][i])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        nll = -jnp.take_along_axis(logp, batch["y"][i][:, None], 1)[:, 0]
        m = batch["m"][i].astype(jnp.float32)
        total = total + jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)
    return total / n_micro


@pytest.fixture(scope="module")
def results(tmp_path_factory, micro, sage_ref):
    tmp = tmp_path_factory.mktemp("pipe")
    worker.dump(micro, str(tmp / "micro.pkl"))
    worker.dump(sage_ref["init"], str(tmp / "sage.weights.pkl"))
    jobs = [dict(kind="pp_gpipe", name="gpipe", mesh=(GPIPE["stages"],), device="cpu",
                 b=GPIPE["b"], w=GPIPE["w"], seed=GPIPE["seed"], cases=GPIPE_CASES),
            dict(kind="pp_sage", name="sage", mesh=(2,), device="cpu", data=("synthetic", DATA),
                 f1=SAGE["f1"], hidden=SAGE["hidden"], seed=SAGE["seed"], steps=SAGE["steps"],
                 micro=str(tmp / "micro.pkl"), weights=str(tmp / "sage.weights.pkl"),
                 logits=True)]
    multihost.spawn(worker.run_jobs, 4, "gloo", jobs, str(tmp), store=str(tmp / "store"),
                    timeout=TIMEOUT)
    return {job["name"]: worker.read_results(str(tmp), job["name"]) for job in jobs}


# --------------------------------------------------------------------------- #
# gpipe
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(GPIPE_CASES))
def test_gpipe_matches_gala_tpu(results, gpipe_refs, case):
    want, _, seq = gpipe_refs[case]
    n_micro, w_out = GPIPE_CASES[case]
    ranks = results["gpipe"]
    assert sorted(ranks) == list(range(GPIPE["stages"]))
    assert want.shape == (n_micro, GPIPE["b"], w_out)
    for rank, r in ranks.items():  # the output is on every rank
        got = r["cases"][case]["out"]
        np.testing.assert_allclose(got, want, err_msg=f"rank {rank}", **TOL)
        np.testing.assert_allclose(got, seq, err_msg=f"rank {rank}", **TOL)


@pytest.mark.parametrize("case", list(GPIPE_CASES))
def test_gpipe_gradients_match_gala_tpu(results, gpipe_refs, case):
    _, want, _ = gpipe_refs[case]
    for stage, r in results["gpipe"].items():
        got = r["cases"][case]["grad"]
        assert np.abs(want[stage]).max() > 0
        np.testing.assert_allclose(got, want[stage], err_msg=f"stage {stage}", **TOL)


# --------------------------------------------------------------------------- #
# the SAGE pipeline
# --------------------------------------------------------------------------- #
def test_sage_step_matches_gala_tpu(results, sage_ref):
    ranks = results["sage"]
    assert sorted(ranks) == [0, 1]
    want = sage_ref["merged1"]
    for rank, r in ranks.items():
        np.testing.assert_allclose(r["losses"][0], sage_ref["losses"][0], rtol=1e-5)
        for part in ("fc", "sfc"):
            for li in range(2):
                for k in ("w", "b"):
                    np.testing.assert_allclose(r["merged1"][part][li][k],
                                               np.asarray(want[part][li][k]),
                                               err_msg=f"rank {rank} {part}[{li}].{k}",
                                               **PARAM_TOL)


def test_sage_gradients_match_gala_tpu(results, sage_ref):
    """Each stage's gradients of step 1 against jax.grad of the sequential
    program (gala_tpu's forward_minibatch), layer l + 1 on stage l."""
    want = sage_ref["grads"]
    for stage, r in results["sage"].items():
        assert sorted(r["grads1"]) == sorted(f"l{stage + 1}.{part}.{k}" for part in ("fc", "sfc")
                                             for k in ("w", "b"))
        for name, got in r["grads1"].items():
            _, part, k = name.split(".")
            np.testing.assert_allclose(got, np.asarray(want[part][stage][k]),
                                       err_msg=f"stage {stage} {name}", **TOL)


def test_sage_losses_match_gala_tpu(results, sage_ref):
    want = sage_ref["losses"]
    assert want[-1] < want[0]
    for r in results["sage"].values():
        assert len(r["losses"]) == SAGE["steps"]
        np.testing.assert_allclose(r["losses"], want, rtol=1e-4)
        assert r["losses"][-1] < r["losses"][0]


def test_merged_logits_match_gala_tpu(results, sage_ref):
    want = sage_ref["logits0"]
    for rank, r in results["sage"].items():
        np.testing.assert_allclose(r["logits0"][: want.shape[0]], want,
                                   err_msg=f"rank {rank}", **TOL)


def test_plain_gather_calls_by_stage(results, micro):
    n_micro = micro["t"].shape[0]
    ranks = results["sage"]
    assert ranks[0]["n_micro"] == n_micro
    assert ranks[0]["gather_calls"] == 3 * n_micro * SAGE["steps"]
    assert ranks[1]["gather_calls"] == 0


def test_stage_params_round_trip(sage_ref):
    init = sage_ref["init"]
    stages = [stage_params_from_jax(init, s) for s in range(2)]
    assert list(stages[0].keys()) == ["l1"] and list(stages[1].keys()) == ["l2"]
    back = stage_params_to_jax(stages)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), init, back)


# --------------------------------------------------------------------------- #
# errors
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_stages", [1, 3])
def test_sage_wiring_needs_two_stages(n_stages):
    mesh = pp.PipeMesh(n_stages=n_stages, stage=0, group=None, device=torch.device("cpu"),
                       backend="gloo")
    with pytest.raises(ValueError, match="2-stage"):
        pp.make_sage_pipeline(mesh, torch.zeros(4, 3), f1=2, hidden=4, n_classes=2)


def test_pipe_mesh_past_the_world_raises():
    made = not dist.is_initialized()
    try:
        world = multihost.initialize(backend="gloo")
        with pytest.raises(ValueError, match=f"need {world + 1} ranks, have {world}"):
            pp.make_pipe_mesh(world + 1, backend="gloo")
    finally:
        if made:
            dist.destroy_process_group()


def test_nccl_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: nccl can run")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        pp.make_pipe_mesh(2, backend="nccl")
    job = dict(kind="pp_gpipe", name="nccl", mesh=(2,), b=2, w=2, seed=0, cases={"one": (1, 2)})
    with pytest.raises(RuntimeError, match="needs CUDA"):
        multihost.spawn(worker.run_jobs, 2, "nccl", [job], str(tmp_path))


def test_spawn_raises_the_root_cause_and_names_every_rank(tmp_path):
    """Rank 1 leaves the group, so rank 0's receive fails with a lost
    connection and rank 0 ends first; rank 1 then raises the chosen error.
    spawn raises that error, not the lost connection, and names both
    ranks."""
    job = dict(kind="lost_peer", name="lost_peer", mesh=(2,), device="cpu", delay=3.0,
               error="the chosen error")
    with pytest.raises(Exception, match="the chosen error") as info:
        multihost.spawn(worker.run_jobs, 2, "gloo", [job], str(tmp_path),
                        store=str(tmp_path / "store"), timeout=TIMEOUT)
    msg = str(info.value)
    assert "rank 1 of 2 failed, the root cause" in msg and "rank 0: " in msg
    assert any(s in msg for s in multihost.PEER_LOST)


LOST = "RuntimeError: [pair.cc:534] Connection closed by peer [127.0.0.1]:4242"


@pytest.mark.parametrize("errors,stopped,want", [
    ({0: LOST, 1: "DistBackendError: Timed out waiting 5000ms"}, set(), 1),
    ({0: "ValueError: a", 1: "ValueError: b"}, set(), 0),
    ({0: LOST, 1: "rank exited: signal SIGKILL"}, set(), 1),
    ({0: "rank exited: terminated by spawn after 30 s", 1: LOST}, {0}, 1),
    ({2: LOST, 3: LOST}, set(), 2),
], ids=["timeout-after-lost-peer", "two-causes", "killed", "stopped", "all-lost"])
def test_root_cause_ranks_a_rank_own_error_first(errors, stopped, want):
    """A rank's own error comes before a death without a traceback, which
    comes before a lost peer, which comes before a rank spawn stopped;
    among equals the lowest rank."""
    assert multihost.root_cause(errors, stopped) == want


def test_unmatched_shift_fails_within_the_timeout(tmp_path):
    """Ranks that disagree on the stream's length: the next stage waits
    for a shift that never comes, and the group's timeout ends the spawn."""
    job = dict(kind="pp_unmatched", name="unmatched", mesh=(2,), device="cpu")
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="Timed out"):
        multihost.spawn(worker.run_jobs, 2, "gloo", [job], str(tmp_path),
                        store=str(tmp_path / "store"), timeout=5)
    assert time.perf_counter() - t0 < TIMEOUT
