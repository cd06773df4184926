"""gala_tpu_torch.ops.spmm against gala_tpu.ops.spmm on the bell strategy:
forward and the gradient of x, on the graph cases of test_torch_graph.

JAX runs its XLA executors on the CPU (strategy 'bell' passed explicitly);
the port runs the plain PyTorch version of the kernel, which is what its
wrapper runs for CPU tensors.  Tolerance rtol=atol=1e-5: both sides sum
in f32 and differ only in the order of the sum."""
import jax
import numpy as np
import pytest
import torch

from gala_tpu.data.csr import densify
from gala_tpu.ops.spmm import spmm as jspmm
from gala_tpu_torch.ops.kernels import bell_spmm as kernel
from gala_tpu_torch.ops.spmm import bell_spmm_reference, spmm
from tests.test_torch_graph import CASES, graph_pair

torch.set_num_threads(2)

WIDTHS = [1, 32, 40, 128]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=CASES)
def graphs(request):
    return (*graph_pair(request.param), request.param)


def _x(rows, f, seed):
    return np.random.default_rng(seed).normal(size=(rows, f)).astype(np.float32)


def _real(g, x):
    """Zero the padding rows, as the features the lowering pads."""
    x = x.copy()
    x[g.n_cols:] = 0.0
    return x


# every width is a column slice of one wide input, so JAX compiles one
# forward and one vjp per graph (SpMM acts on each column alone)
_OFFS = np.cumsum([0] + WIDTHS)


def _cols(a, f):
    i = WIDTHS.index(f)
    return np.ascontiguousarray(a[:, _OFFS[i] : _OFFS[i + 1]])


@pytest.fixture(scope="module")
def jax_results(graphs):
    jg, tg, _, _ = graphs
    x = _real(tg, _x(tg.c_pad, _OFFS[-1], seed=1))
    dz = _x(tg.n_pad, _OFFS[-1], seed=2)
    fwd = jax.jit(jspmm)(jg, x)
    (grad,) = jax.jit(lambda g, v, d: jax.vjp(lambda u: jspmm(g, u), v)[1](d))(jg, x, dz)
    return x, dz, np.asarray(fwd), np.asarray(grad)


@pytest.mark.parametrize("f", WIDTHS)
def test_forward_matches_jax_and_dense(graphs, jax_results, f):
    _, tg, host, _ = graphs
    x, want = _cols(jax_results[0], f), _cols(jax_results[2], f)
    xt = torch.from_numpy(x)
    ref = bell_spmm_reference(tg.bell, xt, tg.n_pad).numpy()
    out = spmm(tg, xt).numpy()
    np.testing.assert_allclose(ref, want, **TOL)
    np.testing.assert_allclose(out, want, **TOL)
    dense = densify(host).astype(np.float64) @ x[: tg.n_cols].astype(np.float64)
    np.testing.assert_allclose(out[: tg.n_nodes], dense, **TOL)
    assert out.shape == (tg.n_pad, f) and not out[tg.n_nodes:].any()


@pytest.mark.parametrize("f", WIDTHS)
def test_grad_matches_jax_vjp(graphs, jax_results, f):
    _, tg, _, _ = graphs
    x, dz, want = (_cols(jax_results[i], f) for i in (0, 1, 3))
    xt = torch.from_numpy(x).requires_grad_(True)
    spmm(tg, xt).backward(torch.from_numpy(dz))
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)


@pytest.mark.parametrize("f", WIDTHS)
def test_units_emulation_matches_jax(graphs, jax_results, f):
    """The kernel's two passes in plain PyTorch (work units, partials of
    the split rows, their merge in unit order) against gala_tpu's
    _bell_raw: the forward on bell and the backward's product on t_bell."""
    _, tg, _, _ = graphs
    x, dz, fwd, grad = (_cols(jax_results[i], f) for i in range(4))
    got = kernel.bell_spmm_units_reference(tg.bell, torch.from_numpy(x), tg.n_pad)
    np.testing.assert_allclose(got.numpy(), fwd, **TOL)
    got = kernel.bell_spmm_units_reference(tg.t_bell, torch.from_numpy(dz), tg.c_pad)
    np.testing.assert_allclose(got.numpy(), grad, **TOL)


@pytest.mark.parametrize("strategy", ["ell", "segment"])
def test_units_emulation_on_slot_rows_matches_jax(strategy):
    """The same emulation on the 'ell' and edge-list layouts of the hub
    graph (rows of more than UNIT_SLOTS slots on both sides), with
    structural and with per-slot values, against gala_tpu's spmm and
    spmm_ev."""
    from gala_tpu.ops.graph import Graph as JGraph
    from gala_tpu.ops.spmm import spmm_ev as jspmm_ev
    from gala_tpu_torch.ops.graph import Graph as TGraph
    from tests.test_torch_graph import host_graph

    gj, und = host_graph("hub_selfloops", "jax")
    jg = JGraph.from_host(gj, strategy=strategy, undirected=und, edge_vals=True)
    tg = TGraph.from_host(host_graph("hub_selfloops", "torch")[0], strategy=strategy,
                          undirected=und, device="cpu", edge_vals=True)
    fwd, bwd = (tg.ell, tg.t_ell) if strategy == "ell" else (tg.seg, tg.t_seg)
    assert fwd.units.n_partials and bwd.units.n_partials
    x = _real(tg, _x(tg.c_pad, 33, seed=5))
    evals = np.random.default_rng(6).uniform(0.5, 1.5, tg.e_pad).astype(np.float32)
    got = kernel.bell_spmm_units_reference(fwd, torch.from_numpy(x), tg.n_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jspmm)(jg, x)), **TOL)
    vals = fwd.slot_values(torch.from_numpy(evals))
    got = kernel.bell_spmm_units_reference(fwd, torch.from_numpy(x), tg.n_pad, vals)
    want = jax.jit(jspmm_ev)(jg, evals, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dz = torch.from_numpy(_x(tg.n_pad, 33, seed=7))
    np.testing.assert_allclose(
        kernel.bell_spmm_units_reference(bwd, dz, tg.c_pad).numpy(),
        kernel.bell_spmm_rows_reference(bwd, dz, tg.c_pad).numpy(), **TOL)


def test_wrapper_checks_its_input():
    _, tg, _ = graph_pair("hub_selfloops")
    x = torch.zeros((tg.c_pad, 8))
    with pytest.raises(TypeError):
        kernel.bell_spmm(tg.bell, x.double(), tg.n_pad)
    with pytest.raises(ValueError):
        kernel.bell_spmm(tg.bell, torch.zeros((8, tg.c_pad)).t(), tg.n_pad)
    with pytest.raises(ValueError):
        kernel.bell_spmm(tg.bell, x[: tg.bell.n_src - 1], tg.n_pad)


def test_cpu_tensors_run_the_plain_version():
    _, tg, _ = graph_pair("directed")
    kernel.counts.reset()
    spmm(tg, torch.ones((tg.c_pad, 4)))
    assert kernel.counts.launches == 0 and kernel.counts.reference_calls_on_cuda == 0
