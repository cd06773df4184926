"""GALA on PyTorch and CUDA: the GALA DSL compiled to a PyTorch training
program for one NVIDIA Hopper GPU (sm_90a).

This package is the port of the JAX/TPU package `gala_tpu`, which stays
beside it as the reference.  Module paths mirror `gala_tpu`'s so each
module's counterpart is found at the same place.  The host layer (DSL,
IR, passes, host graph layouts) is a verbatim copy of `gala_tpu`'s
JAX-free modules with the package renamed; everything that touches a
device is written in PyTorch, and the binned-ELL SpMM runs on a
hand-written CUDA kernel (`gala_tpu_torch/csrc/bell_spmm.cu`).

Public API (the same as gala_tpu's, with the device passed explicitly):

    import gala_tpu_torch as gt
    cm  = gt.compile_source(src, mode="train", device="cuda")
    res = cm.train(iters=20, warmup=2)
    print(res.csv())                              # 'inference_time,total_time'

Importing the package imports neither the kernel module nor CUDA, so it
works on hosts without a GPU or nvcc.
"""

__version__ = "0.1.0"

__all__ = ["compile_file", "compile_source", "compile_model", "__version__"]


def __getattr__(name):
    if name in ("compile_file", "compile_source", "compile_model"):
        from gala_tpu_torch import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
