"""The hand-written CUDA kernels, their wrappers and plain versions; the
import registers their custom ops (ops.kernels.library) and builds nothing."""
from gala_tpu_torch.ops.kernels import library  # noqa: F401
