"""The native CSR build is stable: above 1,000,000 edges
`data.csr.coo_to_csr` runs the native counting sort
(gala_tpu_torch/native/csr_stable.cpp), whose rows keep their edges in
input order, so its result is bitwise the NumPy path's
argsort(dst, kind="stable") and two builds of one edge list are equal.
The copied csr_ops.cpp's own sort (atomic per-row cursors) gave a row's
edges in thread order."""
import numpy as np
import pytest

from gala_tpu_torch import native
from gala_tpu_torch.data import csr


def _numpy_path(monkeypatch, src, dst, vals, n):
    with monkeypatch.context() as m:
        m.setattr(native, "coo_to_csr_native", lambda *a: None)
        return csr.coo_to_csr(src, dst, vals, n_rows=n)


@pytest.mark.parametrize("n_rows,with_vals", [(3_000, True), (200_000, False)])
def test_native_csr_is_the_stable_numpy_order(n_rows, with_vals, monkeypatch):
    if not native.available():
        pytest.skip("no native toolchain: coo_to_csr runs the NumPy path only")
    rng = np.random.default_rng(0)
    e = 1_200_000
    src, dst = rng.integers(0, n_rows, e), rng.integers(0, n_rows, e)
    vals = rng.random(e).astype(np.float32) if with_vals else None
    want = _numpy_path(monkeypatch, src, dst, vals, n_rows)
    calls = []
    monkeypatch.setattr(native, "coo_to_csr_native",
                        lambda *a, f=native.coo_to_csr_native: calls.append(1) or f(*a))
    for _ in range(2):
        got = csr.coo_to_csr(src, dst, vals, n_rows=n_rows)
        for name in ("row_ptr", "src", "dst", "vals"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(calls) == 2  # both builds went through the native sort
