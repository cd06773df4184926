"""The benchmark's graphs, made on the device from a traffic file.

A traffic file names a published graph's shape (nodes, features, classes,
nonzeros, split sizes) and a fixed `graph_seed`.  The graph is an R-MAT
draw (a = 0.57, b = c = 0.19, the repository's generator rewritten in
torch so it runs on the card), 70% of whose edges are rewired to a
random node of the source's class, then made undirected, deduplicated
and given one self loop a node.  `draws` R-MAT edges are drawn; the file
holds the number that lands the nonzeros within 1% of the target.

Features are the dataset's: unit normal noise plus 2.0 on the column
`label % features`, drawn from `graph_seed` as the structure, labels and
split are, because users train many models on one dataset.  `--seed`
draws the weights only (gala_bench.cell).
"""
from __future__ import annotations

import dataclasses
import math

import torch

RMAT_A, RMAT_B, RMAT_C = 0.57, 0.19, 0.19
REWIRE = 0.7
FEATURE_SIGNAL = 2.0
NNZ_TOLERANCE = 0.01


@dataclasses.dataclass
class BenchGraph:
    """A graph on the device: CSR by destination row, sources ascending
    within a row (self loops included), with its node data."""

    n: int
    crow: torch.Tensor      # (n + 1,) int64
    col: torch.Tensor       # (nnz,) int64, source of each edge
    row: torch.Tensor       # (nnz,) int64, destination of each edge
    feats: torch.Tensor     # (n, F) float32
    labels: torch.Tensor    # (n,) int64
    masks: dict             # "train" / "val" / "test": (n,) bool

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def n_classes(self) -> int:
        return int(self.labels.max()) + 1


def rmat(n: int, draws: int, gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`draws` R-MAT edges over 2^ceil(log2 n) ids; those past n dropped."""
    scale = max(int(math.ceil(math.log2(max(n, 2)))), 1)
    src = torch.zeros(draws, dtype=torch.int64, device=device)
    dst = torch.zeros(draws, dtype=torch.int64, device=device)
    t_ab, t_abc = RMAT_A + RMAT_B, RMAT_A + RMAT_B + RMAT_C
    for level in range(scale):
        u = torch.rand(draws, generator=gen, device=device)
        bit = 1 << (scale - 1 - level)
        src_bit = u > t_ab                              # quadrants c, d
        dst_bit = (u > t_abc) | ((u > RMAT_A) & ~src_bit)  # quadrants b, d
        src += bit * src_bit
        dst += bit * dst_bit
        del u, src_bit, dst_bit
    keep = (src < n) & (dst < n)
    return src[keep], dst[keep]


def rewire(src: torch.Tensor, dst: torch.Tensor, labels: torch.Tensor, n_classes: int,
           gen: torch.Generator) -> torch.Tensor:
    """A REWIRE share of the edges point at a random node of the source's
    class instead (planted homophily, as the repository's generator)."""
    by_class = torch.argsort(labels, stable=True)
    counts = torch.bincount(labels, minlength=n_classes)
    starts = torch.cumsum(counts, 0) - counts
    cls = labels[src]
    moved = torch.rand(src.shape[0], generator=gen, device=src.device) < REWIRE
    u = torch.rand(src.shape[0], generator=gen, device=src.device)
    pick = (u * counts[cls]).long().clamp_max(counts[cls] - 1)
    return torch.where(moved, by_class[starts[cls] + pick], dst)


def undirected_csr(src: torch.Tensor, dst: torch.Tensor, n: int):
    """Both directions of every edge, deduplicated, self loops replaced
    by exactly one a node: (crow, col, row) sorted by (row, col)."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    loops = torch.arange(n, dtype=torch.int64, device=src.device)
    keys = torch.cat([dst * n + src, src * n + dst, loops * (n + 1)])
    del src, dst, keep
    keys = torch.unique(keys)  # sorted
    row, col = keys // n, keys % n
    del keys
    crow = torch.zeros(n + 1, dtype=torch.int64, device=row.device)
    crow[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    return crow, col, row


def split_masks(n: int, sizes: dict, gen: torch.Generator, device) -> dict:
    """Disjoint train / val / test masks of the published sizes, the rest
    of the nodes in none."""
    perm = torch.randperm(n, generator=gen, device=device)
    masks, lo = {}, 0
    for name in ("train", "val", "test"):
        m = torch.zeros(n, dtype=torch.bool, device=device)
        m[perm[lo : lo + int(sizes[name])]] = True
        masks[name] = m
        lo += int(sizes[name])
    if lo > n:
        raise ValueError(f"split sizes sum to {lo}, more than the {n} nodes")
    return masks


def make_graph(traffic: dict, device, check_nnz: bool = True) -> BenchGraph:
    """The traffic file's graph on `device`, every draw from its
    graph_seed.  Raises when the nonzeros miss the target by over 1%."""
    n, f, c = int(traffic["nodes"]), int(traffic["features"]), int(traffic["classes"])
    gen = torch.Generator(device=device).manual_seed(int(traffic["graph_seed"]))
    labels = torch.randint(0, c, (n,), generator=gen, device=device)
    src, dst = rmat(n, int(traffic["draws"]), gen, device)
    dst = rewire(src, dst, labels, c, gen)
    crow, col, row = undirected_csr(src, dst, n)
    del src, dst
    target = int(traffic["nonzeros_target"])
    if check_nnz and abs(col.shape[0] - target) > NNZ_TOLERANCE * target:
        raise ValueError(f"{col.shape[0]} nonzeros, the target is {target} (1% allowed): "
                         "set the traffic file's draws anew")
    masks = split_masks(n, traffic["split"], gen, device)
    feats = torch.randn((n, f), generator=gen, device=device)
    feats[torch.arange(n, device=device), labels % f] += FEATURE_SIGNAL
    return BenchGraph(n=n, crow=crow, col=col, row=row, feats=feats, labels=labels,
                      masks=masks)


def host_data(g: BenchGraph):
    """The (HostCSR, feats, labels, masks) tuple that the port's
    `compile_source(data=...)` takes, copied to the host."""
    import numpy as np

    from gala_tpu_torch.data.csr import HostCSR

    csr = HostCSR(
        n_rows=g.n, n_cols=g.n,
        row_ptr=g.crow.cpu().numpy().astype(np.int64),
        dst=g.row.to(torch.int32).cpu().numpy(),
        src=g.col.to(torch.int32).cpu().numpy(),
        vals=np.ones(g.nnz, np.float32),
    )
    masks = {k: v.cpu().numpy() for k, v in g.masks.items()}
    return csr, g.feats.cpu().numpy(), g.labels.cpu().numpy(), masks
