"""Data IR: typed, hierarchical data placeholders.

Clean-room Python equivalent of the reference's Data IR
(reference: src/ir/data.h:82-411 — DataNode/DataLevel/DataInfo,
RelationEdge, TransformEdge).  Dims use the reference's symbolic negative
convention (reference: src/codegen/common.h:287-309):

    -1 = N (number of nodes)     -2 = input feature size
    -3 = number of classes       -4 = E (number of edges)
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional

_ids = itertools.count()

SYM_NODES = -1
SYM_FEATS = -2
SYM_CLASSES = -3
SYM_EDGES = -4


class DataFormat(enum.Enum):
    # reference: src/ir/data.h:17-32
    CSR = "csr"
    CSC = "csc"
    DCSR = "dcsr"
    COO = "coo"
    RM = "rm"    # row-major dense
    CM = "cm"    # col-major dense
    SCALAR = "scalar"


class DataOpt(enum.Enum):
    # reference: src/ir/data.h:47-51
    COL_TILE = "col_tile"
    SAMPLE = "sample"
    SUBGRAPH = "subgraph"


class RelDim(enum.Enum):
    # reference: src/ir/data.h:370 (ROWS/COLS/ALL relation dims)
    ROWS = "rows"
    COLS = "cols"
    ALL = "all"


@dataclasses.dataclass
class DataNode:
    """A named data placeholder with format/flags/dims and data opts.

    Collapses the reference's DataNode->DataLevel->DataInfo chain into one
    object: the hierarchy only ever carried a single live DataInfo plus a
    tiled-level marker, which `opts` expresses directly.
    """

    name: str
    fmt: DataFormat
    rows: int = 0
    cols: int = 0
    directed: bool = False
    weighted: bool = False
    sparser: bool = False          # the DSL's `is_sparser` hint
    opts: list[tuple[DataOpt, float]] = dataclasses.field(default_factory=list)
    index: int = -1                # graph slot (the 2i/2i+1 scheme's base)
    derived: bool = False
    uid: int = dataclasses.field(default_factory=lambda: next(_ids))

    @property
    def is_graph(self) -> bool:
        return self.fmt in (DataFormat.CSR, DataFormat.CSC, DataFormat.DCSR, DataFormat.COO)

    def add_opt(self, opt: DataOpt, param: float) -> None:
        self.opts.append((opt, param))

    def has_opt(self, opt: DataOpt) -> bool:
        return any(o == opt for o, _ in self.opts)

    def dims(self) -> tuple[int, int]:
        return (self.rows, self.cols)

    def clone(self, **overrides) -> "DataNode":
        d = dataclasses.replace(self, uid=next(_ids))
        for k, v in overrides.items():
            setattr(d, k, v)
        return d

    def __hash__(self):
        return self.uid

    def __eq__(self, other):
        return isinstance(other, DataNode) and other.uid == self.uid


@dataclasses.dataclass
class RelationEdge:
    """Dependency or association between two data nodes
    (reference: src/ir/data.h:370)."""

    src: DataNode
    src_dim: RelDim
    dst: DataNode
    dst_dim: RelDim


@dataclasses.dataclass
class TransformData:
    """One data transformation step with params
    (reference: src/ir/data.h:386-411)."""

    kind: DataOpt
    params: list[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TransformEdge:
    """src data is produced from dst data via `transforms`
    (col-tiling, sampling, subgraph extraction)."""

    src: DataNode
    dst: DataNode
    transforms: list[TransformData] = dataclasses.field(default_factory=list)
