"""The tables of a batch of streams for one kernel launch.

A batched kernel (K1, K3, K4, K5, K6) codes D streams in one launch.  The
streams either share one model (the sections of a blocked container) or
each has its own (the blocks of a pseudo-adaptive container).  Both are a
`ModelBatch`: each tensor of the streams' device tables (ops/tables.py's
EncDevice, GroupedEncDevice, SearchDevice, DirectDevice, GroupedDecDevice)
concatenated along its first axis, each distinct table once, and one row
of i32 words per stream that says where its part lies and holds its
scalars:

    (offset, length) of each tensor field, in the dataclass's order, then
    each int field, in the dataclass's order.

A field a table lacks (rank_of None) has offset -1 and length 0.  A block
of a kernel reads the row of its stream; a shared model is one row read
by every block (stride 0), its offsets all 0: the one-model batch is the
case of the per-stream one where every offset is 0, on the same kernels.
What a launch fixes (shared memory, a template instance, the stream's
ring) it takes from the batch's largest model.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

MAX_I32 = (1 << 31) - 1


def _split_fields(kind: type, sample) -> tuple[tuple, tuple]:
    """(tensor fields, int fields) of a device table class, each in the
    dataclass's order."""
    tensors, ints = [], []
    for f in dataclasses.fields(kind):
        value = getattr(sample, f.name)
        (ints if isinstance(value, (int, np.integer)) else tensors).append(
            f.name)
    return tuple(tensors), tuple(ints)


@dataclass(frozen=True)
class ModelBatch:
    """The models of a batch: `tensors` (field -> the concatenated tensor,
    or None where no stream has the field), `rows` (R, W) host i32 and
    `meta` the same on the tensors' device.  R is the number of streams,
    or 1 for a model every stream shares (`shared`)."""

    kind: type
    tensor_fields: tuple
    int_fields: tuple
    tensors: dict
    rows: np.ndarray
    meta: torch.Tensor
    shared: bool
    # what launches derive from the rows, made once: a launch's host work
    # stays a lookup
    memo: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def stride(self) -> int:
        """i32 words between two streams' rows (0: one row for all)."""
        return 0 if self.shared else self.rows.shape[1]

    def column(self, name: str) -> np.ndarray:
        """A field's value over the rows: an int field's value, or
        "<tensor field>_len" / "<tensor field>_off" of a tensor field."""
        if name in self.int_fields:
            return self.rows[:, 2 * len(self.tensor_fields)
                             + self.int_fields.index(name)].astype(np.int64)
        tensor, _, part = name.rpartition("_")
        i = 2 * self.tensor_fields.index(tensor) + (part == "len")
        return self.rows[:, i].astype(np.int64)

    def largest(self, name: str) -> int:
        return self.remember(("largest", name),
                             lambda: int(self.column(name).max()))

    def remember(self, key, make):
        """make() the first time `key` is asked for, then what it gave."""
        if key not in self.memo:
            self.memo[key] = make()
        return self.memo[key]

    def table(self, d: int):
        """Stream d's device table, cut out of the concatenated tensors by
        its row (what the plain versions read)."""
        row = self.rows[0 if self.shared else d].tolist()
        kw = {}
        for i, name in enumerate(self.tensor_fields):
            off, length = row[2 * i], row[2 * i + 1]
            cat = self.tensors[name]
            kw[name] = None if off < 0 else cat[off:off + length]
        for i, name in enumerate(self.int_fields):
            kw[name] = int(row[2 * len(self.tensor_fields) + i])
        return self.kind(**kw)

    def check(self, name: str, D: int) -> None:
        """Raise unless the batch holds a model for each of D streams."""
        if not self.shared and self.rows.shape[0] != D:
            raise ValueError(f"{name}: {self.rows.shape[0]} models for a "
                             f"batch of {D} streams")

    def device_tensors(self) -> list:
        return [t for t in self.tensors.values() if t is not None] + [
            self.meta]


def _rows(kind, tensor_fields, int_fields, tables, placed) -> np.ndarray:
    """The rows of `tables`, whose tensors lie at `placed` (id of a table
    -> field -> offset)."""
    rows = np.zeros((len(tables), 2 * len(tensor_fields) + len(int_fields)),
                    dtype=np.int64)
    for d, t in enumerate(tables):
        for i, name in enumerate(tensor_fields):
            value = getattr(t, name)
            if value is None:
                rows[d, 2 * i:2 * i + 2] = (-1, 0)
            else:
                rows[d, 2 * i:2 * i + 2] = (placed[id(t)][name],
                                            value.shape[0])
        for i, name in enumerate(int_fields):
            rows[d, 2 * len(tensor_fields) + i] = int(getattr(t, name))
    if rows.size and (rows.max() > MAX_I32 or rows.min() < -1):
        raise NotImplementedError("a batch's tables pass 2^31 entries")
    return rows.astype(np.int32)


def shared(table) -> ModelBatch:
    """The batch of one model for any number of streams: the table's own
    tensors, one row, every offset 0.  Made once per table and kept on
    it."""
    cached = table.__dict__.get("_model_batch")
    if cached is not None:
        return cached
    kind = type(table)
    tensor_fields, int_fields = _split_fields(kind, table)
    rows = _rows(kind, tensor_fields, int_fields, [table],
                 {id(table): {name: 0 for name in tensor_fields}})
    device = next(getattr(table, f).device for f in tensor_fields
                  if getattr(table, f) is not None)
    batch = ModelBatch(
        kind=kind, tensor_fields=tensor_fields, int_fields=int_fields,
        tensors={name: getattr(table, name) for name in tensor_fields},
        rows=rows, meta=torch.from_numpy(rows.copy()).to(device),
        shared=True)
    table.__dict__["_model_batch"] = batch  # frozen dataclass: no setattr
    return batch


def stack(tables, device=None) -> ModelBatch:
    """The batch of one model a stream: `tables` (device tables of one
    class, stream d's at d; a table given for several streams is laid out
    once) concatenated on `device` (None: where they lie)."""
    tables = list(tables)
    if not tables:
        raise ValueError("a batch of no streams")
    kind = type(tables[0])
    if any(type(t) is not kind for t in tables):
        raise ValueError("the tables of a batch must be of one kind")
    tensor_fields, int_fields = _split_fields(kind, tables[0])
    distinct = list({id(t): t for t in tables}.values())
    placed = {id(t): {} for t in distinct}
    tensors = {}
    for name in tensor_fields:
        parts, at = [], 0
        for t in distinct:
            value = getattr(t, name)
            if value is None:
                continue
            placed[id(t)][name] = at
            parts.append(value)
            at += value.shape[0]
        tensors[name] = torch.cat(parts) if parts else None
    rows = _rows(kind, tensor_fields, int_fields, tables, placed)
    if device is None:
        device = next(t.device for t in tensors.values() if t is not None)
    tensors = {name: None if t is None else t.to(device)
               for name, t in tensors.items()}
    return ModelBatch(kind=kind, tensor_fields=tensor_fields,
                      int_fields=int_fields, tensors=tensors, rows=rows,
                      meta=torch.from_numpy(rows.copy()).to(device),
                      shared=False)


def of(table) -> ModelBatch:
    """A ModelBatch as it is, or the shared batch of one table."""
    return table if isinstance(table, ModelBatch) else shared(table)
