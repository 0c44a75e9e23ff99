"""Block layer: pyarrow Tables in the object store (port of
``ray_tpu/data/block.py``, unchanged).

Role-equivalent of ray: python/ray/data/block.py (Block, BlockAccessor:219)
+ arrow_block.py.  A Dataset is a list of ObjectRefs to Arrow tables;
accessors convert between rows / numpy / pandas views.  Arrow buffers ride
the serializer's out-of-band path, so block transfer between workers is
copy-light through the shm store.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import pyarrow as pa

Block = pa.Table


def from_rows(rows: List[Dict[str, Any]]) -> Block:
    if not rows:
        return pa.table({})
    # rows from tensor-column blocks carry per-row ndarrays (iter_rows);
    # stack those columns back into tensor columns — from_pylist cannot
    # convert multi-dim ndarray cells
    first = rows[0]
    tensor_cols = [
        k for k, v in first.items()
        if isinstance(v, np.ndarray) and v.ndim >= 1
    ]
    if not tensor_cols:
        return pa.Table.from_pylist(rows)
    plain = [
        {k: v for k, v in r.items() if k not in tensor_cols} for r in rows
    ]
    arrays = {
        k: np.stack([r[k] for r in rows]) for k in tensor_cols
    }
    tensor_tbl = from_numpy(arrays)
    if plain[0]:
        plain_tbl = pa.Table.from_pylist(plain)
        for i, name in enumerate(tensor_tbl.schema.names):
            plain_tbl = plain_tbl.append_column(
                tensor_tbl.schema.field(name), tensor_tbl.column(i)
            )
        return plain_tbl
    return tensor_tbl

def from_numpy(arrays: Dict[str, np.ndarray]) -> Block:
    import json

    cols = {}
    fields = []
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.ndim <= 1:
            arr = pa.array(v)
            fields.append(pa.field(k, arr.type))
        else:
            # tensors: fixed-shape lists (ragged unsupported by the ingest anyway),
            # with the per-row shape kept in field metadata so to_numpy can
            # restore ndim>2 tensors exactly.  Explicit width: reshape(-1)
            # cannot infer a dimension when the array has zero rows.
            import math

            width = math.prod(v.shape[1:])
            flat = v.reshape(len(v), width)
            arr = pa.FixedSizeListArray.from_arrays(
                pa.array(flat.reshape(-1)), flat.shape[1]
            )
            fields.append(
                pa.field(
                    k,
                    arr.type,
                    metadata={"rt_tensor_shape": json.dumps(list(v.shape[1:]))},
                )
            )
        cols[k] = arr
    return pa.table(cols, schema=pa.schema(fields))


def from_pandas(df) -> Block:
    return pa.Table.from_pandas(df, preserve_index=False)


class BlockAccessor:
    """Views over one Arrow block (ray: BlockAccessor analogue)."""

    def __init__(self, block: Block):
        self.block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        return self.block.num_rows

    def size_bytes(self) -> int:
        return self.block.nbytes

    def schema(self):
        return self.block.schema

    def to_pylist(self) -> List[Dict[str, Any]]:
        return self.block.to_pylist()

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        # tensor columns come back as per-row ndarrays with their original
        # shape (reference: row access on tensor extension columns), not
        # nested pylists
        tensor_cols = {
            f.name
            for f in self.block.schema
            if f.metadata and b"rt_tensor_shape" in f.metadata
        }
        if not tensor_cols:
            for batch in self.block.to_batches():
                yield from batch.to_pylist()
            return
        arrays = self.to_numpy()
        n = self.block.num_rows
        names = self.block.schema.names
        for i in range(n):
            yield {name: arrays[name][i] for name in names}

    def to_pandas(self):
        return self.block.to_pandas()

    def to_numpy(self) -> Dict[str, np.ndarray]:
        import json

        out = {}
        for name in self.block.column_names:
            col = self.block.column(name)
            if pa.types.is_fixed_size_list(col.type):
                width = col.type.list_size
                flat = col.combine_chunks().flatten().to_numpy(
                    zero_copy_only=False
                )
                field = self.block.schema.field(name)
                meta = field.metadata or {}
                shape_json = meta.get(b"rt_tensor_shape")
                if shape_json is not None:
                    shape = tuple(json.loads(shape_json))
                    out[name] = flat.reshape((-1,) + shape)
                else:
                    out[name] = flat.reshape(-1, width)
            else:
                out[name] = col.to_numpy(zero_copy_only=False)
        return out

    def slice(self, start: int, end: int) -> Block:
        return self.block.slice(start, end - start)

    def select(self, columns: List[str]) -> Block:
        return self.block.select(columns)


def concat_blocks(blocks: List[Block]) -> Block:
    nonempty = [b for b in blocks if b.num_rows > 0]
    if not nonempty:
        # all-empty: keep the SCHEMA (downstream group_by/sort need the
        # columns even for zero rows — a schemaless table breaks them)
        for b in blocks:
            if b.num_columns:
                return b.slice(0, 0)
        return pa.table({})
    return pa.concat_tables(nonempty, promote_options="default")


def empty_like(block: Optional[Block]) -> Block:
    return block.slice(0, 0) if block is not None else pa.table({})
