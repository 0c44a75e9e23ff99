"""Dataset creation: in-memory sources and file IO (port of
``ray_tpu/data/read_api.py``, unchanged).

Role-equivalent of ray: python/ray/data/read_api.py + datasource/.
Reads are parallelized per file / per range-slice into remote tasks
producing Arrow blocks.
"""

from __future__ import annotations

import glob as glob_mod
import os
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.dataset import Dataset, ReadTask

DEFAULT_BLOCKS = 8


# -- in-memory sources -----------------------------------------------------


def _range_block(lo: int, hi: int):
    return block_mod.from_numpy({"id": np.arange(lo, hi, dtype=np.int64)})


def range(n: int, *, override_num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    import builtins

    nb = min(override_num_blocks or DEFAULT_BLOCKS, max(1, n))
    step = (n + nb - 1) // nb
    return Dataset(
        [
            ReadTask(_range_block, i * step, min((i + 1) * step, n))
            for i in builtins.range(nb)
            if i * step < n
        ]
    )


def from_items(
    items: List[Any], *, override_num_blocks: Optional[int] = None
) -> Dataset:
    import builtins

    rows = [
        it if isinstance(it, dict) else {"item": it} for it in items
    ]
    nb = min(override_num_blocks or DEFAULT_BLOCKS, max(1, len(rows)))
    step = (len(rows) + nb - 1) // nb
    refs = []
    for i in builtins.range(nb):
        chunk = rows[i * step : (i + 1) * step]
        if chunk:
            refs.append(ray_tpu_torch.put(block_mod.from_rows(chunk)))
    return Dataset(refs)


def from_numpy(arrays: Dict[str, np.ndarray]) -> Dataset:
    return Dataset([ray_tpu_torch.put(block_mod.from_numpy(arrays))])


def from_pandas(df) -> Dataset:
    return Dataset([ray_tpu_torch.put(block_mod.from_pandas(df))])


def from_arrow(table) -> Dataset:
    return Dataset([ray_tpu_torch.put(table)])


# -- file sources ----------------------------------------------------------


def _expand_paths(paths, suffix: str) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                sorted(glob_mod.glob(os.path.join(p, f"*{suffix}")))
            )
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths!r}")
    return out


def _read_parquet_file(path, columns=None):
    import pyarrow.parquet as pq

    return pq.read_table(path, columns=columns)


# marks readers that accept a `columns=` kwarg, enabling the
# projection-pushdown rule in Dataset.select_columns
_read_parquet_file.__rt_projectable__ = True


def _read_csv_file(path):
    import pyarrow.csv as pcsv

    return pcsv.read_csv(path)


def _read_jsonl_file(path):
    import pyarrow.json as pjson

    return pjson.read_json(path)


def _read_text_file(path):
    with open(path, "r") as f:
        lines = [ln.rstrip("\n") for ln in f]
    return block_mod.from_rows([{"text": ln} for ln in lines])


def _read_npy_file(path):
    return block_mod.from_numpy({"data": np.load(path)})


def _read_binary_file(path):
    with open(path, "rb") as f:
        data = f.read()
    return block_mod.from_rows([{"bytes": data, "path": path}])


def _file_dataset(paths, suffix: str, reader) -> Dataset:
    """One lazy ReadTask per file: the read happens on a worker when the
    streaming window pulls the block, not at dataset-construction time."""
    return Dataset(
        [ReadTask(reader, f) for f in _expand_paths(paths, suffix)]
    )


def read_parquet(paths, *, columns=None, **kwargs) -> Dataset:
    if columns is not None:
        import functools

        reader = functools.partial(_read_parquet_file, columns=list(columns))
        return _file_dataset(paths, ".parquet", reader)
    return _file_dataset(paths, ".parquet", _read_parquet_file)


def read_csv(paths, **kwargs) -> Dataset:
    return _file_dataset(paths, ".csv", _read_csv_file)


def read_json(paths, **kwargs) -> Dataset:
    """JSONL files (ray: read_json uses pyarrow.json line-delimited)."""
    return _file_dataset(paths, ".jsonl", _read_jsonl_file)


def read_text(paths, **kwargs) -> Dataset:
    return _file_dataset(paths, ".txt", _read_text_file)


def read_numpy(paths, **kwargs) -> Dataset:
    return _file_dataset(paths, ".npy", _read_npy_file)


def read_binary_files(paths, **kwargs) -> Dataset:
    return _file_dataset(paths, "", _read_binary_file)


def _make_image_reader(size, mode):
    def _read_image_file(path):
        from PIL import Image

        img = Image.open(path)
        if mode is not None:
            img = img.convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))  # PIL takes (W, H)
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return block_mod.from_numpy({"image": arr[None, ...]})

    return _read_image_file


def read_images(paths, *, size=None, mode=None, **kwargs) -> Dataset:
    """Image files → tensor-column blocks (ray: read_images,
    data/_internal/datasource/image_datasource.py).  `size=(H, W)`
    resizes (required for batching images of mixed sizes); `mode` is a
    PIL convert mode ("RGB", "L", ...)."""
    reader = _make_image_reader(size, mode)
    paths = _expand_paths(paths, "")
    imgs = [
        p for p in paths
        if p.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".gif",
                               ".webp"))
    ]
    if not imgs:
        raise FileNotFoundError(f"no image files in {paths!r}")
    return Dataset([ReadTask(reader, f) for f in imgs])


def read_sql(sql: str, connection_factory) -> Dataset:
    """A SQL query → Dataset (ray: read_sql,
    data/_internal/datasource/sql_datasource.py).  `connection_factory`
    is a zero-arg callable returning a DBAPI2 connection (sqlite3,
    psycopg2, ...) — it must be picklable since the query runs on a
    worker inside the streaming window.

    The query runs as ONE read task (one block); shard large tables by
    issuing several read_sql calls with disjoint predicates and
    `Dataset.union`, like the reference's sharded read_sql."""

    def _read_sql_task():
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            cols = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        return block_mod.from_rows(
            [dict(zip(cols, r)) for r in rows]
        )

    return Dataset([ReadTask(_read_sql_task)])


# -- writers (attached to Dataset) ----------------------------------------


def _write(ds: Dataset, path: str, fmt: str) -> List[str]:
    os.makedirs(path, exist_ok=True)

    @ray_tpu_torch.remote
    def write_one(block, out_path):
        if fmt == "parquet":
            import pyarrow.parquet as pq

            pq.write_table(block, out_path)
        elif fmt == "csv":
            import pyarrow.csv as pcsv

            pcsv.write_csv(block, out_path)
        else:  # jsonl
            with open(out_path, "w") as f:
                for row in block.to_pylist():
                    import json

                    f.write(json.dumps(row) + "\n")
        return out_path

    suffix = {"parquet": ".parquet", "csv": ".csv", "jsonl": ".jsonl"}[fmt]
    refs = [
        write_one.remote(ref, os.path.join(path, f"part-{i:05d}{suffix}"))
        for i, ref in enumerate(ds.iter_block_refs())
    ]
    return ray_tpu_torch.get(refs, timeout=600)


def _install_writers():
    Dataset.write_parquet = lambda self, path: _write(self, path, "parquet")
    Dataset.write_csv = lambda self, path: _write(self, path, "csv")
    Dataset.write_json = lambda self, path: _write(self, path, "jsonl")


_install_writers()
