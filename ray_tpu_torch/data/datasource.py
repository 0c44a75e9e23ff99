"""Datasource plugin API: bring-your-own formats for read/write (port of
``ray_tpu/data/datasource.py``, unchanged).

Role-equivalent of ray: python/ray/data/datasource/datasource.py
(Datasource, Reader/ReadTask plugin surface) collapsed onto the lazy
ReadTask plan: a Datasource enumerates read tasks (one per block) and
optionally writes blocks back out.  Built-in file formats
(read_parquet & co.) are thin instances of FileBasedDatasource; custom
sources subclass Datasource:

    class MySource(ray_tpu_torch.data.Datasource):
        def get_read_tasks(self, parallelism):
            return [ReadTask(self._load, shard) for shard in self.shards]

    ds = ray_tpu_torch.data.read_datasource(MySource(...))
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

from ray_tpu_torch.data.dataset import Dataset, ReadTask


class Datasource:
    """Subclass contract: get_read_tasks (required); write (optional)."""

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def write(self, blocks: Iterable[Any], path: str) -> List[str]:
        raise NotImplementedError(
            f"{type(self).__name__} does not support writing"
        )

    @property
    def name(self) -> str:
        return type(self).__name__


class FileBasedDatasource(Datasource):
    """One file per read task (the shape of every built-in format).

    ``reader(path) -> Block`` runs on a worker when the streaming window
    pulls the block.
    """

    def __init__(
        self,
        paths,
        *,
        suffix: str = "",
        reader: Optional[Callable[[str], Any]] = None,
    ):
        from ray_tpu_torch.data.read_api import _expand_paths

        self._paths = _expand_paths(paths, suffix)
        if reader is not None:
            self._read_file = reader

    def _read_file(self, path: str):
        raise NotImplementedError("pass reader= or override _read_file")

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        return [ReadTask(self._read_file, p) for p in self._paths]


def read_datasource(
    datasource: Datasource, *, parallelism: int = -1
) -> Dataset:
    """Build a lazy Dataset from a datasource's read tasks (ray:
    ray.data.read_datasource)."""
    tasks = datasource.get_read_tasks(parallelism)
    if not tasks:
        raise ValueError(f"{datasource.name} produced no read tasks")
    return Dataset(tasks)
