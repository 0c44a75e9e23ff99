"""ray_tpu_torch.data: distributed datasets over Arrow blocks (port of
``ray_tpu/data/``).

Role-equivalent of ray: python/ray/data/.  Lazy transform plans with
fused per-block task execution; card ingest via iter_device_batches.
Importing the package loads pyarrow, not torch: stage tasks run in
workers that never touch a tensor.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor  # noqa: F401
from ray_tpu_torch.data.dataset import (  # noqa: F401
    ActorPoolStrategy,
    DataIterator,
    Dataset,
    GroupedData,
)
from ray_tpu_torch.data.read_api import (  # noqa: F401
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
)

from ray_tpu_torch.data.datasource import (  # noqa: F401
    Datasource,
    FileBasedDatasource,
    read_datasource,
)
