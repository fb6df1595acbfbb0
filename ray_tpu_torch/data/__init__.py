"""ray_tpu_torch.data — distributed datasets (Ray Data analog).

Lazy blocks + fused transforms + streaming execution with
backpressure; ``streaming_split`` feeds trainer gangs and
``iter_device_batches`` prefetches sharded device batches onto the
mesh (SURVEY.md §2.3/§2.4).
"""

from ray_tpu_torch.data.context import (
    DataContext,
    DatasetContext,
    ExecutionOptions,
    ExecutionResources,
    set_progress_bars,
)
from ray_tpu_torch.data.dataset import (
    ActorPoolStrategy,
    DataIterator,
    Dataset,
    GroupedData,
)
from ray_tpu_torch.data import aggregate  # noqa: F401  (ray.data.aggregate)
from ray_tpu_torch.data.io import (
    BlockBasedFileDatasink,
    Datasink,
    RowBasedFileDatasink,
    from_dask,
    from_modin,
    from_spark,
    from_tf,
    from_torch,
    from_arrow,
    from_huggingface,
    read_bigquery,
    read_numpy,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
    from_items,
    from_numpy,
    from_numpy_refs,
    from_pandas,
    from_pandas_refs,
    from_arrow_refs,
    range_tensor,
    read_parquet_bulk,
    read_datasource,
    Datasource,
    ReadTask,
    range as range_,  # noqa: A001 — re-exported as .range below
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_parquet,
)

# public name mirrors the reference: ray.data.range
range = range_  # noqa: A001

__all__ = [
    "ActorPoolStrategy",
    "DataContext", "DatasetContext", "Dataset", "DataIterator", "GroupedData", "range",
    "from_items",
    "from_arrow",
    "read_text",
    "read_numpy",
    "from_numpy", "from_pandas", "read_parquet", "read_csv",
    "from_numpy_refs", "from_pandas_refs", "from_arrow_refs",
    "range_tensor", "read_parquet_bulk", "read_datasource",
    "Datasource", "ReadTask", "Datasink", "aggregate",
    "BlockBasedFileDatasink", "RowBasedFileDatasink",
    "from_torch", "from_tf", "from_dask", "from_modin", "from_spark",
    "ExecutionOptions", "ExecutionResources", "set_progress_bars",
    "DatasetIterator", "Preprocessor", "NodeIdStr",
    "read_json", "read_images", "read_binary_files",
    "read_tfrecords", "read_sql", "read_bigquery", "from_huggingface",
    "read_webdataset",
]

# Compat aliases (reference kept both spellings alive).
from ray_tpu_torch.data.dataset import DataIterator as DatasetIterator  # noqa: E402
from ray_tpu_torch.data.preprocessor import Preprocessor  # noqa: E402,F401

NodeIdStr = str  # (reference: ray.data.NodeIdStr type alias)
