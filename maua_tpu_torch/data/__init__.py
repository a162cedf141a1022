"""Dataset and input pipeline: image folders to MREC record shards
(`prepare_data`; the port's own copy of the format), synthetic datasets
(`data.synthetic`), and a threaded loader that lands uint8 batches on the
card through pinned memory."""

from .loader import DataLoader
from .prepare import prepare_data, reencode_raw
from .records import MultiResolutionRecordDataset, RecordShardReader, RecordShardWriter

__all__ = [
    "DataLoader",
    "MultiResolutionRecordDataset",
    "RecordShardReader",
    "RecordShardWriter",
    "prepare_data",
    "reencode_raw",
]
