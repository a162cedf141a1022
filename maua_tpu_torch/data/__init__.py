"""Dataset and input pipeline: the MREC record shards (the port's own copy of
the format), synthetic datasets (`data.synthetic`), and a threaded loader that lands uint8
batches on the card through pinned memory."""

from .loader import DataLoader
from .records import MultiResolutionRecordDataset, RecordShardReader, RecordShardWriter

__all__ = [
    "DataLoader",
    "MultiResolutionRecordDataset",
    "RecordShardReader",
    "RecordShardWriter",
]
