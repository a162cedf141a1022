"""Sharded record files: the storage layer behind the dataset (the port's own
copy of maua_tpu/data/records.py; same format, byte for byte).

Format (per shard file `<name>-<res>-<shard>.mrec`):
  v1 header:  magic b"MREC" | uint32 version=1 | uint64 n_records
  v2 header:  magic b"MREC" | uint32 version=2 | uint64 n_records
              | uint32 fmt (0=jpeg, 1=raw uint8 RGB HWC) | uint32 side
  index:      n_records × (uint64 offset, uint64 length)   [absolute offsets]
  payload:    concatenated blobs (JPEG bytes, or side*side*3 raw bytes)

Equivalent of the reference's LMDB env with keys f"{res}-{idx:05}" holding
JPEG bytes and a "length" key (reference: dataset.py:10-42, prepare_data.py:
54-88), but append-only flat files: trivially shardable across data-parallel
hosts, mmap-friendly, no LMDB dependency.

The raw format exists because JPEG decode can bound the train loop on a host
with few CPU cores. A raw record is a straight mmap slice + reshape — no
decode at all — at 3*side² bytes/record on disk (3 MB at 1024², ~16x a q100
JPEG).
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Iterator

import numpy as np

_MAGIC = b"MREC"
_VERSION = 1
_VERSION_RAW = 2
_HEADER = struct.Struct("<4sIQ")
_HEADER_V2 = struct.Struct("<4sIQII")
_ENTRY = struct.Struct("<QQ")

FMT_JPEG = 0
FMT_RAW = 1


class RecordShardWriter:
    """`fmt="jpeg"` (default, v1 container) or `fmt="raw"` (v2: append
    side*side*3 uint8 RGB HWC buffers; `side` is recorded in the header and
    every blob is length-checked)."""

    def __init__(self, path: str, fmt: str = "jpeg", side: int = 0):
        if fmt not in ("jpeg", "raw"):
            raise ValueError(f"fmt must be jpeg|raw, got {fmt!r}")
        if fmt == "raw" and side <= 0:
            raise ValueError("raw shards need side > 0")
        self.path = path
        self.fmt = fmt
        self.side = int(side)
        self._blobs: list[bytes] = []

    def append(self, blob) -> None:
        if self.fmt == "raw":
            blob = np.ascontiguousarray(blob, dtype=np.uint8).tobytes()
            want = self.side * self.side * 3
            if len(blob) != want:
                raise ValueError(
                    f"raw record is {len(blob)} bytes, want {want} ({self.side}²×3)"
                )
        self._blobs.append(bytes(blob))

    def close(self) -> None:
        n = len(self._blobs)
        header = (
            _HEADER.pack(_MAGIC, _VERSION, n)
            if self.fmt == "jpeg"
            else _HEADER_V2.pack(_MAGIC, _VERSION_RAW, n, FMT_RAW, self.side)
        )
        index_size = len(header) + n * _ENTRY.size
        offsets = []
        pos = index_size
        for b in self._blobs:
            offsets.append((pos, len(b)))
            pos += len(b)
        with open(self.path, "wb") as f:
            f.write(header)
            for off, ln in offsets:
                f.write(_ENTRY.pack(off, ln))
            for b in self._blobs:
                f.write(b)
        self._blobs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordShardReader:
    """mmap-backed random access to one shard (v1 JPEG or v2 raw)."""

    def __init__(self, path: str):
        self.path = path
        self._data = np.memmap(path, dtype=np.uint8, mode="r")
        magic, version, n = _HEADER.unpack(self._data[: _HEADER.size].tobytes())
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a MREC file")
        if version == _VERSION:
            self.fmt, self.side = FMT_JPEG, 0
            idx_start = _HEADER.size
        elif version == _VERSION_RAW:
            _, _, n, fmt, side = _HEADER_V2.unpack(
                self._data[: _HEADER_V2.size].tobytes()
            )
            self.fmt, self.side = int(fmt), int(side)
            idx_start = _HEADER_V2.size
        else:
            raise ValueError(f"{path}: unsupported version {version}")
        self.n_records = n
        idx_bytes = self._data[idx_start : idx_start + n * _ENTRY.size].tobytes()
        self._index = np.frombuffer(idx_bytes, dtype=np.uint64).reshape(n, 2)

    def __len__(self) -> int:
        return self.n_records

    def get(self, i: int) -> bytes:
        off, ln = self._index[i]
        return self._data[int(off) : int(off + ln)].tobytes()

    def get_raw_hwc(self, i: int) -> np.ndarray:
        """Raw shards only: zero-decode [side, side, 3] uint8 view straight
        off the mmap (no copy — callers that mutate must copy)."""
        if self.fmt != FMT_RAW:
            raise ValueError(f"{self.path}: not a raw shard")
        off, ln = self._index[i]
        want = self.side * self.side * 3
        if int(ln) != want:
            raise ValueError(f"{self.path}[{i}]: raw record length {ln} != {want}")
        return self._data[int(off) : int(off) + want].reshape(self.side, self.side, 3)


class MultiResolutionRecordDataset:
    """All shards of one resolution under a directory
    (LMDB MultiResolutionDataset equivalent, reference: dataset.py:10-42).
    Decodes JPEG via OpenCV, normalizes to [-1,1] NCHW float32 (or, with
    `uint8_hwc`, yields the [H, W, 3] uint8 image for the device to
    normalise); corrupt records retry with a random index like the reference
    (dataset.py:27-39)."""

    def __init__(self, root: str, resolution: int = 256, seed: int = 0,
                 uint8_hwc: bool = False):
        pattern = os.path.join(root, f"*-{resolution}-*.mrec")
        paths = sorted(glob.glob(pattern))
        if not paths:
            raise FileNotFoundError(f"no shards matching {pattern}")
        self.readers = [RecordShardReader(p) for p in paths]
        self.sizes = np.array([len(r) for r in self.readers])
        self.cum = np.concatenate([[0], np.cumsum(self.sizes)])
        self.resolution = resolution
        self.uint8_hwc = uint8_hwc
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return int(self.cum[-1])

    def _shard_of(self, index: int) -> tuple[RecordShardReader, int]:
        shard = int(np.searchsorted(self.cum, index, side="right") - 1)
        return self.readers[shard], index - int(self.cum[shard])

    def __getitem__(self, index: int) -> np.ndarray:
        for _ in range(10):  # corrupt-image retry (dataset.py:27-39)
            try:
                reader, local = self._shard_of(index)
                if reader.fmt == FMT_RAW:
                    # pre-decoded fast path: mmap slice + reshape, no decode
                    img = reader.get_raw_hwc(local)
                else:
                    import cv2

                    buf = np.frombuffer(reader.get(local), dtype=np.uint8)
                    img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
                    if img is None:
                        raise ValueError("decode failed")
                    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                if self.uint8_hwc:
                    # uint8 input pipeline: ship [H, W, 3] uint8 to the
                    # accelerator and normalize on device (train/step.py) —
                    # 4x less host->device traffic than fp32 CHW.
                    return img
                return img.transpose(2, 0, 1).astype(np.float32) * np.float32(1.0 / 127.5) - np.float32(1.0)
            except Exception:
                index = int(self._rng.randint(len(self)))
        raise RuntimeError("too many corrupt records")

    def iter_indices(self, seed: int = 0) -> Iterator[int]:
        """Endless epoch iterator: every index once per epoch, each epoch
        shuffled with the next seed (one process; the rank-strided epochs of
        a multi-process run come with torch.distributed, ROADMAP item 13)."""
        while True:
            order = np.arange(len(self))
            np.random.RandomState(seed).shuffle(order)
            seed += 1
            yield from order
