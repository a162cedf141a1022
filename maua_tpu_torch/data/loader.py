"""Threaded prefetching loader (counterpart of maua_tpu/data/loader.py, one
process, no mesh: torch.distributed comes with ROADMAP item 13).

Worker threads read records, in an order shuffled anew each epoch, into a
bounded queue; `next()` assembles a [num_accumulate, batch, ...] super-batch,
flips a random half of it along the width with a seeded numpy RNG, and moves
it to the device: through pinned host memory with a non-blocking copy when
the device is a CUDA card. A dataset with `uint8_hwc=True` (the train CLI's
default) gives [A, B, H, W, 3] uint8 batches that the train step normalises
on the device, a quarter of the bytes of fp32; otherwise [A, B, 3, H, W] fp32.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["DataLoader"]

PREFETCH = 4  # super-batches the workers may read ahead


class DataLoader:
    def __init__(self, dataset, batch_size: int, num_accumulate: int = 1, num_workers: int = 4, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_accumulate = num_accumulate
        self.uint8_hwc = bool(getattr(dataset, "uint8_hwc", False))
        self._rng = np.random.RandomState(seed)
        self._idx_lock = threading.Lock()
        self._indices = dataset.iter_indices(seed=seed)
        self._item_q: queue.Queue = queue.Queue(maxsize=PREFETCH * batch_size * num_accumulate)
        self._stop = threading.Event()
        self._workers = [threading.Thread(target=self._worker, daemon=True) for _ in range(max(1, num_workers))]
        for w in self._workers:
            w.start()

    def _worker(self):
        while not self._stop.is_set():
            with self._idx_lock:
                idx = next(self._indices)
            try:
                item = self.dataset[int(idx)]
            except Exception as exc:  # handed to the consumer, which raises it
                item = exc
            while not self._stop.is_set():
                try:
                    self._item_q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        n = self.batch_size * self.num_accumulate
        items = [self._item_q.get() for _ in range(n)]
        for item in items:
            if isinstance(item, Exception):
                raise RuntimeError("a loader worker could not read a record") from item
        batch = np.stack(items)
        # the layout comes from the dataset's declared mode, not from the dtype
        if self.uint8_hwc:
            if batch.dtype != np.uint8 or batch.shape[-1] != 3:
                raise ValueError(f"dataset declares uint8_hwc but yielded {batch.dtype} {batch.shape[1:]}")
        else:
            if batch.shape[1] != 3:
                raise ValueError(f"dataset yields CHW float but batch item shape is {batch.shape[1:]}")
            batch = batch.astype(np.float32)
        flips = self._rng.rand(n) < 0.5
        w_axis = 2 if self.uint8_hwc else 3  # width: [N, H, W, 3] / [N, 3, H, W]
        batch[flips] = np.flip(batch[flips], axis=w_axis)
        batch = batch.reshape(self.num_accumulate, self.batch_size, *batch.shape[1:])
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def close(self):
        """Stop and join the worker threads (emptying the queue first, so
        that none stays blocked in put)."""
        self._stop.set()
        try:
            while True:
                self._item_q.get_nowait()
        except queue.Empty:
            pass
        for w in self._workers:
            w.join(timeout=5.0)
