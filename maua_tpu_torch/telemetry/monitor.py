"""Out-of-band device monitor (counterpart of maua_tpu/telemetry/monitor.py;
the reference's gpumon.py daemon).

A thread samples, every `interval_s` seconds, each visible CUDA device's bytes
allocated now and at the peak (`torch.cuda.memory_allocated` /
`max_memory_allocated`) and the host's resident set size, and every `window`
samples appends their mean as one JSON line to `log_path` (and logs it to
wandb under `gpumon/`)."""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import torch


class DeviceMonitor:
    def __init__(self, log_path: str = "workspace/gpumon.jsonl", interval_s: float = 2.0, window: int = 30,
                 wandb_run=None):
        self.log_path = log_path
        self.interval_s = interval_s
        self.window = window
        self.wandb_run = wandb_run
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._samples: list[dict] = []

    def _sample(self) -> dict:
        out: dict = {"ts": time.time()}
        for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
            out[f"dev{i}_bytes_in_use"] = torch.cuda.memory_allocated(i)
            out[f"dev{i}_peak_bytes"] = torch.cuda.max_memory_allocated(i)
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        out["host_rss_kb"] = int(line.split()[1])
                        break
        except OSError:  # no procfs: no host RSS
            pass
        return out

    def _flush(self, f) -> None:
        keys = [k for k in self._samples[0] if k != "ts"]
        mean = {k: sum(s.get(k, 0) for s in self._samples) / len(self._samples) for k in keys}
        mean["ts"] = self._samples[-1]["ts"]
        f.write(json.dumps(mean) + "\n")
        f.flush()
        if self.wandb_run is not None:
            self.wandb_run.log({f"gpumon/{k}": v for k, v in mean.items() if k != "ts"})
        self._samples = []

    def _loop(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.log_path)), exist_ok=True)
        with open(self.log_path, "a") as f:
            while not self._stop.is_set():
                self._samples.append(self._sample())
                if len(self._samples) >= self.window:
                    self._flush(f)
                self._stop.wait(self.interval_s)

    def start(self) -> "DeviceMonitor":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
