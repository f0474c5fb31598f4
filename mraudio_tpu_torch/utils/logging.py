"""Training metrics: smoothed windows of a series (``SmoothedValue``) and
a set of them (``MetricLogger``), the LAVIS meters the reference trainer
uses.  Under a distributed launch the meters' totals and counts are
summed across the processes, and only rank 0 logs."""

from __future__ import annotations

import collections
import datetime
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from mraudio_tpu_torch.device import is_main_process

logger = logging.getLogger("mraudio_tpu_torch")


class SmoothedValue:
    """Track a series and expose median/avg over a window plus global
    totals."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: collections.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum the count and the total over every process (one process:
        nothing to gather)."""
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        agg = torch.tensor([self.count, self.total], dtype=torch.float64, device=dev)
        dist.all_reduce(agg)
        self.count, self.total = int(agg[0]), float(agg[1])

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v)
            self.meters[k].update(v)

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def global_avg(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter.global_avg:.4f}" for name, meter in self.meters.items())

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        for i, obj in enumerate(iterable):
            t0 = time.time()
            yield obj
            iter_time.update(time.time() - t0)
            if i % print_freq == 0 and is_main_process():
                logger.info("%s [%d]  %s  time: %s", header, i, str(self), str(iter_time))
        total = time.time() - start
        if is_main_process():
            logger.info("%s total: %s", header, datetime.timedelta(seconds=int(total)))
