"""Training metrics (reference: detectron2/utils/events.py; JAX package
``utils/events.py:34`` ``HistoryBuffer``, :72 ``EventStorage``, :178
``JSONWriter``, :209 ``CommonMetricPrinter``).

``EventStorage`` collects the trainer's scalars by iteration; the writers
flush them. ``JSONWriter`` writes the JAX package's ``metrics.json``
lines: at each flush, one JSON object per iteration that holds a
scalar's newest value (median-smoothed over 20 iterations where the
scalar asks for it), keys sorted. ``TensorboardXWriter`` (JAX package
``utils/events.py:275-300``) writes the same scalars into TensorBoard's
event files, through ``torch.utils.tensorboard`` where it is installed, and
is a no-op with a warning where it is not."""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Optional

import numpy as np

_CURRENT_STORAGE_STACK = []


def get_event_storage() -> "EventStorage":
    assert _CURRENT_STORAGE_STACK, "get_event_storage() has to be called inside a 'with EventStorage(...)' context!"
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """A scalar's (value, iteration) history, with its median and mean over
    the newest values and its global mean."""

    def __init__(self):
        self._data: list = []
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: float) -> None:
        self._data.append((value, iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def median(self, window_size: int) -> float:
        return float(np.median([x[0] for x in self._data[-window_size:]]))

    def avg(self, window_size: int) -> float:
        return float(np.mean([x[0] for x in self._data[-window_size:]]))

    def global_avg(self) -> float:
        return self._global_avg

    def values(self):
        return list(self._data)


class EventStorage:
    """The scalars of a training run by iteration (reference events.py:263);
    ``with EventStorage(start_iter)`` makes it the current one."""

    def __init__(self, start_iter: int = 0):
        self._history = defaultdict(HistoryBuffer)
        self._smoothing_hints = {}
        self._latest_scalars = {}
        self.iter = start_iter

    def put_scalar(self, name: str, value, smoothing_hint: bool = True) -> None:
        value = float(value)
        self._history[name].update(value, self.iter)
        self._latest_scalars[name] = (value, self.iter)
        existing = self._smoothing_hints.get(name)
        if existing is not None:
            assert existing == smoothing_hint, f"Scalar {name} was put with inconsistent smoothing_hint"
        else:
            self._smoothing_hints[name] = smoothing_hint

    def history(self, name: str) -> HistoryBuffer:
        ret = self._history.get(name)
        if ret is None:
            raise KeyError(f"No history metric available for {name}!")
        return ret

    def histories(self):
        return self._history

    def latest_with_smoothing_hint(self, window_size: int = 20):
        return {k: (self._history[k].median(window_size) if self._smoothing_hints[k] else v, itr)
                for k, (v, itr) in self._latest_scalars.items()}

    def __enter__(self):
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        assert _CURRENT_STORAGE_STACK[-1] == self
        _CURRENT_STORAGE_STACK.pop()


class EventWriter:
    def write(self):
        raise NotImplementedError

    def close(self):
        pass


class JSONWriter(EventWriter):
    """Appends to ``json_file`` one line per iteration that has a newer
    scalar than the last flush (reference events.py:49)."""

    def __init__(self, json_file: str, window_size: int = 20):
        os.makedirs(os.path.dirname(os.path.abspath(json_file)), exist_ok=True)
        self._file_handle = open(json_file, "a")
        self._window_size = window_size
        self._last_write = -1

    def write(self) -> None:
        to_save = defaultdict(dict)
        for k, (v, itr) in get_event_storage().latest_with_smoothing_hint(self._window_size).items():
            if itr > self._last_write:
                to_save[itr][k] = v
        if to_save:
            self._last_write = max(to_save.keys())
        for itr, scalars in sorted(to_save.items()):
            scalars["iteration"] = itr
            self._file_handle.write(json.dumps(scalars, sort_keys=True) + "\n")
        self._file_handle.flush()
        os.fsync(self._file_handle.fileno())

    def close(self) -> None:
        self._file_handle.close()


class CommonMetricPrinter(EventWriter):
    """Logs the iteration, the ETA, the median losses, the mean step and
    data times and the learning rate (reference events.py:180)."""

    def __init__(self, max_iter: Optional[int] = None, window_size: int = 20):
        self.logger = logging.getLogger("jtsm_tpu_torch.utils.events")
        self._max_iter = max_iter
        self._window_size = window_size
        self._last_write = None

    def _get_eta(self, storage) -> Optional[str]:
        if self._max_iter is None:
            return None
        iteration = storage.iter
        try:
            eta_seconds = storage.history("time").median(1000) * (self._max_iter - iteration - 1)
            return str(datetime.timedelta(seconds=int(eta_seconds)))
        except KeyError:
            eta_string = None
            if self._last_write is not None:
                per_iter = (time.perf_counter() - self._last_write[1]) / (iteration - self._last_write[0])
                eta_string = str(datetime.timedelta(seconds=int(per_iter * (self._max_iter - iteration - 1))))
            self._last_write = (iteration, time.perf_counter())
            return eta_string

    def write(self) -> None:
        storage = get_event_storage()
        iteration = storage.iter
        if iteration == self._max_iter:
            return

        def read(name, f):
            try:
                return f(storage.history(name))
            except KeyError:
                return None

        data_time = read("data_time", lambda h: h.avg(20))
        iter_time = read("time", lambda h: h.global_avg())
        lr = read("lr", lambda h: "{:.5g}".format(h.latest())) or "N/A"
        eta = self._get_eta(storage)
        losses = "  ".join(f"{k}: {v.median(self._window_size):.4g}" for k, v in storage.histories().items()
                           if "loss" in k)
        self.logger.info(
            (f" eta: {eta}  " if eta else " ") + f"iter: {iteration}  {losses}  "
            + (f"time: {iter_time:.4f}  " if iter_time is not None else "")
            + (f"data_time: {data_time:.4f}  " if data_time is not None else "") + f"lr: {lr}"
        )


class TensorboardXWriter(EventWriter):
    """Adds each scalar's newest value (median-smoothed where the scalar
    asks for it, as ``JSONWriter`` writes it) at its iteration to the event
    files of ``log_dir``, once per iteration that is newer than the last
    flush (reference events.py:130). ``torch.utils.tensorboard`` is
    imported here; without it the writer warns and writes nothing."""

    def __init__(self, log_dir: str, window_size: int = 20, **kwargs):
        self._window_size = window_size
        self._writer = None
        self._last_write = -1
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir, **kwargs)
        except Exception as e:
            logging.getLogger("jtsm_tpu_torch.utils.events").warning(
                f"tensorboard is not available ({type(e).__name__}: {e}); TensorboardXWriter writes nothing")

    def write(self) -> None:
        if self._writer is None:
            return
        new_last_write = self._last_write
        for k, (v, itr) in get_event_storage().latest_with_smoothing_hint(self._window_size).items():
            if itr > self._last_write:
                self._writer.add_scalar(k, v, itr)
                new_last_write = max(new_last_write, itr)
        self._last_write = new_last_write

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
