"""Batching and host-to-device prefetch.

Port of ``qasr_ijcnlp_tpu/data/loader.py``: :class:`DataLoader` (the same
seeded order and process sharding), :func:`pad_batch_to`, and
:func:`prefetch_to_device`, whose background thread copies each batch into
pinned host memory and on to the card with non-blocking copies while the
current batch runs.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch


class DataLoader:
    """Minimal epoch iterator yielding tuples of stacked numpy arrays."""

    def __init__(
        self,
        dataset,
        batch_size: int = 8,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """``process_index``/``process_count`` shard the dataset across
        hosts for multi-process DP training (a process's rank and the world size):
        every process shuffles the SAME global order (seeded identically)
        and takes a disjoint strided slice.  The order is first wrap-padded
        to a multiple of ``process_count`` so every process sees the SAME
        number of items (hence the same number of batches) — data-parallel steps run
        in lockstep across hosts, and a ragged tail would leave one
        host waiting in a gradient all-reduce that never completes.  The
        union of all shards covers the dataset exactly once, plus at most
        ``process_count - 1`` wrapped duplicates when the length doesn't
        divide."""
        assert 0 <= process_index < process_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def _shard_len(self):
        # identical on every process: ceil(n / count) via wrap padding
        n = len(self.dataset)
        return (n + self.process_count - 1) // self.process_count

    def __len__(self):
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        if self.process_count > 1:
            # wrap-pad so every shard has ceil(n / count) items and every
            # host runs the same number of batches (see __init__ docstring)
            pad = (-n) % self.process_count
            if pad:
                order = np.concatenate([order, order[:pad]])
            order = order[self.process_index :: self.process_count]
            n = len(order)
        self.epoch += 1
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            items = [self.dataset[int(i)] for i in idx]
            yield tuple(
                np.stack([item[f] for item in items]) for f in range(len(items[0]))
            )


def _to_device(x, device):
    t = torch.as_tensor(x)
    if device is None:
        return t
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Stage ``size`` batches ahead on a background thread, moving each
    field to ``device`` (a ``torch.device`` or its name; None: CPU tensors)
    as soon as it is produced: on the card through pinned host memory and a
    non-blocking copy.

    Abandoning the generator early (a loop that raises or breaks mid-epoch)
    releases the producer: its puts poll a stop flag, and the generator's
    ``finally`` sets the flag and drains the queue, so neither the thread
    nor its staged buffers outlive the epoch."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not put(tuple(_to_device(x, device) for x in batch)):
                    return
            put(_END)
        except BaseException as exc:  # re-raised in the consumer, not dropped
            put(exc)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer mid-put on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break


def pad_batch_to(
    batch: Sequence[np.ndarray], batch_size: int, pad_values=None
):
    """Right-pad a short final batch to the fixed compile-time batch size,
    returning (padded_batch, real_count) (fixed batch shapes).

    ``pad_values`` gives one fill per field: a scalar fills the padded rows
    with that value (use the loss's ignore-index so padded rows contribute
    zero loss weight — unlike repeating real samples, which would
    double-count them); ``None`` repeats the last row (pure shape filler for
    inputs like mels, whose padded rows are masked out via the label field).
    """
    real = len(batch[0])
    if real == batch_size:
        return tuple(batch), real
    if pad_values is None:
        pad_values = (None,) * len(batch)
    padded = []
    for arr, fill in zip(batch, pad_values):
        if fill is None:
            pad = np.repeat(arr[-1:], batch_size - real, axis=0)
        else:
            pad = np.full((batch_size - real, *arr.shape[1:]), fill, arr.dtype)
        padded.append(np.concatenate([arr, pad], axis=0))
    return tuple(padded), real
