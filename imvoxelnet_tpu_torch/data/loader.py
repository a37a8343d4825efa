"""Threaded prefetching data loader, and the copy of its batches to the card.

Counterpart of ``imvoxelnet_tpu/data/loader.py``: image decode, resize and
normalize run in a thread pool (the native passes release the interpreter
lock) with a bounded prefetch queue, so host work overlaps device work;
epoch shuffling and ``RepeatDataset`` semantics (``dataset_wrappers.py:
11-42``) as there, with the same seeds and the same order.  Batches are the
dataset's ``collate``: torch tensors on the host.  With ``images_dtype``
the images are cast on the host (``torch.bfloat16`` rounds to nearest even,
as the JAX loader's ``ml_dtypes`` cast and the model's own cast do); with
``pin_memory`` they are written straight into page-locked memory.
With ``world_size`` W > 1, ``batch_size`` is the global batch and the
loader of rank r reads only its slice of each (``parallel/mesh.py:
batch_slice``): every rank walks the same seeded global order, and each
sample's augmentation is seeded by its index, so the W slices together are
the one-process batch.

:func:`device_prefetch` is the one-card analog of
``imvoxelnet_tpu/parallel/mesh.py:device_prefetch``: it copies batch N+1 to
the card on a side stream while the caller runs batch N.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class DataLoader:
    def __init__(self, dataset, batch_size: int, train: bool = True,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True, images_dtype=None,
                 pin_memory: bool = False, world_size: int = 1,
                 rank: int = 0):
        if batch_size % world_size:
            raise ValueError(f'global batch {batch_size} does not divide by '
                             f'the world size {world_size}')
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        # num_workers=0 means "no parallelism", torch-style; the pool still
        # needs one thread to run the map
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.images_dtype = images_dtype
        self.pin_memory = pin_memory
        per = batch_size // world_size
        self.rows = slice(rank * per, (rank + 1) * per)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _host(self, batch):
        """The images cast to ``images_dtype``; with ``pin_memory`` every
        tensor in page-locked memory (one copy, the cast fused into it)."""
        out = {}
        for key, t in batch.items():
            dtype = self.images_dtype if key == 'images' else None
            if self.pin_memory or (dtype is not None and dtype != t.dtype):
                t = torch.empty(t.shape, dtype=dtype or t.dtype,
                                pin_memory=self.pin_memory).copy_(t)
            out[key] = t
        return out

    def epoch(self, epoch: int = 0):
        """Yield collated host batches for one epoch."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.train:
            rng = np.random.RandomState(self.seed + epoch)
            rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        batches = [b[self.rows] for b in batches]
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            end = None
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            break
                        rngs = [np.random.RandomState(
                            (self.seed + epoch) * 1_000_003 + int(i))
                            for i in idxs]
                        samples = list(pool.map(
                            lambda a: self.dataset.get_sample(
                                int(a[0]), self.train, a[1]),
                            zip(idxs, rngs)))
                        _put(q, self._host(self.dataset.collate(samples)),
                             stop)
            except Exception as e:              # raised again by the reader
                end = e
            _put(q, end, stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join()


def _put(q, item, stop):
    """Put ``item`` unless the consumer has stopped (it may never read)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


def to_device(batch, device, non_blocking: bool = False):
    return {k: v.to(device, non_blocking=non_blocking)
            for k, v in batch.items()}


def device_prefetch(batches, device):
    """Yield each host batch of ``batches`` on ``device``, having started
    the copy of the next one before yielding.

    On a CUDA device the copies run on a side stream (``non_blocking``,
    from pinned memory where the loader pins), so batch N+1 moves to the
    card while the caller's work on batch N runs; the caller's stream waits
    for a batch's copy before it is used.  Elsewhere each batch is moved
    as it comes."""
    device = torch.device(device)
    if device.type != 'cuda':
        for batch in batches:
            yield to_device(batch, device)
        return
    stream = torch.cuda.Stream(device)

    def start(batch):
        with torch.cuda.stream(stream):
            return to_device(batch, device, non_blocking=True)

    it = iter(batches)
    nxt = next(it, None)
    pending = None if nxt is None else start(nxt)
    while pending is not None:
        current = torch.cuda.current_stream(device)
        current.wait_stream(stream)
        for t in pending.values():
            t.record_stream(current)
        batch = pending
        nxt = next(it, None)
        pending = None if nxt is None else start(nxt)
        yield batch
