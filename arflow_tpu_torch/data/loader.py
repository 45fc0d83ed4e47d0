"""Threaded prefetching data loader with numpy batches (the port's own copy
of ``arflow_tpu/data/loader.py``).

Dataset items are decoded and augmented on host threads while the card
runs, and stacked into numpy batches; the trainer moves them to the
device. Threads, not worker processes: the transforms share one
``RandomState`` (``get_dataset``), which a worker process would copy, so
every worker would repeat the same draws; and the shuffle order is the JAX
loader's, a pure function of (seed, epoch).
"""

from __future__ import annotations

import threading

import numpy as np


def default_collate(items):
    """Stack a list of sample dicts into a batch dict of arrays."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], dict):
            out[key] = default_collate(vals)
        elif isinstance(vals[0], str):
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=2,
                 drop_last=False, seed=0, collate_fn=default_collate,
                 prefetch=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Pin the shuffle order for the next iteration to ``epoch``.

        Shuffling is a pure function of (seed, epoch) — not of how many
        epochs this loader object has served — so a resumed run reproduces
        the unbroken run's batch order exactly (torch DistributedSampler
        semantics). Trainers call this with ``i_epoch`` each epoch."""
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(
                (self.seed * 1000003 + self._epoch) % (2**31 - 1)
            )
            rng.shuffle(idx)
            self._epoch += 1
        nb = len(self)
        for b in range(nb):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self):
        """Bounded in-order pipeline.

        Workers claim batch indices in order but only after acquiring a
        prefetch permit, so at most ``prefetch`` decoded batches are ever
        outstanding (in flight or parked waiting for in-order delivery) —
        a slow consumer back-pressures the decode threads instead of the
        whole epoch being decoded into RAM. The consumer blocks on a
        condition variable (no busy-wait) and releases one permit per
        consumed batch.
        """
        batches = list(self._batches())
        results: dict = {}
        cond = threading.Condition()
        permits = threading.Semaphore(max(1, self.prefetch))
        stop = threading.Event()
        cursor = [0]

        def worker():
            while True:
                # Acquire a prefetch permit before claiming work; the
                # timeout lets the thread notice a consumer that bailed.
                if not permits.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                    continue
                with cond:
                    i = cursor[0]
                    if i >= len(batches) or stop.is_set():
                        permits.release()
                        return
                    cursor[0] += 1
                try:
                    items = [self.dataset[int(j)] for j in batches[i]]
                    batch = self.collate_fn(items)
                except Exception as e:  # propagate to consumer
                    batch = e
                with cond:
                    results[i] = batch
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        try:
            for next_i in range(len(batches)):
                with cond:
                    while next_i not in results:
                        if not cond.wait(timeout=5.0) and not any(
                            t.is_alive() for t in threads
                        ):
                            raise RuntimeError(
                                "DataLoader workers died without producing "
                                f"batch {next_i}"
                            )
                    batch = results.pop(next_i)
                permits.release()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


class InMemoryDataset:
    """Tiny dataset over preloaded sample dicts (tests / synthetic data)."""

    def __init__(self, samples):
        self.samples = list(samples)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]
