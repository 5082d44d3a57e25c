"""Prefetching data loader (port of teochat_tpu/data/loader.py).

The reference leans on torch DataLoader worker processes (train_teochat.sh:39
`--dataloader_num_workers 8`); here a pool of threads loads and collates
batches ahead of the consumer (PIL and the native preprocessing release the
GIL while they decode), at most `prefetch` batches ahead, and hands them out
in sampler order. A worker's exception is raised at the consumer.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, List, Optional


class PrefetchLoader:
    """Iterate batches of collated samples with background workers.

    dataset[i] -> sample; collate(list of samples) -> batch. The sampler
    yields indices (e.g. data.sampler.LengthGroupedSampler); batches are formed
    in sampler order, fetched `prefetch` batches ahead.
    """

    def __init__(
        self,
        dataset,
        collate: Callable[[List[Any]], Any],
        batch_size: int,
        sampler: Optional[Iterable[int]] = None,
        num_workers: int = 4,
        prefetch: int = 4,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.collate = collate
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
        self.drop_last = drop_last

    def _index_batches(self) -> Iterator[List[int]]:
        indices = self.sampler if self.sampler is not None else range(len(self.dataset))
        buf: List[int] = []
        for i in indices:
            buf.append(i)
            if len(buf) == self.batch_size:
                yield buf
                buf = []
        if buf and not self.drop_last:
            yield buf

    def _load(self, idx_batch: List[int]):
        return self.collate([self.dataset[i] for i in idx_batch])

    def __iter__(self):
        pool = ThreadPoolExecutor(self.num_workers)
        pending: deque = deque()
        try:
            for idx_batch in self._index_batches():
                pending.append(pool.submit(self._load, idx_batch))
                if len(pending) > self.prefetch:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n
