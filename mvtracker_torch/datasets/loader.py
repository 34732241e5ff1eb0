"""Host-side data loading: prefetching iterator over scene datasets.

Replaces the reference's torchdata StatefulDataLoader workers
(`cli/train.py:546-558`) with a thread-pool prefetcher (numpy pipelines
release the GIL in the hot paths — image decode, blur, resize). The
iterator is *stateful*: its position (epoch, cursor, RNG) can be saved and
restored with checkpoints, mirroring the reference's dataloader
statefulness (`cli/train.py:52,546`).

A copy of `PrefetchLoader` and `SyntheticSceneDataset` from
`mvtracker_tpu/datasets/loader.py` (the port imports nothing of that
package). The train-time augmentations are not
ported: `SyntheticSceneDataset(augment=True)` raises. The per-process
slicing of the permutation waits for the data-parallel mesh, and the
on-disk scene cache for a dataset that needs it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from mvtracker_torch.datasets.datapoint import Datapoint, collate


class PrefetchLoader:
    """Prefetching, shuffling, stateful batch loader.

    `dataset` is any indexable returning a Datapoint; `batch_size` scenes
    are collated into the train-step batch dict.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0
        self.cursor = 0
        self._executor = None

    # -- statefulness --------------------------------------------------
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "cursor": self.cursor, "seed": self.seed}

    def load_state_dict(self, state: dict):
        self.epoch = state["epoch"]
        self.cursor = state["cursor"]
        self.seed = state["seed"]

    # -- iteration -----------------------------------------------------
    def _order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng(self.seed + epoch).permutation(n)

    def __iter__(self) -> Iterator[dict]:
        while True:
            order = self._order(self.epoch)
            n = len(order)
            while self.cursor + self.batch_size <= n or (
                not self.drop_last and self.cursor < n
            ):
                idxs = order[self.cursor : self.cursor + self.batch_size]
                self.cursor += len(idxs)
                yield self._load_batch(idxs)
            self.epoch += 1
            self.cursor = 0

    def _load_batch(self, idxs) -> dict:
        if self.num_workers <= 1 or len(idxs) == 1:
            dps = [self.dataset[int(i)] for i in idxs]
        else:
            if self._executor is None:
                from concurrent.futures import ThreadPoolExecutor

                self._executor = ThreadPoolExecutor(max_workers=self.num_workers)
            dps = list(self._executor.map(lambda i: self.dataset[int(i)], idxs))
        return collate(dps)

    def prefetching_iter(self) -> Iterator[dict]:
        """Background-thread prefetch of `prefetch` batches ahead."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_interruptible(item) -> bool:
            """put() that re-checks `stop` — a plain blocking put deadlocks
            the producer forever when the consumer abandons the iterator
            with the queue full (leaking the thread + pinned batches)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self:
                    if not put_interruptible(batch):
                        return
            finally:
                put_interruptible(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()


class SyntheticSceneDataset:
    """Indexable dataset of procedurally generated scenes (seeded per index).

    Stands in for the Kubric training set in hermetic environments; the
    per-index seeding mirrors the reference's per-sample seeded RNG
    (`kubric_multiview_dataset.py:475-484`).
    """

    def __init__(
        self,
        n_scenes: int = 64,
        seed: int = 0,
        cache: bool = False,
        randomize: bool = False,
        augment: bool = False,
        **render_kwargs,
    ):
        self.n_scenes = n_scenes
        self.seed = seed
        self.randomize = randomize
        if augment:
            raise NotImplementedError("SyntheticSceneDataset: the train-time augmentations are not ported yet")
        self.render_kwargs = render_kwargs
        self._cache: dict[int, Datapoint] = {} if cache else None

    def __len__(self):
        return self.n_scenes

    def __getitem__(self, idx: int) -> Datapoint:
        scene_seed = self.seed * 100_003 + idx
        if self._cache is not None and idx in self._cache:
            dp = self._cache[idx]
        else:
            from mvtracker_torch.datasets.synthetic import render_scene

            kwargs = dict(self.render_kwargs)
            if self.randomize:
                srng = np.random.default_rng(scene_seed + 17)
                kwargs.setdefault("n_objects", int(srng.integers(3, 9)))
                kwargs.setdefault("static_fraction", float(srng.uniform(0.0, 0.5)))
                kwargs.setdefault("cam_radius", float(srng.uniform(3.0, 5.0)))
            dp = render_scene(seed=scene_seed, **kwargs)
            if self._cache is not None:
                self._cache[idx] = dp
        return dp
