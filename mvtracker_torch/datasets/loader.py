"""Host-side data loading: prefetching iterator over scene datasets.

Replaces the reference's torchdata StatefulDataLoader workers
(`cli/train.py:546-558`) with a thread-pool prefetcher (numpy pipelines
release the GIL in the hot paths — image decode, blur, resize). The
iterator is *stateful*: its position (epoch, cursor, RNG) can be saved and
restored with checkpoints, mirroring the reference's dataloader
statefulness (`cli/train.py:52,546`).

A copy of `PrefetchLoader`, `SyntheticSceneDataset` (with its train-time
augmentations and on-disk scene cache), `MonocularProxyDataset` and
`compress_batch_for_transfer` from `mvtracker_tpu/datasets/loader.py` (the
port imports nothing of that package). The per-process slicing of the
permutation waits for the data-parallel mesh (ROADMAP A.5).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import zipfile
from typing import Iterator, Optional

import numpy as np

from mvtracker_torch.datasets.datapoint import Datapoint, collate


class PrefetchLoader:
    """Prefetching, shuffling, stateful batch loader.

    `dataset` is any indexable returning a Datapoint; `batch_size` scenes
    are collated into the train-step batch dict.

    Data parallelism: with `process_index` and `process_count` every process
    walks the same seeded permutation and takes the disjoint stride
    `order[process_index::process_count]`, so one epoch is a partition of
    the dataset, as in the JAX loader. `process_index` without
    `process_count` raises.
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
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
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
        self.process_index = process_index
        self.process_count = process_count

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
        order = np.random.default_rng(self.seed + epoch).permutation(n) if self.shuffle else np.arange(n)
        if self.process_count is None:
            if self.process_index is not None:
                raise ValueError("process_index given without process_count")
            return order
        return order[(self.process_index or 0) :: self.process_count]

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

    `augment=True` runs `default_train_augmentations` on every touch with a
    fresh, unseeded generator, as the JAX package does (the reference's
    train-time augmentations are unseeded too). `disk_cache_dir` keeps the
    rendered scenes as `scene_<seed>.npz` files, keyed by the scene's seed:
    a restarted run reads them instead of rendering again (a change of the
    renderer's parameters needs a fresh directory).
    """

    def __init__(
        self,
        n_scenes: int = 64,
        seed: int = 0,
        cache: bool = False,
        randomize: bool = False,
        augment: bool = False,
        disk_cache_dir: Optional[str] = None,
        **render_kwargs,
    ):
        self.n_scenes = n_scenes
        self.seed = seed
        self.randomize = randomize
        self.augment = augment
        self.render_kwargs = render_kwargs
        self._cache: dict[int, Datapoint] = {} if cache else None
        self._disk_dir = disk_cache_dir
        if disk_cache_dir:
            os.makedirs(disk_cache_dir, exist_ok=True)

    def __len__(self):
        return self.n_scenes

    def _disk_path(self, scene_seed: int) -> str:
        return os.path.join(self._disk_dir, f"scene_{scene_seed}.npz")

    def _disk_load(self, scene_seed: int) -> Optional[Datapoint]:
        path = self._disk_path(scene_seed)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                return Datapoint(**{k: z[k] for k in z.files if k != "seq_name"}, seq_name=f"synthetic_{scene_seed}")
        except (OSError, ValueError, EOFError, zipfile.BadZipFile):  # a truncated file: render again
            return None

    def _disk_save(self, scene_seed: int, dp: Datapoint) -> None:
        arrays = {
            f.name: getattr(dp, f.name) for f in dataclasses.fields(dp) if isinstance(getattr(dp, f.name), np.ndarray)
        }
        # np.savez appends ".npz" to a name without it: keep the suffix so
        # the temporary path is the file savez writes.
        tmp = self._disk_path(scene_seed) + f".tmp{os.getpid()}.{threading.get_ident()}.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self._disk_path(scene_seed))  # a reader never sees half a file

    def __getitem__(self, idx: int) -> Datapoint:
        scene_seed = self.seed * 100_003 + idx
        if self._cache is not None and idx in self._cache:
            dp = self._cache[idx]
        else:
            dp = self._disk_load(scene_seed) if self._disk_dir else None
            if dp is None:
                from mvtracker_torch.datasets.synthetic import render_scene

                kwargs = dict(self.render_kwargs)
                if self.randomize:
                    srng = np.random.default_rng(scene_seed + 17)
                    kwargs.setdefault("n_objects", int(srng.integers(3, 9)))
                    kwargs.setdefault("static_fraction", float(srng.uniform(0.0, 0.5)))
                    kwargs.setdefault("cam_radius", float(srng.uniform(3.0, 5.0)))
                dp = render_scene(seed=scene_seed, **kwargs)
                if self._disk_dir:
                    self._disk_save(scene_seed, dp)
            if self._cache is not None:
                self._cache[idx] = dp
        if self.augment:
            from mvtracker_torch.datasets.augmentations import default_train_augmentations

            dp = default_train_augmentations(dp, np.random.default_rng())
        return dp


class MonocularProxyDataset:
    """Any multi-view dataset as monocular 2D-tracking problems, for
    training `models.cotracker2d.CoTracker2D`.

    Per scene: one view's video (view `view`, or the scene index modulo the
    view count), that view's pixel track (x, y, 0) in place of the world
    track, the query at its first visible frame in that view (frame 0 when
    it is never visible there), zero depths. The Datapoint contract and the
    trainer and losses apply unchanged, with z supervised to 0."""

    def __init__(self, base, view: Optional[int] = None):
        self.base = base
        self.view = view

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int) -> Datapoint:
        dp = self.base[idx]
        vi = self.view if self.view is not None else idx % dp.video.shape[0]
        traj2d = dp.trajectory[vi]  # [T, N, 3] (x, y, camera z)
        t, n = traj2d.shape[:2]
        traj = np.concatenate([traj2d[..., :2], np.zeros((t, n, 1), np.float32)], axis=-1)
        visibility = dp.visibility[vi : vi + 1]  # [1, T, N]
        first = np.argmax(visibility[0], axis=0)
        first[~visibility[0].any(axis=0)] = 0
        query = np.concatenate([first[:, None].astype(np.float32), traj[first, np.arange(n)]], axis=1)
        return Datapoint(
            video=dp.video[vi : vi + 1],
            videodepth=np.zeros_like(dp.videodepth[vi : vi + 1]),
            intrs=dp.intrs[vi : vi + 1],
            extrs=dp.extrs[vi : vi + 1],
            trajectory=traj[None].copy(),
            visibility=visibility,
            trajectory_3d=traj,
            query_points_3d=query,
            valid=np.ones((t, n), bool),
            seq_name=f"{dp.seq_name}_view{vi}_2d",
        )


def compress_batch_for_transfer(batch: dict) -> dict:
    """Shrink a batch for the host-to-device copy: rgbs (0..255 floats)
    become uint8 and float32 depths float16. The train step casts both back
    to float32 on the device (`training/step.py::scene_loss`). uint8
    rounding loses under 0.5/255 of photometric precision; float16 depth
    carries about 0.05% relative error."""
    out = dict(batch)
    if "rgbs" in out and out["rgbs"].dtype != np.uint8:
        out["rgbs"] = np.clip(np.rint(out["rgbs"]), 0, 255).astype(np.uint8)
    if "depths" in out and out["depths"].dtype == np.float32:
        out["depths"] = out["depths"].astype(np.float16)
    return out
