"""Batch loaders: two-view training loader, eval/projection loaders.

Counterpart of ``util/data.py:466-652`` (``get_dataloaders``'s seven loaders)
re-designed for a single-host input pipeline (the port's copy of the JAX
package's ``data/loader.py``; batches are numpy, the caller moves them to
the card):

* map-style datasets over ``ImageFolder`` with numpy RNG (seeded, resumable);
* the reference's drop_last rule: drop the remainder iff it is < 20%% of a
  batch (``util/data.py:511-515``);
* weighted (inverse class frequency) sampling with replacement
  (``util/data.py:497-507``);
* leave-out-class filtering (``util/data.py:486-495,516-523``);
* per-host sharding for multi-host training (the DistributedSampler
  equivalent, ``main_dist.py:54-68``): each host reads a strided subset;
* background-thread prefetch (the host has few cores; decode/augment overlap
  with device steps).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .augment import EvalTransform, TwoViewTransform
from .folder import ImageFolder

# the decoded-base RAM cache of one TwoViewDataset holds at most this much:
# a CUB-scale train split at 232^2
BASE_CACHE_BYTES = 4 << 30


@dataclass
class Batch:
    xs1: np.ndarray          # (B, H, W, 3) float32, normalized
    xs2: Optional[np.ndarray]
    ys: np.ndarray           # (B,) int64


class TwoViewDataset:
    """(view1, view2, target) per sample (ref TwoAugSupervisedDataset,
    util/data.py:880-901).

    ``device_photometric=True``: yields ONE shared geometric uint8 view
    (``xs2 is None``); the train step derives both photometric views on
    the device (ops/device_augment) — the host-side transform2 is a few-core
    loader's bottleneck.

    ``device_geometric=True`` (implies device_photometric): yields the
    deterministic resized BASE uint8 image; the device also runs transform1
    (ops/device_geometric).  The base is cached in RAM (bounded by
    ``BASE_CACHE_BYTES``) so steady-state host work per sample is one array copy —
    decode + PIL TrivialAugment shear/rotate (~5-8 ms/img) otherwise caps
    end-to-end training at a fraction of device throughput."""

    def __init__(self, folder: ImageFolder, transform: TwoViewTransform,
                 device_photometric: bool = False,
                 device_geometric: bool = False):
        self.folder = folder
        self.transform = transform
        self.device_photometric = (device_photometric
                                   and transform.supports_device_photometric)
        self.device_geometric = (device_geometric and self.device_photometric
                                 and transform.supports_device_geometric)
        self._cache: dict = {}
        self._cache_bytes = 0
        self._cache_limit = BASE_CACHE_BYTES
        self._cache_lock = threading.Lock()

    def __len__(self):
        return len(self.folder)

    def _base(self, index: int) -> np.ndarray:
        with self._cache_lock:
            hit = self._cache.get(index)
        if hit is not None:
            return hit
        img, _ = self.folder.load(index)
        base = self.transform.base_view(img)
        with self._cache_lock:
            if index not in self._cache and self._cache_bytes + base.nbytes <= self._cache_limit:
                self._cache[index] = base
                self._cache_bytes += base.nbytes
        return base

    def get(self, index: int, rng: np.random.Generator):
        if self.device_geometric:
            return self._base(index), None, self.folder.targets[index]
        img, target = self.folder.load(index)
        if self.device_photometric:
            return self.transform.geometric_view(img, rng), None, target
        v1, v2 = self.transform(img, rng)
        return v1, v2, target


class EvalDataset:
    def __init__(self, folder: ImageFolder, transform: EvalTransform):
        self.folder = folder
        self.transform = transform

    def __len__(self):
        return len(self.folder)

    def get(self, index: int, rng=None):
        img, target = self.folder.load(index)
        return self.transform(img), None, target


def reference_drop_last(n: int, batch_size: int) -> bool:
    """Drop the ragged tail iff it is < 20% of a batch (util/data.py:511-515)."""
    return (n % batch_size) / batch_size < 0.2


def _parallel_batches(make_batch, nb: int, *, workers: int, ahead: int):
    """In-order multi-worker batch production (the ``num_workers`` pool).

    PIL decode / numpy augment release the GIL for their heavy inner loops, so
    threads give real parallelism without the ~25 MB/batch pickling cost a
    process pool would pay.  Exceptions raised inside a worker are forwarded
    to the consumer (a dead producer must never leave the consumer
    blocked).  At most ``ahead`` completed batches are held.
    """
    cond = threading.Condition()
    results: dict = {}
    state = {"next_in": 0, "next_out": 0, "stop": False}

    def worker():
        while True:
            with cond:
                while (not state["stop"] and state["next_in"] < nb
                       and state["next_in"] - state["next_out"] >= ahead):
                    cond.wait()
                if state["stop"] or state["next_in"] >= nb:
                    return
                bi = state["next_in"]
                state["next_in"] += 1
            try:
                out = make_batch(bi)
            except BaseException as e:  # noqa: BLE001 — forwarded, re-raised
                out = e
            with cond:
                results[bi] = out
                cond.notify_all()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, workers))]
    for t in threads:
        t.start()
    try:
        for bi in range(nb):
            with cond:
                while bi not in results:
                    if not any(t.is_alive() for t in threads):
                        raise RuntimeError(
                            f"all loader workers exited before batch {bi} was "
                            "produced")
                    cond.wait(timeout=1.0)
                out = results.pop(bi)
                state["next_out"] = bi + 1
                cond.notify_all()
            if isinstance(out, BaseException):
                raise out
            yield out
    finally:
        with cond:
            state["stop"] = True
            cond.notify_all()


class Loader:
    """Epoch-based batch iterator with shuffling / weighted sampling /
    leave-out filtering / host sharding / threaded prefetch."""

    def __init__(self, dataset, batch_size: int, *, seed: int = 1,
                 shuffle: bool = True, drop_last: Optional[bool] = None,
                 weighted: bool = False,
                 keep_labels: Optional[Sequence[int]] = None,
                 keep_indices: Optional[Sequence[int]] = None,
                 num_hosts: int = 1, host_id: int = 0,
                 prefetch: int = 2, num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.weighted = weighted
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.prefetch = prefetch
        self.num_workers = max(1, int(num_workers))

        targets = dataset.folder.targets
        idx = (np.asarray(list(keep_indices), np.int64) if keep_indices is not None
               else np.arange(len(dataset)))
        if keep_labels is not None:
            keep = np.isin(targets[idx], np.asarray(list(keep_labels)))
            idx = idx[keep]
        self.indices = idx
        self.targets = targets
        if weighted:
            counts = np.bincount(targets[idx])
            w = 1.0 / np.maximum(counts, 1)
            self.sample_weights = w[targets[idx]]
            self.sample_weights /= self.sample_weights.sum()
        else:
            self.sample_weights = None

        n_local = len(self.indices) // num_hosts if num_hosts > 1 else len(self.indices)
        self.drop_last = (reference_drop_last(n_local, batch_size)
                          if drop_last is None else drop_last)
        self._epoch_len = (n_local // batch_size if self.drop_last
                           else -(-n_local // batch_size))

    def __len__(self):
        return self._epoch_len

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        if self.weighted:
            order = rng.choice(self.indices, size=len(self.indices), replace=True,
                               p=self.sample_weights)
        elif self.shuffle:
            order = rng.permutation(self.indices)
        else:
            order = self.indices
        if self.num_hosts > 1:
            # strided shard like DistributedSampler (pad by wrapping)
            n = -(-len(order) // self.num_hosts) * self.num_hosts
            order = np.concatenate([order, order[: n - len(order)]])
            order = order[self.host_id::self.num_hosts]
        return order

    def epoch_index_batches(self, epoch: int = 0):
        """(dataset_rows, targets) per batch — the full sampling pipeline
        (shuffle / weighted / leave-out / host shard / drop_last) WITHOUT
        materializing images, for the device-resident data cache
        (data/device_cache.py): the device gathers the rows itself."""
        order = self._epoch_indices(epoch)
        for bi in range(self._epoch_len):
            rows = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            yield (np.ascontiguousarray(rows, np.int32),
                   np.asarray(self.targets[rows], np.int64))

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        order = self._epoch_indices(epoch)
        nb = self._epoch_len

        def make_batch(bi: int) -> Batch:
            # per-BATCH rng seeding makes augmentation deterministic and
            # independent of worker count / scheduling order
            rng = np.random.default_rng((self.seed, epoch, self.host_id, 7, bi))
            rows = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            v1s, v2s, ts = [], [], []
            for i in rows:
                v1, v2, t = self.dataset.get(int(i), rng)
                v1s.append(v1)
                if v2 is not None:
                    v2s.append(v2)
                ts.append(t)
            return Batch(xs1=np.stack(v1s),
                         xs2=np.stack(v2s) if v2s else None,
                         ys=np.asarray(ts, np.int64))

        if self.prefetch <= 0:
            for bi in range(nb):
                yield make_batch(bi)
            return
        yield from _parallel_batches(make_batch, nb,
                                     workers=self.num_workers,
                                     ahead=max(self.prefetch, self.num_workers))


@dataclass
class Loaders:
    """The reference's seven-loader bundle (util/data.py:652)."""
    train: Loader
    train_pretraining: Loader
    train_normal: Loader
    train_normal_augment: Loader
    project: Loader
    test: Loader
    test_project: Loader
    classes: List[str]


def stratified_split(targets: np.ndarray, test_size: float, seed: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic per-class (stratified) train/test index split — the
    ``train_test_split(..., stratify=targets, random_state=seed)`` used when
    a dataset has no test directory (ref util/data.py:663-668).  Each class
    contributes ``round(n_c * test_size)`` samples (at least 1, never all)."""
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"validation_size must be in (0, 1), got {test_size}")
    rng = np.random.default_rng(seed)
    train_idx, test_idx = [], []
    for c in np.unique(targets):
        rows = np.flatnonzero(targets == c)
        rows = rng.permutation(rows)
        n_test = int(np.clip(round(len(rows) * test_size), 1, len(rows) - 1))
        test_idx.append(rows[:n_test])
        train_idx.append(rows[n_test:])
    return (np.sort(np.concatenate(train_idx)),
            np.sort(np.concatenate(test_idx)))


def build_loaders(train_dir: str, test_dir: Optional[str], *,
                  image_size: int = 224,
                  batch_size: int = 64, batch_size_pretrain: int = 128,
                  seed: int = 1, project_dir: Optional[str] = None,
                  train_dir_pretrain: Optional[str] = None,
                  test_dir_projection: Optional[str] = None,
                  weighted: bool = False,
                  leave_out_classes: Optional[Sequence[str]] = None,
                  disable_transform2: bool = False, cars: bool = False,
                  grayscale: bool = False,
                  validation_size: float = 0.0,
                  num_workers: int = 1,
                  device_photometric: bool = False,
                  device_geometric: bool = False,
                  num_hosts: int = 1, host_id: int = 0) -> Loaders:
    from .folder import scan_image_folder

    train_folder = scan_image_folder(train_dir)
    # --validation_size: with no test directory, carve a stratified split of
    # the train folder and use the held-out part as the test set
    # (ref util/data.py:663-668; same rule applied to the pretrain folder at
    # util/data.py:685-691)
    train_keep = pretrain_keep = None
    if test_dir is None:
        if validation_size <= 0.0:
            raise ValueError("no test set directory: validation_size must be "
                             "> 0 so the training set can be split "
                             "(ref util/data.py:664-665)")
        train_keep, test_keep = stratified_split(train_folder.targets,
                                                 validation_size, seed)
        test_folder = train_folder
    else:
        test_keep = None
        test_folder = scan_image_folder(test_dir)
    project_folder = scan_image_folder(project_dir or train_dir)
    if train_dir_pretrain:
        pretrain_folder = scan_image_folder(train_dir_pretrain)
        if test_dir is None:
            pretrain_keep, _ = stratified_split(pretrain_folder.targets,
                                                validation_size, seed)
    else:
        pretrain_folder, pretrain_keep = train_folder, train_keep
    testproj_folder = (scan_image_folder(test_dir_projection)
                       if test_dir_projection else test_folder)
    testproj_keep = None if test_dir_projection else test_keep

    keep = None
    if leave_out_classes:
        if weighted:
            raise ValueError("leave_out_classes and weighted sampling are mutually "
                             "exclusive (ref util/data.py:483-484)")
        keep = [train_folder.class_to_idx[c] for c in train_folder.classes
                if c not in set(leave_out_classes)]

    tv = TwoViewTransform(image_size, disable_transform2=disable_transform2,
                          cars=cars, grayscale=grayscale)
    tvp = TwoViewTransform(image_size, pretrain=True,
                           disable_transform2=disable_transform2, cars=cars,
                           grayscale=grayscale)
    ev = EvalTransform(image_size, grayscale=grayscale)

    common = dict(seed=seed, num_hosts=num_hosts, host_id=host_id,
                  num_workers=num_workers)
    return Loaders(
        train=Loader(TwoViewDataset(train_folder, tv,
                                    device_photometric=device_photometric,
                                    device_geometric=device_geometric),
                     batch_size, weighted=weighted, keep_labels=keep,
                     keep_indices=train_keep, **common),
        train_pretraining=Loader(TwoViewDataset(pretrain_folder, tvp,
                                                device_photometric=device_photometric,
                                                device_geometric=device_geometric),
                                 batch_size_pretrain, weighted=weighted,
                                 keep_labels=keep, keep_indices=pretrain_keep,
                                 **common),
        train_normal=Loader(EvalDataset(train_folder, ev), batch_size,
                            keep_labels=keep, keep_indices=train_keep, **common),
        train_normal_augment=Loader(TwoViewDataset(train_folder, tv), batch_size,
                                    keep_labels=keep, keep_indices=train_keep,
                                    **common),
        project=Loader(EvalDataset(project_folder, ev), 1, shuffle=False,
                       drop_last=False, seed=seed),
        test=Loader(EvalDataset(test_folder, ev), batch_size, shuffle=True,
                    drop_last=False, seed=seed, keep_indices=test_keep,
                    num_workers=num_workers),
        test_project=Loader(EvalDataset(testproj_folder, ev), 1, shuffle=False,
                            drop_last=False, seed=seed,
                            keep_indices=testproj_keep),
        classes=train_folder.classes,
    )
