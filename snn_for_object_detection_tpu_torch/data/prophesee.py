"""Prophesee GEN1 / 1Mpx dataset streams and the data module.

The port's copy of ``snn_for_object_detection_tpu/data/prophesee.py``:
the same file shuffle, shards, sampling and batches, so one seed gives
bit-equal frames and labels in both packages (with one worker thread;
with more, the order in which their samples reach the queue is the
threads' race, in both). Every window is rasterized by the native
kernel (``native/event_ops.cc``); its numpy path is the kernel's plain
version, ``native.rasterize_records_reference``.

Behavioral parity with the reference's utils/datasets.py:

- file discovery by ``*_bbox.npy`` <-> ``*_td.dat`` pairing (:90-104);
- label conversion µs -> frame index + pixel -> normalized xyxy
  (:252-275);
- ``STStream`` = single-target sampling for training (:347-435):
  label-at-end windows, box-size / event-count thresholds, 1Mpx x-clip;
- ``MTStream`` = multi-target fixed windows (:290-344);
- rolling pool of ``num_load_file`` open readers, shuffled infinite
  per-shard file cycling (:225-250);
- collate stacks time-major batches and pads labels with -1 (:127-135)
  — here to a *static* ``max_labels`` so every batch has one shape.

Differences from the reference: frames are NHWC ``[T, B, H, W, 2]``;
batch assembly runs in host threads (the native kernel and numpy
release the GIL) feeding a bounded queue, instead of torch DataLoader
worker processes. A worker's exception is raised in the consumer.
"""

from __future__ import annotations

import glob
import os
import queue
import random
import threading
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from snn_for_object_detection_tpu_torch.data.augment import make_augmenter
from snn_for_object_detection_tpu_torch.data.psee import EventReader
from snn_for_object_detection_tpu_torch.native import rasterize_records

# name -> (height, width, time-field name in the GT npy, class labels)
DATASET_GEOMETRY = {
    "gen1": (240, 304, "ts", ["car", "person"]),
    "1mpx": (
        720,
        1280,
        "t",
        [
            "pedestrians",
            "two wheelers",
            "cars",
            "trucks",
            "buses",
            "signs",
            "traffic lights",
        ],
    ),
}


def prepare_labels(
    gt: np.ndarray, time_field: str, time_step_us: int, width: int, height: int
) -> np.ndarray:
    """Structured GT array -> [N, 6] float32
    (frame_idx, class_id, x1, y1, x2, y2), normalized (datasets.py:252-275)."""
    return np.stack(
        [
            (gt[time_field] // time_step_us).astype(np.float32),
            gt["class_id"].astype(np.float32),
            gt["x"] / width,
            gt["y"] / height,
            (gt["x"] + gt["w"]) / width,
            (gt["y"] + gt["h"]) / height,
        ],
        axis=1,
    ).astype(np.float32)


class _StreamBase:
    """Infinite per-shard sample stream over (.npy, .dat) file pairs."""

    def __init__(
        self,
        gt_files: Sequence[str],
        data_files: Sequence[str],
        time_step: int,
        num_load_file: int,
        height: int,
        width: int,
        time_field: str,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        frame_dtype=np.uint8,
    ):
        assert num_load_file > 0
        self.gt_files = list(gt_files)
        self.data_files = list(data_files)
        self.time_step_us = time_step * 1000
        self.num_load_file = num_load_file
        self.height, self.width = height, width
        self.time_field = time_field
        self.frame_dtype = np.dtype(frame_dtype)
        self.rng = random.Random(seed)
        # Contiguous per-shard slice, like the reference's per-worker
        # sharding (datasets.py:233-240).
        per_shard = max(len(self.gt_files) // num_shards, 1)
        lo = min(per_shard * shard_id, len(self.gt_files))
        hi = min(per_shard * (shard_id + 1), len(self.gt_files))
        self.shard_idx = list(range(lo, hi)) or list(range(len(self.gt_files)))

    def _file_pool(self):
        """Yield rolling pools of opened (labels, reader) pairs."""
        order = list(self.shard_idx)
        self.rng.shuffle(order)
        pos = 0
        while True:
            labels, readers = [], []
            for _ in range(self.num_load_file):
                idx = order[pos % len(order)]
                pos += 1
                gt = np.load(self.gt_files[idx])
                labels.append(
                    prepare_labels(
                        gt, self.time_field, self.time_step_us,
                        self.width, self.height,
                    )
                )
                readers.append(EventReader(self.data_files[idx]))
            yield labels, readers

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError


class STStream(_StreamBase):
    """Single-target stream (training default; datasets.py:347-435).

    Yields ``(features [T, H, W, 2], labels [N, 5])`` where labels
    (class, x1, y1, x2, y2) annotate the final frames only.
    """

    def __init__(self, num_steps: int, time_shift: int, clip_x: bool = False,
                 **kwargs):
        super().__init__(**kwargs)
        self.num_steps = num_steps
        self.time_shift = time_shift
        self.clip_x = clip_x  # 1Mpx has out-of-frame x coords (:425-426)
        self.events_threshold = 4000  # min avg events/frame (:354)
        self.box_size_threshold = 0.01  # min box area fraction (:356)

    def __iter__(self):
        pool = self._file_pool()
        while True:
            labels_list, readers = next(pool)
            live = list(range(self.num_load_file))
            while live:
                keep = []
                for idx in live:
                    sample, retry = self._parse(labels_list[idx], readers[idx])
                    if retry:
                        keep.append(idx)
                    if sample is not None:
                        yield sample
                live = keep
                self.rng.shuffle(live)

    def _parse(self, gt: np.ndarray, reader: EventReader):
        if reader.done:
            return None, False

        start_time_us = reader.current_time
        start_step = start_time_us // self.time_step_us
        future = gt[gt[:, 0] >= start_step + self.num_steps]
        if not future.size:
            return None, False
        labels = future[future[:, 0] == future[0, 0]]

        area = (labels[:, 4] - labels[:, 2]) * (labels[:, 5] - labels[:, 3])
        labels = labels[area > self.box_size_threshold]
        if not labels.size:
            return None, False

        first_label_time_us = int(labels[0, 0]) * self.time_step_us
        first_event_time_us = first_label_time_us - self.time_step_us * (
            self.num_steps - self.time_shift
        )
        records = reader.load_delta_t_records(
            first_label_time_us
            + self.time_step_us * self.time_shift
            - start_time_us
        )

        # fused C++ decode+scatter (one pass, no columns)
        features, n_events = rasterize_records(
            records, first_event_time_us, self.time_step_us,
            self.num_steps, self.height, self.width, clip_x=self.clip_x,
            dtype=self.frame_dtype,
        )
        # Note: n_events == 0 also lands here (0 < threshold), so the
        # file is retried rather than dropped — reader.done catches
        # exhausted files on the next call. The reference behaves
        # identically (datasets.py:417 fires before the empty check).
        if (n_events // self.num_steps) < self.events_threshold:
            return None, True
        return (features, labels[:, 1:].copy()), True


class MTStream(_StreamBase):
    """Multi-target stream: fixed windows, all labels in the window with
    window-relative timestamps (datasets.py:290-344).

    Yields ``(features [T, H, W, 2], labels [N, 6])`` with labels
    (frame_idx, class, x1, y1, x2, y2).
    """

    def __init__(self, num_steps: int, record_time_us: int = 60_000_000,
                 **kwargs):
        super().__init__(**kwargs)
        self.num_steps = num_steps
        self.duration_us = self.time_step_us * num_steps
        self.record_steps = max(record_time_us // self.duration_us, 1)

    def __iter__(self):
        pool = self._file_pool()
        shuffle_idx = list(range(self.num_load_file * self.record_steps))
        self.rng.shuffle(shuffle_idx)
        while True:
            labels_list, readers = next(pool)
            for idx in shuffle_idx:
                data_idx = idx % self.num_load_file
                yield self._parse(labels_list[data_idx], readers[data_idx])

    def _parse(self, gt: np.ndarray, reader: EventReader):
        if reader.done:
            reader.reset()
        start_time = reader.current_time // self.time_step_us
        end_time = start_time + self.num_steps
        records = reader.load_delta_t_records(self.duration_us)
        features, _ = rasterize_records(
            records, start_time * self.time_step_us, self.time_step_us,
            self.num_steps, self.height, self.width,
            dtype=self.frame_dtype,
        )
        sel = (gt[:, 0] >= start_time) & (gt[:, 0] < end_time)
        labels = gt[sel].copy()
        labels[:, 0] -= start_time
        return features, labels


class _WorkerError:
    """A loader worker's exception on its way to the consumer."""

    def __init__(self, error: Exception):
        self.error = error


def collate(
    samples: List[Tuple[np.ndarray, np.ndarray]], max_labels: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack features time-major [T, B, H, W, 2]; pad labels with -1 to
    a static width (datasets.py:127-135)."""
    features = np.stack([s[0] for s in samples], axis=1)
    label_dim = samples[0][1].shape[1] if samples[0][1].ndim == 2 else 5
    labels = np.full((len(samples), max_labels, label_dim), -1.0, np.float32)
    for i, (_, lab) in enumerate(samples):
        n = min(len(lab), max_labels)
        labels[i, :n] = lab[:n]
    return features, labels


class PropheseeDataModule:
    """Dataset orchestration (the ``PropheseeDataModule`` analogue,
    datasets.py:16-167): split discovery, stream construction, threaded
    batch assembly.
    """

    def __init__(
        self,
        data_dir: str = "./data",
        dataset: str = "gen1",
        batch_size: int = 4,
        num_workers: int = 4,
        num_load_file: int = 8,
        num_steps: int = 42,
        time_step: int = 16,
        time_shift: int = 16,
        one_label: bool = True,
        max_labels: int = 64,
        prefetch: int = 4,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        frame_dtype: str = "uint8",
        augment=None,
    ):
        if dataset not in DATASET_GEOMETRY:
            raise ValueError(f'The dataset parameter cannot be "{dataset}"!')
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} is not in [0, {num_hosts})")
        self.data_dir = data_dir
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(num_workers, 1)
        self.num_load_file = num_load_file
        self.num_steps = num_steps
        self.time_step = time_step
        self.time_shift = time_shift
        self.one_label = one_label
        self.max_labels = max_labels
        self.prefetch = prefetch
        self.seed = seed
        # data parallelism across ranks: each rank ("host") reads a
        # disjoint shard of the files (the Trainer derives these from
        # the rank and the world size)
        self.host_id = host_id
        self.num_hosts = num_hosts
        # uint8 frames: 4x smaller host buffers (the memset dominates
        # 1Mpx rasterization) and 4x less host->device transfer; the
        # model casts to its compute dtype on the device.
        self.frame_dtype = frame_dtype
        # Train-split augmentation policy (ST samples only): None/False
        # off, True -> hflip 0.5, or a dict of Augmenter fields
        # (data/augment.py). Beyond-reference.
        self.augment = make_augmenter(augment)
        self.height, self.width, self.time_field, self._labels = (
            DATASET_GEOMETRY[dataset]
        )

    def get_labels(self) -> List[str]:
        return list(self._labels)

    def _files(self, split: str) -> Tuple[List[str], List[str]]:
        data_dir = os.path.join(self.data_dir, self.dataset, split)
        gt_files = sorted(glob.glob(os.path.join(data_dir, "*_bbox.npy")))
        data_files = [p.replace("_bbox.npy", "_td.dat") for p in gt_files]
        if not gt_files or not all(os.path.exists(p) for p in data_files):
            raise RuntimeError(
                f"Directory '{data_dir}' does not contain data or data is "
                "invalid! Expecting paired *_bbox.npy and *_td.dat files. "
                "GEN1/1Mpx can be downloaded from prophesee.ai; for tests "
                "use data.synthetic.make_synthetic_dataset()."
            )
        return gt_files, data_files

    def _make_stream(self, split: str, shard_id: int, num_shards: int):
        gt_files, data_files = self._files(split)
        global_shard = self.host_id * num_shards + shard_id
        global_num = self.num_hosts * num_shards
        common = dict(
            gt_files=gt_files,
            data_files=data_files,
            time_step=self.time_step,
            num_load_file=self.num_load_file,
            height=self.height,
            width=self.width,
            time_field=self.time_field,
            frame_dtype=self.frame_dtype,
            seed=self.seed + global_shard,
            shard_id=global_shard,
            num_shards=global_num,
        )
        if self.one_label:
            return STStream(
                num_steps=self.num_steps,
                time_shift=self.time_shift,
                clip_x=(self.dataset == "1mpx"),
                **common,
            )
        return MTStream(num_steps=self.num_steps, **common)

    def loader(self, split: str) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite batch iterator: (features [T,B,H,W,2], labels [B,N,5|6]).

        Bound the epoch with ``itertools.islice`` / the trainer's
        ``limit_*_batches`` (the reference relies on Lightning's
        ``limit_train_batches`` the same way, SURVEY.md §4).
        """
        n_workers = self.num_workers
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.batch_size)
        stop = threading.Event()

        aug = (
            self.augment
            if split == "train" and self.one_label and self.augment
            else None
        )

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(shard_id: int):
            try:
                stream = self._make_stream(split, shard_id, n_workers)
                aug_rng = np.random.default_rng(
                    self.seed + 7919 * (self.host_id * n_workers + shard_id)
                )
                for sample in stream:
                    if aug is not None:
                        sample = aug(sample[0], sample[1], aug_rng)
                    if stop.is_set() or not put(sample):
                        return
            except Exception as e:  # raised again by the consumer
                put(_WorkerError(e))

        threads = [
            threading.Thread(target=worker, args=(i,), daemon=True)
            for i in range(n_workers)
        ]
        for t in threads:
            t.start()

        try:
            while True:
                samples = []
                while len(samples) < self.batch_size:
                    item = q.get()
                    if isinstance(item, _WorkerError):
                        raise item.error
                    samples.append(item)
                yield collate(samples, self.max_labels)
        finally:
            # closing the generator stops and joins its workers, so no
            # thread outlives the loop that opened the loader
            stop.set()
            for t in threads:
                t.join()

    def train_loader(self):
        return self.loader("train")

    def val_loader(self):
        return self.loader("val")

    def test_loader(self):
        return self.loader("test")

    def predict_loader(self):
        return self.loader("test")
