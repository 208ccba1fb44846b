"""Host-side batching and prefetch.

Replaces torch's DataLoader + SameTrCollate + cycle_data (reference
data/dataset.py:13-45,91-95,169-172) with a thread-pool pipeline tuned for an
accelerator-bound trainer: fixed-shape float32 batches are built and augmented
on host threads (PIL/cv2 release the GIL) and handed to the device ahead of
time, so it never waits on image IO. ``device_prefetch`` additionally keeps
N batches in flight to the device.

The port's own copy of ``htr_vt_tpu/data/loader.py``, held to it batch for
batch by ``tests/test_torch_port_loop.py``, with one change:
``device_prefetch`` copies pinned host batches to a CUDA device with
``non_blocking=True`` (no mesh: one process, one card), and hands CPU
batches on as they are. It imports no cv2 or PIL itself: the augmentation
and the image reader import them where they run.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from htr_vt_torch.config import AugmentConfig, DataConfig
from htr_vt_torch.data.augment import augment_batch
from htr_vt_torch.data.image import from_uint8, load_line_image, to_uint8
from htr_vt_torch.data.lists import LineIndex
from htr_vt_torch.data.synthetic import SyntheticLineDataset
from htr_vt_torch.text.converter import CTCLabelConverter


class FileLineDataset:
    """Disk-backed dataset over a LineIndex; images are decoded once and
    cached as the fixed 64x512 uint8 canvas (a full IAM split is ~200 MB)."""

    def __init__(self, index: LineIndex, img_size: Tuple[int, int] = (64, 512),
                 cache: bool = True):
        self.index = index
        self.height, self.width = img_size
        self.labels = index.labels
        self.alphabet = index.alphabet
        self._cache: Optional[List[np.ndarray]] = [None] * len(index) if cache else None

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, str]:
        if self._cache is not None and self._cache[i] is not None:
            return self._cache[i], self.labels[i]
        img = load_line_image(self.index.paths[i], self.width, self.height)
        u8 = to_uint8(img)
        if self._cache is not None:
            self._cache[i] = u8
        return u8, self.labels[i]


def build_dataset(cfg: DataConfig, split: str):
    """split: train | val | test. Returns a dataset with .alphabet/.labels."""
    if cfg.dataset == "SYNTH":
        size = cfg.synth_train_size if split == "train" else cfg.synth_eval_size
        seed = cfg.synth_seed + {"train": 0, "val": 1, "test": 2}[split]
        ds = SyntheticLineDataset(size, cfg.synth_alphabet, seed,
                                  cfg.img_size[0], cfg.img_size[1])
        return ds
    list_path = {"train": cfg.train_list, "val": cfg.val_list,
                 "test": cfg.test_list}[split]
    index = LineIndex.from_list_file(list_path, cfg.data_path,
                                     max_label_len=cfg.max_label_len)
    return FileLineDataset(index, cfg.img_size)


def make_converter(cfg: DataConfig, train_dataset) -> CTCLabelConverter:
    """Alphabet policy: data-derived by default; the fork's Vietnamese charset
    override when configured (reference model_v1/data/dataset.py:60-81)."""
    if cfg.vietnamese_charset:
        from htr_vt_torch.text.converter import VIETNAMESE_CHARSET
        return CTCLabelConverter(list(VIETNAMESE_CHARSET))
    return CTCLabelConverter(train_dataset.alphabet)


def collate(images: List[np.ndarray], texts: List[str],
            converter: CTCLabelConverter, max_label_len: int,
            augment: Optional[AugmentConfig] = None,
            rng: Optional[np.random.Generator] = None,
            extras_fn=None) -> Dict[str, np.ndarray]:
    """uint8 images + strings -> fixed-shape numpy batch. ``extras_fn(texts)``
    may contribute additional arrays (e.g. SGM context windows)."""
    if augment is not None and augment.enable:
        images = augment_batch(images, augment, rng)
    batch_img = np.stack([from_uint8(im) for im in images])  # [B,H,W,1] f32
    labels, lengths = converter.encode_padded(texts, max_label_len)
    out = {"image": batch_img, "labels": labels, "label_lengths": lengths}
    if extras_fn is not None:
        out.update(extras_fn(texts))
    return out


def choose_max_label_len(labels: Sequence[str], num_frames: int = 128,
                         multiple: int = 8) -> int:
    """Static label width: the longest training label rounded up, capped at
    the CTC feasibility bound (labels longer than the frame count can never
    align)."""
    longest = max((len(l) for l in labels), default=1)
    padded = ((longest + multiple - 1) // multiple) * multiple
    return max(multiple, min(padded, num_frames))


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """The shuffle of epoch ``epoch``: a pure function of (seed, epoch)."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(n)


def batch_sample_ids(n: int, b: int, seed: int, sampling: str,
                     global_bs: int, shard_offset: int, shard_bs: int,
                     perm_cache: Optional[dict] = None) -> np.ndarray:
    """Dataset indices of (this shard's slice of) global batch ``b``.

    A pure function of (seed, b): sampling="epoch" walks epoch-shuffled
    permutations (reference DataLoader(shuffle=True) + cycle_data,
    data/dataset.py:169-172 — every sample exactly once per epoch, batches
    may straddle epoch boundaries); "iid" draws the batch i.i.d. Shards
    take contiguous row ranges of the global batch, so P processes'
    slices concatenate to the exact 1-process stream.
    """
    if sampling == "iid":
        rng = np.random.default_rng(np.random.SeedSequence([seed, b, 1]))
        ids = rng.choice(n, size=global_bs, replace=n < global_bs)
        return ids[shard_offset:shard_offset + shard_bs]
    g = b * global_bs + shard_offset + np.arange(shard_bs)
    epochs, pos = g // n, g % n
    out = np.empty(shard_bs, np.int64)
    for e in np.unique(epochs):
        if perm_cache is not None and e in perm_cache:
            perm = perm_cache[e]
        else:
            perm = epoch_permutation(n, seed, int(e))
            if perm_cache is not None:
                if len(perm_cache) >= 4:
                    perm_cache.pop(min(perm_cache))
                perm_cache[int(e)] = perm
        m = epochs == e
        out[m] = perm[pos[m]]
    return out


class TrainLoader:
    """Infinite shuffled loader with background batch construction.

    DETERMINISTIC BY CONSTRUCTION: batch ``b`` (contents, augmentation draws
    and emission order) is a pure function of (seed, b, shard_rank) —
    workers claim batch indices and a reordering buffer emits them in
    order, so thread scheduling cannot perturb the stream. Consequences:
    - runs are reproducible;
    - stream-exact resume is just ``start_batch=steps_done`` (the reference
      serializes four RNG states and still cannot restore the mid-epoch
      DataLoader position, model_v1/utils/utils.py:253-268);
    - multi-host data sharding is ``shard_rank/shard_count``: each process
      builds rows [rank*bs, (rank+1)*bs) of every global batch; sample
      contents and order concatenate to the exact single-process stream
      (augmentation draws are per-shard — the batch-shared augment
      decisions are made per shard slice, statistically equivalent but
      not bit-identical to a 1-process run's).

    sampling="epoch" (default) follows the reference's epoch-shuffled
    DataLoader; "iid" draws each batch i.i.d. (statistically equivalent for
    100k-iteration training).
    """

    def __init__(self, dataset, converter: CTCLabelConverter, batch_size: int,
                 max_label_len: int, augment: Optional[AugmentConfig] = None,
                 seed: int = 0, num_threads: int = 4, prefetch: int = 4,
                 extras_fn=None, sampling: str = "epoch", start_batch: int = 0,
                 shard_rank: int = 0, shard_count: int = 1):
        self.dataset = dataset
        self.converter = converter
        self.batch_size = batch_size  # per-shard rows of the global batch
        self.max_label_len = max_label_len
        self.augment = augment
        self.extras_fn = extras_fn
        if sampling not in ("epoch", "iid"):
            raise ValueError(f"sampling must be 'epoch' or 'iid', got {sampling!r}")
        self.sampling = sampling
        self._seed = seed
        self.shard_rank, self.shard_count = shard_rank, shard_count
        self._global_bs = batch_size * shard_count
        self._next_emit = start_batch   # next batch index handed to consumer
        self._next_claim = start_batch  # next batch index a worker builds
        self._window = max(prefetch, 2) + num_threads
        self._buf: Dict[int, Dict[str, np.ndarray]] = {}
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._error_batch = -1
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    @property
    def next_batch_index(self) -> int:
        """Batches emitted so far + start_batch — the complete resume state."""
        return self._next_emit

    def _build(self, b: int, perm_cache: dict) -> Dict[str, np.ndarray]:
        idx = batch_sample_ids(len(self.dataset), b, self._seed, self.sampling,
                               self._global_bs,
                               self.shard_rank * self.batch_size,
                               self.batch_size, perm_cache)
        images, texts = [], []
        for i in idx:
            im, tx = self.dataset[int(i)]
            images.append(im)
            texts.append(tx)
        # per-batch augment stream: resume-exact and shard-independent
        rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, b, self.shard_rank, 2]))
        return collate(images, texts, self.converter, self.max_label_len,
                       self.augment, rng, self.extras_fn)

    def _worker(self) -> None:
        perm_cache: dict = {}
        while True:
            with self._cv:
                while (not self._stop.is_set()
                       and self._next_claim >= self._next_emit + self._window):
                    self._cv.wait(0.2)
                if self._stop.is_set():
                    return
                b = self._next_claim
                self._next_claim += 1
            try:
                batch = self._build(b, perm_cache)
            except BaseException as e:  # surface to consumer; never deadlock
                with self._cv:
                    if self._error is None:
                        self._error = e
                        self._error_batch = b
                    self._stop.set()
                    self._cv.notify_all()
                return
            with self._cv:
                self._buf[b] = batch
                self._cv.notify_all()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # NOT a generator: a generator wrapping __next__ would convert the
        # StopIteration raised after close() into RuntimeError (PEP 479),
        # breaking consumers' natural end-of-stream handling.
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        with self._cv:
            while self._next_emit not in self._buf:
                if self._stop.is_set():
                    if self._error is not None:
                        raise RuntimeError(
                            f"TrainLoader worker failed building batch "
                            f"{self._error_batch}") from self._error
                    raise StopIteration
                self._cv.wait(0.2)
            batch = self._buf.pop(self._next_emit)
            self._next_emit += 1
            self._cv.notify_all()
        return batch

    def close(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()


def eval_batches(dataset, converter: CTCLabelConverter, batch_size: int,
                 max_label_len: int,
                 extras_fn=None) -> Iterator[Tuple[Dict[str, np.ndarray], int, List[str]]]:
    """Sequential fixed-shape eval batches. The last batch is padded by
    repeating sample 0; yields (batch, num_valid, texts) so metrics skip the
    padding. Fixed shapes keep eval on the single compiled XLA program."""
    n = len(dataset)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        valid = len(idx)
        idx += [0] * (batch_size - valid)
        images, texts = [], []
        for i in idx:
            im, tx = dataset[i]
            images.append(im)
            texts.append(tx)
        batch = collate(images, texts, converter, max_label_len,
                        extras_fn=extras_fn)
        yield batch, valid, texts[:valid]


def device_prefetch(it: Iterator[Dict[str, np.ndarray]], device,
                    depth: int = 2) -> Iterator[Dict]:
    """Move batches onto ``device`` ahead of consumption: on a CUDA device
    ``depth`` batches in flight, each copied from pinned host memory with
    ``non_blocking=True`` on the current stream, so the copy of the next
    batch queues behind the running step; on the CPU the numpy batches
    pass through as they are (the step converts them)."""
    import collections

    import torch
    device = torch.device(device)
    if device.type != "cuda":
        yield from it
        return

    def put(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
            device, non_blocking=True) for k, v in batch.items()}

    buf = collections.deque()
    it = iter(it)
    try:
        while True:
            while len(buf) < depth:
                buf.append(put(next(it)))
            yield buf.popleft()
    except StopIteration:
        while buf:
            yield buf.popleft()
