"""Input pipeline: file-backed datasets with background prefetch.

PyTorch counterpart of dml_tpu/data.py, with the same classes and
semantics. The rule it serves: the card must never wait for the host.

- `ImageDataset`: deterministic per-epoch shuffle keyed by (seed, epoch),
  fixed batch shapes (drop_remainder by default), decode through the
  port's `models.preprocess.load_images` (the native libjpeg loader for
  an all-JPEG batch when it builds, PIL otherwise).
- `Prefetcher`: a background thread decodes batch k+1..k+depth while the
  card runs batch k. With `device` set, the producer also lands each
  batch on the device: a copy from pinned host memory on a stream of
  its own, then an event; the consumer's stream waits for that event
  before it yields the batch, and the tensors are recorded on the
  consumer's stream, so the caching allocator reuses their memory only
  after the consumer's work on them is done.

Typical loop:

    ds = ImageDataset(samples, image_size=(224, 224), batch_size=32)
    for epoch in range(3):
        for images, labels in Prefetcher(ds, epoch=epoch, device="cuda"):
            trainer.step(images, labels)
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

Sample = Tuple[str, int]  # (image path, class label)


class ImageDataset:
    """Deterministically shuffled, fixed-shape image batches."""

    def __init__(
        self,
        samples: Sequence[Sample],
        image_size: Tuple[int, int],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
    ):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.samples = list(samples)
        self.image_size = image_size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder

    def __len__(self) -> int:
        """Number of batches per epoch."""
        full, rem = divmod(len(self.samples), self.batch_size)
        return full + (1 if rem and not self.drop_remainder else 0)

    def batch_plan(self, epoch: int = 0) -> List[List[Sample]]:
        """The epoch's batches as (path, label) lists, decode-free. The
        shuffle is keyed by (seed, epoch), as in the JAX package: every
        worker that agrees on those sees the same order."""
        order = np.arange(len(self.samples))
        if self.shuffle:
            np.random.RandomState((self.seed * 1_000_003 + epoch) & 0x7FFFFFFF).shuffle(order)
        out: List[List[Sample]] = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_remainder:
                break
            out.append([self.samples[i] for i in idx])
        return out

    def load_batch(self, batch: Sequence[Sample]) -> Tuple[np.ndarray, np.ndarray]:
        """Decode one batch -> (uint8 [B,H,W,3], int32 [B])."""
        from .models.preprocess import load_images

        files = [p for p, _ in batch]
        labels = np.asarray([l for _, l in batch], np.int32)
        return load_images(files, self.image_size), labels

    def epoch(self, epoch: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for batch in self.batch_plan(epoch):
            yield self.load_batch(batch)

    def __iter__(self):
        return self.epoch(0)


class Prefetcher:
    """Iterate a dataset epoch with `depth` batches decoded ahead in a
    background thread. Without `device` it yields numpy arrays; with
    `device` (a CUDA device) it yields tensors on it, copied from the
    producer thread (the host-to-device copy overlaps compute as well).
    Reusable: each `iter()` is a fresh pass over `epoch_idx`; an error in
    the producer is raised on the consumer's side."""

    _DONE = object()

    def __init__(self, dataset: ImageDataset, epoch: int = 0, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.dataset = dataset
        self.epoch_idx = epoch
        self.depth = depth
        self.device = device
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()

    def _to_device(self, images: np.ndarray, labels: np.ndarray, stream):
        """Pinned copies to the device on the producer's `stream`, and an
        event recorded after them there."""
        import torch

        with torch.cuda.stream(stream):
            out = tuple(torch.from_numpy(a).pin_memory().to(self.device, non_blocking=True)
                        for a in (images, labels))
            ready = torch.cuda.Event()
            ready.record(stream)
        return (*out, ready)

    def _produce(self, q: "queue.Queue", stop: threading.Event, error: list) -> None:
        # q/stop/error arrive as arguments (not self attributes): this
        # thread stays bound to ITS iteration's channels even after a
        # later __iter__ replaces the instance state (a dying abandoned
        # producer must never clobber a newer iteration's error slot)
        try:
            stream = None
            if self.device is not None:
                import torch

                stream = torch.cuda.Stream(device=self.device)
            for batch in self.dataset.batch_plan(self.epoch_idx):
                if stop.is_set():
                    return
                images, labels = self.dataset.load_batch(batch)
                if stream is not None:
                    q.put(self._to_device(images, labels, stream))
                else:
                    q.put((images, labels))
        except BaseException as e:  # surfaced on the consumer side
            error.append(e)
        finally:
            q.put(self._DONE)

    def _ready(self, item):
        """A producer item as the consumer may use it: for a device
        batch, the consumer's stream waits for the copy's event, and the
        tensors are recorded on that stream."""
        if self.device is None:
            return item
        import torch

        images, labels, ready = item
        current = torch.cuda.current_stream(images.device)
        current.wait_event(ready)
        images.record_stream(current)
        labels.record_stream(current)
        return images, labels

    def __iter__(self):
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("Prefetcher is already being iterated")
        # fresh per-iteration state: a Prefetcher is reusable across
        # epochs. The generator body uses ONLY these locals, so an
        # abandoned earlier iterator's cleanup tears down its own
        # producer, never a later iteration's.
        q = self._q = queue.Queue(maxsize=self.depth)
        error: list = []  # one-slot channel owned by THIS iteration
        self._error = None
        stop = self._stop = threading.Event()
        thread = self._thread = threading.Thread(
            target=self._produce, args=(q, stop, error), name="dml-prefetch", daemon=True,
        )
        thread.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    if error:
                        self._error = error[0]
                        raise error[0]
                    return
                yield self._ready(item)
        finally:
            # consumer done or bailed early: unblock and retire the
            # producer (it may be parked on a full queue)
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            thread.join(timeout=5)
