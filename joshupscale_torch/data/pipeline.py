"""Config-driven dataset op pipeline (numpy, no tensors).

The port's own copy of ``joshupscale_tpu/data/pipeline.py`` (the
reference package cannot be imported without jax): a YAML list of ops
is chained into a stream of ``{"input", "target"[, "last"]}`` dicts of
numpy arrays, with the reference's op names, config keys and seeded
randomness, so the same config and seed give the same batches on both
sides.  The TFRecord source and Example parsers, and the multiprocess
loader (``num_workers`` > 0), are not ported yet (ROADMAP 14c): they
raise ``NotImplementedError``.
"""

from __future__ import annotations

import glob as globlib
import os
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

Stream = Iterator[Any]


# Construction-time randomness context: ``create_dataset`` pushes a
# per-op (Generator, SeedSequence) pair before instantiating each op so
# every random op draws from its own spawned stream (reference
# ``train_local.py:78-79`` seeds keras/np/random globally; per-op
# generators additionally make the stream independent of op order and
# safe to run in parallel worker processes).  Unseeded pipelines get a
# fresh OS-entropy generator per op (the old global-np.random behavior,
# still nondeterministic run to run).
#
# THREAD-LOCAL: sub-pipelines are built lazily at first iteration
# (SampleDatasetOp.gen), which runs on whatever thread consumes the
# stream -- a PrefetchOp or fit() _InputStager thread.  A process-global
# stack would let a concurrent main-thread create_dataset interleave
# push/pop with that build and silently hand ops the wrong seeds.
_OP_CTX = threading.local()


def _op_randomness_stack() -> List[Tuple[np.random.Generator,
                                         Optional[np.random.SeedSequence]]]:
    stack = getattr(_OP_CTX, "stack", None)
    if stack is None:
        stack = _OP_CTX.stack = []
    return stack


def _take_op_randomness():
    stack = _op_randomness_stack()
    if stack:
        return stack[-1]
    return np.random.default_rng(), None


class DatasetOp:
    """Base op: callable from upstream value/stream to downstream.

    ``self.rng`` is the op's private random generator (seeded by
    ``create_dataset(seed=...)``); ``self.seed_seq`` is its spawnable
    seed sequence for ops that build sub-pipelines (SampleDatasetOp).
    """

    def __init__(self, name: str, **_):
        self.name = name
        self.rng, self.seed_seq = _take_op_randomness()

    def __call__(self, data: Any) -> Any:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Sources


class GlobOp(DatasetOp):
    def __init__(self, name: str, glob_pattern: str, **kw):
        super().__init__(name)
        self.glob_pattern = glob_pattern

    def __call__(self, data):
        assert data is None
        return sorted(globlib.glob(self.glob_pattern, recursive=True))


class ListShuffleOp(DatasetOp):
    def __call__(self, data):
        out = list(data)
        self.rng.shuffle(out)
        return out


class _NotPortedOp(DatasetOp):
    """An op of the reference that waits for its ROADMAP item."""

    def __init__(self, name: str, **kw):
        raise NotImplementedError(
            f"{name} (TFRecord input) is not ported yet; it waits for "
            f"ROADMAP 14c (mploader and the TFRecord ops)")


class LocalDatasetOp(DatasetOp):
    """10-frame groups of LR/HR image files (reference :71-114)."""

    def __init__(self, name: str, hr_path: str, lr_path: str,
                 shuffle: bool = False, **kw):
        super().__init__(name)
        hr_files = sorted(globlib.glob(hr_path, recursive=True))
        lr_files = sorted(globlib.glob(lr_path, recursive=True))
        if len(lr_files) != len(hr_files) or len(hr_files) % 10 != 0:
            raise ValueError("Invalid number of images")
        frames = list(zip(
            [os.path.abspath(x) for x in lr_files],
            [os.path.abspath(x) for x in hr_files],
        ))
        self.groups = [frames[i:i + 10] for i in range(0, len(frames), 10)]
        if shuffle:
            self.rng.shuffle(self.groups)

    def __call__(self, data):
        assert data is None

        def gen():
            for group in self.groups:
                lr = np.stack([_imread_bgr(p) for p, _ in group])
                hr = np.stack([_imread_bgr(p) for _, p in group])
                yield {"input": lr, "target": hr}

        return _Restartable(gen)


def _imread_bgr(path: str) -> np.ndarray:
    """Read an image as BGR uint8 (cv2 convention, like the reference)."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"Cannot read image: {path}")
        return img
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))[:, :, ::-1]


class _Restartable:
    """Iterable wrapping a generator factory (so Repeat/Cache can re-pull)."""

    def __init__(self, factory: Callable[[], Iterator]):
        self.factory = factory

    def __iter__(self):
        return self.factory()


# ---------------------------------------------------------------------------
# Element transforms


class MapOp(DatasetOp):
    """Per-item map; ``num_parallel`` > 1 decodes with a thread pool.

    The ``num_parallel`` config key is the analog of tf.data's
    ``num_parallel_calls`` (the reference decodes PNG sequences in
    parallel): items are submitted to a bounded in-order window of
    worker futures, so output ORDER is identical to the sequential
    path.  Only meaningful for GIL-releasing map_fns (image decoders);
    leave unset for ops that carry per-op RNG state (crops/augs), which
    must run on one thread.
    """

    # Subclasses that cannot run map_fn from a thread pool (per-op
    # np.random state, or a __call__ override without the pool path)
    # set this False so a stray ``num_parallel`` config key fails
    # loudly instead of silently racing / being ignored.
    PARALLEL_OK = True

    def __init__(self, name: str, num_parallel: int = 0, **kw):
        super().__init__(name, **kw)
        self.num_parallel = int(num_parallel)
        if self.num_parallel > 1 and not self.PARALLEL_OK:
            raise ValueError(
                f"{type(self).__name__} does not support num_parallel "
                "(RNG-bearing or flat-map op; it would run np.random "
                "from multiple threads or silently ignore the key)")

    def __call__(self, data):
        src = data

        if self.num_parallel > 1:
            workers = self.num_parallel

            def gen():
                import collections
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(workers) as ex:
                    pending = collections.deque()
                    try:
                        for item in src:
                            pending.append(ex.submit(self.map_fn, item))
                            if len(pending) >= 2 * workers:
                                yield pending.popleft().result()
                        while pending:
                            yield pending.popleft().result()
                    finally:
                        for f in pending:
                            f.cancel()

            return _Restartable(gen)

        def gen():
            for item in src:
                yield self.map_fn(item)

        return _Restartable(gen)


class FlatMapOp(MapOp):
    """Map then unbatch axis 0.  No thread-pool path (PARALLEL_OK)."""

    PARALLEL_OK = False

    def __call__(self, data):
        src = data

        def gen():
            for item in src:
                mapped = self.map_fn(item)
                n = len(next(iter(mapped.values())))
                for i in range(n):
                    yield {k: v[i] for k, v in mapped.items()}

        return _Restartable(gen)


class FilterOp(DatasetOp):
    def filter_fn(self, data) -> bool:
        return True

    def __call__(self, data):
        src = data

        def gen():
            for item in src:
                if self.filter_fn(item):
                    yield item

        return _Restartable(gen)


class RandomCondMapOp(MapOp):
    PARALLEL_OK = False

    def __init__(self, threshold: float, **kw):
        super().__init__(**kw)
        self.threshold = threshold

    def true_fn(self, data):
        return data

    def map_fn(self, data):
        if self.rng.random() < self.threshold:
            return self.true_fn(data)
        return data


class RandomCropOp(FlatMapOp):
    """num_img random LR crops per sequence (+ aligned 4x HR crops)."""

    def __init__(self, crop_size: int, num_img: int, **kw):
        super().__init__(**kw)
        self.crop_size = crop_size
        self.num_img = num_img

    def map_fn(self, data):
        h, w = data["input"].shape[1:3]
        cs = self.crop_size
        inputs, targets = [], []
        for _ in range(self.num_img):
            x0 = int(self.rng.integers(0, w - cs))
            y0 = int(self.rng.integers(0, h - cs))
            inputs.append(data["input"][:, y0:y0 + cs, x0:x0 + cs, :])
            targets.append(
                data["target"][:, y0 * 4:(y0 + cs) * 4,
                               x0 * 4:(x0 + cs) * 4, :]
            )
        return {
            "input": np.stack(inputs),
            "target": np.stack(targets),
        }


class NormalizeOp(MapOp):
    def __init__(self, crop_size: int, **kw):
        super().__init__(**kw)
        self.crop_size = crop_size

    def map_fn(self, data):
        cs = self.crop_size
        return {
            "input": data["input"].astype(np.float32).reshape(
                10, cs, cs, 3) / 255.0 - 0.5,
            "target": data["target"].astype(np.float32).reshape(
                10, cs * 4, cs * 4, 3) / 255.0 - 0.5,
        }


class FilterFlatOp(FilterOp):
    """Drop sequences with low temporal variation (reference :292-308)."""

    def __init__(self, threshold: float, **kw):
        super().__init__(**kw)
        self.threshold = threshold

    def filter_fn(self, data):
        val = np.std(data["input"].astype(np.float32), axis=0)
        val = np.sum(val, axis=-1)
        return float(np.mean(val)) > self.threshold


class RgbToBgrOp(MapOp):
    def map_fn(self, data):
        return {
            "input": data["input"][:, :, :, ::-1],
            "target": data["target"][:, :, :, ::-1],
        }


class RandomNoiseOp(MapOp):
    PARALLEL_OK = False

    def __init__(self, stddev: float, **kw):
        super().__init__(**kw)
        self.stddev = stddev

    def map_fn(self, data):
        noise = self.rng.normal(
            0.0, self.stddev, data["input"].shape
        ).astype(np.float32)
        return {"input": data["input"] + noise, "target": data["target"]}


class RandomContrastOp(MapOp):
    PARALLEL_OK = False

    def __init__(self, stddev: float, base: float, **kw):
        super().__init__(**kw)
        self.stddev = stddev
        self.base = base

    def map_fn(self, data):
        rate = float(self.base) ** self.rng.normal(0.0, self.stddev)
        mean = np.mean(data["target"], axis=(0, 1, 2))
        return {
            "input": (data["input"] - mean) * rate + mean,
            "target": (data["target"] - mean) * rate + mean,
        }


class RandomBrightnessOp(MapOp):
    PARALLEL_OK = False

    def __init__(self, stddev: float, **kw):
        super().__init__(**kw)
        self.stddev = stddev

    def map_fn(self, data):
        delta = self.rng.normal(0.0, self.stddev)
        return {
            "input": data["input"] + delta,
            "target": data["target"] + delta,
        }


class RandomHorizontalFlipOp(RandomCondMapOp):
    """Random horizontal flip of the LR/HR pair (reference
    dataset.py:386-398 semantics).

    SUBPIXEL-PHASE HAZARD: flipping both arrays is only
    alignment-preserving when the LR was downsampled with a
    flip-symmetric kernel (box/area).  For nearest-downsampled LR
    (``lr = hr[::4, ::4]``, the ParseSingleExampleOp convention) the
    LR sample sits at sub-position 0 of each 4x4 HR block; after a
    flip it sits at sub-position 3 -- a 3-HR-pixel phase shift on
    every flipped sample.  Training on the resulting phase mixture
    costs more than the augmentation buys (measured on the round-3
    learning proof: flipped pairs are 2.8x/5x off the aligned pair
    MSE for h/h+v; the model converged to a phase compromise ~1.3 dB
    WORSE than bilinear everywhere).  Use only with phase-symmetric
    LR data.
    """

    def true_fn(self, data):
        return {
            "input": data["input"][:, :, ::-1, :],
            "target": data["target"][:, :, ::-1, :],
        }


class RandomVerticalFlipOp(RandomCondMapOp):
    """Random vertical flip -- same subpixel-phase hazard as
    RandomHorizontalFlipOp (RandomTransposeOp is phase-safe: both
    axes keep sub-position 0)."""

    def true_fn(self, data):
        return {
            "input": data["input"][:, ::-1, :, :],
            "target": data["target"][:, ::-1, :, :],
        }


class RandomTransposeOp(RandomCondMapOp):
    def true_fn(self, data):
        return {
            "input": np.transpose(data["input"], (0, 2, 1, 3)),
            "target": np.transpose(data["target"], (0, 2, 1, 3)),
        }


class ClipOp(MapOp):
    def __init__(self, minval: float, maxval: float, **kw):
        super().__init__(**kw)
        self.minval = minval
        self.maxval = maxval

    def map_fn(self, data):
        return {
            "input": np.clip(data["input"], self.minval, self.maxval),
            "target": np.clip(data["target"], self.minval, self.maxval),
        }


class SingleFrameMapOp(FlatMapOp):
    """Sliding windows for FRVSR-single (reference :452-473)."""

    def __init__(self, flow_frames: int, **kw):
        super().__init__(**kw)
        self.flow_frames = flow_frames

    def map_fn(self, data):
        ff = self.flow_frames
        inputs, targets, last = [], [], []
        for idx in range(11 - ff):
            inputs.append(data["input"][idx:idx + ff])
            targets.append(data["target"][idx + ff - 1])
            last.append(data["target"][idx + ff - 2])
        return {
            "input": np.stack(inputs),
            "target": np.stack(targets),
            "last": np.stack(last),
        }


# ---------------------------------------------------------------------------
# Stream assembly


class SampleDatasetOp(DatasetOp):
    """Random interleave of sub-pipelines (reference :476-493)."""

    def __init__(self, name: str, configs: List[List[Dict]],
                 weights: Optional[List[float]] = None, **kw):
        super().__init__(name)
        self.configs = configs
        self.weights = weights

    def __call__(self, data):
        assert data is None
        configs = self.configs
        weights = self.weights
        rng = self.rng
        seed_seq = self.seed_seq

        def gen():
            # Sub-pipelines get spawned seeds (fresh per pass: spawn()
            # advances the parent's spawn key, so repeated iteration is
            # deterministic but not a verbatim replay).
            children = (seed_seq.spawn(len(configs)) if seed_seq
                        else [None] * len(configs))
            iters = [
                iter(create_dataset(c, seed=s))
                for c, s in zip(configs, children)
            ]
            w = np.asarray(
                weights if weights else [1.0] * len(iters), np.float64
            )
            alive = list(range(len(iters)))
            while alive:
                probs = w[alive] / w[alive].sum()
                pick = int(rng.choice(len(alive), p=probs))
                try:
                    yield next(iters[alive[pick]])
                except StopIteration:
                    alive.pop(pick)

        return _Restartable(gen)


class BatchOp(DatasetOp):
    def __init__(self, name: str, batch_size: int, **kw):
        super().__init__(name)
        self.batch_size = batch_size

    def __call__(self, data):
        src = data
        bs = self.batch_size

        def gen():
            buf = []
            for item in src:
                buf.append(item)
                if len(buf) == bs:
                    yield {
                        k: np.stack([b[k] for b in buf]) for k in buf[0]
                    }
                    buf = []
            # drop_remainder=True semantics: leftover discarded

        return _Restartable(gen)


class RepeatOp(DatasetOp):
    def __call__(self, data):
        src = data

        def gen():
            while True:
                count = 0
                for item in src:
                    count += 1
                    yield item
                if count == 0:
                    return

        return _Restartable(gen)


class ShuffleOp(DatasetOp):
    def __init__(self, name: str, shuffle_window: int, **kw):
        super().__init__(name)
        self.window = shuffle_window

    def __call__(self, data):
        src = data
        window = self.window
        rng = self.rng

        def gen():
            buf = []
            for item in src:
                buf.append(item)
                if len(buf) >= window:
                    i = int(rng.integers(len(buf)))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        return _Restartable(gen)


class CacheOp(DatasetOp):
    def __call__(self, data):
        src = data
        cache: List[Any] = []
        done = [False]

        def gen():
            if done[0]:
                yield from cache
                return
            # Fill into a LOCAL list and publish atomically on
            # completion: two iterators racing before the first full
            # pass (or an abandoned partial fill) can no longer corrupt
            # the shared cache -- the last completed pass wins whole.
            fill: List[Any] = []
            for item in src:
                fill.append(item)
                yield item
            cache[:] = fill
            done[0] = True

        return _Restartable(gen)


class PrefetchOp(DatasetOp):
    """Background-thread prefetch (the host-side analog of tf.data
    prefetch; keeps the accelerator step fed)."""

    def __init__(self, name: str, buffer_size: int, **kw):
        super().__init__(name)
        self.buffer_size = buffer_size if buffer_size > 0 else 4

    def __call__(self, data):
        src = data
        depth = self.buffer_size

        def gen():
            q: "queue.Queue" = queue.Queue(maxsize=depth)
            stop = object()
            cancel = threading.Event()
            error = []

            def _put(item) -> bool:
                """Bounded put that gives up once the consumer is gone."""
                while not cancel.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            def worker():
                try:
                    for item in src:
                        if not _put(item):
                            return  # consumer abandoned: stop pulling src
                except BaseException as exc:  # propagate to consumer
                    error.append(exc)
                finally:
                    _put(stop)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is stop:
                        if error:
                            raise error[0]
                        return
                    yield item
            finally:
                # Generator close()/GC path: release the worker so it
                # stops pulling the source instead of prefetching
                # forever for a dead consumer.
                cancel.set()

        return _Restartable(gen)


class TakeOp(DatasetOp):
    def __init__(self, name: str, size: int, **kw):
        super().__init__(name)
        self.size = size

    def __call__(self, data):
        src = data
        size = self.size

        def gen():
            for i, item in enumerate(src):
                if i >= size:
                    return
                yield item

        return _Restartable(gen)


class SkipOp(DatasetOp):
    def __init__(self, name: str, size: int, **kw):
        super().__init__(name)
        self.size = size

    def __call__(self, data):
        src = data
        size = self.size

        def gen():
            for i, item in enumerate(src):
                if i >= size:
                    yield item

        return _Restartable(gen)


class OptionsOp(DatasetOp):
    """tf.data options have no analog here; accepted and ignored so
    reference configs parse."""

    def __init__(self, name: str, options: Dict[str, Any], **kw):
        super().__init__(name)

    def __call__(self, data):
        return data


DATASET_OPS: Dict[str, type] = {
    "GlobOp": GlobOp,
    "ListShuffleOp": ListShuffleOp,
    "TFRecordDatasetOp": _NotPortedOp,
    "LocalDatasetOp": LocalDatasetOp,
    "ParsePairExampleOp": _NotPortedOp,
    "ParseSingleExampleOp": _NotPortedOp,
    "RandomCropOp": RandomCropOp,
    "NormalizeOp": NormalizeOp,
    "FilterFlatOp": FilterFlatOp,
    "RgbToBgrOp": RgbToBgrOp,
    "RandomNoiseOp": RandomNoiseOp,
    "RandomContrastOp": RandomContrastOp,
    "RandomBrightnessOp": RandomBrightnessOp,
    "RandomHorizontalFlipOp": RandomHorizontalFlipOp,
    "RandomVerticalFlipOp": RandomVerticalFlipOp,
    "RandomTransposeOp": RandomTransposeOp,
    "ClipOp": ClipOp,
    "SampleDatasetOp": SampleDatasetOp,
    "SingleFrameMapOp": SingleFrameMapOp,
    "BatchOp": BatchOp,
    "RepeatOp": RepeatOp,
    "ShuffleOp": ShuffleOp,
    "CacheOp": CacheOp,
    "PrefetchOp": PrefetchOp,
    "TakeOp": TakeOp,
    "SkipOp": SkipOp,
    "OptionsOp": OptionsOp,
}


def create_dataset(config: List[Dict[str, Any]],
                   seed: Optional[Any] = None):
    """Build an iterable dataset from an op-chain config.

    ``seed`` (int or ``np.random.SeedSequence``) makes every random op
    draw from its own deterministically spawned generator: the same
    config + seed reproduces the exact element stream, shuffle order
    and augmentation draws included (reference ``train_local.py:78-79``
    seeds keras/np/random globally for the same guarantee).
    """
    data = None
    seq = None
    if seed is not None:
        seq = (seed if isinstance(seed, np.random.SeedSequence)
               else np.random.SeedSequence(seed))
    children = (seq.spawn(len(config)) if seq is not None
                else [None] * len(config))
    for idx, op_config in enumerate(config):
        if "name" not in op_config:
            raise ValueError("Op name is not defined")
        name = op_config["name"]
        if name not in DATASET_OPS:
            raise ValueError(f"Unknown dataset op: {name}")
        child = children[idx]
        stack = _op_randomness_stack()
        stack.append(
            (np.random.default_rng(child), child) if child is not None
            else (np.random.default_rng(), None)
        )
        try:
            op = DATASET_OPS[name](**op_config)
        finally:
            stack.pop()
        data = op(data)
    if data is None:
        raise ValueError("Invalid dataset config")
    return data


def create_train_dataset(config: List[Dict[str, Any]], batch_size: int,
                         seed: Optional[int] = None,
                         num_workers: int = 0, prefetch: int = 2):
    """Training stream: config + batch + prefetch (reference :657-663).

    ``num_workers >= 1`` (the reference's multiprocess loader) is not
    ported yet (ROADMAP 14c).
    """
    if num_workers and num_workers >= 1:
        raise NotImplementedError(
            "data_workers > 0 (the multiprocess loader) is not ported "
            "yet; it waits for ROADMAP 14c")
    return create_dataset(config + [
        {"name": "BatchOp", "batch_size": batch_size},
        {"name": "PrefetchOp", "buffer_size": max(int(prefetch), 1)},
    ], seed=seed)


def create_val_dataset(config: List[Dict[str, Any]], batch_size: int,
                       play_size: int, val_size: int,
                       seed: Optional[int] = None):
    """(val, play) streams, cached and pre-filled (reference :666-685)."""
    seq = np.random.SeedSequence(seed) if seed is not None else None
    val_seed, play_seed = (seq.spawn(2) if seq is not None
                           else (None, None))
    val_ds = create_dataset(config + [
        {"name": "TakeOp", "size": val_size},
        {"name": "BatchOp", "batch_size": batch_size},
        {"name": "CacheOp"},
    ], seed=val_seed)
    play_ds = create_dataset(config + [
        {"name": "TakeOp", "size": play_size},
        {"name": "BatchOp", "batch_size": play_size},
        {"name": "CacheOp"},
    ], seed=play_seed)
    for _ in val_ds:
        pass
    for _ in play_ds:
        pass
    return val_ds, play_ds
