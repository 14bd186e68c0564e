"""Port parity for the multiprocess loader
(``joshupscale_torch.data.mploader``).

Two worker processes (``spawn``) over the shards of a TFRecord pair
chain must give the JAX package's loader's batch stream bit for bit, and
that stream is the in-process ``create_dataset(shard=(2, i))`` streams
taken round robin.  A worker's error comes back with its traceback; the
workers see no CUDA device; an early close leaves no shared-memory
segment behind.  Four loaders are started in this file (each start
spawns fresh interpreters).
"""

import os
import time

import numpy as np
import pytest

from joshupscale_torch.data import tfrecord as tfr
from joshupscale_torch.data.mploader import (
    ConfigPipelineFactory,
    MultiprocessLoader,
)
from joshupscale_torch.data.pipeline import (
    create_dataset,
    create_train_dataset,
)

SEED = 11


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A pair chain over five examples (10 PNG frames, 16x24 LR each)
    with every kind of seeded op: crops, flips, noise."""
    import cv2

    path = str(tmp_path_factory.mktemp("mp") / "pairs.tfrecords")
    rng = np.random.default_rng(3)
    recs = []
    for _ in range(5):
        hr = rng.integers(0, 256, (10, 64, 96, 3), np.uint8)
        png = lambda f: cv2.imencode(".png", f)[1].tobytes()  # noqa: E731
        recs.append(tfr.encode_example({
            "input": [png(f[::4, ::4]) for f in hr],
            "target": [png(f) for f in hr]}))
    tfr.write_records(path, recs)
    return [{"name": "TFRecordDatasetOp", "path": path},
            {"name": "ParsePairExampleOp"},
            {"name": "RandomCropOp", "crop_size": 8, "num_img": 2},
            {"name": "RandomHorizontalFlipOp", "threshold": 0.5},
            {"name": "NormalizeOp", "crop_size": 8},
            {"name": "RandomNoiseOp", "stddev": 0.01}]


def _shm_segments():
    return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}


def test_loader_stream_matches_reference_loader(chain):
    """``create_train_dataset(num_workers=2)`` in the port and in the
    reference, same config and seed: the same batches, in the same
    order, bit for bit; and they are the in-process shards' batches,
    worker k's every second batch."""
    from joshupscale_tpu.data.pipeline import (
        create_train_dataset as j_create_train_dataset,
    )

    loader = create_train_dataset(chain, 2, seed=SEED, num_workers=2)
    assert isinstance(loader, MultiprocessLoader)
    got = list(loader)
    want = list(j_create_train_dataset(chain, 2, seed=SEED, num_workers=2))
    shards = [iter(create_dataset(chain + [{"name": "BatchOp",
                                            "batch_size": 2}],
                                  seed=SEED, shard=(2, i)))
              for i in (0, 1)]
    # Worker 0 holds examples 0, 2, 4 (3 batches), worker 1 examples
    # 1, 3 (2 batches): the rotation goes 0, 1, 0, 1, 0.
    local = [next(shards[k]) for k in (0, 1, 0, 1, 0)]
    assert len(got) == len(want) == len(local) == 5
    for g, w, l in zip(got, want, local):
        assert set(g) == set(w) == {"input", "target"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_array_equal(g[k], l[k], err_msg=k)
    assert got[0]["input"].shape == (2, 10, 8, 8, 3)


class _ProbeThenFail:
    """A worker factory: one batch saying whether the worker's
    ``CUDA_VISIBLE_DEVICES`` is empty, then an error."""

    def __call__(self, info):
        yield {"hidden": np.asarray(
            os.environ.get("CUDA_VISIBLE_DEVICES") == ""),
            "index": np.asarray(info.index)}
        raise ValueError("probe failure in the worker")


def test_worker_error_reraised_and_card_hidden():
    """A worker's exception is re-raised in the parent with the
    worker's traceback; workers start with the CUDA devices hidden,
    and the parent's environment is left as it was."""
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    it = iter(MultiprocessLoader(_ProbeThenFail(), num_workers=1, seed=0))
    first = next(it)
    assert bool(first["hidden"]) and int(first["index"]) == 0
    with pytest.raises(RuntimeError, match="worker 0 failed") as err:
        next(it)
    assert "Traceback" in str(err.value)
    assert "probe failure in the worker" in str(err.value)
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == before


def test_early_close_leaves_no_segment(chain):
    """Closing the stream mid-epoch (the chain repeats forever) stops
    the workers and unlinks every segment they made."""
    before = _shm_segments()
    loader = MultiprocessLoader(
        ConfigPipelineFactory(chain + [{"name": "RepeatOp"}], batch_size=2),
        num_workers=2, seed=0, prefetch=1)
    it = iter(loader)
    for _ in range(3):
        next(it)
    it.close()
    # Other tests may make (short-lived) segments at the same time: a
    # leak is a new segment that is still there seconds later.
    deadline = time.monotonic() + 10
    while (_shm_segments() - before) and time.monotonic() < deadline:
        time.sleep(0.5)
    assert not (_shm_segments() - before)


@pytest.mark.parametrize("kind", ["GZIP", "ZLIB"])
def test_compressed_shards_through_workers(chain, tmp_path, kind):
    """The chain's file rewritten by tensorflow's writer as GZIP / ZLIB:
    two workers give the in-process shards' batches, which are the
    uncompressed chain's, with or without ``pure_python``.  The
    reference reads the file through tensorflow; its pure-Python reader
    refuses it (a deliberate difference: the port decodes either way)."""
    import tensorflow as tf

    from joshupscale_tpu.data.pipeline import (
        create_dataset as j_create_dataset,
    )

    path = str(tmp_path / f"pairs.{kind.lower()}.tfrecords")
    with tf.io.TFRecordWriter(path, options=kind) as writer:
        for rec in tfr.read_records(chain[0]["path"]):
            writer.write(rec)
    source = {"name": "TFRecordDatasetOp", "path": path,
              "compression_type": kind}
    packed = [source] + chain[1:]
    got = list(create_train_dataset(packed, 2, seed=SEED, num_workers=2))
    batch = [{"name": "BatchOp", "batch_size": 2}]
    for pure in (False, True):
        shards = [iter(create_dataset(
            [{**source, "pure_python": pure}] + chain[1:] + batch,
            seed=SEED, shard=(2, i))) for i in (0, 1)]
        local = [next(shards[k]) for k in (0, 1, 0, 1, 0)]
        plain = list(create_dataset(chain + batch, seed=SEED, shard=(2, 0)))
        assert len(got) == len(local) == 5
        for g, l in zip(got, local):
            for k in g:
                np.testing.assert_array_equal(g[k], l[k], err_msg=k)
        for l, p in zip(local[0::2], plain):
            np.testing.assert_array_equal(l["input"], p["input"])
    want = list(j_create_dataset([source, {"name": "ParsePairExampleOp"}]))
    mine = list(create_dataset([source, {"name": "ParsePairExampleOp"}]))
    assert len(want) == len(mine) == 5
    for a, b in zip(mine, want):
        np.testing.assert_array_equal(a["input"], b["input"])
    with pytest.raises(ValueError, match="compressed"):
        list(j_create_dataset([{**source, "pure_python": True}]))
