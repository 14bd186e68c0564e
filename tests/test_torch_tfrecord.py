"""Port parity for the TFRecord door: the codec
(``joshupscale_torch.data.tfrecord``), the TFRecord source and Example
parsers of the pipeline, and ``create_dataset(shard=...)``.

Files and serialized Examples written by the port are byte for byte the
JAX package's; each side reads the other's (and tensorflow's); the pair
and single chains give the reference's elements bit for bit, against
both of its readers (tf.data and its pure-python codec).
"""

import gzip
import os

import numpy as np
import pytest

from joshupscale_tpu.data import tfrecord as j_tfr
from joshupscale_tpu.data.pipeline import create_dataset as j_create_dataset
from joshupscale_torch.data import tfrecord as tfr
from joshupscale_torch.data.pipeline import create_dataset

# Every feature kind, negative and 64-bit ints, and empty lists whose
# oneof only ``kinds`` can give.
_FEATURES = {
    "b": [b"data" * 50, b"", bytes(range(256))],
    "f": [0.5, -1.25, 3.0e38, np.float32(1e-7)],
    "i": [7, -7, 2 ** 40, -(2 ** 63), np.int64(3)],
    "eb": [], "ef": [], "ei": [],
}
_KINDS = {"eb": "bytes", "ef": "float", "ei": "int64"}


def _png(img):
    import cv2

    return cv2.imencode(".png", img)[1].tobytes()


def _hr_frames(rng, h, w):
    """Ten random (4h, 4w) u8 frames."""
    return rng.integers(0, 256, (10, 4 * h, 4 * w, 3), np.uint8)


def test_codec_bytes_match_reference(tmp_path):
    """Examples (with and without ``kinds``) and record files written by
    the port are the JAX package's bytes (records past 64 KiB take the
    port's chunked CRC); each side reads the other's file, payload CRCs
    verified; the CRC's known answer; a corrupt length raises, and a
    corrupt payload raises under ``verify``."""
    assert tfr.crc32c(b"123456789") == 0xE3069283
    ours = tfr.encode_example(_FEATURES, kinds=_KINDS)
    theirs = j_tfr.encode_example(_FEATURES, kinds=_KINDS)
    assert ours == theirs
    assert (tfr.encode_example({"e": []})
            == j_tfr.encode_example({"e": []}))
    decoded = tfr.decode_example(theirs)
    assert decoded == j_tfr.decode_example(ours)
    assert decoded["eb"] == decoded["ef"] == decoded["ei"] == []
    assert decoded["i"] == [7, -7, 2 ** 40, -(2 ** 63), 3]
    with pytest.raises(ValueError, match="expected 2 values"):
        tfr.parse_fixed_len(ours, {"b": 2})
    with pytest.raises(KeyError):
        tfr.parse_fixed_len(ours, {"missing": 1})

    # Two records long enough for the chunked CRC (one of odd length).
    long = np.random.default_rng(1).integers(0, 256, 300_001, np.uint8)
    recs = [ours, b"raw-record", b"", long.tobytes(), bytes(range(256)) * 512]
    a, b = str(tmp_path / "ours.tfrecords"), str(tmp_path / "theirs.tfrecords")
    assert tfr.write_records(a, recs) == 5
    j_tfr.write_records(b, recs)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert list(tfr.read_records(b, verify=True)) == recs
    assert list(j_tfr.read_records(a, verify=True)) == recs

    data = bytearray(open(a, "rb").read())
    bad = str(tmp_path / "bad_len.tfrecords")
    data[0] ^= 1
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt record length"):
        list(tfr.read_records(bad))
    data[0] ^= 1
    data[20] ^= 1  # inside the first payload
    open(bad, "wb").write(bytes(data))
    assert len(list(tfr.read_records(bad))) == 5
    with pytest.raises(ValueError, match="corrupt record payload"):
        list(tfr.read_records(bad, verify=True))


def test_port_reads_tensorflow_file(tmp_path):
    """A file written by tensorflow's own writer and Example proto."""
    tf = pytest.importorskip("tensorflow")
    path = str(tmp_path / "tf.tfrecords")
    example = tf.train.Example(features=tf.train.Features(feature={
        "images": tf.train.Feature(
            bytes_list=tf.train.BytesList(value=[b"p1", b"p2"])),
        "f": tf.train.Feature(
            float_list=tf.train.FloatList(value=[0.5, -1.0])),
        "i": tf.train.Feature(
            int64_list=tf.train.Int64List(value=[-1, 2])),
    }))
    with tf.io.TFRecordWriter(path) as w:
        w.write(example.SerializeToString())
    (rec,) = list(tfr.read_records(path, verify=True))
    out = tfr.decode_example(rec)
    assert out == {"images": [b"p1", b"p2"], "f": [0.5, -1.0], "i": [-1, 2]}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Two files: pair examples (5, 16x24 LR) and single examples (3,
    64x96 HR), PNG frames, one of them gray."""
    import cv2

    root = tmp_path_factory.mktemp("tfr")
    rng = np.random.default_rng(0)
    pair, single = [], []
    for s in range(5):
        hr = _hr_frames(rng, 16, 24)
        target = [_png(f) for f in hr]
        if s == 1:
            target[3] = _png(cv2.cvtColor(hr[3], cv2.COLOR_BGR2GRAY))
        pair.append(tfr.encode_example({
            "input": [_png(f[::4, ::4]) for f in hr], "target": target}))
    for _ in range(3):
        single.append(tfr.encode_example(
            {"images": [_png(f) for f in _hr_frames(rng, 16, 24)]}))
    paths = {"pair": str(root / "pair.tfrecords"),
             "single": str(root / "single.tfrecords")}
    tfr.write_records(paths["pair"], pair)
    tfr.write_records(paths["single"], single)
    return paths


def _chain(path, kind, pure_python=None):
    src = {"name": "TFRecordDatasetOp", "path": path}
    parse = {"name": ("ParsePairExampleOp" if kind == "pair"
                      else "ParseSingleExampleOp")}
    if pure_python is not None:
        src["pure_python"] = parse["pure_python"] = pure_python
    return [src, parse,
            {"name": "RandomCropOp", "crop_size": 8, "num_img": 2},
            {"name": "RandomHorizontalFlipOp", "threshold": 0.5},
            {"name": "NormalizeOp", "crop_size": 8},
            {"name": "RandomNoiseOp", "stddev": 0.01},
            {"name": "ShuffleOp", "shuffle_window": 3}]


def _same_stream(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["pair", "single"])
@pytest.mark.parametrize("pure_python", [True, False],
                         ids=["reference_codec", "reference_tf_data"])
def test_tfrecord_chains_match_reference(records, kind, pure_python):
    """The pair and single chains through ``create_dataset`` in both
    packages, bit for bit: the reference reads through its codec
    (``pure_python``) or tf.data and tf.io.decode_image; the port
    always through its codec and cv2."""
    if not pure_python:
        pytest.importorskip("tensorflow")
    _same_stream(create_dataset(_chain(records[kind], kind), seed=5),
                 j_create_dataset(_chain(records[kind], kind, pure_python),
                                  seed=5))


def test_shards_match_reference_and_cover_one_pass(records, tmp_path):
    """``shard=(n, i)``: the port's shards are the reference's, record
    streams and shuffled file lists (``GlobOp`` + ``ListShuffleOp``);
    the union of the shards is one pass of the unsharded stream; an
    unseeded shard raises; a GZIP copy of the source gives its shards;
    an unknown compression type raises."""
    plain = _chain(records["pair"], "pair")[:2]
    cfg = plain + [{"name": "RandomCropOp", "crop_size": 8, "num_img": 1}]
    digest = lambda stream: sorted(  # noqa: E731
        e["target"].tobytes() for e in stream)
    full = digest(create_dataset(plain, seed=9))
    for n in (2, 3):
        union = []
        for i in range(n):
            _same_stream(create_dataset(cfg, seed=9, shard=(n, i)),
                         j_create_dataset(cfg, seed=9, shard=(n, i)))
            union += digest(create_dataset(plain, seed=9, shard=(n, i)))
        assert sorted(union) == full and len(set(full)) == 5
    files = [{"name": "GlobOp",
              "glob_pattern": os.path.dirname(records["pair"]) + "/*"},
             {"name": "ListShuffleOp"}]
    shards = [create_dataset(files, seed=2, shard=(2, i)) for i in (0, 1)]
    assert shards == [j_create_dataset(files, seed=2, shard=(2, i))
                      for i in (0, 1)]
    assert sorted(shards[0] + shards[1]) == sorted(create_dataset(files,
                                                                  seed=2))
    with pytest.raises(ValueError, match="requires a seed"):
        create_dataset(cfg, shard=(2, 0))
    next(iter(create_dataset(cfg, shard=(1, 0))))
    packed = str(tmp_path / "pair.tfrecords.gz")
    with open(records["pair"], "rb") as f, gzip.open(packed, "wb") as g:
        g.write(f.read())
    gz = [{**cfg[0], "path": packed, "compression_type": "GZIP"}] + cfg[1:]
    _same_stream(create_dataset(gz, seed=9, shard=(2, 1)),
                 create_dataset(cfg, seed=9, shard=(2, 1)))
    with pytest.raises(ValueError, match="compression"):
        create_dataset([{"name": "TFRecordDatasetOp",
                         "path": records["pair"],
                         "compression_type": "LZ4"}])
