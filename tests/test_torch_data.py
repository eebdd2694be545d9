"""The port's Parquet data layer (tpudl_torch.data: converter, datasets,
ingest) against tpudl.data on the same inputs.

Everything here is integer, byte or text work, so the comparisons are
exact (``np.testing.assert_array_equal``); the one float function,
``device_normalize_cifar``, is held to tpudl's own tolerance for it
(tests/test_datasets.py: atol 1e-6 against the host normalization).
Both packages write the same files: each reads the other's.
"""

import os
import pickle
import tarfile

import numpy as np
import pytest
import torch

from tpudl.data import converter as jconv
from tpudl.data import datasets as jds
from tpudl.data import ingest as jingest
from tpudl_torch.data import converter as tconv
from tpudl_torch.data import datasets as tds
from tpudl_torch.data import ingest as tingest


def _columns(n=600, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8),
        "ids": rng.integers(0, 30522, (n, 12)).astype(np.int64),
        "label": rng.integers(0, 10, (n,)).astype(np.int64),
        "text": np.asarray([f"row {i} é 字" for i in range(n)], dtype=object),
    }


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Three files of 200 rows (the last 200 short of two full files),
    row groups of 37 rows: sharding, shuffle pooling and the reader pool
    all cross group and file boundaries."""
    d = str(tmp_path_factory.mktemp("parquet"))
    tconv.write_parquet(d, _columns(), rows_per_file=200, row_group_size=37)
    return d


@pytest.mark.parametrize("writer", ["tpudl", "port"])
def test_each_package_reads_the_others_files(tmp_path, writer):
    cols = _columns(90, seed=1)
    write = (jconv if writer == "tpudl" else tconv).write_parquet
    paths = write(str(tmp_path), cols, rows_per_file=40, row_group_size=16)
    assert [os.path.basename(p) for p in paths] == [
        "part-00000.parquet", "part-00001.parquet", "part-00002.parquet"]
    for reader in (jconv, tconv):
        conv = reader.make_converter(str(tmp_path))
        assert conv.num_rows == 90 and conv.files_rows == [40, 40, 10]
        (batch,) = conv.make_batch_iterator(90, shard_index=0, num_shards=1)
        for k, v in cols.items():
            np.testing.assert_array_equal(batch[k], v)
        assert batch["image"].shape == (90, 4, 4, 3)


_ITERATIONS = {
    "plain": dict(batch_size=64),
    "shuffled_two_epochs": dict(batch_size=48, epochs=2, shuffle=True, seed=3,
                                shuffle_buffer=100),
    "shard_1_of_3": dict(batch_size=32, shard_index=1, num_shards=3),
    "shard_2_of_3_shuffled": dict(batch_size=32, shard_index=2, num_shards=3,
                                  shuffle=True, seed=7),
    "keep_last": dict(batch_size=64, drop_last=False),
    "keep_last_shuffled": dict(batch_size=50, drop_last=False, shuffle=True,
                               seed=1, shuffle_buffer=64),
    "columns": dict(batch_size=64, columns=("label", "text")),
    "four_threads": dict(batch_size=64, num_reader_threads=4, shuffle=True,
                         seed=5),
}


@pytest.mark.parametrize("name", sorted(_ITERATIONS))
def test_batch_sequences_match_tpudl(dataset, name):
    kw = dict(_ITERATIONS[name])
    kw.setdefault("shard_index", 0)
    kw.setdefault("num_shards", 1)
    want = jconv.make_converter(dataset).make_batch_iterator(**kw)
    got = tconv.make_converter(dataset).make_batch_iterator(**kw)
    _same_batches(got, want)


@pytest.mark.parametrize("shuffle", [False, True])
def test_reader_pool_keeps_the_single_thread_order(dataset, shuffle):
    conv = tconv.make_converter(dataset)
    kw = dict(batch_size=40, epochs=2, shuffle=shuffle, seed=11,
              shard_index=1, num_shards=2, drop_last=False)
    _same_batches(conv.make_batch_iterator(num_reader_threads=4, **kw),
                  conv.make_batch_iterator(num_reader_threads=1, **kw))


def test_steps_per_epoch_row_ranges_and_transform_match_tpudl(dataset):
    jc, tc = jconv.make_converter(dataset), tconv.make_converter(dataset)
    for bs in (16, 64, 199):
        for shards in (1, 2, 3):
            assert tc.steps_per_epoch(bs, shards) == \
                jc.steps_per_epoch(bs, shards)
    # One file, windowed: two converters over disjoint row windows.
    one = [tc.files[0]]
    for lo, hi in ((0, 150), (150, 200)):
        jw = jconv.Converter(files=one, num_rows=hi - lo, files_rows=[200],
                             row_ranges=[(lo, hi)])
        tw = tconv.Converter(files=one, num_rows=hi - lo, files_rows=[200],
                             row_ranges=[(lo, hi)])
        assert tw.steps_per_epoch(8, 2) == jw.steps_per_epoch(8, 2)

        def double(b):
            return {**b, "label": b["label"] * 2}

        kw = dict(batch_size=8, shard_index=1, num_shards=2, shuffle=True,
                  seed=2, drop_last=False, transform=double)
        _same_batches(tw.make_batch_iterator(**kw),
                      jw.make_batch_iterator(**kw))
    with pytest.raises(ValueError, match="shard_index"):
        next(tc.make_batch_iterator(8, shard_index=3, num_shards=3))
    for bad in (str(dataset) + "-missing", []):
        with pytest.raises((FileNotFoundError, ValueError)):
            tconv.make_converter(bad)


def test_default_shard_is_the_process_group_rank(dataset, monkeypatch):
    """Without a process group every process reads shard 0 of 1; with
    one, its rank over the world size (tpudl: jax.process_index() over
    jax.process_count()), and eval_stream counts shards the same way."""
    assert tconv.process_topology() == (0, 1)
    conv = tconv.make_converter(dataset)
    whole = list(conv.make_batch_iterator(64))
    _same_batches(whole, conv.make_batch_iterator(64, shard_index=0,
                                                  num_shards=1))
    import jax
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 3)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    assert tconv.process_topology() == (1, 3)
    _same_batches(conv.make_batch_iterator(32),
                  jconv.make_converter(dataset).make_batch_iterator(32))
    _same_batches(conv.make_batch_iterator(32),
                  conv.make_batch_iterator(32, shard_index=1, num_shards=3))
    assert conv.steps_per_epoch(32) == conv.steps_per_epoch(32, 3)
    # 600 rows over 3 shards is 200 a shard: a 250-row batch keeps its
    # partial batch (drop_last off) in both packages.
    got = list(tds.eval_stream(conv, 250, lambda b: b)())
    want = list(jds.eval_stream(jconv.make_converter(dataset), 250,
                                lambda b: b)())
    _same_batches(got, want)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def _read_all(directory):
    conv = jconv.make_converter(directory)
    (batch,) = conv.make_batch_iterator(conv.num_rows, shard_index=0,
                                        num_shards=1)
    return conv, batch


_MATERIALIZERS = {
    "cifar10": ("materialize_cifar10_like",
                dict(num_rows=300, rows_per_file=128, row_group_size=50)),
    "sst2_ids": ("materialize_sst2_like",
                 dict(num_rows=200, seq_len=32, rows_per_file=64)),
    "imagenet": ("materialize_imagenet_like",
                 dict(num_rows=12, image_size=16, num_classes=5,
                      rows_per_file=5, row_group_size=2)),
    "sst2_text": ("materialize_sst2_text",
                  dict(num_rows=150, seed=4, rows_per_file=64)),
}


@pytest.mark.parametrize("name", sorted(_MATERIALIZERS))
def test_materialized_datasets_equal_tpudls(tmp_path, name):
    fn, kw = _MATERIALIZERS[name]
    tconv_ = getattr(tds, fn)(str(tmp_path / "port"), **kw)
    jconv_ = getattr(jds, fn)(str(tmp_path / "tpudl"), **kw)
    assert isinstance(tconv_, tconv.Converter)
    assert tconv_.files_rows == jconv_.files_rows
    _, got = _read_all(str(tmp_path / "port"))
    _, want = _read_all(str(tmp_path / "tpudl"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_tokenize_split_and_eval_stream_equal_tpudls(tmp_path):
    from tpudl.data.tokenizer import WordPieceTokenizer as JWordPiece
    from tpudl.data.tokenizer import build_wordpiece_vocab as jbuild
    from tpudl_torch.data.tokenizer import (
        WordPieceTokenizer,
        build_wordpiece_vocab,
    )

    text = tds.materialize_sst2_text(str(tmp_path / "text"), num_rows=300,
                                     rows_per_file=300)
    corpus = [str(s) for b in text.make_batch_iterator(
        100, drop_last=False, columns=("sentence",)) for s in b["sentence"]]
    tok = WordPieceTokenizer(build_wordpiece_vocab(corpus, 256))
    jtok = JWordPiece(jbuild(corpus, 256))
    got = tds.tokenize_text_dataset(str(tmp_path / "text"),
                                    str(tmp_path / "ids"), tok, seq_len=24,
                                    batch_size=64, rows_per_file=128)
    want = jds.tokenize_text_dataset(str(tmp_path / "text"),
                                     str(tmp_path / "jids"), jtok,
                                     seq_len=24, batch_size=64,
                                     rows_per_file=128)
    assert got.files_rows == want.files_rows == [128, 128, 44]
    _same_batches(got.make_batch_iterator(300, drop_last=False),
                  want.make_batch_iterator(300, drop_last=False))
    # Multi-file: the last file is the holdout; one file: the last rows.
    splits = []
    for conv, jc in ((got, want), (text, jconv.make_converter(
            str(tmp_path / "text")))):
        train, hold = tds.split_train_eval(conv)
        jtrain, jhold = jds.split_train_eval(jc)
        splits.append((hold, jhold))
        assert [os.path.basename(f) for f in train.files] == \
            [os.path.basename(f) for f in jtrain.files]
        assert (train.num_rows, hold.num_rows, train.row_ranges,
                hold.row_ranges) == (jtrain.num_rows, jhold.num_rows,
                                     jtrain.row_ranges, jhold.row_ranges)
        kw = dict(batch_size=16, shuffle=True, seed=0, shard_index=0,
                  num_shards=1)
        _same_batches(train.make_batch_iterator(**kw),
                      jtrain.make_batch_iterator(**kw))
    (hold, jhold), _ = splits
    hold_stream = tds.eval_stream(hold, 64, tds.normalize_sst2_batch,
                                  batch_divisor=4)
    jhold_stream = jds.eval_stream(jhold, 64, jds.normalize_sst2_batch,
                                   batch_divisor=4)
    for _ in range(2):  # re-iterable
        _same_batches(hold_stream(), jhold_stream())
    for b in hold_stream():
        assert all(v.dtype == np.int32 for v in b.values())
    with pytest.raises(ValueError, match="already-windowed"):
        tds.split_train_eval(train)
    with pytest.raises(ValueError, match="eval_fraction"):
        tds.split_train_eval(got, eval_fraction=1.0)


def test_normalize_and_wire_functions_match_tpudls():
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (6, 8, 8, 3), dtype=np.uint8),
             "label": rng.integers(0, 10, (6,)).astype(np.int64),
             "input_ids": rng.integers(0, 99, (6, 5)).astype(np.int64),
             "attention_mask": np.ones((6, 5), np.int64)}
    for fn in ("normalize_cifar_batch", "wire_cifar_batch"):
        got = getattr(tds, fn)({k: batch[k] for k in ("image", "label")})
        want = getattr(jds, fn)({k: batch[k] for k in ("image", "label")})
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    got, want = tds.normalize_sst2_batch(batch), jds.normalize_sst2_batch(batch)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    # On the device: the port's transform on a uint8 tensor against
    # tpudl's traced one and the host normalization, at tpudl's atol.
    wire = tds.wire_cifar_batch({k: batch[k] for k in ("image", "label")})
    on_device = tds.device_normalize_cifar()(
        {k: torch.as_tensor(v) for k, v in wire.items()})
    jnorm = jds.device_normalize_cifar()(dict(wire))
    host = tds.normalize_cifar_batch({k: batch[k] for k in ("image",
                                                            "label")})
    assert on_device["image"].dtype == torch.float32
    np.testing.assert_allclose(on_device["image"].numpy(),
                               np.asarray(jnorm["image"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(on_device["image"].numpy(), host["image"],
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------


def _cifar_batch(rng, n):
    hwc = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    return {b"data": hwc.transpose(0, 3, 1, 2).reshape(n, 3072),
            b"labels": [int(x) for x in rng.integers(0, 10, n)],
            b"batch_label": b"testing batch"}


def _cifar_archive(root, batches, as_tar):
    src = root / "cifar-10-batches-py"
    src.mkdir(parents=True)
    for i, d in enumerate(batches, start=1):
        with open(src / f"data_batch_{i}", "wb") as f:
            pickle.dump(d, f)
    with open(src / "test_batch", "wb") as f:
        pickle.dump(batches[-1], f)
    if not as_tar:
        return str(root)
    tar = root / "cifar-10-python.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        tf.add(src, arcname="cifar-10-batches-py")
    return str(tar)


def _same_dataset(got_dir, want_dir):
    _, got = _read_all(got_dir)
    _, want = _read_all(want_dir)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    return got


@pytest.mark.parametrize("as_tar,split", [(False, "train"), (True, "train"),
                                          (True, "test")])
def test_ingest_cifar10_writes_tpudls_rows(tmp_path, as_tar, split):
    rng = np.random.default_rng(3)
    batches = [_cifar_batch(rng, 24) for _ in range(5)]
    src = _cifar_archive(tmp_path / "src", batches, as_tar)
    conv = tingest.ingest_cifar10(src, str(tmp_path / "port"), split=split,
                                  rows_per_file=10)
    jingest.ingest_cifar10(src, str(tmp_path / "tpudl"), split=split,
                           rows_per_file=10)
    got = _same_dataset(str(tmp_path / "port"), str(tmp_path / "tpudl"))
    assert conv.num_rows == (120 if split == "train" else 24)
    first = batches[0] if split == "train" else batches[-1]
    np.testing.assert_array_equal(
        got["image"][0], first[b"data"][0].reshape(3, 32, 32).transpose(
            1, 2, 0))


def test_ingest_sst2_tsv_and_image_folder_write_tpudls_rows(tmp_path):
    from PIL import Image

    tsv = tmp_path / "SST-2"
    tsv.mkdir()
    with open(tsv / "dev.tsv", "w", encoding="utf-8") as f:
        f.write("label\tsentence\n")
        for i in range(9):
            f.write(f"{i % 2}\ta \"quoted\" film, {i} ½ stars\n")
        f.write("\n")
    tingest.ingest_sst2_tsv(str(tsv), str(tmp_path / "port_tsv"),
                            split="dev")
    jingest.ingest_sst2_tsv(str(tsv), str(tmp_path / "tpudl_tsv"),
                            split="dev")
    got = _same_dataset(str(tmp_path / "port_tsv"),
                        str(tmp_path / "tpudl_tsv"))
    assert got["sentence"][0] == 'a "quoted" film, 0 ½ stars'

    tree = tmp_path / "images"
    rng = np.random.default_rng(0)
    for cls, n in (("dog", 3), ("cat", 2)):
        (tree / cls / "nested").mkdir(parents=True)
        for i in range(n):
            arr = rng.integers(0, 256, (20 + i, 30, 3), dtype=np.uint8)
            ext = ".png" if i % 2 else ".JPG"
            sub = tree / cls / ("nested" if i == 2 else "")
            Image.fromarray(arr).save(sub / f"{i}{ext}")
        (tree / cls / "notes.txt").write_text("skipped")
    for pkg, out in ((tingest, "port_img"), (jingest, "tpudl_img")):
        pkg.ingest_image_folder(str(tree), str(tmp_path / out),
                                image_size=16, resize_shorter=18,
                                rows_per_file=2, row_group_size=1)
    got = _same_dataset(str(tmp_path / "port_img"),
                        str(tmp_path / "tpudl_img"))
    assert got["image"].shape == (5, 16, 16, 3)
    assert (tmp_path / "port_img" / "classes.txt").read_text() == \
        (tmp_path / "tpudl_img" / "classes.txt").read_text() == "cat\ndog\n"
    # A re-ingest over the published directory swaps it whole and keeps
    # a user's file.
    (tmp_path / "port_img" / "README").write_text("mine")
    tingest.ingest_image_folder(str(tree), str(tmp_path / "port_img"),
                                image_size=16, rows_per_file=5)
    assert (tmp_path / "port_img" / "README").read_text() == "mine"
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["SST-2", "images", "port_tsv", "tpudl_tsv", "port_img",
         "tpudl_img"])


def _bad_inputs(tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "noclass").mkdir()
    (tmp_path / "noclass" / "a").mkdir()
    with open(tmp_path / "short.tsv", "w") as f:
        f.write("sentence\tlabel\nonly-one-field\n")
    with open(tmp_path / "nohead.tsv", "w") as f:
        f.write("text\ty\nx\t1\n")
    with open(tmp_path / "rows.tsv", "w") as f:
        f.write("sentence\tlabel\n")
    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump({"x": 1}, f)
    (tmp_path / "badc" / "cifar-10-batches-py").mkdir(parents=True)
    for name in ("data_batch_1", "test_batch"):
        with open(tmp_path / "badc" / "cifar-10-batches-py" / name,
                  "wb") as f:
            pickle.dump({b"data": np.zeros((2, 10), np.uint8),
                         b"labels": [0, 1]}, f)
    (tmp_path / "nokeys" / "cifar-10-batches-py").mkdir(parents=True)
    with open(tmp_path / "nokeys" / "cifar-10-batches-py" / "test_batch",
              "wb") as f:
        pickle.dump({b"other": 1}, f)
    return [
        ("ingest_cifar10", (str(tmp_path / "empty"),), dict(split="train")),
        ("ingest_cifar10", (str(tmp_path / "empty"),), dict(split="val")),
        ("ingest_cifar10", (str(tmp_path / "badc"),), dict(split="test")),
        ("ingest_cifar10", (str(tmp_path / "nokeys"),), dict(split="test")),
        ("ingest_sst2_tsv", (str(tmp_path / "short.tsv"),), {}),
        ("ingest_sst2_tsv", (str(tmp_path / "nohead.tsv"),), {}),
        ("ingest_sst2_tsv", (str(tmp_path / "rows.tsv"),), {}),
        ("ingest_sst2_tsv", (str(tmp_path / "missing.tsv"),), {}),
        ("ingest_image_folder", (str(tmp_path / "empty"),), {}),
        ("ingest_image_folder", (str(tmp_path / "noclass"),), {}),
        ("ingest_image_folder", (str(tmp_path / "noclass"),),
         dict(image_size=32, resize_shorter=16)),
    ]


def test_ingest_errors_are_tpudls(tmp_path):
    for fn, args, kw in _bad_inputs(tmp_path):
        errors = []
        for pkg, out in ((tingest, "out_port"), (jingest, "out_tpudl")):
            with pytest.raises(Exception) as info:
                getattr(pkg, fn)(*args, str(tmp_path / out), **kw)
            errors.append(info.value)
        got, want = errors
        assert type(got) is type(want), (fn, kw, got, want)
        assert str(got).replace(str(tmp_path), "") == \
            str(want).replace(str(tmp_path), ""), (fn, kw)


def test_ingest_records_a_span_and_counters(tmp_path):
    from tpudl_torch import obs
    from tpudl_torch.obs import counters

    with open(tmp_path / "train.tsv", "w", encoding="utf-8") as f:
        f.write("sentence\tlabel\n")
        for i in range(8):
            f.write(f"{'a fine movie about observability ' * 8}{i}\t1\n")
    counters.registry().reset()
    rec = obs.enable(str(tmp_path / "obs"))
    try:
        tingest.ingest_sst2_tsv(str(tmp_path / "train.tsv"),
                                str(tmp_path / "out"))
        chunks = [r for r in rec.records if r.get("name") == "ingest_chunk"]
        snap = counters.registry().snapshot()["counters"]
    finally:
        obs.disable()
        counters.registry().reset()
    assert len(chunks) == 1 and chunks[0]["cat"] == "ingest"
    assert chunks[0]["rows"] == 8 and chunks[0]["part"] == 0
    assert snap["rows_ingested"] == 8 and snap["bytes_ingested"] > 8 * 200


def test_config_bert_large_equals_tpudls_but_mesh_and_strategy():
    import dataclasses

    from tpudl.config import CONFIGS as JCONFIGS
    from tpudl.config import get_config as jget
    from tpudl_torch.config import CONFIGS, get_config

    assert sorted(CONFIGS) == sorted(JCONFIGS)
    for name in sorted(JCONFIGS):
        got = dataclasses.asdict(get_config(name))
        want = dataclasses.asdict(jget(name))
        assert set(want) - set(got) == {"mesh", "strategy"}
        assert {k: want[k] for k in got} == got, name
    cfg = get_config("bert_large_v4_32")
    assert (cfg.model, cfg.global_batch_size, cfg.accum_steps,
            cfg.optim.mu_dtype) == ("bert-large", 256, 4, "bfloat16")
