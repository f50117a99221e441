"""PyTorch port, the data pipeline and its CLIs against the JAX package's on
the CPU.

Both pipelines are numpy, so the comparisons are exact: the same argv gives
the same config, the same records and seed the same batch plans, the same
images (PNGs written here with PIL, memmap shards, or an ``.npz`` of
features) the same batches key by key and byte for byte, the same caption
JSON the same ``vocab.json`` and ``data.json`` bytes, the same PNGs the same
memmap shards. The port's memmap writer differs on purpose in one place:
it rebuilds when a shard listed in the index is missing or short.
"""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from show_and_tell_tpu import config as jconfig
from show_and_tell_tpu.cli import import_vocab as jimport_vocab
from show_and_tell_tpu.cli import pack_memmap as jpack_cli
from show_and_tell_tpu.cli import preprocess as jpreprocess_cli
from show_and_tell_tpu.data import dataset as jdataset
from show_and_tell_tpu.data import memmap as jmemmap
from show_and_tell_tpu.data import pipeline as jpipeline
import show_and_tell_tpu.data.preprocess  # noqa: F401  (the package exports a function by the name)
from show_and_tell_tpu.utils.vocab import Vocabulary as JVocabulary
from show_and_tell_tpu_torch import config
from show_and_tell_tpu_torch.cli import import_vocab, pack_memmap
from show_and_tell_tpu_torch.cli import preprocess as preprocess_cli
from show_and_tell_tpu_torch.data import dataset, memmap, pipeline, preprocess
from show_and_tell_tpu_torch.utils.shapes import round_up
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

WORDS = ["a", "man", "rides", "horse", "dog", "runs", "fast", "on", "the", "beach", "tall", "red"]
SIZE = 32  # image side of the PNGs written here
RESIZED = 256  # the side cli.preprocess resizes to, and the loaders' image size over its output


# --- shared corpus helpers (also used by test_torch_port_trainer.py) --------


def write_corpus(root, n_train=16, n_val=4, n_test=2, sents=2, img_hw=(SIZE, SIZE), seed=0):
    """A Karpathy-format caption JSON and one PNG per image under ``root``
    (``imgs/<split>/img<i>.png``). Returns (caption json path, images root).
    Caption lengths vary so that the datasets have several buckets."""
    rng = np.random.default_rng(seed)
    images = []
    imgid = 0
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        d = os.path.join(root, "imgs", split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            fname = f"img{i}.png"
            Image.fromarray(rng.integers(0, 256, (*img_hw, 3), dtype=np.uint8)).save(os.path.join(d, fname))
            sentences = [
                {"tokens": [WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(2, 9)))]}
                for _ in range(sents)
            ]
            images.append({"split": split, "imgid": imgid, "cocoid": 1000 + imgid, "filepath": split,
                           "filename": fname, "sentences": sentences,
                           "sentids": [imgid * sents + s for s in range(sents)]})
            imgid += 1
    path = os.path.join(root, "captions.json")
    with open(path, "w") as f:
        json.dump({"images": images}, f)
    return path, os.path.join(root, "imgs")


def run_preprocess(pkg, root, caption_json, images_root, resize, memmap_dir=None):
    """``cli.preprocess.main`` of ``pkg`` (``"jax"`` or ``"torch"``) into
    ``root``; resized images go to ``<root>/data``. Returns (vocab path,
    data.json path)."""
    os.makedirs(root, exist_ok=True)
    argv = ["--caption_json", caption_json, "--vocab_path", os.path.join(root, "vocab.json"),
            "--output_json", os.path.join(root, "data.json"), "--word_count_threshold", "1",
            "--print_stats", "false", "--num_workers", "2"]
    if memmap_dir:
        argv += ["--memmap_dir", memmap_dir]
    cfg_mod, pre = (jconfig, sys.modules["show_and_tell_tpu.data.preprocess"]) if pkg == "jax" else (config, preprocess)
    cfg = cfg_mod.parse_config(argv + (["--images_root", images_root] if resize else []))
    pre.preprocess(cfg, resize_images=resize, data_root=os.path.join(root, "data"))
    return cfg.vocab_path, cfg.output_json


def features_npz(path, records, L=4, seed=0):
    """An ``.npz`` of random [L, 512] features for every cocoid of
    ``records``, keyed ``str(cocoid)`` as ``cli.extract_features`` writes."""
    rng = np.random.default_rng(seed)
    ids = sorted({r["cocoid"] for r in records})
    np.savez(path, **{str(c): rng.standard_normal((L, 512)).astype(np.float32) for c in ids})
    return path


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                assert np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


def _records(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return [{"split": "train", "imgid": i, "cocoid": 100 + i, "file_path": f"x{i}.png",
             "final_caption": [WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(1, 14)))],
             "sentids": i} for i in range(n)]


# --- config -----------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [],
    ["--batch_size", "7", "--learning_rate", "0.01", "--preempt_save", "false", "--native_decode", "true"],
    ["--start_from", "/x/y", "--features_path", "f.npz", "--multihost", "1", "--dtype", "bfloat16",
     "--ema_decay", "0.5", "--native_decode", "no", "--profile_step", "-3", "--encoder_weights", "w.pth"],
])
def test_parse_config_matches_jax(argv):
    got = config.parse_config(argv).to_dict()
    assert got == jconfig.parse_config(argv).to_dict()
    assert got.keys() == config.Config().to_dict().keys()


def test_save_and_load_config_round_trip(tmp_path):
    cfg = config.parse_config(["--exp_id", "e1", "--expr_dir", str(tmp_path), "--beam_size", "5"])
    path = config.save_config(cfg)
    assert path == os.path.join(str(tmp_path), "config_expr_e1.json")
    assert config.load_config(path) == cfg
    jpath = jconfig.save_config(jconfig.parse_config(["--exp_id", "e1", "--beam_size", "5",
                                                      "--expr_dir", str(tmp_path / "j")]))
    with open(path) as a, open(jpath) as b:
        mine, theirs = json.load(a), json.load(b)
    assert {k: v for k, v in mine.items() if k != "expr_dir"} == {k: v for k, v in theirs.items() if k != "expr_dir"}


def test_round_up():
    assert [round_up(x, 4) for x in (1, 4, 5, 8)] == [4, 4, 8, 8]


# --- dataset ----------------------------------------------------------------


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("num_buckets", [1, 3])
def test_batch_plans_match_jax(drop_remainder, num_buckets):
    recs = _records()
    ds = dataset.CocoCaptionDataset(recs, Vocabulary.from_words(WORDS), num_buckets=num_buckets, max_caption_len=12)
    jds = jdataset.CocoCaptionDataset(recs, JVocabulary.from_words(WORDS), num_buckets=num_buckets,
                                      max_caption_len=12)
    assert [b["pad_len"] for b in ds.buckets] == [b["pad_len"] for b in jds.buckets]
    assert all(np.array_equal(a["indices"], b["indices"]) for a, b in zip(ds.buckets, jds.buckets))
    for shuffle in (False, True):
        got = list(ds.iter_index_batches(6, shuffle, np.random.default_rng(3), drop_remainder))
        want = list(jds.iter_index_batches(6, shuffle, np.random.default_rng(3), drop_remainder))
        assert [(p["pad_len"], p["indices"].tolist()) for p in got] == \
               [(p["pad_len"], p["indices"].tolist()) for p in want]
    assert ds.num_batches(6, drop_remainder) == jds.num_batches(6, drop_remainder) == len(got)
    caps, lens = ds.encode_indices(got[0]["indices"], got[0]["pad_len"])
    jcaps, jlens = jds.encode_indices(got[0]["indices"], got[0]["pad_len"])
    assert np.array_equal(caps, jcaps) and np.array_equal(lens, jlens)
    assert ds.batch_meta([0, 5]) == jds.batch_meta([0, 5])


# --- loader -----------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Both packages' preprocess output over one caption JSON of 32 px PNGs,
    and memmap shards of its images."""
    root = str(tmp_path_factory.mktemp("corpus"))
    caption_json, images_root = write_corpus(root, n_train=12, n_val=4)
    vocab_path, data_json = run_preprocess("torch", os.path.join(root, "torch"), caption_json, images_root,
                                           resize=True)
    with open(data_json) as f:
        records = json.load(f)
    mm = os.path.join(root, "mm")
    memmap.pack_memmap([r["file_path"] for r in records], mm, size=RESIZED, items_per_shard=5, native_decode=False)
    npz = features_npz(os.path.join(root, "feats.npz"), records)
    return {"root": root, "caption_json": caption_json, "images_root": images_root, "vocab": vocab_path,
            "records": records, "memmap": mm, "npz": npz}


def _loaders(corpus, source, **kw):
    recs = corpus["records"]
    vocab = Vocabulary.load(corpus["vocab"])
    ds = dataset.CocoCaptionDataset(recs, vocab, "train", num_buckets=2)
    jds = jdataset.CocoCaptionDataset(recs, JVocabulary.load(corpus["vocab"]), "train", num_buckets=2)
    common = dict(batch_size=5, num_workers=2, prefetch_depth=1, seed=11, image_size=RESIZED, drop_remainder=True,
                  **kw)
    mine, theirs = dict(common), dict(common, native_decode=False)
    if source == "pil":
        mine["native_decode"] = False
    elif source == "native":
        mine["native_decode"] = True  # no resize at RESIZED: native and PIL decode the same pixels
    elif source == "memmap":
        mine["memmap_images"] = theirs["memmap_images"] = corpus["memmap"]
    else:
        mine["features"] = theirs["features"] = corpus["npz"]
    return pipeline.Loader(ds, **mine), jpipeline.Loader(jds, **theirs)


@pytest.mark.parametrize("source", ["pil", "native", "memmap", "npz"])
def test_loader_batches_match_jax(corpus, source):
    """Two epochs pinned by set_epoch, then a resume skip of 2 plans."""
    mine, theirs = _loaders(corpus, source)
    if source == "native":
        assert pipeline._native_available(), "the C++ image decoder did not build on this host"
    for epoch in (1, 2):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert_same_batches(mine, theirs)
    for loader in (mine, theirs):
        loader.set_resume_skip(2)
    assert_same_batches(mine, theirs)
    assert len(mine) == len(theirs) and mine.corrupt_skipped == 0
    key = "features" if source == "npz" else "images"
    batch = next(iter(mine))
    assert batch[key].shape[0] == 5 and ("images" in batch) == (source != "npz")


def _corrupt_dataset(tmp_path, n_good, bad):
    rng = np.random.default_rng(1)
    paths = []
    for i in range(n_good):
        p = str(tmp_path / f"g{i}.png")
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    if n_good:
        (tmp_path / "trunc.png").write_bytes(open(paths[0], "rb").read()[:40])
    (tmp_path / "text.png").write_bytes(b"not an image")
    for i, name in bad:
        paths.insert(i, str(tmp_path / name))
    recs = [{"split": "train", "imgid": i, "cocoid": i, "file_path": p, "final_caption": ["a", "dog"],
             "sentids": i} for i, p in enumerate(paths)]
    return (dataset.CocoCaptionDataset(recs, Vocabulary.from_words(WORDS), num_buckets=1),
            jdataset.CocoCaptionDataset(recs, JVocabulary.from_words(WORDS), num_buckets=1))


@pytest.mark.parametrize("use_memmap", [False, True])
def test_corrupt_policy_substitutes_as_jax(tmp_path, use_memmap):
    """A truncated and a non-image file are substituted by healthy rows of
    their batch, as in the JAX package; through the memmap path the misses
    are decoded and substituted alike."""
    ds, jds = _corrupt_dataset(tmp_path, 5, [(2, "trunc.png"), (4, "text.png")])
    mm = None
    if use_memmap:
        mm = str(tmp_path / "mm")
        memmap.pack_memmap([r["file_path"] for r in ds.data], mm, size=SIZE, native_decode=False)
        assert len(memmap.MemmapImages(mm)) == 5
    kw = dict(batch_size=7, shuffle=False, num_workers=1, image_size=SIZE, native_decode=False, memmap_images=mm)
    mine, theirs = pipeline.Loader(ds, **kw), jpipeline.Loader(jds, **kw)
    assert_same_batches(mine, theirs)
    assert mine.corrupt_skipped == theirs.corrupt_skipped == 2
    (batch,) = list(mine)
    assert all(img.any() for img in batch["images"]) and not {2, 4} & set(batch["imgids"])


def test_corrupt_policy_raise_and_all_corrupt(tmp_path):
    ds, _ = _corrupt_dataset(tmp_path, 1, [(1, "text.png")])
    loader = pipeline.Loader(ds, batch_size=2, shuffle=False, num_workers=1, image_size=SIZE,
                             native_decode=False, on_corrupt="raise")
    with pytest.raises(RuntimeError, match="failed to decode"):
        list(loader)
    with pytest.raises(ValueError, match="on_corrupt"):
        pipeline.Loader(ds, batch_size=2, on_corrupt="ignore")
    bad, _ = _corrupt_dataset(tmp_path, 0, [(0, "text.png"), (1, "text.png")])
    with pytest.raises(RuntimeError, match="every image"):
        list(pipeline.Loader(bad, batch_size=2, shuffle=False, num_workers=1, image_size=SIZE, native_decode=False))


def test_native_decode_required_but_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(pipeline, "_native_available", lambda: False)
    ds = dataset.CocoCaptionDataset(_records(4), Vocabulary.from_words(WORDS), num_buckets=1)
    with pytest.raises(RuntimeError, match="native_decode=True"):
        pipeline.Loader(ds, batch_size=2, native_decode=True)
    with pytest.raises(RuntimeError, match="native_decode=True"):
        memmap.pack_memmap(["x.png"], str(tmp_path / "mm"), native_decode=True)
    # auto: PIL, probed at the first decode and not at construction
    assert pipeline.Loader(ds, batch_size=2)._use_native is None


def test_make_loader_picks_features_then_memmap(corpus):
    cfg = config.Config(batch_size=4, num_workers=1)
    ds = dataset.CocoCaptionDataset(corpus["records"], Vocabulary.load(corpus["vocab"]), "val", num_buckets=1)
    by_features = pipeline.make_loader(cfg.replace(features_path=corpus["npz"], memmap_dir=corpus["memmap"]), ds)
    assert by_features.features is not None and not by_features.load_images
    by_memmap = pipeline.make_loader(cfg.replace(memmap_dir=corpus["memmap"]), ds, mode="val")
    assert by_memmap.memmap_images is not None and not by_memmap.shuffle and not by_memmap.drop_remainder
    decoded = pipeline.make_loader(cfg.replace(memmap_dir=corpus["root"]), ds)  # no index there
    assert decoded.memmap_images is None and decoded.shuffle and decoded.drop_remainder


# --- memmap -----------------------------------------------------------------


def _png_paths(d, n, seed=7):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(d, f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (SIZE + 8, SIZE, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def test_pack_memmap_matches_jax(tmp_path):
    paths = _png_paths(str(tmp_path / "png"), 5)
    paths.insert(3, str(tmp_path / "missing.png"))
    mine = memmap.pack_memmap(paths + paths[:2], str(tmp_path / "a"), size=SIZE, items_per_shard=2,
                              native_decode=False)
    theirs = jmemmap.pack_memmap(paths + paths[:2], str(tmp_path / "b"), size=SIZE, items_per_shard=2,
                                 native_decode=False)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    names = json.load(open(mine))["shards"]
    assert names == ["shard_00000.u8", "shard_00001.u8", "shard_00002.u8"]
    for n in names:
        with open(tmp_path / "a" / n, "rb") as a, open(tmp_path / "b" / n, "rb") as b:
            assert a.read() == b.read()
    mm = memmap.MemmapImages(str(tmp_path / "a"))
    assert len(mm) == 5 and paths[3] not in mm
    np.testing.assert_array_equal(mm.get_batch(paths[4:6]), jmemmap.MemmapImages(str(tmp_path / "b")).get_batch(
        paths[4:6]))
    np.testing.assert_array_equal(mm.get(paths[0]), pipeline._load_image(paths[0], SIZE))


@pytest.mark.parametrize("damage", ["deleted", "truncated", "none"])
def test_pack_memmap_rebuilds_a_damaged_shard(tmp_path, damage):
    """The port reuses an index only when every shard it lists is whole;
    the JAX writer reuses it on the index alone (left as it is)."""
    paths = _png_paths(str(tmp_path / "png"), 5)
    out = str(tmp_path / "mm")
    index = memmap.pack_memmap(paths, out, size=SIZE, items_per_shard=2, native_decode=False)
    last = os.path.join(out, "shard_00002.u8")
    assert os.path.getsize(last) == SIZE * SIZE * 3  # the remainder: one row
    if damage == "deleted":
        os.remove(os.path.join(out, "shard_00001.u8"))
    elif damage == "truncated":
        with open(last, "r+b") as f:
            f.truncate(SIZE * SIZE * 3 - 1)
    before = os.path.getmtime(index)
    os.utime(index, (before - 10, before - 10))
    memmap.pack_memmap(paths, out, size=SIZE, items_per_shard=2, native_decode=False)
    rebuilt = os.path.getmtime(index) != before - 10
    assert rebuilt == (damage != "none")
    mm = memmap.MemmapImages(out)
    for p in paths:
        np.testing.assert_array_equal(mm.get(p), pipeline._load_image(p, SIZE))
    if damage != "none":  # the JAX writer trusts the index it finds
        with open(last, "r+b") as f:
            f.truncate(1)
        jmemmap.pack_memmap(paths, out, size=SIZE, items_per_shard=2, native_decode=False)
        assert os.path.getsize(last) == 1


def test_pack_memmap_cli_matches_jax(corpus, tmp_path):
    data_json = os.path.join(corpus["root"], "torch", "data.json")
    mine = pack_memmap.main(["--data_json", data_json, "--memmap_dir", str(tmp_path / "a"), "--num_workers", "1",
                             "--native_decode", "false"])
    theirs = jpack_cli.main(["--data_json", data_json, "--memmap_dir", str(tmp_path / "b"), "--num_workers", "1",
                             "--native_decode", "false"])
    with open(mine) as a, open(theirs) as b:
        assert json.load(a) == json.load(b)
    with pytest.raises(SystemExit):
        pack_memmap.main(["--data_json", data_json])


# --- preprocess ---------------------------------------------------------------


@pytest.mark.parametrize("resize", [False, True])
def test_preprocess_matches_jax_byte_for_byte(corpus, tmp_path, resize):
    args = (corpus["caption_json"], corpus["images_root"], resize)
    mine = run_preprocess("torch", str(tmp_path / "t"), *args)
    theirs = run_preprocess("jax", str(tmp_path / "j"), *args)
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            got, want = fa.read(), fb.read()
        # the records name their data root
        want = want.replace(str(tmp_path / "j").encode(), str(tmp_path / "t").encode())
        assert got == want
    records = json.load(open(mine[1]))
    assert len(records) == 2 * 18 and len(Vocabulary.load(mine[0])) == len(WORDS) + 4
    if resize:
        for r in records[:4]:
            with open(r["file_path"], "rb") as a, \
                    open(r["file_path"].replace(str(tmp_path / "t"), str(tmp_path / "j")), "rb") as b:
                assert a.read() == b.read()


def test_preprocess_cli_and_memmap(corpus, tmp_path):
    with pytest.raises(SystemExit):
        preprocess_cli.main([])
    vocab_path, data_json = run_preprocess("torch", str(tmp_path), corpus["caption_json"], corpus["images_root"],
                                           resize=True, memmap_dir=str(tmp_path / "mm"))
    records = json.load(open(data_json))
    mm = memmap.MemmapImages(str(tmp_path / "mm"))
    assert len(mm) == 18 and all(r["file_path"] in mm for r in records)
    vocab, imgs = preprocess.build_vocab(corpus["caption_json"], 100, show_stats=False)
    assert len(vocab) == 4 and len(imgs) == 18  # every word under the threshold


def test_import_vocab_matches_jax(tmp_path):
    from test_vocab import _reference_style_pickle

    pkl = _reference_style_pickle(tmp_path)
    assert import_vocab.main([pkl, str(tmp_path / "a.json")]) == 0
    assert jimport_vocab.main([pkl, str(tmp_path / "b.json")]) == 0
    assert open(tmp_path / "a.json").read() == open(tmp_path / "b.json").read()
    assert Vocabulary.load(str(tmp_path / "a.json"))("horse") == 6
