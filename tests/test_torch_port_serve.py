"""PyTorch port, serving front door against the JAX package on the CPU.

The port's ``Captioner`` and the JAX ``Captioner`` serve the same weights
(crossed through ``ckpt.convert.from_jax_params``) and must return the same
caption strings, n-best lists, attention maps and error slots. The port's
entry points default to the GPU and never fall back to the CPU on their own.
The small modules that serving uses (vocabulary, RNG streams, attention
sheets) are held against their JAX counterparts too.
"""

import dataclasses
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

from show_and_tell_tpu.config import Config as JConfig
from show_and_tell_tpu.models.registry import build_model as jbuild
from show_and_tell_tpu.serve import Captioner as JCaptioner
from show_and_tell_tpu.utils import vocab as jvocab
from show_and_tell_tpu_torch.ckpt.convert import from_jax_params
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.serve import Captioner
from show_and_tell_tpu_torch.utils import vocab as tvocab

SMALL = dict(embed_size=16, hidden_size=24, crop_size=32, max_decode_len=8, beam_size=3)
WORDS = [f"w{i}" for i in range(46)]  # 50 ids with the four special tokens


@pytest.fixture(scope="module")
def captioners():
    """The JAX and the port Captioner over the same random weights."""
    jcfg, cfg = JConfig(**SMALL), Config(**SMALL)
    jm = jbuild(jcfg, len(WORDS) + 4)
    trainable, frozen = jm.init(jax.random.PRNGKey(3))
    trainable = jax.tree.map(np.asarray, trainable)
    frozen = jax.tree.map(np.asarray, frozen)
    jcap = JCaptioner(
        jcfg, jm, trainable, frozen, jvocab.Vocabulary.from_words(WORDS), bucket_sizes=(1, 2, 4)
    )
    tm = build_model(cfg, len(WORDS) + 4, device="cpu")
    tcap = Captioner(
        cfg, tm, from_jax_params(trainable, frozen), tvocab.Vocabulary.from_words(WORDS),
        device="cpu", bucket_sizes=(1, 2, 4),
    )
    return jcap, tcap


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_captioner_matches_jax_captioner(captioners, mode):
    """3 images under buckets (1, 2, 4): one chunk padded from 3 to 4 and
    sliced back to the live rows."""
    jcap, tcap = captioners
    images = np.random.default_rng(7).integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    want = jcap.caption_images(images, mode=mode)
    got = tcap.caption_images(images, mode=mode)
    assert len(got) == 3
    assert got == want
    assert any(got), "random weights should still emit some words"


def test_captioner_chunks_over_buckets(captioners):
    """7 images: chunks of 4, 2 and 1, each captioned as if alone."""
    _, tcap = captioners
    images = np.random.default_rng(8).integers(0, 256, (7, 40, 40, 3), dtype=np.uint8)
    got = tcap.caption_images(images, mode="greedy")
    alone = [tcap.caption_images(images[i : i + 1], mode="greedy")[0] for i in range(7)]
    assert got == alone


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, 50)
    tm = build_model(cfg, 50, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Captioner(cfg, tm, None, tvocab.Vocabulary.from_words(WORDS))


def test_show_tell_builds_as_the_jax_model():
    """``build_model`` gives Show-and-Tell: ResNet-152
    for the default encoder as in JAX, and its trainable names are the JAX
    tree's paths (the parity tests are in test_torch_port_show_tell.py)."""
    from show_and_tell_tpu_torch.ckpt import trainable_state_dict
    from show_and_tell_tpu_torch.ckpt.convert import from_jax_trainable

    m = build_model(Config(**SMALL, model="show_tell"), 50, device="cpu")
    jm = jbuild(JConfig(**SMALL, model="show_tell"), 50)
    trainable, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), trainable)
    want = from_jax_trainable(zeros)
    got = trainable_state_dict(m)
    assert type(m).__name__ == "ShowTell" and m.encoder_name == jm.encoder_name == "resnet152"
    assert set(got) == set(want) and all(got[k].shape == want[k].shape for k in want)


def test_config_matches_jax_config():
    want = {f.name: f.default for f in dataclasses.fields(JConfig)}
    got = {f.name: f.default for f in dataclasses.fields(Config)}
    assert got == want


def test_vocab_files_interchange_with_jax(tmp_path):
    words = ["a", "man", "rides", "a", "horse"]
    tv, jv = tvocab.Vocabulary.from_words(words), jvocab.Vocabulary.from_words(words)
    assert (tvocab.PAD_ID, tvocab.START_ID, tvocab.END_ID, tvocab.UNK_ID) == (
        jvocab.PAD_ID, jvocab.START_ID, jvocab.END_ID, jvocab.UNK_ID,
    )
    tv.save(str(tmp_path / "t.json"))
    jv.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    back = tvocab.Vocabulary.load(str(tmp_path / "j.json"))
    ids = np.array([[1, 4, 5, 6, 2, 7], [4, 0, 3, 9, 2, 0]])
    assert back.decode_batch(ids) == jv.decode_batch(ids)
    assert back("zebra") == jv("zebra") == jvocab.UNK_ID


def test_caption_nbest_matches_jax(captioners):
    """Every beam of every image: captions identical, scores within 1e-5,
    best first; the first is the beam caption."""
    jcap, tcap = captioners
    images = np.random.default_rng(9).integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    want = jcap.caption_nbest(images)
    got = tcap.caption_nbest(images)
    assert [[c for c, _ in row] for row in got] == [[c for c, _ in row] for row in want]
    np.testing.assert_allclose([[s for _, s in row] for row in got], [[s for _, s in row] for row in want],
                               atol=1e-5, rtol=0)
    assert all(len(row) == SMALL["beam_size"] for row in got)
    assert all(row[0][1] >= row[-1][1] for row in got)
    assert [row[0][0] for row in got] == tcap.caption_images(images, mode="beam")


def test_caption_with_attention_matches_jax(captioners):
    jcap, tcap = captioners
    images = np.random.default_rng(10).integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    want_caps, want = jcap.caption_with_attention(images)
    got_caps, got = tcap.caption_with_attention(images)
    assert got_caps == want_caps == tcap.caption_images(images, mode="greedy")
    assert got.dtype == np.float32 and got.shape == want.shape == (3, SMALL["max_decode_len"], 4)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    empty_caps, empty = tcap.caption_with_attention(images[:0])
    jempty_caps, jempty = jcap.caption_with_attention(images[:0])
    assert empty_caps == jempty_caps == [] and empty.shape == jempty.shape and empty.dtype == jempty.dtype


def test_caption_with_attention_needs_attention(captioners):
    _, tcap = captioners
    model = tcap.model
    no_attention = Captioner(Config(**SMALL), model, None, tvocab.Vocabulary.from_words(WORDS), device="cpu")
    no_attention.model = object()
    with pytest.raises(ValueError, match="no attention maps"):
        no_attention.caption_with_attention(np.zeros((1, 40, 40, 3), np.uint8))


def test_caption_paths_errors_match_jax(captioners, tmp_path):
    """A zero-byte file and a truncated PNG caption as ERROR_CAPTION at the
    same indices as the JAX package's, with the same last_errors; the good
    files caption as caption_images does."""
    from PIL import Image

    from show_and_tell_tpu import serve as jserve
    from show_and_tell_tpu_torch import serve

    jcap, tcap = captioners
    rng = np.random.default_rng(11)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"ok{i}.png"))
        Image.fromarray(rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)).save(paths[-1])
    (tmp_path / "empty.png").write_bytes(b"")
    good = (tmp_path / "ok0.png").read_bytes()
    (tmp_path / "cut.png").write_bytes(good[: len(good) // 2])
    paths[1:1] = [str(tmp_path / "empty.png")]
    paths.append(str(tmp_path / "cut.png"))
    want = jcap.caption_paths(paths, mode="greedy")
    got = tcap.caption_paths(paths, mode="greedy")
    assert serve.ERROR_CAPTION == jserve.ERROR_CAPTION
    assert got == want
    assert [i for i, c in enumerate(got) if c == serve.ERROR_CAPTION] == [1, 5]
    assert tcap.last_errors == jcap.last_errors == [(1, paths[1]), (5, paths[5])]
    tcap.caption_paths(paths[:1], mode="greedy")
    assert tcap.last_errors == []


def test_load_image_matches_jax(tmp_path):
    from PIL import Image

    from show_and_tell_tpu.data.pipeline import _load_image_checked as jload
    from show_and_tell_tpu_torch.data.pipeline import _load_image_checked

    path = str(tmp_path / "a.jpg")
    Image.fromarray(np.random.default_rng(12).integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(path)
    for src in (path, open(path, "rb").read(), b"not an image"):
        (got, ok), (want, jok) = _load_image_checked(src), jload(src)
        assert ok == jok and got.dtype == np.uint8 and got.shape == (256, 256, 3)
        np.testing.assert_array_equal(got, want)


def test_entry_points_hold_one_reentrant_lock(captioners):
    """More threads than cores caption at once, with a short switch
    interval: each greedy call gets what it gets alone, and the sampling
    counter loses no update (it ends at the images sampled, and the calls'
    streams are disjoint: each sample call replays one of the counter
    offsets a serial run visits)."""
    import os
    import sys

    _, tcap = captioners
    assert tcap._lock.acquire(blocking=False)  # re-entrant: caption_paths nests it
    tcap._lock.release()
    rng = np.random.default_rng(13)
    n = (os.cpu_count() or 4) + 4
    batches = [rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8) for _ in range(n)]
    alone = [tcap.caption_images(b, mode="greedy") for b in batches]
    start = tcap._sample_count
    serial = [tcap.caption_images(batches[0], mode="sample") for _ in range(n)]
    tcap._sample_count = start
    got, sampled = [None] * n, [None] * n

    def run(i):
        got[i] = tcap.caption_images(batches[i], mode="greedy")
        sampled[i] = tcap.caption_images(batches[0], mode="sample")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == alone
    assert tcap._sample_count == start + 2 * n
    assert sorted(map(tuple, sampled)) == sorted(map(tuple, serial))


class _ReferenceVocabulary:
    """Stands in for the reference's pickled class; neither loader may import
    it."""


def _write_reference_pickle(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=2)
    return str(path)


def test_vocab_encode_and_reference_pickle_match_jax(tmp_path):
    words = ["a", "man", "rides", "a", "horse"]
    tv, jv = tvocab.Vocabulary.from_words(words), jvocab.Vocabulary.from_words(words)
    for toks, n in ((["a", "man", "zebra"], 8), (["a", "man", "rides", "a", "horse"], 4), ([], 3)):
        np.testing.assert_array_equal(tv.encode(toks, n), jv.encode(toks, n))
        assert tv.encode(toks, n).dtype == np.int32
    batch = [["a", "horse"], ["man"] * 9, []]
    for got, want in zip(tv.encode_batch(batch, 6), jv.encode_batch(batch, 6)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert tvocab.Vocabulary.with_special_tokens().word2idx == jvocab.Vocabulary.with_special_tokens().word2idx

    ref = _ReferenceVocabulary()
    ref.word2idx = dict(jv.word2idx)
    ref.idx2word = dict(jv.idx2word)
    ref.idx = jv.idx
    bag = _write_reference_pickle(tmp_path / "vocab.pkl", ref)
    bare = _write_reference_pickle(tmp_path / "bare.pkl", dict(jv.word2idx))
    for path in (bag, bare):
        got, want = tvocab.Vocabulary.from_reference_pickle(path), jvocab.Vocabulary.from_reference_pickle(path)
        assert got.word2idx == want.word2idx == jv.word2idx and got.idx == want.idx
    shuffled = _write_reference_pickle(tmp_path / "bad.pkl", {"a": 0, "<pad>": 1, "<start>": 2, "<end>": 3,
                                                              "<unk>": 4})
    for loader in (tvocab.Vocabulary.from_reference_pickle, jvocab.Vocabulary.from_reference_pickle):
        with pytest.raises(ValueError, match="special token"):
            loader(shuffled)


def test_keychain_numpy_streams_match_jax():
    from show_and_tell_tpu.utils.rng import KeyChain as JKeyChain
    from show_and_tell_tpu_torch.utils.rng import KeyChain

    for tags in ((), ("shuffle",), ("shuffle", 3), (7, "data", 12)):
        got = KeyChain(123).numpy_rng(*tags).integers(0, 1 << 30, 16)
        want = JKeyChain(123).numpy_rng(*tags).integers(0, 1 << 30, 16)
        np.testing.assert_array_equal(got, want)
    a = torch.rand(8, generator=KeyChain(123).generator("sample", 4))
    assert torch.equal(a, torch.rand(8, generator=KeyChain(123).generator("sample", 4)))
    assert not torch.equal(a, torch.rand(8, generator=KeyChain(123).generator("sample", 5)))


def test_attention_sheets_match_jax(tmp_path):
    from show_and_tell_tpu.utils import visualize as jvis
    from show_and_tell_tpu_torch.utils import visualize

    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (1, 40, 36, 3), dtype=np.uint8)
    alphas = rng.random((1, 4, 16)).astype(np.float32)
    words = ["a", "dog", "runs"]
    np.testing.assert_array_equal(visualize.model_view(img[0], 32), jvis.model_view(img[0], 32))
    np.testing.assert_array_equal(visualize.attention_overlay(img[0], alphas[0, 1]),
                                  jvis.attention_overlay(img[0], alphas[0, 1]))
    np.testing.assert_array_equal(np.asarray(visualize.attention_sheet(img[0], alphas[0], words)),
                                  np.asarray(jvis.attention_sheet(img[0], alphas[0], words)))
    tv, jv = tvocab.Vocabulary.from_words(words), jvocab.Vocabulary.from_words(words)
    ids = np.array([[4, 5, 2, 6]])
    out = [str(tmp_path / "t.png")]
    assert visualize.save_attention_sheets(img, ids, alphas, tv, out) == out
    jvis.save_attention_sheets(img, ids, alphas, jv, [str(tmp_path / "j.png")])
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
