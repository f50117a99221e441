"""PyTorch port, serving front door against the JAX package on the CPU.

The port's ``Captioner`` and the JAX ``Captioner`` serve the same weights
(crossed through ``ckpt.convert.from_jax_params``) and must return the same
caption strings. The port's entry points default to the GPU and never fall
back to the CPU on their own.
"""

import dataclasses

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


def test_show_tell_and_sample_not_ported_yet():
    from show_and_tell_tpu_torch.decode.dispatch import decode_ids

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(Config(**SMALL, model="show_tell"), 50, device="cpu")
    tm = build_model(Config(**SMALL), 50, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_ids(tm, Config(**SMALL), torch.zeros(1, 4, 512), "sample")


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
