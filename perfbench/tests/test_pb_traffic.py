"""The traffic generator: the same seed gives the same inputs, and the
statistics are the ones the mixes state."""

import numpy as np
import torch

from harness import traffic, weights


def test_images_depend_on_the_seed_alone():
    a = traffic.images(3, 48, 64, 2**31 + 7, "cpu", block=2)
    b = traffic.images(3, 48, 64, 2**31 + 7, "cpu", block=2)
    c = traffic.images(3, 48, 64, 2**31 + 8, "cpu", block=2)
    assert a.dtype == torch.uint8 and a.shape == (3, 48, 64, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_weights_depend_on_the_seed_alone():
    shapes = {"lstm.w": (8, 16), "lstm.b": (16,), "encoder.convs.0.w": (4, 3, 3, 3), "bn.var": (4,)}
    a, b = weights.make(shapes, 5, "cpu"), weights.make(shapes, 5, "cpu")
    c = weights.make(shapes, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["lstm.w"], c["lstm.w"])
    assert float(a["bn.var"].min()) >= 0.5  # variances stay positive
    assert float(a["lstm.w"].abs().max()) <= 1 / np.sqrt(8)


def test_caption_lengths_follow_coco():
    mix = traffic.load("train_b128")
    n = 20000
    L = traffic.caption_lengths(n, mix["log_words_mu"], mix["log_words_sigma"], mix["min_words"],
                                mix["max_words"], 3)
    assert np.array_equal(L, traffic.caption_lengths(n, mix["log_words_mu"], mix["log_words_sigma"],
                                                     mix["min_words"], mix["max_words"], 3))
    assert 10.0 < L.mean() < 11.0  # COCO: about 10.5 words
    assert ((L >= 8) & (L <= 15)).mean() > 0.8  # most between 8 and 15
    assert L.max() > 16 and L.min() >= mix["min_words"] and L.max() <= mix["max_words"]
    caps, enc = traffic.captions(L[:50], 100, 3)
    assert np.all(caps[:, 0] == 1) and np.all(enc == L[:50] + 2)
    assert all(caps[i, L[i] + 1] == 2 and np.all(caps[i, 1 : L[i] + 1] >= 4) for i in range(50))
