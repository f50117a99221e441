"""A run with its timed path broken underneath comes out not correct.

Each case skips the look for a card and drives the rest of a run on the CPU
at a tiny width, with one fault planted in the program: a token altered
where the decode produces it, or a decode that searches one beam of the
configuration's three (serving cells), a step that leaves the state
as it was, and a step that takes the mean over half of the batch (the
training cell). One sound run of each kind shows the same drive passes."""

import pytest

import run as bench
from harness import faults

M = {"embed_size": 16, "hidden_size": 24, "crop_size": 32, "max_decode_len": 8}
# the configurations' output gains are set for their full widths
W = {"head_gain": 25.0}
TINY = {
    "bulk_beam3": {"model": M, "vocab_size": 40, "weights": W, "mix": {"images_per_call": 8, "image_px": 40, "check_sample": 6}},
    "train_b128": {"model": dict(M, batch_size=4, max_caption_len=12), "vocab_size": 40, "weights": W,
                   "mix": {"pool_images": 16, "image_px": 40, "max_words": 10, "log_words_mu": 1.6}},
}
SERVING = ["sat_vgg16_bf16.bulk_beam3", "st_resnet152_bf16.bulk_beam3"]
TRAINING = ["sat_vgg16_bf16.train_b128"]


def drive(name):
    overrides = dict(TINY[name.split(".")[1]])
    if name.startswith("st_"):  # a smaller hidden state: a larger gain to the same spread of logits
        overrides["weights"] = {"head_gain": 150.0}
    return bench.run_cell(name, 2**31 + 99, 0.5, False, device="cpu", overrides=overrides)


@pytest.mark.parametrize("name", SERVING + TRAINING)
def test_a_sound_run_is_correct(name):
    res = drive(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["failed"] == 0


@pytest.mark.parametrize("fault", ["altered_token", "beam_width_1"])
@pytest.mark.parametrize("name", SERVING)
def test_a_broken_decode_fails(name, fault):
    with faults.FAULTS[fault](40):
        res = drive(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", TRAINING)
def test_a_broken_step_fails(name, fault):
    with faults.FAULTS[fault]():
        res = drive(name)
    assert not res["correct"], res["checks"]
