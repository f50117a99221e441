"""The control: the reference put in the program's place and computed one
precision below bf16 (fp8 operands and results, ``reference/lowp.py``)
reads at least three times what the program reads, on the number that
catches it, here at a size a test run holds (on the chip it is read at the
cells' size by ``perfbench/control.py``, and the cells' limits sit between
the two readings)."""

import pytest

import control
from harness import cell as cell_lib
from reference import lowp

M = {"embed_size": 64, "hidden_size": 96, "crop_size": 64, "max_decode_len": 12}
SMALL = {
    "bulk_beam3": {"model": M, "vocab_size": 400, "weights": {"head_gain": 40.0},
                   "mix": {"images_per_call": 16, "image_px": 72, "check_sample": 12}},
    "train_b128": {"model": dict(M, batch_size=8, max_caption_len=14), "vocab_size": 400,
                   "weights": {"head_gain": 40.0},
                   "mix": {"pool_images": 24, "image_px": 72, "max_words": 12, "log_words_mu": 2.0}},
}


@pytest.mark.parametrize("name,number", [("sat_vgg16_bf16.bulk_beam3", "score_err_nats"),
                                         ("sat_vgg16_bf16.bulk_beam3", "topk_gap_nats"),
                                         ("sat_vgg16_bf16.train_b128", "loss1_rel")])
def test_the_control_reads_three_times_the_program(name, number):
    assert number in cell_lib.Cell.find(name).limits
    readings = [control.readings(name, seed, 0.0, device="cpu", overrides=SMALL[name.split(".")[1]])
                for seed in (1, 2, 3)]
    program = max(r["program"][number] for r in readings)
    assert min(r["control"][number] for r in readings) >= 3 * program, readings


def test_fp8_rounds_to_three_mantissa_bits():
    import torch

    x = torch.tensor([1.0, 1.1, 1.2, 448.0, -3.3])
    y = lowp.fp8(x)
    assert torch.equal(y[[0, 3]], x[[0, 3]]) and float((y - x).abs().max() / x.abs().max()) < 2 ** -4
