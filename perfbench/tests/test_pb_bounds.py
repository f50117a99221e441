"""The yardstick's arithmetic against hand counts."""

from types import SimpleNamespace

import pytest
import torch

from harness import bounds


@pytest.mark.parametrize("B,I,H", [(768, 1024, 1024), (8, 512, 1024)])
def test_cell_bound_by_hand(B, I, H):
    flops = 2 * B * (I + H) * 4 * H
    nbytes = 2 * (B * I + B * H + (I + H) * 4 * H) + 4 * 4 * H + 4 * B * H + 2 * B * H + 4 * B * H
    want = max(flops / 989e12, nbytes / 3.35e12) * 1e3
    assert bounds.cell_bound(B, I, H, torch.bfloat16) == pytest.approx(want, rel=1e-12)


def test_cell_bound_fp32_counts_three_tf32_products():
    B, I, H = 768, 1024, 1024
    assert bounds.cell_bound(B, I, H, torch.float32) == pytest.approx(3 * 2 * B * (I + H) * 4 * H / 495e12 * 1e3)


@pytest.mark.parametrize("B,K,L,D", [(256, 3, 196, 512), (1, 3, 196, 512)])
def test_attention_bound_by_hand(B, K, L, D):
    ops = 5 * B * K * L * D
    sfu = B * K * L * D + B * K * L
    nbytes = 2 * (2 * B * L * D + B * K * D + D) + 2 * B * K * D + 4 * B * K * L
    want = max(ops / 67e12, sfu / (16 * 132 * 1.98e9), nbytes / 3.35e12) * 1e3
    assert bounds.attention_bound(B, K, L, D, torch.bfloat16) == pytest.approx(want, rel=1e-12)


def test_trunk_flops_published_counts():
    # VGG16 to conv5_2 at 224 px: 12 convs, 14.88 G multiply-adds
    assert bounds.vgg16_conv5_2_flops(224) == pytest.approx(2 * 14.88e9, rel=2e-3)
    # ResNet-152 at 224 px: 11.5 G multiply-adds (He et al. 2016, table 1),
    # 11.51 in torchvision's count
    assert bounds.resnet152_flops(224) == pytest.approx(2 * 11.51e9, rel=1e-2)


def test_step_flops_by_hand():
    cfg = SimpleNamespace(model="show_attend_tell", crop_size=224, embed_size=512, hidden_size=1024, num_layers=1)
    L, D, E, H, V = 196, 512, 512, 1024, 10000
    want = 2 * H * D + 5 * L * D + 2 * (E + D + H) * 4 * H + 2 * D * E + 2 * H * E + 2 * E * V
    assert bounds.step_flops(cfg, V) == want
    st = SimpleNamespace(model="show_tell", crop_size=224, embed_size=512, hidden_size=1024, num_layers=2)
    assert bounds.step_flops(st, V) == 2 * (E + H) * 4 * H + 2 * (H + H) * 4 * H + 2 * H * V
