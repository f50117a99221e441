"""The yardstick's arithmetic against hand counts."""

from types import SimpleNamespace

import pytest
import torch

from harness import bounds, plugins


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


def _cfg(**kw):
    base = dict(model="show_attend_tell", encoder="vgg16", crop_size=224, embed_size=512, hidden_size=1024,
                num_layers=1)
    return SimpleNamespace(**{**base, **kw})


SAT, ST = _cfg(), _cfg(model="show_tell", encoder="resnet152")
E, H, V, L, D = 512, 1024, 10000, 196, 512


def test_trunk_flops_published_counts():
    # VGG16 to conv5_2 at 224 px: 12 convs, 14.88 G multiply-adds
    assert plugins.encoder("vgg16").flops(SAT) == pytest.approx(2 * 14.88e9, rel=2e-3)
    # ResNet-152 at 224 px: 11.5 G multiply-adds (He et al. 2016, table 1),
    # 11.51 in torchvision's count
    assert plugins.encoder("resnet152").flops(ST) == pytest.approx(2 * 11.51e9, rel=1e-2)


# Each figure as the yardstick gave it before the plug-ins held it, to the
# FLOP, and the decoder's step by hand
FIGURES = [
    ("encoder", "vgg16", "flops", SAT, 29_768_417_280),
    ("encoder", "resnet152", "flops", ST, 23_023_157_248),
    ("model", "show_attend_tell", "image_flops", SAT, 104_857_600),
    ("model", "show_tell", "image_flops", ST, 2_097_152),
    ("model", "show_attend_tell", "step_flops", SAT, 30_140_416),
    ("model", "show_tell", "step_flops", ST, 33_062_912),
    ("model", "show_attend_tell", "step_flops", SAT,
     2 * H * D + 5 * L * D + 2 * (E + D + H) * 4 * H + 2 * D * E + 2 * H * E + 2 * E * V),
    ("model", "show_tell", "step_flops", _cfg(model="show_tell", num_layers=2),
     2 * (E + H) * 4 * H + 2 * (H + H) * 4 * H + 2 * H * V),
]


@pytest.mark.parametrize("kind,name,fn,cfg,want", FIGURES,
                         ids=[f"{n}.{f}.{c.num_layers}" for _, n, f, c, _ in FIGURES])
def test_flops_figures(kind, name, fn, cfg, want):
    plugin = getattr(plugins, kind)(name)
    got = plugin.flops(cfg) if kind == "encoder" else getattr(plugin, fn)(cfg, V)
    assert got == want


@pytest.mark.parametrize("cfg,trunk,image,step", [(SAT, 29_768_417_280, 104_857_600, 30_140_416),
                                                  (ST, 23_023_157_248, 2_097_152, 33_062_912)],
                         ids=["show_attend_tell", "show_tell"])
def test_window_flops_compose_as_before(cfg, trunk, image, step):
    """``model_flops`` of a window's counters, as ``bulk.Driver.traced``
    computed it inline before: images x (trunk + image) + cell rows x step
    / layers."""
    counters = {"trunk_images": 4096.0, "decode_row_cells": 245760.0}
    want = counters["trunk_images"] * (trunk + image) + counters["decode_row_cells"] * step / cfg.num_layers
    assert plugins.model_flops(cfg, V, counters, {}) == want


@pytest.mark.parametrize("cfg,trunk,image,step", [(SAT, 29_768_417_280, 104_857_600, 30_140_416),
                                                  (ST, 23_023_157_248, 2_097_152, 33_062_912)],
                         ids=["show_attend_tell", "show_tell"])
def test_the_figures_through_the_plugin_interface_with_no_arch(cfg, trunk, image, step):
    """The six figures, each read through the plug-ins' own entry points as
    the harness calls them, with the empty ``arch`` of a model whose sizes
    are all ``Config`` fields: one image, one decoder step of one row, and
    (Show-Attend-Tell) one training step of one two-word caption."""
    net = plugins.model(cfg.model)
    one_image = {"trunk_images": 1.0, "decode_row_cells": 0.0}
    one_step = {"trunk_images": 0.0, "decode_row_cells": float(cfg.num_layers)}
    assert plugins.encoder(cfg.encoder).flops(cfg) == trunk
    assert net.model_flops(cfg, V, one_image, trunk, {}) == plugins.model_flops(cfg, V, one_image, {}) == trunk + image
    assert net.model_flops(cfg, V, one_step, trunk, {}) == step
    if hasattr(net, "train_step_flops"):
        assert net.train_step_flops(cfg, V, 1, 2, trunk, {}) == trunk + 3 * image + 3 * step
