"""The plain reference against the program's plain path, in float32 on the
CPU at a tiny width: the same weights and images give the same features,
the same beams and the same training steps."""

import numpy as np
import pytest
import torch

from harness import cell as cell_lib, plugins, traffic
from reference import models as ref
from reference import train as ref_train

TINY = {"embed_size": 16, "hidden_size": 24, "crop_size": 32, "max_decode_len": 8, "dtype": "float32"}
V = 40


def port(name, **kw):
    c = cell_lib.Cell.find(name, {"model": dict(TINY, **kw), "vocab_size": V})
    model, w = cell_lib.build_model(c, 2**32 + 3, "cpu")
    return c.port_config(), model, w


@pytest.mark.parametrize("name", ["sat_vgg16_bf16.bulk_beam3", "st_resnet152_bf16.bulk_beam3"])
def test_features_and_beams_match_the_program(name):
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.decode.dispatch import decode_ids

    cfg, model, w = port(name)
    images = traffic.images(5, 40, 40, 9, "cpu")
    net = plugins.reference(cfg, w, {})
    with torch.no_grad():
        got = model.backbone_features(eval_transform(images, cfg.crop_size))
        want = ref.features_of(net, images, cfg.crop_size)
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))
        ids = decode_ids(model, cfg, got, "beam")
        all_ids, scores, parents, words = ref.beam_search(net, want, cfg.beam_size, cfg.max_decode_len)
        assert torch.equal(ids, all_ids[:, 0])
        # the reference's own choices replay to its beams, each step its k best
        gap, replayed, replay_scores = ref.replay(net, want, parents, words)
        assert torch.equal(replayed, all_ids) and torch.allclose(replay_scores, scores, atol=1e-5)
        assert float(gap.max()) <= 0.0


@pytest.mark.parametrize("name", ["sat_vgg16_bf16.bulk_beam3", "st_resnet152_bf16.bulk_beam3"])
def test_the_programs_recorded_search_replays_to_its_beams(name):
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.decode.dispatch import decode_ids

    from harness import served

    cfg, model, w = port(name)
    images = traffic.images(5, 40, 40, 9, "cpu")
    net = plugins.reference(cfg, w, {})
    rec = served.BeamRecorder()
    with torch.no_grad(), rec.recording():
        ids = decode_ids(model, cfg, model.backbone_features(eval_transform(images, cfg.crop_size)), "beam")
    records = [rec.record(0, r) for r in range(5)]
    assert all(r[0] is not None for r in records)
    par, tok = (torch.from_numpy(np.stack([r[0][i] for r in records])) for i in (0, 1))
    gap, replayed, scores = ref.replay(net, ref.features_of(net, images, cfg.crop_size), par, tok)
    assert torch.equal(replayed[:, 0], ids) and torch.equal(replayed, torch.from_numpy(np.stack([r[1] for r in records])))
    assert torch.allclose(scores, torch.from_numpy(np.stack([r[2] for r in records])), atol=1e-4)
    assert float(gap.max()) <= 1e-4


def test_training_steps_match_the_program():
    from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step

    cfg, model, w = port("sat_vgg16_bf16.train_b128")
    state, step = make_train_state(cfg, model), make_train_step(model, cfg)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        caps = torch.from_numpy(rng.integers(4, V, (4, 7)))
        caps[:, 0] = 1
        lengths = torch.tensor([7, 6, 5, 7])
        for i, L in enumerate(lengths.tolist()):
            caps[i, L - 1] = 2
            caps[i, L:] = 0
        batches.append((traffic.images(4, 40, 40, int(rng.integers(1000)), "cpu"), caps, lengths))
    g = torch.Generator().manual_seed(11)
    losses = []
    for n, (im, c, ln) in enumerate(batches):
        state, m = step(state, {"images": im, "captions": c, "lengths": ln}, cfg.learning_rate, generator=g)
        losses.append(float(m["loss"]))
        if n == 0:
            first = {k: v.clone() / 0.1 for k, v in state.opt_state["mu"].items()}
    g = torch.Generator().manual_seed(11)
    r_losses, r_first, r_after = ref_train.train(lambda p, q: plugins.reference(cfg, p, {}, q), w, batches, g,
                                                 cfg.crop_size, cfg.learning_rate, cfg.grad_clip)
    assert np.allclose(losses, r_losses, rtol=1e-5)
    assert set(r_first) == set(first)
    for k in r_first:
        assert torch.allclose(first[k], r_first[k], rtol=1e-3, atol=1e-6), k
        # Adam moves an element by about lr whatever its gradient's size, so
        # where a gradient is round-off the direction is too: compare the
        # change of each tensor by its norm, as the benchmark's check does
        got, want = float((state.params[k] - w[k]).norm()), float((r_after[k] - w[k]).norm())
        assert abs(got - want) <= 2e-2 * want, k
