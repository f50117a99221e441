"""PyTorch port, the eval driver and the scoring CLI against the JAX
package's on the CPU.

Weights come from the JAX model's random init at the widths of
``tests/test_evalsuite.py`` and cross through
``ckpt.convert.from_jax_params``; the batches are that file's
``_val_loader`` (features [4, 4, 512], two batches). In fp32 the port's
``evaluation`` must give the JAX driver's predictions and language
statistics exactly and its validation loss within 1e-5 relative.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from test_evalsuite import V_WORDS, _ann_file, _val_loader
from show_and_tell_tpu.cli import score as jscore
from show_and_tell_tpu.config import Config as JConfig
from show_and_tell_tpu.evalsuite import driver as jdriver
from show_and_tell_tpu.metrics import spice as jspice
from show_and_tell_tpu.models.registry import build_model as jbuild
from show_and_tell_tpu.utils.vocab import END_ID
from show_and_tell_tpu.utils.vocab import Vocabulary as JVocabulary
from show_and_tell_tpu_torch.ckpt.checkpoint import trainable_state_dict
from show_and_tell_tpu_torch.ckpt.convert import from_jax_params
from show_and_tell_tpu_torch.cli import score
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.evalsuite import driver
from show_and_tell_tpu_torch.metrics import spice
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.train.step import make_train_state
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

SMALL = dict(embed_size=16, hidden_size=32, num_layers=1, crop_size=32, max_decode_len=5, beam_size=2)
LOSS_RTOL = 1e-5
# uint8 images run the VGG16 trunk, whose conv sums run in another order in
# the two frameworks (held at 1e-4 of the feature scale in
# test_torch_port_model.py); the loss moves by less than that
IMAGE_LOSS_RTOL = 1e-4


def _pair(seed=0, end_bias=0.0, **kw):
    """(JAX model, its trees, JAX config, port model on the CPU, port
    config). ``end_bias`` raises the <end> logit so that captions end
    before max_decode_len."""
    jcfg, cfg = JConfig(**SMALL, **kw), Config(**SMALL, **kw)
    V = len(JVocabulary.from_words(V_WORDS))
    jm = jbuild(jcfg, V)
    trainable, frozen = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(seed)))
    trainable["classifier"]["b"][END_ID] += end_bias
    tm = build_model(cfg, V, device="cpu")
    tm.load_state_dict(from_jax_params(trainable, frozen))
    return jm, trainable, frozen, jcfg, tm, cfg


def _both(jm, trainable, frozen, jcfg, tm, cfg, loader, mode, ann=None, **kw):
    want = jdriver.evaluation(jm, jcfg, trainable, None, frozen, loader, JVocabulary.from_words(V_WORDS),
                              mode=mode, ann_file=ann, **kw)
    got = driver.evaluation(tm, cfg, loader, Vocabulary.from_words(V_WORDS), mode=mode, ann_file=ann, **kw)
    return want, got


@pytest.mark.parametrize("end_bias", [0.0, 2.5])
@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_evaluation_matches_jax(tmp_path, mode, end_bias):
    pair = _pair(end_bias=end_bias)
    ann = _ann_file(tmp_path, ids=[100 + i for i in range(8)])
    (wl, wp, ws), (gl, gp, gs) = _both(*pair, _val_loader(), mode, ann)
    assert gl == pytest.approx(wl, rel=LOSS_RTOL, abs=0)
    assert gp == wp and len(gp) == 8
    assert gs == ws and {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"} <= set(gs)
    lengths = [len(p["caption"].split()) for p in gp]
    if end_bias:  # the <end> truncation was exercised
        assert min(lengths) < SMALL["max_decode_len"]


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_evaluation_of_uint8_images_matches_jax(mode):
    """Images [4, 40, 44, 3] take the centre crop to 32, the normalisation
    and the trunk ([4, 4, 512] features), in both packages."""
    loader = _val_loader()
    rng = np.random.default_rng(7)
    for b in loader:
        del b["features"]
        b["images"] = rng.integers(0, 256, (4, 40, 44, 3), dtype=np.uint8)
    (wl, wp, _), (gl, gp, gs) = _both(*_pair(end_bias=2.5), loader, mode, run_language_eval=False)
    assert gl == pytest.approx(wl, rel=IMAGE_LOSS_RTOL, abs=0)
    assert gp == wp and len(gp) == 8 and gs == {}


def test_evaluation_dedups_by_imgid_and_keys_by_cocoid():
    loader = _val_loader()
    loader[0]["imgids"] = [0, 0, 1, 1]
    loader[1]["imgids"] = [1, 2, 2, 3]
    (_, wp, _), (_, gp, _) = _both(*_pair(), loader, "greedy", run_language_eval=False)
    assert gp == wp
    # the first of each imgid survives, under its cocoid
    assert [p["image_id"] for p in gp] == [100, 102, 105, 107]


def test_language_eval_filters_to_the_annotation_ids(tmp_path, caplog):
    ann = _ann_file(tmp_path, ids=[100, 101])
    preds = [
        {"image_id": 100, "caption": "a man rides a horse"},
        {"image_id": 101, "caption": "a dog runs"},
        {"image_id": 999, "caption": "not in set"},
    ]
    with caplog.at_level(logging.INFO, logger=driver.log.name):
        got = driver.language_eval(preds, ann)
    assert got == jdriver.language_eval(preds, ann)
    assert "using 2/3 predictions" in caplog.text
    assert driver.language_eval(preds[2:], ann) == {} == jdriver.language_eval(preds[2:], ann)


def test_missing_ann_file_warns_once_per_process(monkeypatch, caplog):
    monkeypatch.setattr(driver, "_warned_no_ann", False)
    jm, trainable, frozen, jcfg, tm, cfg = _pair()
    vocab = Vocabulary.from_words(V_WORDS)
    with caplog.at_level(logging.WARNING, logger=driver.log.name):
        for _ in range(2):
            _, preds, stats = driver.evaluation(tm, cfg, _val_loader(n_batches=1), vocab, run_language_eval=True)
            assert stats == {} and len(preds) == 4
    warnings = [r for r in caplog.records if r.name == driver.log.name and r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "ann_file is unset" in warnings[0].getMessage()


def test_sample_mode_replays_under_one_seed():
    """JAX and torch draw different streams, so sample mode is held to
    replay: the same seed gives the same captions, batch by batch."""
    _, _, _, _, tm, cfg = _pair(end_bias=1.0)
    vocab = Vocabulary.from_words(V_WORDS)
    loader = _val_loader(n_batches=3)
    runs = [driver.evaluation(tm, cfg, loader, vocab, mode="sample", run_language_eval=False) for _ in range(2)]
    assert runs[0][1] == runs[1][1] and len(runs[0][1]) == 12
    assert runs[0][0] == runs[1][0]
    other = driver.evaluation(tm, cfg.replace(random_seed=cfg.random_seed + 1), loader, vocab, mode="sample",
                              run_language_eval=False)
    assert other[1] != runs[0][1]
    with pytest.raises(ValueError, match="sample"):
        driver.make_caption_fn(tm, cfg, "sample")(torch.zeros(1, 4, 512))


def test_trainer_eval_fn_evaluates_given_weights_and_restores_the_models(tmp_path):
    ann = _ann_file(tmp_path, ids=[100 + i for i in range(8)])
    _, _, _, _, tm, cfg = _pair(seed=0, ann_file=ann, ema_decay=0.9)
    _, _, _, _, other, _ = _pair(seed=1, end_bias=2.5, ann_file=ann)
    state = make_train_state(cfg, tm)
    with torch.no_grad():  # an EMA unlike the model's weights: the other model's
        for k, v in trainable_state_dict(other).items():
            state.ema_params[k].copy_(v)
    own = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    vocab = Vocabulary.from_words(V_WORDS)
    eval_fn = driver.make_trainer_eval_fn(tm, cfg, _val_loader(), vocab)

    got = eval_fn(state.ema_params)
    want = driver.evaluation(other, cfg, _val_loader(), vocab, ann_file=ann)
    assert got == want and "CIDEr" in got[2]
    for k, v in tm.state_dict().items():
        assert torch.equal(v, own[k]), k
    assert state.params["lstm.w"] is dict(tm.named_parameters())["lstm.w"]
    assert eval_fn(state.params) == eval_fn() == driver.evaluation(tm, cfg, _val_loader(), vocab, ann_file=ann)
    assert eval_fn()[1] != got[1]
    with pytest.raises(ValueError, match="names differ"):
        eval_fn({"lstm.w": state.ema_params["lstm.w"]})


def _score_files(tmp_path):
    ann = {
        "images": [{"id": 1}, {"id": 2}, {"id": 3}],
        "annotations": [
            {"image_id": 1, "id": 1, "caption": "a man riding a horse"},
            {"image_id": 1, "id": 2, "caption": "a person rides a horse"},
            {"image_id": 2, "id": 3, "caption": "two dogs playing in a park"},
            {"image_id": 2, "id": 4, "caption": "dogs play on the grass"},
            {"image_id": 3, "id": 5, "caption": "a red bus on a city street"},
        ],
    }
    ann_p = tmp_path / "ann.json"
    ann_p.write_text(json.dumps(ann))
    res_p = tmp_path / "res.json"
    res_p.write_text(json.dumps([
        {"image_id": 1, "caption": "a man riding a horse"},
        {"image_id": 2, "caption": "two dogs running on grass"},
        {"image_id": 3, "caption": "a bus"},
        {"image_id": 99, "caption": "unmatched"},
    ]))
    return ann_p, res_p


@pytest.mark.parametrize("spice_cache", [False, True])
def test_score_cli_matches_jax(tmp_path, monkeypatch, capsys, spice_cache):
    monkeypatch.chdir(tmp_path)  # the CLIs write score_log.txt to the working directory
    for mod in (jspice, spice):  # --spice_cache installs a backend for the process
        monkeypatch.setattr(mod, "_BACKEND", mod._BACKEND)
        monkeypatch.setattr(mod, "_DEFAULT_INSTALLED", mod._DEFAULT_INSTALLED)
    ann_p, res_p = _score_files(tmp_path)
    lines, per_image = [], []
    for name, main in (("jax", jscore.main), ("port", score.main)):
        per_p = tmp_path / f"per_{name}.json"
        argv = ["--ann_file", str(ann_p), "--res_file", str(res_p), "--per_image_out", str(per_p)]
        if spice_cache:
            argv += ["--spice_cache", str(tmp_path / f"spice_{name}.json")]
        assert main(argv) == 0
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
        per_image.append(per_p.read_text())
    assert lines[1] == lines[0] and json.loads(lines[1])["n_scored"] == 3
    assert per_image[1] == per_image[0]
    if spice_cache:
        assert (tmp_path / "spice_port.json").read_text() == (tmp_path / "spice_jax.json").read_text()
    res_p.write_text(json.dumps([{"image_id": 7, "caption": "x"}]))
    for main in (jscore.main, score.main):
        assert main(["--ann_file", str(ann_p), "--res_file", str(res_p)]) == 1
    assert "no prediction matches" in capsys.readouterr().err
