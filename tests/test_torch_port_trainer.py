"""PyTorch port, the trainer, the training CLIs and their helpers against the
JAX package's on the CPU.

Both trainers start from one ``model-best.msgpack`` that the JAX side
writes (``--load_pretrained true --load_model_path``), at E=16, H=32, crop
32, in fp32, fed by loaders over one ``.npz`` of features, so no random
crop is involved; dropout is 0 and scheduled sampling off. Each step's loss
is held within 1e-5 relative, the final params within 1e-4 absolute, and
the bookkeeping (iterations, epochs, histories, the best checkpoint's
iteration) exactly. The port's preempt-and-resume is held bit for bit
against its own uninterrupted run, with images (the per-step generator) and
the EMA on.
"""

import json
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from test_torch_port_data import SIZE, features_npz, run_preprocess, write_corpus
from show_and_tell_tpu import ckpt as jckpt
from show_and_tell_tpu.cli import evaluate as jevaluate
from show_and_tell_tpu.cli import extract_features as jextract
from show_and_tell_tpu.cli import main as jmain
from show_and_tell_tpu.config import Config as JConfig
from show_and_tell_tpu.data.dataset import CocoCaptionDataset as JDataset
from show_and_tell_tpu.data.pipeline import Loader as JLoader
from show_and_tell_tpu.evalsuite.driver import make_trainer_eval_fn as jmake_eval_fn
from show_and_tell_tpu.models.registry import build_model as jbuild
from show_and_tell_tpu.train import schedule as jschedule
from show_and_tell_tpu.train.trainer import Trainer as JTrainer
from show_and_tell_tpu.utils.vocab import Vocabulary as JVocabulary
from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.ckpt.convert import to_jax_trainable
from show_and_tell_tpu_torch.cli import evaluate, extract_features
from show_and_tell_tpu_torch.cli import main as cli_main
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data import memmap
from show_and_tell_tpu_torch.data.dataset import CocoCaptionDataset
from show_and_tell_tpu_torch.data.pipeline import Loader
from show_and_tell_tpu_torch.evalsuite.driver import make_trainer_eval_fn
from show_and_tell_tpu_torch.models.encoders import to_torch_vgg16
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.obs import meters, profiler
from show_and_tell_tpu_torch.train import preempt, schedule
from show_and_tell_tpu_torch.train.trainer import Trainer
from show_and_tell_tpu_torch.utils.rng import KeyChain
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

SMALL = dict(embed_size=16, hidden_size=32, crop_size=SIZE, max_decode_len=6, beam_size=2, num_devices=1,
             batch_size=4, num_buckets=1, num_workers=2, max_epochs=2, save_checkpoint_every=4, log_step=2)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
# the VGG16 trunk's conv sums run in another order in the two frameworks
# (test_torch_port_model.py holds the trunk at 1e-4 of the feature scale)
TRUNK_RTOL = 1e-4


def make_tiny(root):
    """A preprocessed corpus (16 train, 4 val images, one caption each), an
    ``.npz`` of their features, a COCO annotation file of the val captions,
    and a ``model-best.msgpack`` of the JAX model's init, the start of every
    run here."""
    caption_json, images_root = write_corpus(root, n_train=16, n_val=4, sents=1, img_hw=(40, 44))
    vocab_path, data_json = run_preprocess("torch", os.path.join(root, "pre"), caption_json, images_root,
                                           resize=False)
    records = json.load(open(data_json))
    npz = features_npz(os.path.join(root, "feats.npz"), records, seed=3)
    val = [r for r in records if r["split"] == "val"]
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump({"images": [{"id": r["cocoid"]} for r in val],
                   "annotations": [{"image_id": r["cocoid"], "id": i, "caption": " ".join(r["final_caption"])}
                                   for i, r in enumerate(val)]}, f)
    V = len(Vocabulary.load(vocab_path))
    trainable, _ = jbuild(JConfig(**SMALL), V).init(jax.random.PRNGKey(0))
    start = os.path.join(root, "start")
    jckpt.save_best(start, jax.device_get(trainable), None, {})
    return {"root": root, "caption_json": caption_json, "images_root": images_root, "vocab": vocab_path,
            "data_json": data_json, "records": records, "npz": npz, "ann": ann, "start": start, "V": V}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))


def _cfgs(**kw):
    both = dict(SMALL, **kw)
    return JConfig(**both), Config(**both)


def _recording(step_fn, losses):
    def step(*a):
        state, metrics = step_fn(*a)
        losses.append(float(metrics["loss"]))
        return state, metrics
    return step


def params_diff(jax_params, model):
    got = to_jax_trainable(ckpt.trainable_state_dict(model))
    worst = max(float(np.abs(np.asarray(a) - b).max())
                for a, b in zip(jax.tree_util.tree_leaves(jax_params), jax.tree_util.tree_leaves(got)))
    return worst


# --- schedules ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    dict(learning_rate_decay_start=0, learning_rate_decay_every=2, learning_rate_decay_rate=0.5),
    dict(learning_rate_decay_start=-1, scheduled_sampling_start=0, scheduled_sampling_increase_every=1),
    dict(learning_rate_decay_start=3, scheduled_sampling_start=2, scheduled_sampling_increase_prob=0.1,
         scheduled_sampling_max_prob=0.25),
])
def test_schedules_match_jax(kw):
    jcfg, cfg = _cfgs(**kw)
    for epoch in range(1, 13):
        assert schedule.lr_for_epoch(cfg, epoch) == jschedule.lr_for_epoch(jcfg, epoch)
        assert schedule.ss_prob_for_epoch(cfg, epoch) == jschedule.ss_prob_for_epoch(jcfg, epoch)


# --- the Trainer against the JAX Trainer ----------------------------------------


def _loader(pkg, tiny, split, shuffle):
    if pkg == "jax":
        ds = JDataset(tiny["records"], JVocabulary.load(tiny["vocab"]), split, num_buckets=1)
        return JLoader(ds, 4, shuffle=shuffle, num_workers=2, seed=5, features=tiny["npz"], load_images=False,
                       drop_remainder=shuffle)
    ds = CocoCaptionDataset(tiny["records"], Vocabulary.load(tiny["vocab"]), split, num_buckets=1)
    return Loader(ds, 4, shuffle=shuffle, num_workers=2, seed=5, features=tiny["npz"], load_images=False,
                  drop_remainder=shuffle)


def train_both(tiny, root, gate):
    """Both trainers, 2 epochs of 4 steps, a gate every 4: -val_loss through
    both eval drivers, or CIDEr fed the same injected scores. Returns the
    trainers, their infos and each step's loss."""
    jcfg, cfg = _cfgs(language_eval=int(gate == "cider"), load_pretrained=True, load_model_path=tiny["start"])
    jcfg = jcfg.replace(expr_dir=os.path.join(root, "jax"))
    cfg = cfg.replace(expr_dir=os.path.join(root, "torch"))
    jm, tm = jbuild(jcfg, tiny["V"]), build_model(cfg, tiny["V"], device="cpu")
    if gate == "cider":
        scores = {"jax": iter([0.5, 0.7]), "torch": iter([0.5, 0.7])}
        jeval = lambda params, batch_stats, frozen: (2.0, [], {"CIDEr": next(scores["jax"])})  # noqa: E731
        teval = lambda params: (2.0, [], {"CIDEr": next(scores["torch"])})  # noqa: E731
    else:
        jeval = jmake_eval_fn(jm, jcfg, _loader("jax", tiny, "val", False), JVocabulary.load(tiny["vocab"]))
        teval = make_trainer_eval_fn(tm, cfg, _loader("torch", tiny, "val", False), Vocabulary.load(tiny["vocab"]))
    jt = JTrainer(jcfg, jm, _loader("jax", tiny, "train", True), eval_fn=jeval)
    tt = Trainer(cfg, tm, _loader("torch", tiny, "train", True), eval_fn=teval)
    losses = {"jax": [], "torch": []}
    jt.train_step = _recording(jt.train_step, losses["jax"])
    tt.train_step = _recording(tt.train_step, losses["torch"])
    return jt, tt, jt.train(), tt.train(), losses


@pytest.mark.parametrize("gate", ["val_loss", "cider"])
def test_trainer_matches_jax(tiny, tmp_path, gate):
    jt, tt, jinfos, infos, losses = train_both(tiny, str(tmp_path), gate)
    jcfg, cfg = jt.cfg, tt.cfg
    assert len(losses["torch"]) == len(losses["jax"]) == 8
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=LOSS_RTOL, atol=0)
    assert losses["torch"][-1] < losses["torch"][0]
    for k in ("total_iter", "iter", "epoch", "best_val_score", "epoch_schedule"):
        if k == "best_val_score" and gate == "val_loss":
            assert infos[k] == pytest.approx(jinfos[k], rel=LOSS_RTOL, abs=0)
        else:
            assert infos[k] == jinfos[k], k
    assert (infos["total_iter"], infos["epoch"]) == (8, 2)
    assert infos["loss_history"].keys() == jinfos["loss_history"].keys() == {"4", "8"}
    for k, v in jinfos["loss_history"].items():
        assert infos["loss_history"][k] == pytest.approx(v, rel=LOSS_RTOL, abs=0)
    for k, v in jinfos["val_result_history"].items():
        got = infos["val_result_history"][k]
        assert got["lang_stats"] == v["lang_stats"] and got["predictions_sample"] == v["predictions_sample"]
        assert got["loss"] == pytest.approx(v["loss"], rel=LOSS_RTOL, abs=0)
    best = ckpt.load_infos(cfg.expr_dir, best=True)
    assert best["total_iter"] == jckpt.load_infos(jcfg.expr_dir, best=True)["total_iter"]
    if gate == "cider":
        assert best["total_iter"] == 8 and infos["best_val_score"] == 0.7
    assert params_diff(jax.device_get(jt.state.params), tt.model) <= PARAM_ATOL
    # the best checkpoint holds the gate's weights, and reloads into a model
    assert ckpt.load_best_params(cfg.expr_dir, ckpt.trainable_state_dict(build_model(cfg, tiny["V"], device="cpu")))


# --- the CLIs against the JAX CLIs ------------------------------------------------


@pytest.fixture(scope="module")
def trained(tiny, tmp_path_factory):
    """``cli.main`` of both packages from the same start, on the features,
    with the CIDEr gate."""
    root = str(tmp_path_factory.mktemp("trained"))
    kw = dict(data_json=tiny["data_json"], vocab_path=tiny["vocab"], features_path=tiny["npz"],
              ann_file=tiny["ann"], language_eval=1, load_pretrained=True, load_model_path=tiny["start"])
    jcfg, cfg = _cfgs(**kw)
    jt = jmain.main(jcfg.replace(expr_dir=os.path.join(root, "jax")))
    tt = cli_main.main(cfg.replace(expr_dir=os.path.join(root, "torch")), device="cpu")
    return jt, tt


def test_cli_main_matches_jax(trained):
    jt, tt = trained
    jinfos, infos = jckpt.load_infos(jt.cfg.expr_dir), ckpt.load_infos(tt.cfg.expr_dir)
    assert tt.cfg.expr_dir.endswith(os.path.join("torch", "default", "showattendtell"))
    assert os.path.exists(os.path.join(tt.cfg.expr_dir, "config_expr_showattendtell.json"))
    assert (infos["total_iter"], infos["epoch"]) == (jinfos["total_iter"], jinfos["epoch"]) == (8, 2)
    assert infos["val_result_history"].keys() == jinfos["val_result_history"].keys() == {"4", "8"}
    for k, v in jinfos["val_result_history"].items():
        got = infos["val_result_history"][k]
        assert got["lang_stats"] == v["lang_stats"] and "CIDEr" in v["lang_stats"]
        assert got["predictions_sample"] == v["predictions_sample"]
        assert got["loss"] == pytest.approx(v["loss"], rel=LOSS_RTOL, abs=0)
    for k, v in jinfos["loss_history"].items():
        assert infos["loss_history"][k] == pytest.approx(v, rel=LOSS_RTOL, abs=0)
    assert infos["best_val_score"] == jinfos["best_val_score"]
    best = ckpt.load_infos(tt.cfg.expr_dir, best=True)["total_iter"]
    assert best == jckpt.load_infos(jt.cfg.expr_dir, best=True)["total_iter"]
    assert os.path.exists(os.path.join(tt.cfg.expr_dir, "model-best.pt"))
    assert params_diff(jax.device_get(jt.state.params), tt.model) <= PARAM_ATOL
    assert tt.throughput.items_per_sec > 0 and tt.timer.avg_s > 0


@pytest.mark.parametrize("beam_size", [1, 2])
def test_cli_evaluate_matches_jax(tiny, trained, beam_size):
    """Both CLIs evaluate the JAX-trained ``model-best.msgpack``; beam
    search when beam_size > 1."""
    jt, _ = trained
    argv = ["--data_json", tiny["data_json"], "--vocab_path", tiny["vocab"], "--features_path", tiny["npz"],
            "--ann_file", tiny["ann"], "--load_model_path", jt.cfg.expr_dir, "--beam_size", str(beam_size)]
    argv += [f"--{k}={v}" for k, v in SMALL.items() if k != "beam_size"]
    wl, wp, ws = jevaluate.main(argv)
    gl, gp, gs = evaluate.main(argv, device="cpu")
    assert gl == pytest.approx(wl, rel=LOSS_RTOL, abs=0)
    assert gp == wp and len(gp) == 4 and gs == ws and "CIDEr" in gs
    with pytest.raises(SystemExit):
        evaluate.main(argv[:-2] + ["--load_model_path", os.path.join(jt.cfg.expr_dir, "nope")], device="cpu")


def test_cli_extract_features_matches_jax(tiny, tmp_path):
    """One torchvision-layout trunk file for both; the images decoded by
    PIL (the JAX CLI's path) and through memmap shards (the port's)."""
    cfg = Config(**SMALL)
    trunk = str(tmp_path / "vgg16.pth")
    torch.save(to_torch_vgg16(build_model(cfg, tiny["V"], device="cpu",
                                          generator=torch.Generator().manual_seed(9)).frozen_tree()), trunk)
    _, data_json = run_preprocess("torch", str(tmp_path / "pre"), tiny["caption_json"], tiny["images_root"],
                                  resize=True)
    argv = ["--data_json", data_json, "--vocab_path", tiny["vocab"], "--encoder_weights", trunk]
    argv += [f"--{k}={v}" for k, v in SMALL.items()]
    want = np.load(jextract.extract(jextract.parse_config(argv + ["--output_json", str(tmp_path / "j.npz")])))
    records = json.load(open(data_json))
    mm = str(tmp_path / "mm")
    memmap.pack_memmap([r["file_path"] for r in records], mm, native_decode=False)
    for extra in ([], ["--memmap_dir", mm]):
        path = extract_features.main(argv + extra + ["--output_json", str(tmp_path / "t")], device="cpu")
        got = np.load(path)
        assert path.endswith(".npz") and sorted(got.files) == sorted(want.files) and len(want.files) == 20
        scale = max(np.abs(want[k]).max() for k in want.files)
        worst = max(np.abs(got[k] - want[k]).max() for k in want.files)
        assert got[want.files[0]].shape == (4, 512) and worst <= TRUNK_RTOL * scale, (worst, scale)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    argv = ["--data_json", tiny["data_json"], "--vocab_path", tiny["vocab"]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract_features.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main.main(Config(**SMALL))
    with pytest.raises(NotImplementedError, match="A9"):
        cli_main.main(Config(multihost=True), device="cpu")


@pytest.mark.parametrize("kw,what", [(dict(num_devices=2), "A9"), (dict(model_parallel=2), "A9"),
                                     (dict(multihost=True), "A9")])
def test_trainer_refuses_what_is_not_ported(tiny, kw, what):
    model = build_model(Config(**SMALL), tiny["V"], device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        Trainer(Config(**SMALL).replace(**kw), model, [])


def test_trainer_quantizes_on_first_batch(tiny, image_loader, tmp_path):
    """quantize_backbone: the Trainer calibrates the int8 trunk on its first
    batch of images and trains through it (finite losses, every step on
    int8 GEMMs); its checkpoints hold the keys of a float run's."""
    from show_and_tell_tpu_torch.models import quantize

    cfg = _cfgs(quantize_backbone=True, max_epochs=1, save_checkpoint_every=2, language_eval=0,
                expr_dir=str(tmp_path / "q"))[1]
    model = build_model(cfg, tiny["V"], device="cpu")
    before = quantize.GEMMS["int_mm"]
    t = Trainer(cfg, model, image_loader(), eval_fn=lambda params: (1.0, [], {}))
    t.train(preempt.PreemptionGuard())
    assert "qconvs" in model.quantized and t.state.step == 4
    assert quantize.GEMMS["int_mm"] - before == 4 * 11  # 11 int8 convs per step
    infos = ckpt.load_infos(cfg.expr_dir)
    assert infos["loss_history"] and all(np.isfinite(v) for v in infos["loss_history"].values())
    blob = torch.load(os.path.join(cfg.expr_dir, "model-best.pt"), weights_only=True)
    assert set(blob["params"]) == set(ckpt.trainable_state_dict(build_model(cfg, tiny["V"], device="cpu")))


def test_cli_evaluate_quantizes_on_the_first_val_batch(tiny, tmp_path):
    """``cli.evaluate --quantize_backbone`` on images: the trunk calibrated
    on the first val batch and saved to ``--quantized_backbone_path``, the
    evaluation run on int8 GEMMs; with ``--features_path`` nothing
    quantizes."""
    from show_and_tell_tpu_torch.models import quantize

    path = str(tmp_path / "int8.pt")
    _, data_json = run_preprocess("torch", str(tmp_path / "pre"), tiny["caption_json"], tiny["images_root"],
                                  resize=True)
    argv = ["--data_json", data_json, "--vocab_path", tiny["vocab"], "--ann_file", tiny["ann"],
            "--quantize_backbone", "true",
            "--quantized_backbone_path", path, "--language_eval", "0"]
    argv += [f"--{k}={v}" for k, v in SMALL.items()]
    before = quantize.GEMMS["int_mm"]
    loss, preds, _ = evaluate.main(argv, device="cpu")
    assert np.isfinite(loss) and len(preds) == 4
    assert quantize.GEMMS["int_mm"] > before and quantize.is_quantized(quantize.load_quantized(path))
    before = quantize.GEMMS["int_mm"]
    evaluate.main(argv + ["--features_path", tiny["npz"]], device="cpu")
    assert quantize.GEMMS["int_mm"] == before


# --- preempt and resume, port against port ----------------------------------------


class _TriggerAt:
    """Loader wrapper that triggers ``guard`` while producing its batch
    ``at`` (0-based, counted over epochs), and records the captions of every
    batch it hands out."""

    def __init__(self, loader, guard=None, at=-1):
        self.loader, self.guard, self.at, self.n, self.seen = loader, guard, at, 0, []

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def set_resume_skip(self, n):
        self.loader.set_resume_skip(n)

    def __iter__(self):
        for b in self.loader:
            if self.n == self.at:
                self.guard.trigger()
            self.n += 1
            self.seen.append(b["captions"])
            yield b


@pytest.fixture(scope="module")
def image_loader(tiny, tmp_path_factory):
    """A loader factory over memmap shards of the train images (40x44 PNGs
    squashed to 40 px)."""
    mm = str(tmp_path_factory.mktemp("mm"))
    paths = [os.path.join(tiny["images_root"], "train", f"img{i}.png") for i in range(16)]
    records = [dict(r, file_path=p) for r, p in zip([r for r in tiny["records"] if r["split"] == "train"], paths)]
    memmap.pack_memmap(paths, mm, size=40, native_decode=False)
    vocab = Vocabulary.load(tiny["vocab"])
    return lambda: Loader(CocoCaptionDataset(records, vocab, "train", num_buckets=1), 4, seed=5, num_workers=2,
                          image_size=40, memmap_images=mm, drop_remainder=True)


def _state_equal(a, b):
    for x, y in ((a.params, b.params), (a.opt_state["mu"], b.opt_state["mu"]),
                 (a.opt_state["nu"], b.opt_state["nu"]), (a.ema_params, b.ema_params)):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    assert (a.step, a.opt_state["count"]) == (b.step, b.opt_state["count"])


def test_preempt_and_resume_is_bit_continuous(tiny, image_loader, tmp_path):
    """Trigger mid-epoch 2 (after step 6 of 8), resume with start_from: the
    final state equals the uninterrupted run's bit for bit, uint8 images
    through the random crop and flip, the EMA on."""
    cfg = _cfgs(ema_decay=0.9, save_checkpoint_every=100, expr_dir=str(tmp_path / "a"))[1]
    init = KeyChain(cfg.random_seed).generator

    def trainer(c, loader):
        return Trainer(c, build_model(c, tiny["V"], device="cpu", generator=init("init")), loader)

    ta = trainer(cfg, _TriggerAt(image_loader()))
    ta.train(preempt.PreemptionGuard())
    assert ckpt.load_infos(cfg.expr_dir)["total_iter"] == 8

    guard = preempt.PreemptionGuard()
    cfg_b = cfg.replace(expr_dir=str(tmp_path / "b"))
    tb = trainer(cfg_b, _TriggerAt(image_loader(), guard, at=6))
    infos = tb.train(guard)
    assert infos["preempted"] is True and (infos["total_iter"], infos["epoch"], infos["iter"]) == (6, 2, 2)
    assert ckpt.load_infos(cfg_b.expr_dir)["preempted"] is True
    assert os.path.exists(os.path.join(cfg_b.expr_dir, "state-last.pt"))

    resumed_loader = _TriggerAt(image_loader())
    tc = trainer(cfg_b.replace(start_from=cfg_b.expr_dir), resumed_loader)
    infos = tc.train(preempt.PreemptionGuard())
    assert infos.get("preempted") is None and (infos["total_iter"], infos["epoch"]) == (8, 2)
    # the loader skipped the two trained plans of epoch 2
    assert len(resumed_loader.seen) == 2
    assert np.array_equal(resumed_loader.seen[0], ta.trainloader.seen[6])
    _state_equal(tc.state, ta.state)
    assert not ckpt.load_infos(cfg_b.expr_dir).get("preempted")


def test_resume_from_best_params_reseeds_the_ema(tiny, tmp_path):
    """A start_from directory with infos and a best checkpoint but no train
    state: the params load, and the EMA restarts from them."""
    cfg = _cfgs(ema_decay=0.5, max_epochs=1, save_checkpoint_every=100)[1]
    donor = build_model(cfg, tiny["V"], device="cpu", generator=torch.Generator().manual_seed(1))
    d = str(tmp_path / "best")
    ckpt.save_best(d, ckpt.trainable_state_dict(donor), None, {"total_iter": 4, "iter": 4, "epoch": 1})
    ckpt.save_infos(d, {"total_iter": 4, "iter": 4, "epoch": 1})
    t = Trainer(cfg.replace(start_from=d, expr_dir=str(tmp_path / "run")), build_model(cfg, tiny["V"], device="cpu"),
                _loader("torch", tiny, "train", True))
    infos = t.train(preempt.PreemptionGuard())
    assert infos["total_iter"] == 4  # epoch 1 was done: nothing ran, the infos were rewritten
    want = ckpt.trainable_state_dict(donor)
    assert all(torch.equal(t.state.ema_params[k], want[k]) for k in want)
    assert all(torch.equal(t.state.params[k], want[k]) for k in want)


# --- the guard, the watchdog, the meters and the profiler ------------------------------


def test_preemption_guard_latches_and_restores():
    prev, prev_int = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    g = preempt.PreemptionGuard()
    with g:
        assert not g.triggered
        os.kill(os.getpid(), signal.SIGTERM)  # latched, not fatal
        assert g.triggered
        # one latch: the first signal restores the previous handlers
        assert signal.getsignal(signal.SIGTERM) is prev and signal.getsignal(signal.SIGINT) is prev_int
    assert signal.getsignal(signal.SIGTERM) is prev and signal.getsignal(signal.SIGINT) is prev_int


def test_rss_watchdog_triggers_the_guard():
    guard = preempt.PreemptionGuard()
    assert preempt.current_rss_gb() > 0
    with preempt.RssWatchdog(guard, threshold_gb=1e-6, interval_s=0.01) as w:
        deadline = time.time() + 10
        while not guard.triggered and time.time() < deadline:
            time.sleep(0.01)
    assert guard.triggered and w.fired and not w._thread.is_alive()
    calm = preempt.PreemptionGuard()
    with preempt.RssWatchdog(calm, threshold_gb=1e6, interval_s=0.01) as w:
        time.sleep(0.05)
    assert not calm.triggered and not w.fired
    with pytest.raises(ValueError):
        preempt.RssWatchdog(calm, 0)


def test_step_timer_and_throughput_meter():
    t = meters.StepTimer(ema=0.5)
    t.start()
    time.sleep(0.01)
    d1 = t.stop(torch.ones(3))
    t.start()
    d2 = t.stop({"loss": torch.zeros(()), "x": [torch.ones(1)]})
    assert d1 >= 0.01 and t.last_s == d2 and abs(t.avg_s - (0.5 * d1 + 0.5 * d2)) < 1e-9
    t.record(1.0)
    assert t.last_s == 1.0
    m = meters.ThroughputMeter()
    assert m.items_per_sec == 0.0
    m.update(100, 2.0)
    m.update(50, 1.0)
    assert m.items_per_sec == 50.0
    m.reset()
    assert m.items == 0 and m.seconds == 0.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiler.profile_trace(d, enabled=False):
        torch.ones(4).sum()
    assert not os.path.exists(d)
    with profiler.profile_trace(d):
        with profiler.annotate("region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "region" for e in events)


def test_trainer_profiles_the_asked_step(tiny, tmp_path):
    cfg = _cfgs(max_epochs=1, save_checkpoint_every=100, profile_dir=str(tmp_path / "p"), profile_step=3,
                 expr_dir=str(tmp_path / "e"), preempt_save=False)[1]
    Trainer(cfg, build_model(cfg, tiny["V"], device="cpu"), _loader("torch", tiny, "train", True)).train()
    assert len(os.listdir(tmp_path / "p")) == 1

