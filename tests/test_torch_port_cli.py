"""PyTorch port, the last CLIs against the JAX package's on the CPU:
``cli.caption``, ``cli.export_torch``, ``cli.train_chain`` and ``python -m
show_and_tell_tpu_torch``.

The caption and export CLIs of both packages read one experiment dir: a JAX
``model-best.msgpack`` of ``test_torch_port_batcher.jax_weights`` and a
torchvision-layout trunk file of the same weights (``--encoder_weights``),
at the JAX serving tests' tiny size, in fp32. Their JSON lines must be equal
and their ``.pth`` files equal key for key within 1e-6. The chain's
supervisor runs with a fake spawn (the JAX tests' fake trainer) and with one
that runs ``cli.main`` in this process on the CPU. The three behaviours of
the port's ``train_chain`` that differ from the JAX one on purpose are each
asserted beside the JAX behaviour.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_batcher import TINY, WORDS, jax_weights, scenes
from test_torch_port_data import features_npz, run_preprocess, write_corpus
from show_and_tell_tpu import ckpt as jckpt
from show_and_tell_tpu.cli import caption as jcaption
from show_and_tell_tpu.cli import export_torch as jexport
from show_and_tell_tpu.cli import train_chain as jchain
from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.cli import caption, export_torch, train_chain
from show_and_tell_tpu_torch.cli import main as cli_main
from show_and_tell_tpu_torch.config import Config, parse_config
from show_and_tell_tpu_torch.models.encoders import _VGG_TORCH_IDX
from show_and_tell_tpu_torch.utils.visualize import attention_sheet, model_view
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _fast_jax_trunk_init(monkeypatch):
    """The JAX CLIs build their model from its init, whose VGG16 trunk takes
    10-30 s to run here, and then replace the trunk with --encoder_weights:
    give them the init's shapes, in zeros, which no output reads."""
    from show_and_tell_tpu.models import encoders as jencoders

    init = jencoders.init_encoder
    monkeypatch.setattr(jencoders, "init_encoder", lambda *a, **kw: jax.tree.map(
        lambda leaf: np.zeros(leaf.shape, leaf.dtype), jax.eval_shape(lambda: init(*a, **kw))))


def write_experiment(root):
    """Under ``root``: an experiment dir with the JAX model-best.msgpack of
    ``jax_weights``, the trunk file, vocab.json, and the flags that both
    packages' CLIs take."""
    _, (trainable, frozen) = jax_weights()
    expr = os.path.join(root, "exp")
    jckpt.save_best(expr, jax.device_get(trainable), None, {})
    trunk = os.path.join(root, "vgg16.pth")
    torch.save({f"features.{i}.{k}": torch.from_numpy(np.ascontiguousarray(
                    conv["w"].transpose(3, 2, 0, 1) if k == "weight" else conv["b"]))
                for conv, i in zip(frozen["convs"], _VGG_TORCH_IDX) for k in ("weight", "bias")}, trunk)
    vocab = os.path.join(root, "vocab.json")
    Vocabulary.from_words(WORDS).save(vocab)
    flags = [f"--{k}={v}" for k, v in TINY.items()] + [
        "--vocab_path", vocab, "--load_model_path", expr, "--encoder_weights", trunk]
    return {"root": root, "expr": expr, "flags": flags}


def export_both(flags, root):
    """The .pth of each package's export CLI: {"jax": path, "torch": path}."""
    paths = {pkg: os.path.join(root, f"{pkg}.pth") for pkg in ("jax", "torch")}
    assert jexport.main(flags + ["--export_path", paths["jax"]]) == paths["jax"]
    assert export_torch.main(flags + [f"--export_path={paths['torch']}"], device="cpu") == paths["torch"]
    return paths


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return write_experiment(str(tmp_path_factory.mktemp("cli")))


@pytest.fixture(scope="module")
def image_files(trained):
    """Three scenes as PNG files of other sizes, and a corrupt file."""
    d = os.path.join(trained["root"], "imgs")
    os.makedirs(d)
    paths = []
    for i, hw in enumerate([(64, 64), (80, 48), (256, 256)]):
        paths.append(os.path.join(d, f"img{i}.png"))
        Image.fromarray(scenes(1, 10 + i, hw)[0]).save(paths[-1])
    bad = os.path.join(d, "broken.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    return paths, bad


def _run_cli(main, argv, capsys, **kw):
    """(stdout lines, SystemExit message or None)."""
    try:
        main(argv, **kw)
        err = None
    except SystemExit as e:
        err = str(e)
    return capsys.readouterr().out.splitlines(), err


# --- cli.caption --------------------------------------------------------------


@pytest.mark.parametrize("beam_size", [1, 2])
def test_caption_lines_equal_jax(trained, image_files, capsys, monkeypatch, tmp_path, beam_size):
    """One JSON line per image, in the order given (a directory expands to
    its sorted image files), the corrupt file marked, and the exit message
    naming it: the same as the JAX CLI's, beam and greedy."""
    paths, bad = image_files
    argv = trained["flags"] + [f"--beam_size={beam_size}", paths[2], os.path.dirname(bad)]
    monkeypatch.chdir(tmp_path)
    want = _run_cli(jcaption.main, argv, capsys)
    got = _run_cli(caption.main, argv, capsys, device="cpu")
    assert got == want
    lines, err = got
    recs = [json.loads(ln) for ln in lines]
    assert [r["image"] for r in recs] == [paths[2], bad] + paths
    assert recs[1] == {"image": bad, "caption": "<error: image failed to decode>",
                       "error": "image failed to decode"}
    assert err.startswith("1 of 5 image(s) failed to decode") and bad in err


def test_caption_attention_sheets(trained, image_files, capsys, monkeypatch, tmp_path):
    """--attention_dir: the JSON lines equal the JAX CLI's, and the port
    renders each image's sheet from that image, its caption and its maps.
    The JAX CLI renders every sheet of a chunk from the chunk's first image
    (its loop index is reused as the name counter, cli/caption.py): its
    first sheet equals the port's within one grey level, its second is the
    first image's sheet again. A difference on purpose (ROADMAP.md §C)."""
    paths, _ = image_files
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, main, kw in (("jax", jcaption.main, {}), ("torch", caption.main, {"device": "cpu"})):
        sheets = str(tmp_path / name)
        out[name] = _run_cli(main, trained["flags"] + ["--beam_size=1", "--attention_dir", sheets] + paths[:2],
                             capsys, **kw)
        assert out[name][1] is None
    jrecs = [json.loads(ln) for ln in out["jax"][0]]
    trecs = [json.loads(ln) for ln in out["torch"][0]]
    assert [{k: v for k, v in r.items() if k != "attention_sheet"} for r in trecs] == [
        {k: v for k, v in r.items() if k != "attention_sheet"} for r in jrecs]
    assert [os.path.basename(r["attention_sheet"]) for r in trecs] == ["img0_attention.png", "img1_attention.png"]
    read = lambda p: np.asarray(Image.open(p), np.int16)  # noqa: E731
    cfg = parse_config(trained["flags"])
    from show_and_tell_tpu_torch.serve import Captioner

    cap = Captioner.from_checkpoint(cfg, cfg.load_model_path, Vocabulary.load(cfg.vocab_path), device="cpu")
    for rec in trecs:
        img = np.asarray(Image.open(rec["image"]).convert("RGB").resize((256, 256)))
        caps, alphas = cap.caption_with_attention(img[None])
        assert caps[0] == rec["caption"]
        want = attention_sheet(model_view(img, cfg.crop_size), alphas[0], caps[0].split() or ["<no caption>"])
        assert np.array_equal(read(rec["attention_sheet"]), np.asarray(want, np.int16))
    assert np.abs(read(jrecs[0]["attention_sheet"]) - read(trecs[0]["attention_sheet"])).max() <= 1
    assert np.array_equal(read(jrecs[1]["attention_sheet"]), read(jrecs[0]["attention_sheet"]))
    assert not np.array_equal(read(trecs[1]["attention_sheet"]), read(trecs[0]["attention_sheet"]))


# --- cli.export_torch ---------------------------------------------------------


def test_export_equal_jax(trained, capsys, monkeypatch, tmp_path):
    """The same .pth key for key within 1e-6; both spellings of
    --export_path; the usage errors of the JAX CLI."""
    monkeypatch.chdir(tmp_path)
    paths = export_both(trained["flags"], str(tmp_path))
    jpath, tpath = paths["jax"], paths["torch"]
    assert capsys.readouterr().out.splitlines() == [jpath, tpath]
    want = torch.load(jpath, weights_only=True)
    got = torch.load(tpath, weights_only=True)
    assert sorted(got) == sorted(want)
    worst = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
    assert worst <= EXPORT_ATOL, worst
    assert all(got[k].dtype == want[k].dtype and got[k].shape == want[k].shape for k in want)
    for argv, msg in (([], "--export_path OUT.pth is required"), (["--export_path"], "requires a value"),
                      ([f"--vocab_path={trained['flags'][trained['flags'].index('--vocab_path') + 1]}",
                        "--export_path", tpath], "--load_model_path"),
                      (trained["flags"][:-4] + ["--load_model_path", str(tmp_path), "--export_path", tpath],
                       "no checkpoint found")):
        with pytest.raises(SystemExit, match=msg):
            export_torch.main(argv, device="cpu")


def test_cli_entry_points_need_a_card_unless_asked_for_the_cpu(trained, image_files, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        caption.main(trained["flags"] + image_files[0][:1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_torch.main(trained["flags"] + ["--export_path", str(tmp_path / "x.pth")])
    # Show-and-Tell reaches the same device check
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_torch.main(trained["flags"] + ["--model", "show_tell", "--export_path", "x.pth"])


# --- cli.train_chain ----------------------------------------------------------


def _chain_cfg(tmp_path, **kw):
    return Config(**dict(dict(expr_dir=str(tmp_path / "exp"), user_id="u", exp_id="e", max_epochs=3), **kw))


class FakeTrainer:
    """Stands in for a cli.main child, as the JAX tests' fake does: each call
    saves the infos that the real Trainer would (or preempts mid-epoch, or
    crashes first)."""

    def __init__(self, expr, steps_per_epoch=10):
        self.expr, self.steps = expr, steps_per_epoch
        self.calls, self.script = [], []

    def __call__(self, argv, log_path, timeout_s, grace_s):
        upto = int(argv[argv.index("--max_epochs") + 1])
        behavior = self.script.pop(0) if self.script else "ok"
        self.calls.append((upto, behavior))
        infos = ckpt.load_infos(self.expr) or {}
        if behavior == "crash_no_progress":
            return 1
        if behavior == "preempt_mid":
            half = self.steps // 2
            infos.update(epoch=upto, iter=half, total_iter=(upto - 1) * self.steps + half, preempted=True)
        else:
            infos.pop("preempted", None)
            infos.update(epoch=upto, iter=self.steps, total_iter=upto * self.steps)
        ckpt.save_infos(self.expr, infos)
        return 0


def test_child_argv_spawns_the_port_and_round_trips_the_config(tmp_path):
    cfg = _chain_cfg(tmp_path, batch_size=7, dtype="bfloat16", rss_preempt_gb=99.5, scheduled_sampling_start=0)
    argv = train_chain.child_argv(cfg, upto_epoch=2)
    assert argv[:3] == [sys.executable, "-m", "show_and_tell_tpu_torch.cli.main"]
    assert jchain.child_argv(cfg, 2)[:3] == [sys.executable, "-m", "show_and_tell_tpu.cli.main"]
    child = parse_config(argv[3:])
    assert child == cfg.replace(max_epochs=2, start_from=train_chain.resolved_expr_dir(cfg), preempt_save=True)
    assert argv[3:] == jchain.child_argv(cfg, 2)[3:]  # the same flags as the JAX chain's


@pytest.mark.parametrize("script,max_epochs,epochs,completed", [
    ([], 3, [1, 2, 3], 3),
    (["ok", "preempt_mid", "ok"], 2, [1, 2, 2], 2),
])
def test_chain_runs_one_child_per_epoch(tmp_path, script, max_epochs, epochs, completed):
    """The happy path, and a preempted child respawned for its epoch (the
    spawn recorded as preempted, and as progress)."""
    cfg = _chain_cfg(tmp_path, max_epochs=max_epochs)
    fake = FakeTrainer(train_chain.resolved_expr_dir(cfg))
    fake.script = list(script)
    record = train_chain.run_chain(cfg, spawn=fake)
    assert [c[0] for c in fake.calls] == epochs
    assert record["completed_epochs"] == completed == max_epochs
    chain = json.load(open(os.path.join(fake.expr, "chain.json")))
    assert chain == record and all(s["returncode"] == 0 for s in chain["spawns"])
    assert [s["progressed"] for s in chain["spawns"] if s["preempted"]] == ([True] if "preempt_mid" in script else [])


def test_chain_bounds_no_progress_respawns_and_resumes_after_a_restart(tmp_path):
    cfg = _chain_cfg(tmp_path, max_epochs=3)
    fake = FakeTrainer(train_chain.resolved_expr_dir(cfg))
    fake.script = ["ok", "ok"] + ["crash_no_progress"] * 3
    with pytest.raises(RuntimeError, match="no progress"):
        train_chain.run_chain(cfg, max_retries=2, spawn=fake)
    assert len(fake.calls) == 5  # 2 epochs, then the first try and 2 retries
    fake2 = FakeTrainer(fake.expr)
    record = train_chain.run_chain(cfg, spawn=fake2)
    assert [c[0] for c in fake2.calls] == [3]
    assert record["completed_epochs"] == 3 and len(record["spawns"]) == 6


def test_chain_without_its_record_reruns_the_infos_epoch(tmp_path):
    """chain.json missing: infos of a mid-epoch gate (no preempted flag)
    are not a finished epoch. The JAX chain counts the epoch as complete and
    starts the next one; the port's reruns it, resuming at its iter, and
    reruns a finished epoch the same way, as a child that runs no step. A
    difference on purpose (ROADMAP.md §C)."""
    calls = {}
    for pkg, mod in (("jax", jchain), ("torch", train_chain)):
        cfg = _chain_cfg(tmp_path / pkg, max_epochs=3)
        fake = FakeTrainer(mod.resolved_expr_dir(cfg))
        os.makedirs(fake.expr)
        ckpt.save_infos(fake.expr, {"epoch": 2, "iter": 4, "total_iter": 14})  # a gate in epoch 2 of 10 steps
        record = mod.run_chain(cfg, spawn=fake)
        calls[pkg] = [c[0] for c in fake.calls]
        assert record["completed_epochs"] == 3
    assert calls == {"jax": [3], "torch": [2, 3]}
    # the end of epoch 2 looks alike to the port: rerun, as a no-op child
    cfg = _chain_cfg(tmp_path / "ended", max_epochs=3)
    fake = FakeTrainer(train_chain.resolved_expr_dir(cfg))
    os.makedirs(fake.expr)
    ckpt.save_infos(fake.expr, {"epoch": 2, "iter": 10, "total_iter": 20})
    record = train_chain.run_chain(cfg, spawn=fake)
    assert [c[0] for c in fake.calls] == [2, 3] and record["spawns"][0]["progressed"] is False


def test_chain_rejects_start_from(tmp_path):
    """An operator's --start_from: the JAX chain drops it silently (every
    child resumes the chain's own dir); the port's refuses it. A difference
    on purpose (ROADMAP.md §C)."""
    cfg = _chain_cfg(tmp_path, start_from=str(tmp_path / "warm"))
    assert parse_config(jchain.child_argv(cfg, 1)[3:]).start_from == jchain.resolved_expr_dir(cfg)
    with pytest.raises(ValueError, match="start_from"):
        train_chain.run_chain(cfg, spawn=FakeTrainer(str(tmp_path)))
    assert not os.path.exists(train_chain.resolved_expr_dir(cfg))


SUPERVISOR = """
import os, sys
sys.path.insert(0, {repo!r})
from show_and_tell_tpu_torch.cli import train_chain
child = "import os, time; open({pid!r} + '.tmp', 'w').write(str(os.getpid())); os.replace({pid!r} + '.tmp', {pid!r}); time.sleep(120)"
train_chain.child_argv = lambda cfg, epoch: [sys.executable, "-c", child]
sys.argv = ["train_chain", "--expr_dir", {expr!r}, "--max_epochs", "1", "--term_grace_s", "10"]
train_chain.cli_entry()
"""


def test_supervisor_sigterm_terminates_the_child(tmp_path, monkeypatch):
    """SIGTERM to a supervisor whose child is running: the port's supervisor
    terminates the child and exits 143. The JAX supervisor runs its chain
    with SIGTERM at the default action, so the signal kills it at once and
    its child goes on running. A difference on purpose (ROADMAP.md §C)."""
    seen = []
    monkeypatch.setattr(jchain, "run_chain", lambda *a, **kw: seen.append(signal.getsignal(signal.SIGTERM)))
    monkeypatch.setattr(sys, "argv", ["train_chain", "--expr_dir", str(tmp_path)])
    jchain.cli_entry()
    assert seen == [signal.SIG_DFL]

    pid_file = str(tmp_path / "child.pid")
    sup = subprocess.Popen([sys.executable, "-c", SUPERVISOR.format(repo=REPO, pid=pid_file,
                                                                   expr=str(tmp_path / "exp"))],
                           stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(pid_file):
            assert sup.poll() is None and time.monotonic() < deadline, "the child did not start"
            time.sleep(0.05)
        child = int(open(pid_file).read())
        sup.send_signal(signal.SIGTERM)
        rc = sup.wait(timeout=60)
        try:
            os.kill(child, 0)
            alive = True
            os.kill(child, signal.SIGKILL)
        except ProcessLookupError:
            alive = False
    finally:
        if sup.poll() is None:
            sup.kill()
    assert (rc, alive) == (128 + signal.SIGTERM, False)


def test_chain_of_cpu_children_trains_two_epochs(tmp_path):
    """Two epochs through cli.main, each link run on the CPU in this process
    by the spawn argument: one child per epoch, the second resuming the
    first's state, not starting over."""
    caption_json, images_root = write_corpus(str(tmp_path), n_train=8, n_val=2, sents=1)
    vocab, data_json = run_preprocess("torch", str(tmp_path / "pre"), caption_json, images_root, resize=False)
    records = json.load(open(data_json))
    npz = features_npz(str(tmp_path / "f.npz"), records)
    cfg = _chain_cfg(tmp_path, **TINY, max_epochs=2, data_json=data_json, vocab_path=vocab, features_path=npz,
                     batch_size=4, num_buckets=1, num_workers=1, language_eval=0, log_step=1,
                     save_checkpoint_every=1000)

    def cpu_spawn(argv, log_path, timeout_s, grace_s):
        assert argv[1:3] == ["-m", "show_and_tell_tpu_torch.cli.main"]
        cli_main.main(parse_config(argv[3:]), device="cpu")
        return 0

    record = train_chain.run_chain(cfg, spawn=cpu_spawn)
    assert record["completed_epochs"] == 2
    assert [(s["epoch"], s["total_iter"], s["preempted"]) for s in record["spawns"]] == [(1, 2, False), (2, 4, False)]
    infos = ckpt.load_infos(train_chain.resolved_expr_dir(cfg))
    assert (infos["epoch"], infos["iter"], infos["total_iter"]) == (2, 2, 4)
    assert set(infos["epoch_schedule"]) == {"1", "2"}


def test_python_dash_m_prints_the_banner():
    out = subprocess.run([sys.executable, "-m", "show_and_tell_tpu_torch"], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0
    for name in ("main", "train_chain", "evaluate", "caption", "serve_http", "export_torch"):
        assert f"python -m show_and_tell_tpu_torch.cli.{name} " in out.stdout
    assert "jax" not in out.stdout.lower().replace("show_and_tell_tpu_torch", "")
