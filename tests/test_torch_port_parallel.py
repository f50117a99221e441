"""PyTorch port, multi-device (``parallel/``) against the JAX package's meshes
and against itself, on the CPU.

The port runs one process per device over ``torch.distributed``; here the
ranks are processes on the CPU over gloo (``tests/torch_port_ranks.py``
starts them), and the JAX side is ``make_mesh`` on ``conftest.py``'s 8
virtual devices with the same weights (``ckpt.convert.from_jax_params``)
and the same global batch:

- three train steps of data parallel (DP=2), vocabulary tensor parallel
  (TP=2, an even V) and both (DP=2 x TP=2, the layout of
  ``__graft_entry__.dryrun_multichip``): losses within 2e-4 relative (the
  JAX package's own DP bound, ``tests/test_parallel.py:68``) and params
  within 1e-4 of their scale (the largest |param|);
- the port's 2 ranks against its 1 rank (a process without a group): losses
  within 1e-5 relative and params within 1e-5 of scale, with uint8 images in
  the batch (the random crop and flip drawn for the global batch);
- Show-and-Tell at DP=2 with unequal token counts per rank: the BatchNorm's
  running statistics within 1e-5 of scale of one device and of the JAX mesh;
- the ``Captioner`` over 2 ranks: captions identical to one device's for
  beam, greedy and sample, n-best scores within rtol 1e-5, the bucket rules.

Adam divides each gradient element by its own magnitude, so an element whose
gradient lies near its rounding moves by an amount set by the rounding (the
reason ``test_torch_port_show_tell.py`` trains at lr 1e-4): the steps here
run at lr 1e-4. Show-and-Tell's ``proj.b`` is such a parameter throughout:
the train-mode BatchNorm subtracts the batch mean, so its gradient is zero
but for rounding (``chip_smoke.py`` phase 12 holds it apart too), and Adam
moves it by up to lr per step in a direction the rounding sets; it is held
within steps x lr, the rest of the params as above.
``tests/torch_port_parity.py`` prints the figures.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import test_torch_port_model as tpm
import test_torch_port_show_tell as tst
import torch_port_ranks as ranks
from test_torch_port_data import features_npz, run_preprocess, write_corpus
from show_and_tell_tpu.config import Config as JConfig
from show_and_tell_tpu.data.dataset import CocoCaptionDataset as JDataset
from show_and_tell_tpu.models.registry import build_model as jbuild
from show_and_tell_tpu.parallel import mesh as jmesh
from show_and_tell_tpu.train import step as jstep
from show_and_tell_tpu.utils.vocab import Vocabulary as JVocabulary
from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.ckpt.convert import from_jax_trainable
from show_and_tell_tpu_torch.cli import main as cli_main
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data.dataset import CocoCaptionDataset
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.parallel import distributed
from show_and_tell_tpu_torch.parallel import mesh as mesh_lib
from show_and_tell_tpu_torch.serve import Captioner
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

LR = 1e-4
LOSS_RTOL_JAX, PARAM_JAX = 2e-4, 1e-4  # against the JAX meshes
LOSS_RTOL, PARAM_REL = 1e-5, 1e-5  # 2 ranks against 1
STATS_REL = 1e-5
B, T, L = 8, 7, 4
SAT = dict(tpm.SMALL)  # V = tpm.V = 50, even: TP=2 splits it
ST = dict(tst.SMALL)  # V = tst.V = 30
MESHES = {"dp2": (2, 1), "tp2": (2, 2), "dp2xtp2": (4, 2)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The file's small steps on one thread: under a parallel test run,
    more only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(V, seed=0, features=(L, 512), images=False):
    """A global batch of 8: captions from <start>, rows 0-3 of length 7 and
    rows 4-7 of 3 or 2, so the ranks of DP=2 hold 24 and 7 tokens."""
    rng = np.random.default_rng(seed)
    b = {"captions": np.concatenate([np.ones((B, 1), np.int64), rng.integers(4, V, (B, T - 1))], 1),
         "lengths": np.array([7, 7, 7, 7, 3, 3, 2, 2])}
    if images:
        b["images"] = rng.integers(0, 256, (B, 40, 40, 3), dtype=np.uint8)
    else:
        b["features"] = rng.standard_normal((B, *features)).astype(np.float32)
    return b


def _sat_weights():
    trainable, frozen = tpm._jax_init(0)
    return trainable, frozen, {k: v.numpy() for k, v in from_jax_trainable(trainable).items()}


def _st_weights():
    jm, trainable, _, stats = tst.jax_weights(ST, trunk=False)
    sd = {k: v.numpy() for k, v in from_jax_trainable(trainable).items()}
    sd.update({"bn.mean": stats["mean"], "bn.var": stats["var"]})
    return jm, trainable, stats, sd


def _case(cfg, V, weights, batch, mp=1, **kw):
    return dict(cfg=cfg, V=V, weights=weights, batch=batch, mp=mp, lr=LR, steps=3, **kw)


def _jax_run(model_kw, V, trainable, frozen, stats, batch, n, mp):
    """Three JAX train steps on a mesh of ``n`` of the 8 virtual devices."""
    mesh = jmesh.make_mesh(num_devices=n, model_parallel=mp)
    cfg = JConfig(**model_kw, model_parallel=mp)
    model = jbuild(cfg, V)
    state = jstep.make_train_state(cfg, jmesh.place_params(mesh, trainable), stats)
    step = jstep.make_train_step(model, cfg, donate=False)
    b = jmesh.shard_batch(mesh, batch)
    frozen = jmesh.replicate(mesh, frozen) if frozen is not None else None
    losses = []
    for i in range(3):
        state, m = step(state, frozen, b, LR, 0.0, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    params = {k: v.numpy() for k, v in from_jax_trainable(jax.device_get(state.params)).items()}
    stats = None if state.batch_stats is None else jax.tree.map(np.asarray, state.batch_stats)
    return losses, params, stats


NOISE = ("proj.b",)  # Show-and-Tell's: its gradient is zero but for rounding


def _rel(got, want):
    """max |diff| over every tensor but ``NOISE`` / the largest |value|;
    each of ``NOISE`` held within the 3 steps' 3 x lr."""
    for k in NOISE:
        if k in want:
            assert np.abs(got[k] - want[k]).max() <= 3 * LR, k
    keys = [k for k in want if k not in NOISE]
    return max(np.abs(got[k] - want[k]).max() for k in keys) / max(np.abs(want[k]).max() for k in keys)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One 2-rank run: the train cases (Show-Attend-Tell DP=2 and TP=2 on
    features, DP=2 on images, Show-and-Tell DP=2) and the Captioner."""
    _, _, sat = _sat_weights()
    _, _, _, st = _st_weights()
    cases = [
        _case(SAT, tpm.V, sat, _batch(tpm.V)),
        _case(SAT, tpm.V, sat, _batch(tpm.V), mp=2),
        _case(SAT, tpm.V, sat, _batch(tpm.V, images=True), trunk=True),
        _case(ST, tst.V, st, _batch(tst.V, features=(tst.F,))),
    ]
    serve = dict(cfg=dict(SAT, beam_size=3), words=[f"w{i}" for i in range(tpm.V - 4)], weights=sat,
                 buckets=(2, 4), images=np.random.default_rng(5).integers(0, 256, (6, 40, 40, 3), dtype=np.uint8))
    out = ranks.run("both", 2, str(tmp_path_factory.mktemp("ranks2")), {"cases": cases, "serve": serve})
    return cases, serve, out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    _, _, sat = _sat_weights()
    cases = [_case(SAT, tpm.V, sat, _batch(tpm.V), mp=2)]
    return cases, ranks.run("train", 4, str(tmp_path_factory.mktemp("ranks4")), {"cases": cases})


# --- the mesh ------------------------------------------------------------------


def test_mesh_layout_and_errors_match_jax():
    """rank = d * mp + m, as the JAX mesh's device array; without a process
    group one device, on which every helper is the identity; the JAX
    errors."""
    jm = jmesh.make_mesh(model_parallel=2)
    for r in range(8):
        m = mesh_lib.Mesh(4, 2, r, torch.device("cpu"))
        d, k = np.argwhere(np.vectorize(lambda dev: dev.id)(jm.devices) == jax.devices()[r].id)[0]
        assert (m.data_index, m.model_index) == (d, k) and m.shape == dict(jm.shape)
    one = mesh_lib.make_mesh(device="cpu")
    assert (one.data, one.model, one.distributed) == (1, 1, False)
    batch = {"x": np.arange(6)}
    assert mesh_lib.shard_batch(one, batch)["x"].tolist() == list(range(6))
    assert distributed.globalize_batch(one, batch)["x"].tolist() == list(range(6))
    assert mesh_lib.shard_batch(mesh_lib.Mesh(2, 1, 1, torch.device("cpu")), batch)["x"].tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="requested 2 devices"):
        mesh_lib.make_mesh(num_devices=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        mesh_lib.make_mesh(model_parallel=2, device="cpu")


@pytest.mark.parametrize("model,V", [("show_attend_tell", 50), ("show_attend_tell", 49), ("show_tell", 30),
                                     ("show_tell", 31)])
def test_param_shardings_match_jax(model, V):
    """Name for name the JAX ``param_shardings`` at model axis 2: the
    vocabulary dimension of embed and the head split at an even V, every
    parameter replicated at an odd one."""
    kw = SAT if model == "show_attend_tell" else ST
    shapes = jax.eval_shape(jbuild(JConfig(**kw), V).init, jax.random.PRNGKey(0))[0]
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            jmesh.param_shardings(jmesh.make_mesh(model_parallel=2), shapes))[0]:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        spec = tuple(sh.spec)
        want[name] = spec.index("model") if "model" in spec else None
    with ranks.no_trunk():
        m = build_model(Config(**kw), V, device="cpu")
    got = mesh_lib.param_shardings(mesh_lib.Mesh(1, 2, 0, torch.device("cpu")), ckpt.trainable_state_dict(m))
    assert got == want
    assert any(ax is not None for ax in got.values()) == (V % 2 == 0)


# --- training against the JAX meshes ---------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
def test_train_steps_match_jax_mesh(two_ranks, four_ranks, name):
    n, mp = MESHES[name]
    trainable, frozen, _ = _sat_weights()
    got = four_ranks[1] if n == 4 else [r["train"] for r in two_ranks[2]]
    case = {"dp2": 0, "tp2": 1}.get(name, 0)
    losses, params, _ = _jax_run(SAT, tpm.V, trainable, frozen, None, _batch(tpm.V), n, mp)
    for r, rank in enumerate(got):
        res = rank[case]
        loss_rel = np.abs(np.array(res["losses"]) - losses).max() / np.abs(losses).max()
        prel = _rel(res["params"], params)
        print(f"{name} rank {r}: losses {res['losses']} vs JAX {losses}: {loss_rel:.2e} relative; params "
              f"{prel:.2e} of scale")
        assert loss_rel <= LOSS_RTOL_JAX and prel <= PARAM_JAX
        split = mp > 1
        assert res["local_shapes"]["embed"] == (tpm.V // (2 if split else 1), SAT["embed_size"])
        assert res["local_shapes"]["classifier.w"] == (SAT["embed_size"], tpm.V // (2 if split else 1))


def test_two_ranks_equal_one_rank(two_ranks):
    """Each 2-rank case against the same case in one process: the losses,
    the params, the logits of the first forward; with images, the crop and
    flip of the global batch."""
    cases, _, out = two_ranks
    for i, case in enumerate(cases):
        one = ranks.train_case(dict(case, mp=1), 1)
        for r in range(2):
            res = out[r]["train"][i]
            loss_rel = np.abs(np.array(res["losses"]) - one["losses"]).max() / np.abs(one["losses"]).max()
            prel = _rel(res["params"], one["params"])
            lrel = np.abs(res["logits"] - one["logits"]).max() / np.abs(one["logits"]).max()
            print(f"case {i} (mp {case['mp']}) rank {r}: losses {loss_rel:.2e} relative, params {prel:.2e} of "
                  f"scale, first logits {lrel:.2e} of scale")
            assert loss_rel <= LOSS_RTOL and prel <= PARAM_REL and lrel <= PARAM_REL
            assert res["tokens"] == one["tokens"] == 4 * 6 + 2 * 2 + 2 * 1


def test_show_tell_batch_norm_under_dp2(two_ranks):
    """The running statistics of the global batch: each rank's against one
    device's and the JAX mesh's; the ranks hold 24 and 7 tokens."""
    jm, trainable, stats, _ = _st_weights()
    cases, _, out = two_ranks
    one = ranks.train_case(cases[3], 1)
    losses, params, jstats = _jax_run(ST, tst.V, trainable, None, stats, cases[3]["batch"], 2, 1)
    for r in range(2):
        res = out[r]["train"][3]
        for k in ("mean", "var"):
            for want, what in ((one["stats"][k], "one device"), (jstats[k], "JAX DP=2")):
                rel = np.abs(res["stats"][k] - want).max() / np.abs(want).max()
                print(f"rank {r} BatchNorm {k} vs {what}: {rel:.2e} of scale")
                assert rel <= STATS_REL
        assert np.abs(np.array(res["losses"]) - losses).max() / np.abs(losses).max() <= LOSS_RTOL_JAX
        assert _rel(res["params"], params) <= PARAM_JAX


# --- serving ------------------------------------------------------------------------


def test_captioner_over_two_ranks_matches_one_device(two_ranks):
    _, spec, out = two_ranks
    cfg = Config(**spec["cfg"])
    vocab = Vocabulary.from_words(spec["words"])
    one = Captioner(cfg, ranks.model_with(cfg, len(vocab), spec["weights"]), None, vocab, device="cpu",
                    bucket_sizes=spec["buckets"])
    images = spec["images"]
    want = {mode: one.caption_images(images, mode=mode) for mode in ("beam", "greedy", "sample")}
    nbest = one.caption_nbest(images)
    caps, alphas = one.caption_with_attention(images)
    for r in range(2):
        got = out[r]["serve"]
        for mode in want:
            assert got[mode] == want[mode], (r, mode)
        assert got["nbest"] == [[c for c, _ in alts] for alts in nbest]
        np.testing.assert_allclose(got["nbest_scores"], [[s for _, s in alts] for alts in nbest], rtol=1e-5)
        assert got["attention"][0] == caps
        np.testing.assert_allclose(got["attention"][1], alphas, rtol=0, atol=1e-6)


def test_captioner_bucket_rules_over_a_mesh(two_ranks):
    """As ``tests/test_serve.py``: explicit buckets must divide the data
    axis; the default ones are rounded up to it and still caption."""
    for r in range(2):
        got = two_ranks[2][r]["serve"]
        assert "divisible" in got["odd_bucket"]
        assert got["auto_buckets"] == [2, 8, 32, 128, 256] and len(got["auto_greedy"]) == 3


# --- multi-host input and the process group --------------------------------------------


def test_host_shard_partitions_records_as_jax():
    recs = [{"split": "train", "imgid": i, "cocoid": i, "file_path": f"{i}.png", "final_caption": ["w"] * 3}
            for i in range(12)]
    for n in (1, 3):
        for i in range(n):
            got = CocoCaptionDataset(recs, Vocabulary.from_words(["w"]), host_shard=(i, n)).data
            want = JDataset(recs, JVocabulary.from_words(["w"]), host_shard=(i, n)).data
            assert [r["imgid"] for r in got] == [r["imgid"] for r in want] == list(range(12))[i::n]


def test_initialize_without_arguments_is_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.host_shard_info() == distributed.host_shard_info(2) == (0, 1)


def test_initialize_raises_on_explicit_arguments_that_cannot_hold(monkeypatch, tmp_path):
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(ValueError, match="process 5 of 2"):
        distributed.initialize(store, num_processes=2, process_id=5, backend="gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        distributed.initialize(store, num_processes=2, process_id=1, backend="nccl")
    # two ranks on a host with one card: NCCL refuses, the message names gloo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        distributed.initialize(store, num_processes=2, process_id=1, backend="nccl")
    assert not torch.distributed.is_initialized()


# --- end to end --------------------------------------------------------------------


def _corpus(root):
    caption_json, images_root = write_corpus(root, n_train=16, n_val=4, sents=1, img_hw=(40, 44))
    vocab_path, data_json = run_preprocess("torch", os.path.join(root, "pre"), caption_json, images_root,
                                           resize=False)
    records = json.load(open(data_json))
    npz = features_npz(os.path.join(root, "feats.npz"), records, seed=3)
    return dict(data_json=data_json, vocab_path=vocab_path, features_path=npz)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``cli.main`` on a tiny corpus of features at num_devices 1 and 2 (the
    second starts two CPU ranks), 2 epochs of 4 steps, a gate every 2."""
    root = str(tmp_path_factory.mktemp("cli"))
    kw = dict(SAT, **_corpus(root), batch_size=4, num_buckets=1, num_workers=2, max_epochs=2,
              save_checkpoint_every=2, log_step=2, learning_rate=LR)
    one = cli_main.main(Config(**kw, expr_dir=os.path.join(root, "one")), device="cpu")
    two = cli_main.main(Config(**kw, num_devices=2, expr_dir=os.path.join(root, "two")), device="cpu")
    return kw, one, two, os.path.join(root, "two", "default", "showattendtell")


def test_cli_main_two_devices_matches_one(cli_runs):
    kw, one, two, expr = cli_runs
    assert two is None
    infos, want = ckpt.load_infos(expr), ckpt.load_infos(one.cfg.expr_dir)
    assert (infos["total_iter"], infos["epoch"]) == (want["total_iter"], want["epoch"]) == (8, 2)
    got_l, want_l = [infos["loss_history"][k] for k in sorted(want["loss_history"])], \
        [want["loss_history"][k] for k in sorted(want["loss_history"])]
    print(f"cli.main gate losses, 2 ranks {got_l} vs 1 {want_l}")
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for k, v in want["val_result_history"].items():
        assert infos["val_result_history"][k]["loss"] == pytest.approx(v["loss"], rel=1e-5)
    blob = torch.load(os.path.join(expr, "state-last.pt"), weights_only=True)
    params = {k: v.numpy() for k, v in blob["params"].items()}
    prel = _rel(params, {k: v.detach().numpy() for k, v in one.state.params.items()})
    print(f"cli.main final params, 2 ranks vs 1: {prel:.2e} of scale")
    assert prel <= PARAM_REL
    # rank 0 alone wrote: its log has the saves, rank 1's has none
    logs = {n: open(os.path.join(expr, n)).read() for n in ("log.txt", "log.proc1.txt")}
    assert "model saved to" in logs["log.txt"] and "model saved to" not in logs["log.proc1.txt"]
    assert "rank 1 of 2" in logs["log.proc1.txt"]
    assert os.path.exists(os.path.join(expr, "model-best.pt"))


def test_resume_at_model_parallel_two(cli_runs, tmp_path):
    """The 2-rank run's ``state-last.pt`` resumed by a Trainer at
    model_parallel 2 (TP=2: each rank restores its slices of the params and
    of Adam's moments) and by one device, for a third epoch of the same
    batches: the restored state gathers back to the file bit for bit, and
    the two continue alike."""
    kw, _, _, expr = cli_runs
    records = json.load(open(kw["data_json"]))
    V = len(Vocabulary.load(kw["vocab_path"]))
    npz = np.load(kw["features_path"])
    train = [r for r in records if r["split"] == "train"][:8]
    ds = CocoCaptionDataset(train, Vocabulary.load(kw["vocab_path"]), "train", num_buckets=1)
    caps, lens = ds.encode_indices(range(8), ds.buckets[0]["pad_len"])
    batches = [{"captions": caps[i:i + 4], "lengths": lens[i:i + 4],
                "features": np.stack([npz[str(r["cocoid"])] for r in train[i:i + 4]])} for i in (0, 4)]
    base = {k: v for k, v in kw.items() if k not in ("data_json", "features_path")}
    spec = dict(V=V, batches=batches, cfg=dict(base, max_epochs=3, start_from=expr, num_devices=2, model_parallel=2,
                                               expr_dir=str(tmp_path / "tp")))
    two = ranks.run("resume", 2, str(tmp_path / "ranks"), spec)
    one = ranks.resume(0, 1, dict(spec, cfg=dict(spec["cfg"], num_devices=1, model_parallel=1,
                                                  expr_dir=str(tmp_path / "one"))))
    saved = torch.load(os.path.join(expr, "state-last.pt"), weights_only=True)
    for r in range(2):
        assert two[r]["restored"].keys() == saved["params"].keys()
        assert all(np.array_equal(two[r]["restored"][k], saved["params"][k].numpy()) for k in saved["params"])
        assert two[r]["local_shapes"]["embed"] == (V // 2, SAT["embed_size"])
        assert two[r]["step"] == one["step"] == 8 + 2
        print(f"resume at TP=2, rank {r}: losses {two[r]['losses']} vs one device {one['losses']}")
        np.testing.assert_allclose(two[r]["losses"], one["losses"], rtol=1e-5)
        assert _rel(two[r]["params"], one["params"]) <= 1e-5
