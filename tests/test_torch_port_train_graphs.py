"""PyTorch port: the train step's CUDA graphs (``train.graphs``), which
replay the teacher-forced forward and its backward per padded shape.

On the CPU: the rule that decides when the graphs engage
(``TrainStep.graphable``) takes the eager path for CPU tensors, a mesh
across processes, scheduled sampling and dropout; ``__call__`` reaches its
four phases through the instance, in order, as the benchmark's timers
patch them; and the eager step's loss and gradients are those of the
model's own calls. On the card (``card`` marker; skips without a CUDA
device): the graphed step against the eager one over 3 steps at two padded
lengths, for both models in bf16 and fp32, bit for bit.

The module imports nothing of JAX, so on a machine without JAX run it
without ``tests/conftest.py``:
``python -m pytest --noconftest tests/test_torch_port_train_graphs.py -q``.
"""

import types

import pytest
import torch

from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.obs import profiler
from show_and_tell_tpu_torch.train.losses import masked_cross_entropy
from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step

V, B, L = 40, 3, 4
MODELS = ["show_attend_tell", "show_tell"]
# the card's shapes: widths the kernels' fast designs take, two padded lengths
CARD = {"V": 200, "B": 96, "E": 128, "H": 128, "T": (12, 8)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none. Decided here,
    never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _model(name, device="cpu", dtype="float32", E=16, H=24, V=V):
    cfg = Config(model=name, embed_size=E, hidden_size=H, crop_size=32, dtype=dtype)
    return cfg, build_model(cfg, V, device=device, generator=torch.Generator().manual_seed(7))


def _batch(name, T, seed, device="cpu", B=B, V=V):
    """Features of the model's kind, captions from <start>, lengths from T
    down to 2."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.rand((B, L, 512) if name == "show_attend_tell" else (B, 2048), generator=g)
    caps = torch.cat([torch.ones(B, 1, dtype=torch.long), torch.randint(4, V, (B, T - 1), generator=g)], 1)
    lens = torch.linspace(T, 2, B).round().long()
    return {k: v.to(device) for k, v in {"features": feats, "captions": caps, "lengths": lens}.items()}


def test_graphs_engage_only_on_cuda_without_mesh_sampling_or_dropout():
    """The rule reads the features' device, the mesh, ss_prob and the
    model's dropout. A stand-in for CUDA features (only ``is_cuda`` is
    read) shows each condition alone; a CPU step runs eagerly, counted as
    such, and makes no graph."""
    cfg, model = _model("show_attend_tell")
    step = make_train_step(model, cfg)
    on_card = types.SimpleNamespace(is_cuda=True)
    assert step.graphable(on_card, 0.0)
    assert not step.graphable(torch.zeros(1), 0.0)
    assert not step.graphable(on_card, 0.25)
    assert not step.graphable(on_card, torch.tensor(0.0))  # the per-step path
    step.mesh = types.SimpleNamespace(distributed=True)
    assert not step.graphable(on_card, 0.0)
    step.mesh = types.SimpleNamespace(distributed=False)
    assert step.graphable(on_card, 0.0)
    step.mesh = None
    model.dropout_rate = 0.5
    assert not step.graphable(on_card, 0.0)
    model.dropout_rate = 0.0
    state = make_train_state(cfg, model)
    with profiler.recording() as rec:
        for i in range(2):
            state, _ = step(state, _batch("show_attend_tell", 6, i), 1e-3)
    assert rec.counters["train.eager_steps"] == 2
    assert rec.counters["train.graph_captures"] == rec.counters["train.graph_replays"] == 0
    assert not step.graphs.pairs


@pytest.mark.parametrize("name", MODELS)
def test_call_reaches_the_phases_through_the_instance_in_order(name):
    """Patched on the instance as ``perfbench/harness/train.py`` patches
    ``features`` and ``backward``, each phase is called once a step, in the
    order features, forward, backward, apply."""
    cfg, model = _model(name)
    step = make_train_step(model, cfg)
    state = make_train_state(cfg, model)
    calls = []

    def patched(phase):
        orig = getattr(step, phase)

        def run(*a, **kw):
            calls.append(phase)
            return orig(*a, **kw)

        return run

    for phase in ("features", "forward", "backward", "apply"):
        setattr(step, phase, patched(phase))
    for i, T in enumerate((6, 5)):
        state, _ = step(state, _batch(name, T, i), 1e-3)
    assert calls == ["features", "forward", "backward", "apply"] * 2


@pytest.mark.parametrize("name", MODELS)
def test_eager_step_gives_the_model_calls_loss_and_gradients(name):
    """On the CPU the step runs eagerly: its loss, token count, gradients
    and (Show-and-Tell) new running statistics are those of the model's
    own calls and ``masked_cross_entropy``, bit for bit."""
    cfg, model = _model(name)
    step = make_train_step(model, cfg)
    state = make_train_state(cfg, model)
    batch = _batch(name, 6, 3)
    feats, caps, lens = batch["features"], batch["captions"], batch["lengths"]
    loss, count = step.forward(feats, batch)
    grads = step.backward(state, loss)
    stats = step.new_stats
    if name == "show_tell":
        emb, want_stats = model.encode(feats, train=True)
        logits, mask = model.decode_train(emb, caps, lens)
    else:
        want_stats = None
        logits, mask, _ = model.decode_train(feats, caps, lens)
    want_loss, want_count = masked_cross_entropy(logits, caps[:, 1:], mask)
    want = torch.autograd.grad(want_loss, list(state.params.values()), allow_unused=True)
    assert torch.equal(loss, want_loss) and torch.equal(count, want_count)
    for (k, g), w in zip(grads.items(), want):
        assert torch.equal(g, torch.zeros_like(g) if w is None else w), k
    if want_stats is None:
        assert stats is None
    else:
        assert set(stats) == set(want_stats) and all(torch.equal(stats[k], want_stats[k]) for k in stats)


def test_fresh_splits_make_the_split_once_a_scope_and_leave_the_memo_alone():
    """Inside ``fresh_splits`` the fp32 cell's W split is made anew, once per
    weight version for the scope, and the memo is neither read nor filled:
    a graph captured inside re-makes it at each replay, where a memo hit
    would replay the split of the version seen at capture."""
    from show_and_tell_tpu_torch.ops import lstm

    w = torch.randn(48, 64)
    memo = lstm.prepared_weight(w)
    assert lstm.prepared_weight(w) is memo
    with lstm.fresh_splits():
        a = lstm.prepared_weight(w)
        assert a is not memo and torch.equal(a, memo) and lstm.prepared_weight(w) is a
        w.add_(1.0)  # a new version within the scope: split again
        b = lstm.prepared_weight(w)
        assert b is not a and torch.equal(b, lstm.tf32x3_weight(w))
    with lstm.fresh_splits():
        assert lstm.prepared_weight(w) is not b
    fresh = lstm.prepared_weight(w)  # the memo, made for the new version only now
    assert fresh is not memo and fresh is lstm.prepared_weight(w) and torch.equal(fresh, b)


def _run(name, dtype, device, graphed):
    """3 steps at each of two padded lengths, in turns, from one init:
    (losses, first moments after the first step, params, running
    statistics, counters, the first step's loss as returned)."""
    cfg, model = _model(name, device, dtype, CARD["E"], CARD["H"], CARD["V"])
    step = make_train_step(model, cfg)
    if not graphed:
        step.graphable = lambda *a, **kw: False
    state = make_train_state(cfg, model)
    batches = [_batch(name, CARD["T"][i % 2], i, device, CARD["B"], CARD["V"]) for i in range(6)]
    losses, first = [], None
    with profiler.recording() as rec:
        for i, batch in enumerate(batches):
            state, m = step(state, batch, cfg.learning_rate)
            losses.append(m["loss"])
            if i == 0:
                first = {k: v.clone() for k, v in state.opt_state["mu"].items()}
                returned, value = m["loss"], m["loss"].clone()
    torch.cuda.synchronize()
    stats = {k: v.clone() for k, v in (state.batch_stats or {}).items()}
    assert torch.equal(returned, value), "a later replay rewrote a loss the step had returned"
    return losses, first, dict(state.params), stats, dict(rec.counters)


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", MODELS)
def test_graphed_step_equals_eager_on_the_card(card, name, dtype):
    """The graphed step against the eager one from one init over the same
    six batches (two padded lengths in turns): every loss, Adam's first
    moment after the first step, the params and the running statistics
    after all six, bit for bit; one capture per length, replays after, no
    eager step. fp32 runs the cell's tf32x3 design, whose split weight the
    graph re-makes at each replay."""
    g_loss, g_first, g_params, g_stats, g_counts = _run(name, dtype, card, graphed=True)
    e_loss, e_first, e_params, e_stats, e_counts = _run(name, dtype, card, graphed=False)
    assert [float(x) for x in g_loss] == [float(x) for x in e_loss]
    for tree_g, tree_e in ((g_first, e_first), (g_params, e_params), (g_stats, e_stats)):
        assert set(tree_g) == set(tree_e)
        assert all(torch.equal(tree_g[k], tree_e[k]) for k in tree_g), [k for k in tree_g
                                                                          if not torch.equal(tree_g[k], tree_e[k])]
    assert g_counts.get("train.graph_captures") == 2 and g_counts.get("train.graph_replays") == 4
    assert not g_counts.get("train.eager_steps")
    assert e_counts.get("train.eager_steps") == 6 and not e_counts.get("train.graph_captures")
