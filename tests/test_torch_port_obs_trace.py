"""PyTorch port: the program's spans and counters (``obs.profiler``) on the
CPU, with tiny models.

Off, a call leaves no ``show_and_tell.*`` range in a profile and counts
nothing; on, the spans nest as documented on one thread, the training step
emits its phases once per step, the outputs are bit-identical, the decode
reads nothing more back from the device, and ``decode.live_row_steps``
equals a count replayed step by step from what the search fed its step
function.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data.transforms import eval_transform
from show_and_tell_tpu_torch.decode import beam
from show_and_tell_tpu_torch.decode.beam import beam_search
from show_and_tell_tpu_torch.decode.greedy import greedy_decode
from show_and_tell_tpu_torch.decode.sample import sample_decode
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.obs import profiler
from show_and_tell_tpu_torch.serve import Captioner
from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step
from show_and_tell_tpu_torch.utils.vocab import END_ID, Vocabulary

SMALL = dict(embed_size=16, hidden_size=24, crop_size=32, max_decode_len=8, beam_size=3)
V = 50
MODELS = ("show_attend_tell", "show_tell")


def _model(name):
    cfg = Config(model=name, **SMALL)
    return cfg, build_model(cfg, V, device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def models():
    return {name: _model(name) for name in MODELS}


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 40, 40, 3), dtype=np.uint8)


def _captioner(cfg, m):
    return Captioner(cfg, m, None, Vocabulary.from_words(f"w{i}" for i in range(4, V)), device="cpu",
                     bucket_sizes=(1, 2, 4))


def _trace(fn, tmp_path):
    """The ``show_and_tell.*`` ranges of ``fn()`` under ``profile_trace``:
    (name, start, end, tid), and ``fn``'s result."""
    d = str(tmp_path / "trace")
    with profiler.profile_trace(d):
        out = fn()
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [(e["name"][len(profiler.PREFIX):], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
             if e.get("ph") == "X" and e.get("name", "").startswith(profiler.PREFIX)]
    return sorted(spans, key=lambda s: (s[1], -s[2])), out


def _parents(spans):
    """Each span's name with the name of the innermost span around it on its
    thread (None at the top)."""
    out, stacks = [], {}
    for name, s, e, tid in spans:
        stack = stacks.setdefault(tid, [])
        while stack and stack[-1][1] < e:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, e))
    return out


def _logging_steps(model, log):
    """``model.decode_state`` whose step function logs the tokens fed to it."""
    orig = model.decode_state

    def decode_state(*a, **kw):
        step_fn, carry, first, tile = orig(*a, **kw)

        def step(c, tok):
            log.append(("step", tok.clone()))
            return step_fn(c, tok)

        return step, carry, first, tile

    return decode_state


def test_spans_and_counters_are_off_without_a_recording(models, tmp_path):
    assert profiler.active is None
    assert profiler.span("decode") is profiler.span("trunk.copy")  # one shared no-op context
    with profiler.recording() as closed:
        pass
    cap = _captioner(*models["show_attend_tell"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cap.caption_images(_images(6), mode="beam")
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        names = [e.get("name", "") for e in json.load(fh)["traceEvents"]]
    assert names and not any(n.startswith(profiler.PREFIX) for n in names)
    assert dict(closed.counters) == {}


@pytest.mark.parametrize("name", MODELS)
def test_serving_spans_nest_on_one_thread(models, name, tmp_path, monkeypatch):
    cfg, m = models[name]
    cap = _captioner(cfg, m)
    log = []
    monkeypatch.setattr(m, "decode_state", _logging_steps(m, log))
    spans, _ = _trace(lambda: cap.caption_images(_images(6), mode="beam"), tmp_path)
    assert len({tid for *_, tid in spans}) == 1
    parents = _parents(spans)
    want = {
        "serve.call": {None}, "serve.chunk": {"serve.call"}, "trunk": {"serve.chunk"},
        "trunk.copy": {"trunk"}, "trunk.transform": {"trunk"}, "trunk.backbone": {"trunk"},
        "decode": {"serve.chunk"}, "decode.prepare": {"decode"}, "decode.step": {"decode"},
        "decode.select": {"decode"}, "decode.sync": {"decode"},
        # the last chunk's strings are read after the chunk loop
        "strings": {"serve.chunk", "serve.call"}, "strings.wait": {"strings"},
        "op.lstm_cell": {"decode.step", "decode.prepare"},
        "op.attention_beam": {"decode.step"},
    }
    if name == "show_tell":
        del want["op.attention_beam"]
    assert {n for n, _ in parents} == set(want)
    for n, p in parents:
        assert p in want[n], (n, p)
    count = {n: sum(1 for s, _ in parents if s == n) for n in want}
    assert count["serve.call"] == 1 and count["serve.chunk"] == 2  # chunks of 4 and 2
    assert count["decode"] == count["trunk"] == count["strings"] == count["strings.wait"] == 2
    assert count["decode.step"] == len(log) > 2
    assert ("strings", "serve.chunk") in parents


def test_the_train_step_emits_its_phases_once_per_step(tmp_path):
    cfg, m = _model("show_attend_tell")
    state, step = make_train_state(cfg, m), make_train_step(m, cfg)
    g = torch.Generator().manual_seed(1)
    B, T = 4, 6
    batch = {"images": torch.randint(0, 256, (B, 36, 36, 3), dtype=torch.uint8, generator=g),
             "captions": torch.randint(4, V, (B, T), generator=g), "lengths": torch.full((B,), T)}

    def two_steps():
        for _ in range(2):
            step(state, batch, 1e-3, generator=torch.Generator().manual_seed(2))

    spans, _ = _trace(two_steps, tmp_path)
    parents = [(n, p) for n, p in _parents(spans) if n.startswith("train.")]
    for n, p in (("train.step", None), ("train.features", "train.step"), ("train.forward", "train.step"),
                 ("train.backward", "train.step"), ("train.apply", "train.step"),
                 ("train.apply.sync", "train.apply")):
        assert parents.count((n, p)) == 2, n
    assert len(parents) == 12


def test_recording_changes_no_training_number():
    cfg, _ = _model("show_attend_tell")
    g = torch.Generator().manual_seed(1)
    B, T = 4, 6
    batch = {"images": torch.randint(0, 256, (B, 36, 36, 3), dtype=torch.uint8, generator=g),
             "captions": torch.randint(4, V, (B, T), generator=g), "lengths": torch.full((B,), T)}
    runs = []
    for on in (False, True):
        _, m = _model("show_attend_tell")
        state, step = make_train_state(cfg, m), make_train_step(m, cfg)
        with profiler.recording() if on else contextlib.nullcontext():
            metrics = [step(state, batch, 1e-3, generator=torch.Generator().manual_seed(2))[1] for _ in range(2)]
        runs.append((metrics, {k: v.detach().clone() for k, v in state.params.items()}))
    (m_off, p_off), (m_on, p_on) = runs
    for a, b in zip(m_off, m_on):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(p_off[k], p_on[k]) for k in p_off)


def _decode(m, cfg, mode, feats):
    """(ids, scores or None) of one decode straight from the model."""
    B = feats.shape[0]
    k = cfg.beam_size if mode == "beam" else 1
    with torch.no_grad():
        step_fn, carry, first, tile = m.decode_state(feats, beam_size=k)
        if mode == "beam":
            return beam_search(step_fn, carry, B, beam_size=k, max_len=cfg.max_decode_len, first_logits=first,
                               tile=tile, return_all=True)
        if mode == "sample":
            return sample_decode(step_fn, carry, B, torch.Generator().manual_seed(5), cfg.max_decode_len,
                                 temperature=0.8, top_k=10, first_logits=first), None
        return greedy_decode(step_fn, carry, B, cfg.max_decode_len, first_logits=first), None


def _features(m, cfg, n=5):
    with torch.no_grad():
        return m.backbone_features(eval_transform(torch.from_numpy(_images(n, seed=3)), cfg.crop_size))


def _replayed_live(B, k, log, first_emitted):
    """The rows not ended before each call of the step function, replayed on
    the host from the tokens fed to it and, for beam, the parents that each
    selection gathered, in the order the search made them. ``first_emitted``:
    the first call's input is a word already emitted (Show-and-Tell), not
    ``<start>``."""
    fin = np.zeros((B, k), bool)
    live, calls = 0, 0
    for kind, t in log:
        if kind == "gather":
            fin = np.take_along_axis(fin, t.numpy(), axis=1)
            continue
        if calls or first_emitted:
            fin |= t.numpy().reshape(B, k) == END_ID
        live += int((~fin).sum())
        calls += 1
    return live, calls


@pytest.mark.parametrize("mode", ["beam", "greedy", "sample"])
@pytest.mark.parametrize("name", MODELS)
def test_recording_changes_no_output(models, name, mode):
    cfg, m = models[name]
    feats = _features(m, cfg)
    off = _decode(m, cfg, mode, feats)
    with profiler.recording() as rec:
        on = _decode(m, cfg, mode, feats)
    for a, b in zip(off, on):
        assert (a is None and b is None) or torch.equal(a, b)
    assert rec.counters["decode.row_steps"] > 0


def _toy(B, first, end_bias):
    """A step function whose rows end at different steps: (step_fn, carry
    [B, V], first logits or None)."""
    g = torch.Generator().manual_seed(7)
    emb, h0 = torch.randn(V, V, generator=g), torch.randn(B, V, generator=g)

    def step_fn(h, tok):
        h = torch.tanh(h + emb[tok])
        logits = 3.0 * h
        logits[:, END_ID] += end_bias
        return h, logits

    return step_fn, h0, 3.0 * torch.tanh(h0) if first else None


@pytest.mark.parametrize("mode", ["beam", "greedy", "sample"])
@pytest.mark.parametrize("first", [False, True], ids=["from_start", "first_logits"])
def test_live_row_steps_equal_a_replay(mode, first, monkeypatch):
    B, k, T = 6, (3 if mode == "beam" else 1), 10
    step_fn, h0, first_logits = _toy(B, first, end_bias=1.5)
    log = []
    orig_gather = beam._gather_beams

    def gather(tree, parent, B, k):
        log.append(("gather", parent.clone()))
        return orig_gather(tree, parent, B, k)

    def logged(c, tok):
        log.append(("step", tok.clone()))
        return step_fn(c, tok)

    monkeypatch.setattr(beam, "_gather_beams", gather)
    with profiler.recording() as rec:
        if mode == "beam":
            beam_search(logged, h0, B, beam_size=k, max_len=T, first_logits=first_logits)
        elif mode == "sample":
            sample_decode(logged, h0, B, torch.Generator().manual_seed(5), T, first_logits=first_logits)
        else:
            greedy_decode(logged, h0, B, T, first_logits=first_logits)
    live, calls = _replayed_live(B, k, log, first)
    assert rec.counters["decode.row_steps"] == B * k * calls
    assert rec.counters["decode.live_row_steps"] == live
    assert 0 < live < B * k * calls  # some rows ended early, not all


def test_recording_reads_nothing_more_back_from_the_device(models, monkeypatch):
    cfg, m = models["show_attend_tell"]
    feats = _features(m, cfg)
    reads = []
    for attr in ("__bool__", "item", "tolist", "__int__", "__float__"):
        orig = getattr(torch.Tensor, attr)

        def wrapped(self, *a, _orig=orig, _attr=attr, **kw):
            reads.append(_attr)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, attr, wrapped)
    _decode(m, cfg, "beam", feats)
    off = list(reads)
    reads.clear()
    with profiler.recording() as rec:
        _decode(m, cfg, "beam", feats)
        during = list(reads)
        before_close = rec.counters["decode.live_row_steps"]  # the call from <start> alone
    assert during == off and off
    assert before_close == feats.shape[0] * cfg.beam_size
    assert rec.counters["decode.live_row_steps"] > before_close
