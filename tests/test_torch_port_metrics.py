"""PyTorch port, the metric suite against the JAX package's on the CPU.

The port keeps its own copy of ``metrics/`` and of the ctypes loader, which
builds the repository's ``csrc/*.cpp`` into
``show_and_tell_tpu_torch/_build/native/``. The same corpus goes through
both packages, and every score, corpus and per image, must be equal: no
tolerance (NaN equals NaN in SPICE's subcategory dicts). Each scorer with a
C++ path runs once forced to it in both packages and once forced to the
pure-Python path, as ``tests/test_native.py`` forces them.

The corpus: 64 images with 5 references and one candidate each, drawn from
a 40-word vocabulary, 3-15 words long, plus one image per edge string of
``tests/test_native.py``'s ``CORPUS`` (punctuation, contractions,
non-ASCII, empty), whose references are the other edge strings.
"""

import gzip
import json
import math
import os
import shutil

import numpy as np
import pytest

from test_ingest import PARA_FIXTURE, WN_S_FIXTURE
from test_native import CORPUS, _ensure_built
from show_and_tell_tpu.metrics import bleu as jbleu
from show_and_tell_tpu.metrics import cider as jcider
from show_and_tell_tpu.metrics import coco as jcoco
from show_and_tell_tpu.metrics import ingest as jingest
from show_and_tell_tpu.metrics import meteor as jmeteor
from show_and_tell_tpu.metrics import orchestrator as jorch
from show_and_tell_tpu.metrics import paraphrases as jpara
from show_and_tell_tpu.metrics import rouge as jrouge
from show_and_tell_tpu.metrics import spice as jspice
from show_and_tell_tpu.metrics import synonyms as jsyn
from show_and_tell_tpu.metrics import tokenizer as jtok
from show_and_tell_tpu_torch.metrics import bleu, cider, coco, ingest, meteor, orchestrator
from show_and_tell_tpu_torch.metrics import paraphrases, rouge, spice, synonyms, tokenizer
from show_and_tell_tpu_torch.utils import native

WORDS = (
    "a the man woman dog cat horse bike red blue big small two on in near "
    "with riding sitting standing running table street park beach grass "
    "field car bus tree water next to of and is are holding young group"
).split()
N_IMAGES, N_REFS = 64, 5

# scorer -> (JAX module, port module, factory by module, its C++ library)
SCORERS = {
    "bleu": (jbleu, bleu, lambda mod: mod.Bleu(4), "libbleu.so"),
    "meteor": (jmeteor, meteor, lambda mod: mod.Meteor(), "libmeteor.so"),
    "rouge": (jrouge, rouge, lambda mod: mod.Rouge(), "librouge.so"),
    "cider": (jcider, cider, lambda mod: mod.Cider(), "libcider.so"),
}
PATHS = ("native", "python")


def _raw_corpus(seed=0):
    """(gts, res): image id -> raw strings."""
    rng = np.random.default_rng(seed)

    def sentence():
        return " ".join(rng.choice(WORDS, int(rng.integers(3, 16))))

    gts = {i: [sentence() for _ in range(N_REFS)] for i in range(N_IMAGES)}
    res = {i: [sentence()] for i in range(N_IMAGES)}
    n = len(CORPUS)
    for j, text in enumerate(CORPUS):
        gts[N_IMAGES + j] = [CORPUS[(j + d) % n] for d in range(1, N_REFS)] + [sentence()]
        res[N_IMAGES + j] = [text]
    return gts, res


def _tokenized(seed=0):
    """The corpus as COCOEvalCap hands it to the scorers: PTB-tokenized."""
    gts, res = _raw_corpus(seed)
    tok = jtok.PTBTokenizer()
    wrap = lambda d: {i: [{"caption": c} for c in caps] for i, caps in d.items()}  # noqa: E731
    return tok.tokenize(wrap(gts)), tok.tokenize(wrap(res))


def _assert_same(want, got, where="score"):
    """Exact equality through dicts, sequences and arrays; NaN equals NaN."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_same(want[k], got[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple, np.ndarray)):
        assert len(got) == len(want), where
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_same(w, g, f"{where}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), (where, want, got)
    else:
        assert got == want, (where, want, got)


def _need_compiler():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the native scorers cannot be built")


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """Force every scorer of both packages onto one path. "native" asserts
    that both packages loaded their C++ library."""
    if request.param == "native":
        _need_compiler()
        for jmod, pmod, _, lib in SCORERS.values():
            assert _ensure_built(lib), f"csrc/{lib} did not build"
            assert jmod._cpp_available() and pmod._cpp_available(), lib
        assert _ensure_built("libptb_tokenizer.so")
        assert jtok._cpp_tokenizer_available() and tokenizer._cpp_tokenizer_available()
    else:
        for jmod, pmod, _, _ in SCORERS.values():
            monkeypatch.setattr(jmod, "_cpp_available", lambda: False)
            monkeypatch.setattr(pmod, "_cpp_available", lambda: False)
    return request.param


def test_ptb_tokenizer_matches_jax(path):
    gts, res = _raw_corpus()
    corpus = {i: [{"caption": c} for c in gts[i] + res[i]] for i in gts}
    use_cpp = path == "native"
    want = jtok.PTBTokenizer().tokenize(corpus, use_cpp=use_cpp)
    got = tokenizer.PTBTokenizer().tokenize(corpus, use_cpp=use_cpp)
    _assert_same(want, got)


@pytest.mark.parametrize("scorer", list(SCORERS))
def test_scorer_matches_jax_exactly(scorer, path):
    jmod, pmod, make, _ = SCORERS[scorer]
    gts, res = _tokenized()
    want = make(jmod).compute_score(gts, res)
    got = make(pmod).compute_score(gts, res)
    _assert_same(want[0], got[0], f"{scorer} corpus")
    _assert_same(want[1], got[1], f"{scorer} per image")
    assert len(got[1] if scorer != "bleu" else got[1][0]) == len(gts)


def test_spice_matches_jax_exactly():
    """SPICE has no C++ path; the port installs its own built-in backend."""
    gts, res = _tokenized()
    want = jspice.Spice().compute_score(gts, res)
    got = spice.Spice().compute_score(gts, res)
    _assert_same(want[0], got[0], "SPICE corpus")
    _assert_same(want[1], got[1], "SPICE per image")
    assert any(math.isnan(s[c]["f"]) for s in got[1] for c in s)  # NaN categories were compared
    assert spice._BACKEND is not jspice._BACKEND


def _ann_file(tmp_path):
    gts, res = _raw_corpus(seed=1)
    ann = {
        "images": [{"id": 1000 + i} for i in gts],
        "annotations": [
            {"image_id": 1000 + i, "id": 10 * i + k, "caption": c}
            for i, caps in gts.items() for k, c in enumerate(caps)
        ],
    }
    p = tmp_path / "captions.json"
    p.write_text(json.dumps(ann))
    return str(p), [{"image_id": 1000 + i, "caption": caps[0]} for i, caps in res.items()]


def test_coco_eval_cap_matches_jax(tmp_path, path):
    ann, preds = _ann_file(tmp_path)
    evals = []
    for cmod, omod in ((jcoco, jorch), (coco, orchestrator)):
        c = cmod.COCO(ann)
        r = c.loadRes(preds)
        e = omod.COCOEvalCap(c, r)
        e.params["image_id"] = r.getImgIds()
        e.evaluate()
        evals.append(e)
    want, got = evals
    assert set(got.eval) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"}
    _assert_same(want.eval, got.eval, "eval")
    _assert_same(want.imgToEval, got.imgToEval, "imgToEval")
    _assert_same(want.evalImgs, got.evalImgs, "evalImgs")


@pytest.mark.parametrize("loader,fixture,kw,gz", [
    ("load_wordnet_synsets", WN_S_FIXTURE, {}, False),
    ("load_wordnet_synsets", WN_S_FIXTURE, {}, True),
    ("load_wordnet_synsets", WN_S_FIXTURE, {"parts": ("n",)}, False),
    ("load_wordnet_synsets", WN_S_FIXTURE, {"include_collocations": True}, False),
    ("load_paraphrase_en", PARA_FIXTURE, {}, False),
    ("load_paraphrase_en", PARA_FIXTURE, {"min_prob": 0.5}, True),
])
def test_ingest_loaders_match_jax(tmp_path, loader, fixture, kw, gz):
    p = tmp_path / "table.data"
    if gz:
        with gzip.open(p, "wt") as fh:
            fh.write(fixture)
    else:
        p.write_text(fixture)
    want = getattr(jingest, loader)(str(p), **kw)
    got = getattr(ingest, loader)(str(p), **kw)
    assert got == want and len(got) > 0


# table -> (module of each package, its setter, a pair that the default
# table scores above the swapped one)
TABLES = {
    "synonyms": ((jsyn, synonyms), "set_synonym_groups", ("a kitty", ["a cat"]), [("cat", "feline")]),
    "paraphrases": ((jpara, paraphrases), "set_paraphrase_groups",
                    ("a dog beside a car", ["a dog next to a car"]), [("on top of", "atop")]),
}


@pytest.mark.parametrize("swapped", ["port", "jax"])
@pytest.mark.parametrize("table", list(TABLES))
def test_table_swap_stays_in_its_package(table, swapped):
    """The two packages' native METEOR are separate libraries: a table swap
    in one leaves the other's C++ (and Python) scores as they were."""
    _need_compiler()
    assert _ensure_built("libmeteor.so")
    assert jmeteor._cpp_available() and meteor._cpp_available()
    assert jmeteor._CPP_LIB._handle != meteor._CPP_LIB._handle
    (jtab, ptab), setter, (hyp, refs), groups = TABLES[table]
    mods = {"jax": (jtab, jmeteor), "port": (ptab, meteor)}
    other = "jax" if swapped == "port" else "port"
    tab, met = mods[swapped]
    otab, omet = mods[other]

    def scores(m):
        m._cpp_sync_tables()
        return m._cpp_meteor_sentence(hyp, refs), m.meteor_sentence(hyp, refs)

    base, obase = scores(met), scores(omet)
    assert base == obase
    default = tab.active_groups()
    try:
        getattr(tab, setter)(groups)
        after = scores(met)
        assert after[0] == after[1] < base[0]  # the swap took effect where it was made
        assert scores(omet) == obase  # and nowhere else
    finally:
        getattr(tab, setter)(default)
        met._cpp_sync_tables()
    assert scores(met) == base


def test_native_loader_builds_and_loads_only_from_its_build_dir():
    _need_compiler()
    assert native.status() == {s: "native" for s in native.SCORERS}
    for soname, lib in native._LIBS.items():
        assert os.path.dirname(lib._name) == native.BUILD_DIR, lib._name
        assert os.path.basename(lib._name).startswith(soname[:-3] + "-")
    assert native.BUILD_DIR.endswith(os.path.join("show_and_tell_tpu_torch", "_build", "native"))


def test_native_loader_does_not_latch_a_missing_build(tmp_path, monkeypatch):
    """Without a compiler the probe says None and caches nothing; once one
    is there, the next probe builds and loads."""
    _need_compiler()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert native.load_csrc_lib("librouge.so", rouge._configure_cpp) is None
    assert native._LIBS == {} and not os.path.exists(native.lib_path("librouge.so"))
    monkeypatch.delenv("CXX")
    lib = native.load_csrc_lib("librouge.so", rouge._configure_cpp)
    assert lib is not None and lib._name == native.lib_path("librouge.so")
    assert native.load_csrc_lib("librouge.so") is lib


def test_status_reports_the_python_path_when_forced(monkeypatch):
    for name in ("bleu", "cider"):
        monkeypatch.setattr(SCORERS[name][1], "_cpp_available", lambda: False)
    monkeypatch.setattr(tokenizer, "_cpp_tokenizer_available", lambda: False)
    st = native.status()
    assert st["bleu"] == st["cider"] == st["tokenizer"] == "python"
    assert set(st) == set(native.SCORERS)
