"""PyTorch port, sampling (temperature, top-k, top-p) against the JAX package
on the CPU.

The two frameworks draw different random numbers, so sampling is held two
ways: exactly where it is deterministic (top-k 1, or a top-p that keeps one
token, equals greedy), and on distributions (20,000 draws from fixed logits
against the filtered softmax computed in numpy, to which the JAX package's
sampler is held too). The Captioner's per-chunk streams behave as the JAX
package's tests pin them: the counter advances per sampled image, a fresh
Captioner replays, warmup leaves the counter alone, and ``caption_paths``'
chunks equal one whole call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_model as tpm
from show_and_tell_tpu.config import Config as JConfig
from show_and_tell_tpu.decode import sample as jsample
from show_and_tell_tpu.decode.greedy import greedy_decode as jgreedy
from show_and_tell_tpu.serve import Captioner as JCaptioner
from show_and_tell_tpu.utils import vocab as jvocab
from show_and_tell_tpu_torch.ckpt.convert import from_jax_params
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.decode import sample
from show_and_tell_tpu_torch.decode.dispatch import decode_ids
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.serve import Captioner
from show_and_tell_tpu_torch.utils import vocab as tvocab

SMALL = dict(tpm.SMALL, beam_size=3)
WORDS = [f"w{i}" for i in range(tpm.V - 4)]
N_DRAWS = 20_000
TV_LIMIT = 0.02


@pytest.fixture(scope="module")
def captioners():
    """The JAX and the port Captioner over the same random weights."""
    trainable, frozen = tpm._jax_init(3)
    jcfg, cfg = JConfig(**SMALL), Config(**SMALL)
    jcap = JCaptioner(jcfg, tpm.jbuild(jcfg, tpm.V), trainable, frozen, jvocab.Vocabulary.from_words(WORDS),
                      bucket_sizes=(1, 2, 4))
    tcap = Captioner(cfg, build_model(cfg, tpm.V, device="cpu"), from_jax_params(trainable, frozen),
                     tvocab.Vocabulary.from_words(WORDS), device="cpu", bucket_sizes=(1, 2, 4))
    return jcap, tcap


def _fresh(**kw):
    cap = Captioner.from_checkpoint(Config(**SMALL), None, tvocab.Vocabulary.from_words(WORDS), device="cpu",
                                    bucket_sizes=kw.pop("bucket_sizes", (4,)))
    for k, v in kw.items():
        setattr(cap, k, v)
    return cap


def _images(n=4, seed=0, size=40):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("knob", [{"top_k": 1}, {"top_p": 1e-6}], ids=["top_k_1", "top_p_1e-6"])
def test_one_kept_token_samples_jax_greedy(captioners, knob):
    """top_k=1, or a top_p below any probability, keeps the argmax alone:
    the port's sampled captions are the JAX package's greedy captions, at a
    temperature that would otherwise spread the draws."""
    jcap, tcap = captioners
    images = _images(n=5, seed=3)
    want = jcap.caption_images(images, mode="greedy")
    tcap.temperature, tcap.top_k, tcap.top_p = 2.0, knob.get("top_k", 0), knob.get("top_p", 1.0)
    try:
        assert tcap.caption_images(images, mode="sample") == want
    finally:
        tcap.temperature, tcap.top_k, tcap.top_p = 1.0, 0, 1.0
    assert any(want)


def test_sample_counter_advances_and_a_fresh_captioner_replays():
    images = _images()
    cap = _fresh(temperature=1.5)
    first = cap.caption_images(images, mode="sample")
    assert len(first) == 4 and cap._sample_count == 4
    second = cap.caption_images(images, mode="sample")
    assert cap._sample_count == 8
    assert second != first, "the counter moved: the second call draws from other streams"
    assert _fresh(temperature=1.5).caption_images(images, mode="sample") == first
    # a rebuilt Captioner continues the sequence through rng_offset
    assert _fresh(temperature=1.5).caption_images(images, mode="sample", rng_offset=4) == second
    # greedy and beam do not move the counter
    cap.caption_images(images, mode="greedy")
    assert cap._sample_count == 8


def test_warmup_leaves_the_sample_counter():
    images = _images(n=2)
    live = _fresh(bucket_sizes=(2, 4)).caption_images(images, mode="sample")
    cap = _fresh(bucket_sizes=(2, 4))
    assert cap.warmup(modes=("sample", "nbest", "attention"), buckets=(2,)) > 0
    assert cap._sample_count == 0
    assert cap.caption_images(images, mode="sample") == live


def test_caption_paths_chunks_equal_one_call(tmp_path):
    """caption_paths reads one largest bucket at a time; the counter gives
    each chunk the streams of one whole caption_images call."""
    from PIL import Image

    images = _images(n=4, seed=1, size=256)
    paths = []
    for i, arr in enumerate(images):
        paths.append(str(tmp_path / f"img{i}.png"))
        Image.fromarray(arr).save(paths[-1])
    whole = _fresh(bucket_sizes=(2,), temperature=2.0).caption_images(images, mode="sample")
    cap = _fresh(bucket_sizes=(2,), temperature=2.0)
    assert cap.caption_paths(paths, mode="sample") == whole
    assert cap._sample_count == 4 and cap.last_errors == []


# --- the sampler on distributions -------------------------------------------


def _numpy_filtered(logits, temperature, top_k, top_p):
    """(kept mask, probabilities) of the JAX package's filters, in numpy."""
    lg = logits.astype(np.float32) / np.float32(temperature)
    kth = np.sort(lg)[-top_k]
    lg = np.where(lg < kth, np.float32(-1e9), lg)
    s = np.sort(lg)[::-1]
    p = np.exp(s - s.max())
    p /= p.sum()
    exclusive = np.cumsum(p) - p
    min_kept = s[exclusive < top_p].min()
    lg = np.where(lg < min_kept, np.float32(-1e9), lg)
    kept = lg > -1e8
    probs = np.where(kept, np.exp(lg - lg.max()), 0.0)
    return kept, probs / probs.sum()


KNOBS = dict(temperature=1.5, top_k=10, top_p=0.9)


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_sampler_draws_the_filtered_softmax(impl):
    """Fixed logits (V=50): the support is the kept set and the frequencies
    are within total variation 0.02 of the filtered softmax."""
    logits = np.random.default_rng(5).standard_normal(50).astype(np.float32) * 2.0
    kept, probs = _numpy_filtered(logits, **KNOBS)
    assert 2 < kept.sum() < KNOBS["top_k"], "the fixture should cut by both filters"
    tiled = np.tile(logits, (N_DRAWS, 1))
    if impl == "port":
        draws = sample._sample_from_logits(
            torch.Generator().manual_seed(0), torch.from_numpy(tiled), KNOBS["temperature"], KNOBS["top_k"],
            KNOBS["top_p"],
        ).numpy()
    else:
        draws = np.asarray(jsample._sample_from_logits(
            jax.random.PRNGKey(0), jnp.asarray(tiled), KNOBS["temperature"], KNOBS["top_k"], KNOBS["top_p"]))
    freq = np.bincount(draws, minlength=50) / N_DRAWS
    assert set(np.flatnonzero(freq)) == set(np.flatnonzero(kept))
    assert 0.5 * np.abs(freq - probs).sum() < TV_LIMIT


def test_filters_keep_ties_and_use_a_finite_floor():
    logits = torch.tensor([[3.0, 1.0, 3.0, 2.0, 2.0, -1.0]])
    out = sample.filter_logits(logits, 1.0, 3, 1.0)
    # the 3rd largest is 2.0, shared by two tokens: both are kept
    assert out.tolist()[0] == [3.0, sample.NEG_INF, 3.0, 2.0, 2.0, sample.NEG_INF]
    assert torch.isfinite(out).all()
    # top-p keeps the top token even when its probability exceeds p
    peaked = torch.tensor([[10.0, 0.0, 0.0]])
    assert (sample.filter_logits(peaked, 1.0, 0, 0.5) > sample.NEG_INF).tolist() == [[True, False, False]]
    # the temperature divides before the filters; 1.0 and top_p 1 change nothing
    assert torch.equal(sample.filter_logits(logits, 1.0, 0, 1.0), logits)
    assert torch.allclose(sample.filter_logits(logits, 2.0, 0, 1.0), logits / 2)


# --- decode_ids and sample_decode -------------------------------------------


def test_decode_ids_sample_at_top_k_1_is_jax_full_greedy():
    """Sampling has no early exit, like the JAX scan: with top_k=1 its ids
    are the JAX fixed-length greedy's, tokens after <end> included."""
    jcfg, jm, trainable, _, cfg, tm = tpm._pair(end_bias=0.6)
    jf, tf = tpm._feats(3, seed=2)
    jstep, jcarry, _ = jm.make_decode_state(trainable, jf, beam_size=1)
    want = np.asarray(jgreedy(jstep, jcarry, 3, cfg.max_decode_len, early_stop=False))
    got = decode_ids(tm, cfg, tf, "sample", generator=torch.Generator().manual_seed(1), top_k=1)
    assert got.dtype == torch.long and got.shape == (3, cfg.max_decode_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == tvocab.END_ID).any(), "the <end> bias should finish some rows"


def test_decode_ids_sample_is_reproducible_per_generator():
    _, _, _, _, cfg, tm = tpm._pair()
    _, tf = tpm._feats(4, seed=3)

    def draw(seed):
        return decode_ids(tm, cfg, tf, "sample", generator=torch.Generator().manual_seed(seed), temperature=1.5)

    assert torch.equal(draw(0), draw(0))
    assert not torch.equal(draw(0), draw(1))


def test_decode_ids_sample_needs_a_generator():
    tm = build_model(Config(**SMALL), tpm.V, device="cpu")
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        decode_ids(tm, Config(**SMALL), torch.zeros(1, 4, 512), "sample")
    with pytest.raises(ValueError, match="unknown decode mode"):
        decode_ids(tm, Config(**SMALL), torch.zeros(1, 4, 512), "nucleus")


def test_sample_decode_from_first_logits_matches_jax():
    """The Show-and-Tell entry (token 0 drawn from ``first_logits``) on a
    table-driven step function, at top_k=1 where both frameworks agree."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((12, 12)).astype(np.float32)
    first = rng.standard_normal((3, 12)).astype(np.float32)

    def jstep(carry, prev):
        return carry + 1, jnp.asarray(table)[prev] + carry[:, None]

    def tstep(carry, prev):
        return carry + 1, torch.from_numpy(table)[prev] + carry[:, None]

    want = jsample.sample_decode(jstep, jnp.zeros(3), 3, jax.random.PRNGKey(0), 6, top_k=1,
                                 first_logits=jnp.asarray(first))
    got = sample.sample_decode(tstep, torch.zeros(3), 3, torch.Generator().manual_seed(0), 6, top_k=1,
                               first_logits=torch.from_numpy(first))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, 0].tolist() == first.argmax(-1).tolist()
    none = sample.sample_decode(tstep, torch.zeros(3), 3, torch.Generator(), 1,
                                first_logits=torch.from_numpy(first))
    assert none.shape == (3, 1)
