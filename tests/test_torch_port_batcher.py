"""PyTorch port, the ``DynamicBatcher`` against the JAX package's on the CPU.

The JAX and the port ``Captioner`` serve the same weights (numpy-seeded JAX
trees, crossed by ``ckpt.convert.from_jax_params``) at the JAX serving
tests' tiny size, in fp32; the batchers over them must answer the same captions.
The port's batcher is then held to the behaviour that
``tests/test_serve_batcher.py`` pins for the JAX one: coalescing, mode runs,
``max_batch``, ``QueueFull``, abandoned tickets, the per-request queue wait,
the latency percentiles, error propagation and ``close``.
"""

import random
import sys
import threading
import time

import jax
import numpy as np
import pytest
from PIL import Image

from show_and_tell_tpu.config import Config as JConfig
from show_and_tell_tpu.models.registry import build_model as jbuild
from show_and_tell_tpu.serve import Captioner as JCaptioner
from show_and_tell_tpu.serve import DynamicBatcher as JDynamicBatcher
from show_and_tell_tpu.utils.vocab import Vocabulary as JVocabulary
from show_and_tell_tpu_torch.ckpt.convert import from_jax_params
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.serve import Captioner, DynamicBatcher, QueueFull
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

# the JAX serving tests' configuration
TINY = dict(embed_size=16, hidden_size=24, crop_size=32, max_decode_len=4, beam_size=2)
WORDS = ["a", "dog", "runs", "sits"]
BUCKETS = (1, 4, 8)


def jax_weights(seed=0):
    """The JAX model's (trainable, frozen) trees at TINY, filled from a numpy
    seed; the shapes come from tracing the JAX init, which is much faster
    than running it. Conv kernels are at He scale, every other leaf uniform
    in +-4 / sqrt(its first dimension), and the ``<end>`` logit's bias is
    lowered by 3: captions of a few words that vary with the image, where
    the JAX init's scale ends every caption at once."""
    jm = jbuild(JConfig(**TINY), len(WORDS) + 4)
    rng = np.random.default_rng(seed)

    def fill(leaf):
        if len(leaf.shape) == 4:  # HWIO
            return rng.normal(0.0, np.sqrt(2.0 / np.prod(leaf.shape[:3])), leaf.shape).astype(np.float32)
        bound = 4.0 / np.sqrt(leaf.shape[0])
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    trainable, frozen = jax.tree.map(fill, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    trainable["classifier"]["b"][Vocabulary.from_words(WORDS)("<end>")] -= 3.0
    return jm, (trainable, frozen)


def make_pair(buckets=BUCKETS):
    """The JAX and the port Captioner over the same weights."""
    jm, (trainable, frozen) = jax_weights()
    jcap = JCaptioner(JConfig(**TINY), jm, trainable, frozen, JVocabulary.from_words(WORDS), bucket_sizes=buckets)
    cfg = Config(**TINY)
    tcap = Captioner(cfg, build_model(cfg, len(WORDS) + 4, device="cpu"), from_jax_params(trainable, frozen),
                     Vocabulary.from_words(WORDS), device="cpu", bucket_sizes=buckets)
    return jcap, tcap


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def captioner(pair):
    return pair[1]


def scenes(n, seed=0, hw=(256, 256)):
    """n uint8 images of 4 x 4 blocks of random colour: unlike pixel noise,
    they give the trunk features that differ from image to image."""
    grid = np.random.default_rng(seed).integers(0, 256, (n, 4, 4, 3), dtype=np.uint8)
    return np.stack([np.asarray(Image.fromarray(g).resize(hw[::-1], Image.NEAREST)) for g in grid])


_images = scenes


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_coalesced_batch_matches_jax_batcher(pair, mode):
    """8 tickets queued before the worker starts: one batch in each package,
    the same captions, equal to a direct call; the port's device work runs
    on its one worker thread."""
    jcap, tcap = pair
    imgs = _images(8)
    threads = []
    call = tcap.caption_images

    def recorded(*a, **kw):
        threads.append(threading.current_thread().name)
        return call(*a, **kw)

    tcap.caption_images = recorded
    try:
        got = {}
        for name, batcher in (("jax", JDynamicBatcher(jcap, max_delay_ms=50.0, autostart=False)),
                              ("torch", DynamicBatcher(tcap, max_delay_ms=50.0, autostart=False))):
            tickets = [batcher.submit(imgs[i], mode=mode) for i in range(8)]
            batcher.start()
            got[name] = [t.result(timeout=120.0) for t in tickets]
            s = batcher.stats()
            assert (s["requests"], s["batches"], s["mean_batch_size"]) == (8, 1, 8.0), name
            batcher.close()
    finally:
        del tcap.caption_images
    assert got["torch"] == got["jax"]
    assert got["torch"] == tcap.caption_images(imgs, mode=mode)
    assert len(set(got["torch"])) > 1, got
    assert threads == ["caption-batcher"]


def test_mode_runs_split_batches(captioner):
    """A mode change at the head closes the batch; FIFO order and the
    per-mode results are kept."""
    imgs = _images(6, seed=1)
    want = captioner.caption_images(imgs[:3], mode="beam") + captioner.caption_images(imgs[3:], mode="greedy")
    b = DynamicBatcher(captioner, max_delay_ms=50.0, autostart=False)
    tickets = [b.submit(imgs[i], "beam") for i in range(3)] + [b.submit(imgs[3 + i], "greedy") for i in range(3)]
    b.start()
    assert [t.result(timeout=120.0) for t in tickets] == want
    s = b.stats()
    assert (s["batches"], s["requests"]) == (2, 6)
    assert s["requests_by_mode"] == {"beam": 3, "greedy": 3, "sample": 0}
    b.close()


def test_max_batch_and_default_queue_depth(captioner):
    b = DynamicBatcher(captioner, autostart=False)
    assert (b.max_batch, b.max_queue) == (max(BUCKETS), 8 * max(BUCKETS))
    b.close()
    imgs = _images(5, seed=2)
    b = DynamicBatcher(captioner, max_batch=2, max_delay_ms=20.0, autostart=False)
    tickets = [b.submit(imgs[i]) for i in range(5)]
    b.start()
    for t in tickets:
        t.result(timeout=120.0)
    assert b.stats()["batches"] == 3  # 2 + 2 + 1
    b.close()


def test_error_propagates_and_worker_survives(captioner):
    b = DynamicBatcher(captioner, max_delay_ms=5.0)
    bad = np.zeros((16, 16, 3), np.uint8)  # too small for the trunk
    with pytest.raises(RuntimeError, match="caption request failed"):
        b.caption(bad, timeout=120.0)
    assert b.caption(_images(1)[0], timeout=120.0) == captioner.caption_images(_images(1))[0]
    assert b.stats()["errors"] == 1
    b.close()


def test_close_contracts(captioner):
    b = DynamicBatcher(captioner, max_delay_ms=5.0)
    worker = b._worker
    b.close()
    assert not worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(_images(1)[0])
    with pytest.raises(RuntimeError, match="closed"):
        b.start()
    # pending tickets fail rather than hang
    b2 = DynamicBatcher(captioner, autostart=False)
    t = b2.submit(_images(1)[0])
    b2.close()
    with pytest.raises(RuntimeError, match="batcher closed"):
        t.result(timeout=5.0)


def test_queue_full_backpressure(captioner):
    b = DynamicBatcher(captioner, autostart=False, max_queue=2)
    imgs = _images(3, seed=3)
    t0, t1 = b.submit(imgs[0]), b.submit(imgs[1])
    with pytest.raises(QueueFull, match="queue full"):
        b.submit(imgs[2])
    assert b.stats()["rejected"] == 1
    b.start()
    for t in (t0, t1):
        t.result(timeout=120.0)
    assert b.stats()["requests"] == 2
    b.close()


def test_abandoned_tickets_not_dispatched(captioner):
    """A ticket whose client timed out is dropped by the worker; a retried
    result() on it raises instead of returning None."""
    b = DynamicBatcher(captioner, autostart=False, max_delay_ms=5.0)
    imgs = _images(3, seed=4)
    tickets = [b.submit(imgs[i]) for i in range(3)]
    with pytest.raises(TimeoutError):
        tickets[1].result(timeout=0.01)
    assert tickets[1].abandoned
    b.start()
    assert tickets[0].result(timeout=120.0) == captioner.caption_images(imgs[:1])[0]
    assert tickets[2].result(timeout=120.0) == captioner.caption_images(imgs[2:])[0]
    with pytest.raises(RuntimeError, match="abandoned"):
        tickets[1].result(timeout=5.0)
    s = b.stats()
    assert (s["abandoned"], s["batch_size_sum"]) == (1, 2)  # only the live tickets reach the device
    b.close()


def test_abandoned_tickets_do_not_block_queue(captioner):
    """Dead tickets are purged before a full queue sheds a fresh request."""
    b = DynamicBatcher(captioner, max_delay_ms=50.0, autostart=False, max_queue=4)
    imgs = _images(5, seed=3)
    tickets = [b.submit(imgs[i]) for i in range(4)]
    for t in tickets:
        t.abandoned = True  # as a result() timeout leaves them
    fresh = b.submit(imgs[4])
    assert b.stats()["abandoned"] == 4
    for t in tickets:
        with pytest.raises(RuntimeError, match="abandoned"):
            t.result(timeout=0.1)
    b.start()
    assert fresh.result(timeout=120.0) == captioner.caption_images(imgs[4:5])[0]
    b.close()


def test_abandoned_head_does_not_pull_wrong_mode(captioner):
    """Skipping an abandoned ticket mid-gather never pulls a ticket of
    another mode into the batch."""
    b = DynamicBatcher(captioner, autostart=False, max_delay_ms=5.0)
    imgs = _images(3, seed=6)
    t_beam, t_dead, t_greedy = b.submit(imgs[0], "beam"), b.submit(imgs[1], "beam"), b.submit(imgs[2], "greedy")
    with pytest.raises(TimeoutError):
        t_dead.result(timeout=0.01)
    b._running = True  # drive _collect on this thread, no worker
    assert b._collect() == [t_beam]
    assert list(b._q) == [t_greedy]
    b.close()


def test_mean_queue_wait_is_per_request(captioner):
    b = DynamicBatcher(captioner, max_delay_ms=50.0, autostart=False)
    imgs = _images(4, seed=5)
    tickets = [b.submit(imgs[i]) for i in range(4)]
    time.sleep(0.02)
    b.start()
    for t in tickets:
        t.result(timeout=120.0)
    s = b.stats()
    assert (s["batches"], s["batch_size_sum"]) == (1, 4)
    assert s["mean_queue_wait_ms"] == round(s["queue_wait_s_sum"] / 4 * 1e3, 2) >= 20.0


def test_latency_percentiles_tracked(captioner):
    """The window holds served requests only; the quantiles are ordered."""
    imgs = _images(4, seed=7)
    b = DynamicBatcher(captioner, max_delay_ms=5.0)
    assert b.stats()["latency_ms"] == {"n": 0, "p50": None, "p95": None, "p99": None}
    for i in range(4):
        b.caption(imgs[i], mode="greedy", timeout=120.0)
    lat = b.stats()["latency_ms"]
    assert lat["n"] == 4 and 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    with pytest.raises(RuntimeError, match="caption request failed"):
        b.caption(np.zeros((16, 16, 3), np.uint8), mode="greedy", timeout=120.0)
    assert b.stats()["latency_ms"]["n"] == 4
    assert b._latencies.maxlen == 2048
    b.close()


def test_submit_validates_image_contract(captioner):
    """Malformed images are refused at submit(); shapes need only match the
    queued requests."""
    b = DynamicBatcher(captioner, max_delay_ms=50.0, autostart=False)
    for bad in (np.zeros((256, 256, 3), np.float32), np.zeros((256, 256), np.uint8),
                np.zeros((256, 256, 4), np.uint8)):
        with pytest.raises(ValueError, match="uint8 image"):
            b.submit(bad)
    with pytest.raises(ValueError, match="unknown mode"):
        b.submit(np.zeros((256, 256, 3), np.uint8), mode="topk")
    b.submit(np.zeros((256, 256, 3), np.uint8))
    with pytest.raises(ValueError, match="mixed shapes"):
        b.submit(np.zeros((16, 16, 3), np.uint8))
    assert b.stats()["requests"] == 1
    b.close()


def test_soak_mixed_modes_abandonment_overload(captioner):
    """More client threads than cores, a short switch interval, mixed modes,
    abandonment and a small queue: every ticket resolves exactly once and
    the batcher's counters reconcile with the clients' tally."""
    b = DynamicBatcher(captioner, max_batch=8, max_delay_ms=2.0, max_queue=16)
    img = _images(1)[0]
    results = {"ok": 0, "rejected": 0, "timeout": 0, "error": 0, "none": 0}
    lock = threading.Lock()

    def client(seed):
        rng = random.Random(seed)
        for _ in range(12):
            try:
                t = b.submit(img, mode=rng.choice(["beam", "greedy", "sample"]))
            except QueueFull:
                outcome = "rejected"
            else:
                try:
                    cap = t.result(timeout=0.001 if rng.random() < 0.25 else 60.0)
                    outcome = "ok" if isinstance(cap, str) else "none"
                except TimeoutError:
                    outcome = "timeout"
                    try:  # a retry raises, or returns the caption of a batch already in flight
                        if not isinstance(t.result(timeout=10.0), str):
                            outcome = "none"
                    except (TimeoutError, RuntimeError):
                        pass
                except RuntimeError:
                    outcome = "error"
            with lock:
                results[outcome] += 1
            if rng.random() < 0.3:
                time.sleep(rng.random() * 0.004)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "client thread hung"
    finally:
        sys.setswitchinterval(interval)
    assert sum(results.values()) == 12 * 12 and results["ok"] > 0, results
    assert results["error"] == results["none"] == 0, results
    # FIFO: once a last request is served, every earlier one was dispatched or dropped as abandoned
    assert isinstance(b.caption(img, timeout=120.0), str)
    s = b.stats()
    assert s["requests"] == 12 * 12 - results["rejected"] + 1
    assert s["rejected"] == results["rejected"]
    assert s["batch_size_sum"] + s["abandoned"] == s["requests"] and s["errors"] == 0
    b.close()
