"""PyTorch port, the HTTP server (``cli/serve_http.py``) against the JAX
package's on the CPU.

Both servers run on ephemeral ports over the JAX and the port ``Captioner``
of the same weights (``test_torch_port_batcher.make_pair``: the JAX serving
tests' tiny size, fp32) and get the same PNG requests. ``/caption`` (beam and
greedy), ``/caption_batch`` with a corrupt item and every error answer must
be the same JSON; ``?nbest=1`` the same captions, with scores within 1e-5 before the
answer rounds them;
``?attention=1`` the same caption and a contact sheet within one grey level;
``/healthz`` and ``/metrics`` the same keys and counters.
"""

import base64
import contextlib
import io
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_batcher import TINY, WORDS, make_pair, scenes
from show_and_tell_tpu.cli import serve_http as jserve_http
from show_and_tell_tpu_torch.cli import serve_http
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.serve import ERROR_CAPTION
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

NBEST_ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@contextlib.contextmanager
def serving(pkg, cap, **kw):
    """A server of package ``pkg`` over ``cap``, served by a thread; yields
    (url, server) and closes both."""
    mod = jserve_http if pkg == "jax" else serve_http
    srv = mod.make_server(cap.cfg, cap.vocab, host="127.0.0.1", port=0, captioner=cap, **kw)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


@pytest.fixture(scope="module")
def servers(pair):
    """{"jax": url, "torch": url}; the port's server warmed over its buckets."""
    jcap, tcap = pair
    with serving("jax", jcap) as (jurl, _), serving("torch", tcap, warmup=True, warmup_surfaces="greedy") as (turl, _):
        yield {"jax": jurl, "torch": turl}


def png_bytes(seed=0, hw=(64, 64)):
    buf = io.BytesIO()
    Image.fromarray(scenes(1, seed, hw)[0]).save(buf, format="PNG")
    return buf.getvalue()


def request(url, data=None, headers=None):
    """(status, body): the JSON body, or the text of /metrics."""
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, raw, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    return status, (json.loads(raw) if ctype == "application/json" else raw.decode())


def both(servers, path, data=None, headers=None):
    return {pkg: request(url + path, data, headers) for pkg, url in servers.items()}


BATCH = json.dumps([base64.b64encode(png_bytes(0)).decode(), base64.b64encode(b"this is not an image").decode(),
                    base64.b64encode(png_bytes(1, (40, 52))).decode()]).encode()


@pytest.mark.parametrize("path,data", [
    ("/caption", png_bytes(0)),
    ("/caption?mode=greedy", png_bytes(1, (80, 48))),
    ("/caption?mode=beam", png_bytes(2, (256, 256))),
    ("/caption_batch", BATCH),
    ("/caption_batch?mode=greedy", BATCH),
], ids=["beam", "greedy", "beam-256px", "batch", "batch-greedy"])
def test_captions_equal_jax(servers, path, data):
    got = both(servers, path, data)
    assert got["torch"] == got["jax"]
    status, body = got["torch"]
    assert status == 200
    if "captions" in body:
        assert body["errors"] == [1] and body["captions"][1] == ERROR_CAPTION
        assert ERROR_CAPTION not in (body["captions"][0], body["captions"][2])


@pytest.mark.parametrize("path,data,headers,status", [
    ("/caption", b"junk bytes", None, 400),
    ("/caption?mode=quantum", png_bytes(), None, 400),
    ("/caption", b"", None, 400),
    ("/caption", png_bytes(), {"Content-Length": "many"}, 400),
    ("/caption_batch", b'{"not": "a list"}', None, 400),
    ("/caption_batch", b"[]", None, 400),
    ("/nope", png_bytes(), None, 404),
    ("/nope", None, None, 404),
], ids=["corrupt", "mode", "empty", "length", "batch-object", "batch-empty", "post-path", "get-path"])
def test_error_answers_equal_jax(servers, path, data, headers, status):
    got = both(servers, path, data, headers)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == status


def test_nbest_equal_jax(pair, servers):
    """?nbest=1: the beam's list, best first, its head the beam caption; the
    captions equal the JAX server's and the scores within 1e-5 of the JAX
    Captioner's. Each answer holds its Captioner's score rounded to 4
    places, so the two answers may sit one rounding step apart."""
    got = both(servers, "/caption?nbest=1", png_bytes(3))
    (js, jbody), (ts, tbody) = got["jax"], got["torch"]
    assert js == ts == 200 and tbody["mode"] == "beam"
    assert [a["caption"] for a in tbody["nbest"]] == [a["caption"] for a in jbody["nbest"]]
    assert tbody["caption"] == tbody["nbest"][0]["caption"] == jbody["caption"]
    assert len(tbody["nbest"]) == TINY["beam_size"]
    img = serve_http._decode_image(png_bytes(3))[None]
    jcap, tcap = pair
    want, have = jcap.caption_nbest(img)[0], tcap.caption_nbest(img)[0]
    assert max(abs(a[1] - b[1]) for a, b in zip(want, have)) <= NBEST_ATOL
    assert [a["score"] for a in tbody["nbest"]] == [round(s, 4) for _, s in have]
    assert [a["score"] for a in jbody["nbest"]] == [round(s, 4) for _, s in want]
    assert tbody["caption"] == request(servers["torch"] + "/caption", png_bytes(3))[1]["caption"]


def test_attention_sheet_equal_jax(servers):
    """?attention=1: the greedy caption and its contact sheet over the
    model's 32-pixel view, within one grey level of the JAX server's."""
    got = both(servers, "/caption?attention=1", png_bytes(4))
    (js, jbody), (ts, tbody) = got["jax"], got["torch"]
    assert js == ts == 200 and tbody["mode"] == "greedy" and tbody["caption"] == jbody["caption"]
    sheets = [np.asarray(Image.open(io.BytesIO(base64.b64decode(b["attention_sheet_png_b64"]))), np.int16)
              for b in (jbody, tbody)]
    assert sheets[0].shape == sheets[1].shape
    assert sheets[1].shape[1] == 32 * min(1 + max(len(tbody["caption"].split()), 1), 5)
    assert np.abs(sheets[0] - sheets[1]).max() <= 1


def _metric_values(text):
    return dict(line.rsplit(" ", 1) for line in text.splitlines() if line and not line.startswith("#"))


def test_healthz_and_metrics_equal_jax(pair):
    """The same requests to fresh servers: /healthz and /metrics carry the
    same keys, and the same counters but the timings."""
    answers = {}
    for pkg, cap in zip(("jax", "torch"), pair):
        with serving(pkg, cap) as (url, srv):
            for path, data in (("/caption", png_bytes(0)), ("/caption?mode=greedy", png_bytes(1)),
                               ("/caption_batch", BATCH), ("/caption?mode=topk", png_bytes(0))):
                request(url + path, data)
            answers[pkg] = (request(url + "/healthz"), request(url + "/metrics"))
    (jh, jm), (th, tm) = answers["jax"], answers["torch"]
    assert jh[0] == th[0] == jm[0] == tm[0] == 200
    jb, tb = jh[1].pop("batcher"), th[1].pop("batcher")
    assert th[1] == jh[1] == {"ok": True, "model": "show_attend_tell", "beam_size": 2, "buckets": [1, 4, 8]}
    assert set(tb) == set(jb) and set(tb["latency_ms"]) == set(jb["latency_ms"])
    for key in ("requests", "batch_size_sum", "errors", "rejected", "abandoned", "requests_by_mode"):
        assert tb[key] == jb[key], key
    assert tb["requests"] == 4 and tb["requests_by_mode"] == {"beam": 3, "greedy": 1, "sample": 0}
    jv, tv = _metric_values(jm[1]), _metric_values(tm[1])
    assert set(tv) == set(jv)
    assert [ln for ln in tm[1].splitlines() if ln.startswith("#")] == [
        ln for ln in jm[1].splitlines() if ln.startswith("#")]
    for name in tv:
        if "latency" not in name and "wait" not in name and "batches" not in name:
            assert tv[name] == jv[name], name
    assert tv["sat_requests_total"] == "4" and tv['sat_requests_by_mode_total{mode="beam"}'] == "3"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_no_dynamic_batch(pair, pkg):
    """--no_dynamic_batch: one request at a time, the same captions, no
    /metrics."""
    cap = pair[0] if pkg == "jax" else pair[1]
    with serving(pkg, cap, dynamic_batch=False) as (url, srv):
        assert srv.batcher is None
        single = request(url + "/caption?mode=greedy", png_bytes(1, (80, 48)))
        batch = request(url + "/caption_batch", BATCH)
        metrics = request(url + "/metrics")
    assert metrics[0] == 404
    with serving("jax", pair[0]) as (url, _):
        assert single == request(url + "/caption?mode=greedy", png_bytes(1, (80, 48)))
        assert batch == request(url + "/caption_batch", BATCH)


def test_overload_maps_to_429(pair):
    """A queue that holds nothing: /caption and /caption_batch answer 429,
    counted as rejected, as the JAX server does."""
    got = {}
    for pkg, cap in zip(("jax", "torch"), pair):
        with serving(pkg, cap, batch_max_queue=0) as (url, srv):
            got[pkg] = (request(url + "/caption", png_bytes()), request(url + "/caption_batch", BATCH),
                        srv.batcher.stats()["rejected"])
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == got["torch"][1][0] == 429 and got["torch"][2] == 3


def test_concurrent_requests_coalesce(pair):
    """Concurrent single-image POSTs share device batches; the counters of
    /healthz and /metrics add up to the requests sent; closing the server
    stops the batcher's worker."""
    _, tcap = pair
    with serving("torch", tcap, batch_max_delay_ms=250.0) as (url, srv):
        n = 8
        out = [None] * n

        def post(i):
            out[i] = request(url + "/caption", png_bytes(i))

        request(url + "/caption", png_bytes(0))
        threads = [threading.Thread(target=post, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert all(s == 200 and "caption" in b for s, b in out), out
        stats = srv.batcher.stats()
        assert stats["requests"] == stats["batch_size_sum"] == n + 1 and stats["batches"] < n + 1
        assert request(url + "/healthz")[1]["batcher"]["requests_by_mode"]["beam"] == n + 1
        assert _metric_values(request(url + "/metrics")[1])["sat_requests_total"] == str(n + 1)
        worker = srv.batcher._worker
    assert not worker.is_alive()


def test_bind_failure_closes_batcher(pair):
    hog = socket.socket()
    hog.bind(("127.0.0.1", 0))
    hog.listen(1)
    before = set(threading.enumerate())
    try:
        with pytest.raises(OSError):
            serve_http.make_server(pair[1].cfg, pair[1].vocab, host="127.0.0.1", port=hog.getsockname()[1],
                                   captioner=pair[1])
        assert [t for t in threading.enumerate() if t.name == "caption-batcher" and t not in before] == []
    finally:
        hog.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_listen_backlog_holds_a_burst_of_connections(pair, pkg):
    """32 clients connect while nothing accepts: the JAX server's backlog of
    5 completes 6 handshakes and leaves the rest to be reset or retried after
    a second; the port's backlog of socket.SOMAXCONN completes all 32. A
    difference on purpose (ROADMAP.md §C)."""
    cap = pair[0] if pkg == "jax" else pair[1]
    mod = jserve_http if pkg == "jax" else serve_http
    srv = mod.make_server(cap.cfg, cap.vocab, host="127.0.0.1", port=0, captioner=cap)  # not serving
    socks, connected = [], 0
    try:
        for _ in range(32):
            s = socket.socket()
            socks.append(s)
            s.settimeout(0.05)
            try:
                s.connect(srv.server_address)
                connected += 1
            except OSError:  # the handshake did not complete in time
                pass
    finally:
        for s in socks:
            s.close()
        srv.server_close()
    assert connected == (6 if pkg == "jax" else 32)


def test_decode_image_equals_jax():
    for data in (png_bytes(5, (30, 70)), png_bytes(6, (256, 256))):
        np.testing.assert_array_equal(serve_http._decode_image(data), jserve_http._decode_image(data))
    assert serve_http._decode_image(b"junk") is None and jserve_http._decode_image(b"junk") is None


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """make_server and main default to the GPU and never fall back; main
    passes its flags and device through; with quantize_backbone the warmup
    calibrates the int8 trunk on ``--warmup_calib_dir``'s images (side files
    skipped), and a directory without a decodable image stops it."""
    cfg, vocab = Config(**TINY), Vocabulary.from_words(WORDS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_http.make_server(cfg, vocab, port=0)
    with pytest.raises(SystemExit, match="no decodable images"):
        serve_http.make_server(cfg, vocab, port=0, device="cpu", warmup=True, warmup_calib_dir=str(tmp_path))
    calib = tmp_path / "calib"
    calib.mkdir()
    (calib / "0_labels.json").write_text("{}")
    for i, im in enumerate(scenes(3, seed=11)):
        Image.fromarray(im).save(calib / f"img{i}.png")
    qcfg = Config(**TINY, quantize_backbone=True)
    srv = serve_http.make_server(qcfg, vocab, port=0, device="cpu", warmup=True, warmup_calib_dir=str(calib))
    try:
        cap = srv.RequestHandlerClass.captioner
        assert "qconvs" in cap.model.quantized
        want = cap.model.quantized["qconvs"][0]["sx"]
    finally:
        srv.server_close()
    srv = serve_http.make_server(qcfg, vocab, port=0, device="cpu", warmup=True)
    try:
        assert srv.RequestHandlerClass.captioner.model.quantized is None  # the dummies never calibrate
    finally:
        srv.server_close()
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.models import quantize

    frozen = cap.model.frozen_tree()
    q = quantize.quantize_vgg16(frozen, eval_transform(torch.from_numpy(scenes(3, seed=11)), TINY["crop_size"]))
    assert torch.equal(q["qconvs"][0]["sx"], want)
    vocab_path = str(tmp_path / "vocab.json")
    vocab.save(vocab_path)
    calls = []

    class FakeServer:
        def serve_forever(self):
            calls.append("served")

        def server_close(self):
            calls.append("closed")

    def fake_make_server(*a, **kw):
        calls.append((a[2:], kw))
        return FakeServer()

    monkeypatch.setattr(serve_http, "make_server", fake_make_server)
    monkeypatch.chdir(tmp_path)
    serve_http.main(["--http_port", "0", "--vocab_path", vocab_path, "--batch_max_queue", "5", "--warmup",
                     "--no_dynamic_batch"], device="cpu")
    (args, kw), served, closed = calls
    assert args == ("0.0.0.0", 0) and (served, closed) == ("served", "closed")
    assert kw["device"] == "cpu" and kw["batch_max_queue"] == 5 and kw["warmup"] and not kw["dynamic_batch"]
