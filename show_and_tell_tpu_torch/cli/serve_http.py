"""HTTP captioning server over the ``Captioner``, stdlib ``http.server`` only:

    python -m show_and_tell_tpu_torch.cli.serve_http \
        --vocab_path data/vocab.json --load_model_path experiment/u/e \
        --encoder_weights vgg16.pth --http_port 8000 --warmup

    curl -s -X POST --data-binary @photo.jpg localhost:8000/caption
    -> {"caption": "a man riding a horse", "mode": "beam"}

Endpoints:
- ``POST /caption``: raw image bytes (any PIL format) -> one caption. Query
  parameters: ``mode=beam|greedy|sample`` (default by ``--beam_size``);
  ``attention=1`` answers a greedy caption and the attention contact sheet
  as a base64 PNG; ``nbest=1`` answers the beam's n-best list (caption and
  score each).
- ``POST /caption_batch``: a JSON list of base64 images -> their captions;
  an item that does not decode gets ``ERROR_CAPTION`` and its index in
  ``errors``.
- ``GET /healthz``: liveness, the model and the batcher's stats.
- ``GET /metrics``: the batcher's counters in the Prometheus text format.

A threaded server accepts any number of connections; every decoded image
goes through one ``DynamicBatcher``, whose one worker thread coalesces
concurrent requests into bucketed device batches (same-mode FIFO runs of up
to ``--batch_max_size``, waiting at most ``--batch_max_delay_ms`` after the
first). ``--no_dynamic_batch`` serves one request at a time on one thread.
Status codes: 400 for a bad request or an image that does not decode, 404
for an unknown path, 429 when the batcher's queue is full, 503 when a
request times out, 500 for a failure of the model. Unlike the JAX package's
server, the socket listens with a backlog of ``socket.SOMAXCONN``, not 5, so
that a burst of connections is not reset (ROADMAP.md §C).

It runs on the GPU and raises without one; ``make_server(...,
device="cpu")`` and ``main(argv, device="cpu")`` run on the CPU.
"""

from __future__ import annotations

import base64
import glob
import json
import logging
import os
import socket
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from typing import Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from show_and_tell_tpu_torch.config import Config, parse_config
from show_and_tell_tpu_torch.serve import ERROR_CAPTION, Captioner, DynamicBatcher, QueueFull
from show_and_tell_tpu_torch.utils.logging import setup_logging
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

log = logging.getLogger(__name__)


def _decode_image(data: bytes, size: int = 256) -> Optional[np.ndarray]:
    """Request bytes -> [size, size, 3] uint8, or None if they do not
    decode: the data pipeline's ingest, so that training, serving and HTTP
    read images alike."""
    from show_and_tell_tpu_torch.data.pipeline import _load_image_checked

    img, ok = _load_image_checked(data, size)
    return img if ok else None


class CaptionHandler(BaseHTTPRequestHandler):
    # set by make_server; batcher None = one request at a time
    captioner: Captioner = None
    default_mode: str = "beam"
    batcher: Optional[DynamicBatcher] = None

    def log_message(self, fmt, *args):
        log.info("%s - %s", self.address_string(), fmt % args)

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _query(self) -> dict:
        return parse_qs(urlparse(self.path).query)

    def _mode(self) -> str:
        mode = self._query().get("mode", [self.default_mode])[0]
        if mode not in ("beam", "greedy", "sample"):
            raise ValueError(f"unknown mode {mode!r}")
        return mode

    def _qflag(self, name: str) -> bool:
        return self._query().get(name, ["0"])[0] in ("1", "true", "yes")

    def do_GET(self):
        if self.path.startswith("/metrics"):
            return self._metrics()
        if self.path.startswith("/healthz"):
            cfg = self.captioner.cfg
            payload = {"ok": True, "model": cfg.model, "beam_size": cfg.beam_size,
                       "buckets": list(self.captioner.bucket_sizes)}
            if self.batcher is not None:
                payload["batcher"] = self.batcher.stats()
            self._send(200, payload)
        else:
            self._send(404, {"error": "unknown path"})

    def _metrics(self) -> None:
        """The batcher's counters in the Prometheus text format 0.0.4: sums
        and counts, so that rates and means are computed server side."""
        if self.batcher is None:
            return self._send(404, {"error": "metrics require dynamic batching (drop --no_dynamic_batch)"})
        s = self.batcher.stats()
        lines = []
        for name, value in (
            ("sat_requests_total", s["requests"]),
            ("sat_batches_total", s["batches"]),
            ("sat_batched_images_total", s["batch_size_sum"]),
            ("sat_queue_wait_seconds_total", f"{s['queue_wait_s_sum']:.6f}"),
            ("sat_request_errors_total", s["errors"]),
            ("sat_requests_rejected_total", s["rejected"]),
            ("sat_requests_abandoned_total", s["abandoned"]),
        ):
            lines += [f"# TYPE {name} counter", f"{name} {value}"]
        lines.append("# TYPE sat_requests_by_mode_total counter")
        lines += [f'sat_requests_by_mode_total{{mode="{m}"}} {n}' for m, n in s["requests_by_mode"].items()]
        lat = s["latency_ms"]
        if lat["n"]:
            # the windowed percentiles as gauges
            lines.append("# TYPE sat_request_latency_ms gauge")
            lines += [f'sat_request_latency_ms{{quantile="{q}"}} {lat[q]}' for q in ("p50", "p95", "p99")]
        body = ("\n".join(lines) + "\n").encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        try:
            mode = self._mode()
        except ValueError as e:
            return self._send(400, {"error": str(e)})
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            return self._send(400, {"error": "bad Content-Length header"})
        if length <= 0:
            return self._send(400, {"error": "empty body"})
        data = self.rfile.read(length)
        # every failure answers with a status code, never a dropped connection
        try:
            if self.path.startswith("/caption_batch"):
                return self._caption_batch(data, mode)
            if self.path.startswith("/caption"):
                return self._caption_one(data, mode)
        except QueueFull as e:
            return self._send(429, {"error": str(e)})
        except TimeoutError as e:
            return self._send(503, {"error": str(e)})
        except Exception as e:
            log.exception("request handling failed")
            return self._send(500, {"error": f"caption request failed: {e}"})
        self._send(404, {"error": "unknown path"})

    def _caption_one(self, data: bytes, mode: str) -> None:
        img = _decode_image(data)
        if img is None:
            return self._send(400, {"error": "image failed to decode"})
        if self._qflag("attention"):
            return self._caption_attention(img)
        if self._qflag("nbest"):
            # interactive, like the attention maps: it bypasses the batcher,
            # and the Captioner's lock orders it against the worker
            nbest = self.captioner.caption_nbest(img[None])[0]
            return self._send(200, {
                "caption": nbest[0][0], "mode": "beam",
                "nbest": [{"caption": c, "score": round(s, 4)} for c, s in nbest],
            })
        if self.batcher is not None:
            caption = self.batcher.caption(img, mode=mode)
        else:
            caption = self.captioner.caption_images(img[None], mode=mode)[0]
        self._send(200, {"caption": caption, "mode": mode})

    def _caption_attention(self, img) -> None:
        """``POST /caption?attention=1``: the greedy caption and its
        attention contact sheet, rendered over the centre crop the model
        attended to. It bypasses the batcher; the Captioner's lock orders it
        against the worker."""
        import io

        from show_and_tell_tpu_torch.utils.visualize import attention_sheet, model_view

        try:
            caps, alphas = self.captioner.caption_with_attention(img[None])
        except ValueError as e:  # a model without attention
            return self._send(400, {"error": str(e)})
        words = caps[0].split() or ["<no caption>"]
        sheet = attention_sheet(model_view(img, self.captioner.cfg.crop_size), alphas[0], words)
        buf = io.BytesIO()
        sheet.save(buf, format="PNG")
        self._send(200, {"caption": caps[0], "mode": "greedy",
                         "attention_sheet_png_b64": base64.b64encode(buf.getvalue()).decode()})

    def _caption_batch(self, data: bytes, mode: str) -> None:
        try:
            items = json.loads(data)
            if not isinstance(items, list) or not items:
                raise ValueError("not a non-empty list")
            blobs = [base64.b64decode(s) for s in items]
        except Exception:
            return self._send(400, {"error": "body must be a non-empty JSON list of base64 images"})
        decoded = [_decode_image(b) for b in blobs]
        ok = [d is not None for d in decoded]
        if self.batcher is not None:
            # one ticket per item, coalesced with every other client's; an
            # item that is shed or times out gets ERROR_CAPTION, unless no
            # item succeeded: then the request answers 429 or 503
            any_decoded = any(ok)
            tickets = []
            for d, good in zip(decoded, ok):
                if not good:
                    tickets.append(None)
                    continue
                try:
                    tickets.append(self.batcher.submit(d, mode=mode))
                except QueueFull as e:
                    tickets.append(e)
            captions = []
            for i, t in enumerate(tickets):
                if t is None or isinstance(t, QueueFull):
                    captions.append(ERROR_CAPTION)
                    if t is not None:
                        ok[i] = False
                    continue
                try:
                    captions.append(t.result(timeout=120.0))
                except (TimeoutError, RuntimeError):
                    captions.append(ERROR_CAPTION)
                    ok[i] = False
            if any_decoded and not any(ok):
                first = next((t for t in tickets if isinstance(t, QueueFull)), None)
                if first is not None:
                    raise first
                raise TimeoutError("no caption request completed")
        else:
            stack = np.stack([d if d is not None else np.zeros((256, 256, 3), np.uint8) for d in decoded])
            captions = self.captioner.caption_images(stack, mode=mode)
            captions = [c if good else ERROR_CAPTION for c, good in zip(captions, ok)]
        self._send(200, {"captions": captions, "mode": mode, "errors": [i for i, good in enumerate(ok) if not good]})


def _calibration_images(directory: str) -> np.ndarray:
    """Up to 32 images of ``directory`` in name order, files that do not
    decode skipped (so that side files do not crowd images out)."""
    from show_and_tell_tpu_torch.data.pipeline import _load_image_checked

    paths = sorted(p for p in glob.glob(os.path.join(directory, "*")) if os.path.isfile(p))
    ok = []
    for p in paths:
        im, good = _load_image_checked(p)
        if good:
            ok.append(im)
        if len(ok) == 32:
            break
    if not ok:
        raise SystemExit(f"--warmup_calib_dir {directory}: no decodable images found")
    return np.stack(ok)


def make_server(
    cfg: Config,
    vocab: Vocabulary,
    host: str = "127.0.0.1",
    port: int = 8000,
    captioner: Optional[Captioner] = None,
    dynamic_batch: bool = True,
    batch_max_delay_ms: float = 10.0,
    batch_max_size: Optional[int] = None,
    batch_max_queue: Optional[int] = None,
    warmup: bool = False,
    warmup_calib_dir: Optional[str] = None,
    warmup_surfaces: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> HTTPServer:
    """Build (don't start) the server; ``serve_forever`` runs it. Without
    ``captioner``, ``Captioner.from_checkpoint(cfg, cfg.load_model_path,
    vocab, device)`` serves. ``warmup`` runs every bucket of the default
    mode and of the comma-separated ``warmup_surfaces`` before the bind, so
    that no request pays a kernel build or a cuDNN algorithm search. With
    ``dynamic_batch`` the server is threaded and carries its
    ``DynamicBatcher`` as ``server.batcher``, which ``server_close`` closes.
    With ``cfg.quantize_backbone`` the warmup calibrates the int8 trunk on
    the first 32 decodable images of ``warmup_calib_dir`` (the zero dummies
    never calibrate it).
    """
    cap = captioner or Captioner.from_checkpoint(cfg, cfg.load_model_path, vocab, device=device)
    default_mode = "greedy" if cfg.beam_size <= 1 else "beam"
    if warmup:
        calib = _calibration_images(warmup_calib_dir) if warmup_calib_dir else None
        modes = [default_mode] + [s for s in (warmup_surfaces or "").split(",") if s]
        log.info("warming serving programs (modes=%s)...", modes)
        log.info("warmup done in %.1f s", cap.warmup(modes=modes, calib_images=calib))
    batcher = (
        DynamicBatcher(cap, max_batch=batch_max_size, max_delay_ms=batch_max_delay_ms, max_queue=batch_max_queue)
        if dynamic_batch
        else None
    )
    handler = type("BoundCaptionHandler", (CaptionHandler,),
                   {"captioner": cap, "default_mode": default_mode, "batcher": batcher})
    server_cls = ThreadingHTTPServer if batcher is not None else HTTPServer

    class _Server(server_cls):
        daemon_threads = True
        # the listen backlog: socketserver's default of 5 resets or stalls
        # (for a 1 s SYN retransmit) the connections of a burst of clients
        # that arrive faster than the one accepting thread takes them
        request_queue_size = socket.SOMAXCONN

        def server_close(self):
            if batcher is not None:
                batcher.close()
            super().server_close()

    try:
        srv = _Server((host, port), handler)
    except Exception:
        # a failed bind (port in use) must not leave the worker running
        if batcher is not None:
            batcher.close()
        raise
    srv.batcher = batcher
    return srv


def main(argv=None, device: Union[str, torch.device] = "cuda"):
    import argparse

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--http_host", default="0.0.0.0")
    ap.add_argument("--http_port", type=int, default=8000)
    ap.add_argument("--no_dynamic_batch", action="store_true",
                    help="serve one request at a time on one thread (no coalescing)")
    ap.add_argument("--batch_max_delay_ms", type=float, default=10.0,
                    help="the longest wait after the first queued request before dispatch")
    ap.add_argument("--batch_max_size", type=int, default=None,
                    help="the largest coalesced batch (default: the largest serving bucket)")
    ap.add_argument("--batch_max_queue", type=int, default=None,
                    help="the queue depth past which requests get 429 (default: 8x the largest batch)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every bucket once before accepting traffic, so that no request pays the "
                         "kernel build or the cuDNN algorithm search")
    ap.add_argument("--warmup_calib_dir", default=None,
                    help="a directory of real images for the int8 trunk's calibration during --warmup "
                         "(quantize_backbone; without it the calibration waits for the first real batch)")
    ap.add_argument("--warmup_surfaces", default=None,
                    help="more surfaces for --warmup, comma-separated from {nbest,attention,greedy,beam,sample}; "
                         "otherwise the first ?nbest=1 or ?attention=1 request warms them while holding the "
                         "Captioner's lock, stalling the batcher behind it")
    http_args, rest = ap.parse_known_args(argv)
    cfg = parse_config(rest)
    setup_logging("serve_http_log.txt")
    vocab = Vocabulary.load(cfg.vocab_path)
    server = make_server(
        cfg, vocab, http_args.http_host, http_args.http_port,
        dynamic_batch=not http_args.no_dynamic_batch,
        batch_max_delay_ms=http_args.batch_max_delay_ms,
        batch_max_size=http_args.batch_max_size,
        batch_max_queue=http_args.batch_max_queue,
        warmup=http_args.warmup,
        warmup_calib_dir=http_args.warmup_calib_dir,
        warmup_surfaces=http_args.warmup_surfaces,
        device=device,
    )
    log.info("serving on %s:%d", http_args.http_host, http_args.http_port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
