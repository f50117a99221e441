"""Evaluation driver — the ``eval.py`` layer of the reference, rebuilt.

``evaluation`` (reference eval.py:58-122): loop over the validation loader,
accumulate teacher-forced loss, decode captions (greedy like the reference's
``model.sample``, or batched beam search — the capability the reference stubs
at model2.py:113-114), convert ids to words truncating at ``<end>``
(eval.py:101-111), de-duplicate per image (eval.py:112-118), then run
``language_eval``.

``language_eval`` (reference eval.py:17-56): filter predictions to ids in
the annotation set, build a result index, and run the COCOEvalCap-equivalent
orchestrator. The annotation path comes from config (``cfg.ann_file``) rather
than a hardcoded home-directory path (eval.py:20). Predictions are keyed by
**cocoid**, so the filter genuinely matches the COCO annotation ids (the
reference keys by Karpathy imgid and silently drops most predictions at the
filter — a bug documented in SURVEY.md §7 rather than reproduced).

Against the JAX package's driver: nothing is jitted, and there are no
``params`` / ``batch_stats`` / ``frozen`` arguments. The ``nn.Module`` holds
its weights, and the batches go to the model's device. Evaluating other
weights (an EMA) goes through :func:`make_trainer_eval_fn`, which swaps
the trainable parameters in for the call; Show-and-Tell's BatchNorm
statistics are buffers, not swapped, so the gate always evaluates with the
running statistics. Sample mode draws from a ``torch.Generator`` seeded
from ``(cfg.random_seed, batch index)``: two runs give the same captions,
but not the JAX package's, whose random streams differ.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from show_and_tell_tpu_torch.ckpt.checkpoint import check_like, trainable_state_dict
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data.transforms import eval_transform
from show_and_tell_tpu_torch.decode.dispatch import decode_ids
from show_and_tell_tpu_torch.metrics.coco import COCO
from show_and_tell_tpu_torch.metrics.orchestrator import COCOEvalCap
from show_and_tell_tpu_torch.train.step import make_eval_loss_step
from show_and_tell_tpu_torch.utils.rng import KeyChain
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

log = logging.getLogger(__name__)


_warned_no_ann = False  # one warning per process, not per periodic eval


def language_eval(
    predictions: List[Dict], ann_file: str
) -> Dict[str, float]:
    """predictions: [{'image_id': cocoid, 'caption': str}, ...]."""
    coco = COCO(ann_file)
    valids = set(coco.getImgIds())
    preds_filt = [p for p in predictions if p["image_id"] in valids]
    log.info("using %d/%d predictions", len(preds_filt), len(predictions))
    if not preds_filt:
        return {}
    coco_res = coco.loadRes(preds_filt)
    coco_eval = COCOEvalCap(coco, coco_res)
    coco_eval.params["image_id"] = coco_res.getImgIds()
    return coco_eval.evaluate()


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_caption_fn(
    model,
    cfg: Config,
    mode: str = "greedy",
) -> Callable:
    """Returns ``fn(features, generator=None) -> ids [B, max_decode_len]`` on
    the model's device. ``mode='sample'`` needs the generator (on that
    device); the evaluation loop seeds one per batch."""

    @torch.no_grad()
    def fn(features: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return decode_ids(model, cfg, features, mode, generator=generator)

    return fn


def evaluation(
    model,
    cfg: Config,
    validloader,
    vocab: Vocabulary,
    mode: str = "greedy",
    ann_file: Optional[str] = None,
    run_language_eval: Optional[bool] = None,
    _fns=None,  # (loss_step, caption_fn, encode_images) reused across calls
) -> Tuple[float, List[Dict], Dict]:
    """Returns ``(val_loss, predictions, lang_stats)`` (eval.py:58-122).

    Each batch holds ``captions`` and ``lengths``, ``imgids`` and
    ``cocoids``, and either ``features`` (the trunk's output: [B, L, 512]
    for Show-Attend-Tell, [B, 2048] for Show-and-Tell) or uint8 ``images``
    [B, H, W, 3] (centre crop, normalisation and the trunk), as numpy arrays
    or tensors. ``_fns`` lets periodic callers reuse one set of step
    functions (:func:`make_eval_fns`, :func:`make_trainer_eval_fn`).
    """
    loss_step, caption_fn, encode_images = _fns or make_eval_fns(model, cfg, mode)
    device = _device(model)

    if run_language_eval is None:
        run_language_eval = cfg.language_eval == 1

    loss_sum, loss_evals = 0.0, 0
    predictions: List[Dict] = []
    seen = set()

    def collect(loss_d, ids_d, imgids, cocoids):
        nonlocal loss_sum, loss_evals
        loss_sum += float(loss_d)
        loss_evals += 1
        sentences = vocab.decode_batch(ids_d.cpu().numpy())
        for i, sentence in enumerate(sentences):
            imgid = imgids[i]
            if imgid in seen:  # dedup (eval.py:112-118)
                continue
            seen.add(imgid)
            predictions.append({"image_id": cocoids[i], "caption": sentence})

    # One-batch-lag pipeline (the serving loop's pattern): queue batch i's
    # encode/loss/decode, then fetch + host-process batch i-1 — the
    # id->string decode and the result transfers come after the next
    # batch's work is queued instead of between batches.
    keys = KeyChain(cfg.random_seed) if mode == "sample" else None
    inflight = None
    for bi, batch in enumerate(validloader):
        dbatch = {
            "captions": torch.as_tensor(batch["captions"]).to(device),
            "lengths": torch.as_tensor(batch["lengths"]).to(device),
        }
        if "features" in batch:
            dbatch["features"] = torch.as_tensor(batch["features"]).to(device)
        else:
            dbatch["features"] = encode_images(batch["images"])
        loss_d, _ = loss_step(dbatch)
        generator = keys.generator(bi, device=device) if keys is not None else None
        ids_d = caption_fn(dbatch["features"], generator)
        if inflight is not None:
            collect(*inflight)
        inflight = (loss_d, ids_d, batch["imgids"], batch["cocoids"])
    if inflight is not None:
        collect(*inflight)

    lang_stats: Dict = {}
    if run_language_eval and ann_file:
        lang_stats = language_eval(predictions, ann_file)
    elif run_language_eval:
        # language_eval==1 with no annotation file would otherwise SILENTLY
        # switch the best-checkpoint gate from CIDEr to -val_loss: say so
        # once, loudly.
        global _warned_no_ann
        if not _warned_no_ann:
            _warned_no_ann = True
            log.warning(
                "language_eval=1 but ann_file is unset: language metrics "
                "are skipped and the best-checkpoint gate falls back to "
                "-val_loss. Pass Config.ann_file (a COCO-format annotation "
                "JSON) to gate on CIDEr as configured."
            )
    return loss_sum / max(loss_evals, 1), predictions, lang_stats


def make_eval_fns(model, cfg: Config, mode: str = "greedy"):
    """The three step functions of an evaluation (loss, captioning, image
    encode), built once for repeated evaluations."""
    loss_step = make_eval_loss_step(model, cfg)
    caption_fn = make_caption_fn(model, cfg, mode)
    device = _device(model)

    @torch.no_grad()
    def encode_images(images_u8) -> torch.Tensor:
        # CenterCrop + Normalize on device (main.py:32-36), then backbone.
        x = torch.as_tensor(images_u8).to(device)
        return model.backbone_features(eval_transform(x, cfg.crop_size))

    return loss_step, caption_fn, encode_images


@contextlib.contextmanager
def _swapped_weights(model, params: Optional[Mapping[str, torch.Tensor]]):
    """Run the block with ``params`` (trainable parameters by state-dict
    name, e.g. a ``TrainState``'s ``params`` or ``ema_params``) copied into
    the model's own, and copy the model's back afterwards. ``None`` or the
    model's own tensors change nothing."""
    own = trainable_state_dict(model)
    if params is not None:
        check_like(own, params, "evaluated params")
    swap = {
        k: v for k, v in (params or {}).items() if own[k].data_ptr() != v.data_ptr()
    }
    saved = {k: own[k].detach().clone() for k in swap}
    try:
        with torch.no_grad():
            for k, v in swap.items():
                own[k].copy_(v)
        yield model
    finally:
        with torch.no_grad():
            for k, v in saved.items():
                own[k].copy_(v)


def make_trainer_eval_fn(
    model, cfg: Config, validloader, vocab: Vocabulary, mode: str = "greedy"
) -> Callable:
    """Adapter producing the ``eval_fn(params=None)`` a trainer consumes
    (train.py:157-159 call shape): ``params`` is a dict of trainable
    parameters by state-dict name (a ``TrainState``'s ``params`` or
    ``ema_params``), evaluated in place of the model's own, which are left
    as they were. The step functions are built once here and reused for
    every checkpoint evaluation."""
    fns = make_eval_fns(model, cfg, mode)

    def eval_fn(params: Optional[Mapping[str, torch.Tensor]] = None):
        with _swapped_weights(model, params):
            return evaluation(
                model, cfg, validloader, vocab,
                mode=mode, ann_file=cfg.ann_file, _fns=fns,
            )

    return eval_fn
