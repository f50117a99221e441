"""Standalone metric scoring — the pycocoevalcap workflow with no model.

The reference suite is routinely run directly on a predictions file
(``coco.loadRes`` + ``COCOEvalCap``, pycocoevalcap/eval.py:9-62); this CLI
exposes that exact path so captions produced by ANY system — this
framework, the reference, or a third party — score against a COCO
annotation file with the full JVM-free metric stack (BLEU-1..4, METEOR,
ROUGE-L, CIDEr, SPICE incl. subcategory score sets).

Usage::

    python -m show_and_tell_tpu_torch.cli.score \
        --ann_file captions_val2014.json --res_file results.json \
        [--per_image_out per_image.json] [--spice_cache cache.json]

``res_file``: COCO results format — a JSON list of
``{"image_id": <cocoid>, "caption": "..."}``.
Prints one metric per line (the reference orchestrator's console format)
plus a final one-line JSON summary; ``--per_image_out`` additionally
writes the per-image scores (SPICE entries carry the subcategory dicts).
Exit code 1 if no prediction matches the annotation ids.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import sys

from show_and_tell_tpu_torch.utils.logging import setup_logging

log = logging.getLogger(__name__)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ann_file", required=True,
                    help="COCO caption annotation JSON (images+annotations)")
    ap.add_argument("--res_file", required=True,
                    help="predictions JSON: [{'image_id', 'caption'}, ...]")
    ap.add_argument("--per_image_out", default=None,
                    help="optional path for per-image scores JSON")
    ap.add_argument("--spice_cache", default=None,
                    help="optional persistent SPICE cache path")
    args = ap.parse_args(argv)
    setup_logging("score_log.txt")

    if args.spice_cache:
        from show_and_tell_tpu_torch.metrics import spice as spice_mod
        from show_and_tell_tpu_torch.metrics.scene_graph import spice_backend

        spice_mod.set_backend(
            spice_mod.cached_backend(spice_backend, args.spice_cache)
        )

    with open(args.res_file) as f:
        predictions = json.load(f)
    if not isinstance(predictions, list):
        raise SystemExit("res_file must be a JSON list of predictions")

    from show_and_tell_tpu_torch.metrics.coco import COCO
    from show_and_tell_tpu_torch.metrics.orchestrator import COCOEvalCap

    coco = COCO(args.ann_file)
    valids = set(coco.getImgIds())
    preds = [p for p in predictions if p.get("image_id") in valids]
    log.info("scoring %d/%d predictions", len(preds), len(predictions))
    if not preds:
        print("no prediction matches the annotation image ids", file=sys.stderr)
        return 1
    coco_res = coco.loadRes(preds)
    coco_eval = COCOEvalCap(coco, coco_res)
    coco_eval.params["image_id"] = coco_res.getImgIds()
    scores = coco_eval.evaluate()

    if args.per_image_out:
        def jsonable(v):
            if isinstance(v, dict):
                return {k: jsonable(x) for k, x in v.items()}
            if isinstance(v, float) and math.isnan(v):
                return None  # the jar's JSON null for undefined categories
            return v

        with open(args.per_image_out, "w") as f:
            json.dump(
                {str(i): jsonable(v) for i, v in coco_eval.imgToEval.items()},
                f,
            )
        log.info("per-image scores -> %s", args.per_image_out)
    print(json.dumps({"n_scored": len(preds), **{k: round(v, 6) for k, v in scores.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
