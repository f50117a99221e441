"""Metric orchestrator — the ``COCOEvalCap`` equivalent.

Covers the same pipeline as the reference (pycocoevalcap/eval.py:9-75): pair
ground truths and results per image id, PTB-tokenize both sides, run the
scorer suite, and aggregate corpus-level scores (``.eval``) plus per-image
scores (``.imgToEval`` / ``.evalImgs``) under the identical metric names
(Bleu_1..Bleu_4, METEOR, ROUGE_L, CIDEr, SPICE — eval.py:39-45).

The internals are registry-driven rather than a hand-unrolled scorer list:
each :class:`ScorerSpec` declares a factory, the metric names it yields, and
an availability predicate; ``evaluate`` is one generic loop that normalizes
every scorer to the multi-metric shape. SPICE's spec is gated on a backend
being installed (metrics/spice.py), mirroring the reference's de-facto
behavior where the SPICE jar is missing.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from show_and_tell_tpu_torch.metrics.bleu import Bleu
from show_and_tell_tpu_torch.metrics.cider import Cider
from show_and_tell_tpu_torch.metrics.meteor import Meteor
from show_and_tell_tpu_torch.metrics.rouge import Rouge
from show_and_tell_tpu_torch.metrics.spice import Spice
from show_and_tell_tpu_torch.metrics.tokenizer import PTBTokenizer

log = logging.getLogger(__name__)


def _nanmean(vals) -> float:
    vals = [v for v in vals if not math.isnan(v)]
    return sum(vals) / len(vals) if vals else float("nan")


@dataclass(frozen=True)
class ScorerSpec:
    """One entry in the metric registry.

    ``factory`` builds a scorer exposing ``compute_score(gts, res) ->
    (score(s), per_image(s))``; ``names`` are the reported metric names, one
    per returned score (a single-element tuple means the scorer returns a
    scalar + flat per-image list); ``enabled`` lets a spec opt out at runtime
    (SPICE without a backend)."""

    factory: Callable
    names: Tuple[str, ...]
    enabled: Callable[[], bool] = field(default=lambda: True)


def default_registry() -> List[ScorerSpec]:
    return [
        ScorerSpec(lambda: Bleu(4), ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4")),
        ScorerSpec(Meteor, ("METEOR",)),
        ScorerSpec(Rouge, ("ROUGE_L",)),
        ScorerSpec(Cider, ("CIDEr",)),
        ScorerSpec(
            lambda: Spice(strict=False),
            ("SPICE",),
            enabled=lambda: Spice(strict=False).available(),
        ),
    ]


class COCOEvalCap:
    """Drop-in for the reference orchestrator: construct with an annotation
    index and a result index, call :meth:`evaluate`, read ``.eval`` /
    ``.imgToEval`` / ``.evalImgs``."""

    def __init__(self, coco, cocoRes, registry: Optional[Sequence[ScorerSpec]] = None):
        self.coco = coco
        self.cocoRes = cocoRes
        self.params = {"image_id": coco.getImgIds()}
        self.eval: Dict[str, float] = {}
        self.imgToEval: Dict = {}
        self.evalImgs: List[Dict] = []
        self._registry = list(registry) if registry is not None else default_registry()

    # -- data assembly ------------------------------------------------------

    def _gather(self) -> Tuple[Dict, Dict]:
        """(gts, res) caption dicts keyed by image id, PTB-tokenized.

        Images that appear in the annotation file with zero reference
        captions are excluded up front with a warning — scoring against an
        empty reference set is undefined (the reference would KeyError or
        degenerate here depending on the pycocotools version)."""
        ids = self.params["image_id"]
        missing = [i for i in ids if not self.coco.imgToAnns.get(i)]
        if missing:
            log.warning(
                "skipping %d image(s) with no reference captions: %s%s",
                len(missing),
                missing[:10],
                "..." if len(missing) > 10 else "",
            )
            missing_set = set(missing)
            ids = [i for i in ids if i not in missing_set]
        gts = {i: self.coco.imgToAnns[i] for i in ids}
        res = {i: self.cocoRes.imgToAnns[i] for i in ids}
        log.info("tokenization...")
        tok = PTBTokenizer()
        return tok.tokenize(gts), tok.tokenize(res)

    # -- aggregation ----------------------------------------------------------

    def _record(self, name: str, corpus: float, per_image, ordered_ids) -> None:
        self.eval[name] = corpus
        for img_id, s in zip(ordered_ids, per_image):
            self.imgToEval.setdefault(img_id, {"image_id": img_id})[name] = s

    def evaluate(self) -> Dict[str, float]:
        gts, res = self._gather()
        # every scorer emits per-image scores in sorted-image-id order
        ordered_ids = sorted(gts.keys())

        for spec in self._registry:
            if not spec.enabled():
                log.info("scorer for %s unavailable, skipped", spec.names)
                continue
            scorer = spec.factory()
            log.info("computing %s score...", scorer.method())
            corpus, per_image = scorer.compute_score(gts, res)
            # normalize scalar-returning scorers to the multi-metric shape
            if len(spec.names) == 1:
                corpus, per_image = [corpus], [per_image]
            for name, c, p in zip(spec.names, corpus, per_image):
                self._record(name, c, p, ordered_ids)
                log.info("%s: %0.3f", name, c)
                if name == "SPICE" and p and isinstance(p[0], dict):
                    # the Java scorer's -subset breakdown (spice.py:66):
                    # corpus mean f per category over images where the
                    # category is defined (NaN = absent from both graphs).
                    # Non-dict entries can appear when a cached_backend
                    # file predates the subcategory shape — skip them.
                    dicts = [si for si in p if isinstance(si, dict)]
                    log.info(
                        "SPICE subcategories: %s",
                        ", ".join(
                            "%s %.3f"
                            % (cat, _nanmean(si[cat]["f"] for si in dicts))
                            for cat in p[0]
                            if cat != "All"
                        ),
                    )

        self.evalImgs = [self.imgToEval[i] for i in sorted(self.imgToEval)]
        return self.eval
