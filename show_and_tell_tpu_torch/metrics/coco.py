"""Minimal COCO caption-annotation index.

Replaces the ``pycocotools.coco.COCO`` dependency (used at eval.py:22,30-43
of the reference) for the captioning path — which needs only the annotation
index, never the Cython mask code:

- ``COCO(ann_file_or_dict)``: indexes ``annotations`` by image id,
- ``getImgIds()``: all image ids (from ``images`` when present, else from
  annotations),
- ``loadRes(results)``: a result-set COCO over
  ``[{'image_id': id, 'caption': str}, ...]`` (file path or list), ids
  restricted to this COCO's images — same contract the reference relies on
  for filtering predictions to the val set (eval.py:30-43).

``imgToAnns`` values are dicts with at least ``caption`` (and ``image_id``/
``id``), exactly the shape ``COCOEvalCap`` consumes.
"""

from __future__ import annotations

import json
from typing import Dict, List, Union


class COCO:
    def __init__(self, annotations: Union[str, dict, None] = None):
        self.dataset: dict = {}
        self.imgToAnns: Dict[int, List[dict]] = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        if annotations is not None:
            if isinstance(annotations, str):
                with open(annotations) as f:
                    annotations = json.load(f)
            self.dataset = annotations
            self._create_index()

    def _create_index(self) -> None:
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for i, ann in enumerate(self.dataset.get("annotations", [])):
            ann_id = ann.get("id", i + 1)
            self.anns[ann_id] = ann
            self.imgToAnns.setdefault(ann["image_id"], []).append(ann)
            if ann["image_id"] not in self.imgs:
                self.imgs[ann["image_id"]] = {"id": ann["image_id"]}

    def getImgIds(self) -> List[int]:
        return list(self.imgs.keys())

    def getAnnIds(self, imgIds=None) -> List[int]:
        if imgIds is None:
            return list(self.anns.keys())
        if not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        want = set(imgIds)
        return [i for i, a in self.anns.items() if a["image_id"] in want]

    def loadRes(self, res: Union[str, List[dict]]) -> "COCO":
        if isinstance(res, str):
            with open(res) as f:
                res = json.load(f)
        valid = set(self.imgs.keys())
        anns = []
        for i, r in enumerate(res):
            if r["image_id"] not in valid:
                raise ValueError(
                    f"result image_id {r['image_id']} not in the annotation set"
                )
            anns.append(
                {"image_id": r["image_id"], "caption": r["caption"], "id": i + 1}
            )
        out = COCO()
        out.dataset = {
            "images": [{"id": r["image_id"]} for r in res],
            "annotations": anns,
        }
        out._create_index()
        return out
