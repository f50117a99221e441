"""Attention-map figures: one panel per decoded word, brightened where the
model looked. numpy and PIL only (PIL is imported where it is used).

Renders what ``Captioner.caption_with_attention`` returns: captions and
alphas [N, T, L], with L a square patch grid (196 = 14 x 14 at 224 px).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np


def model_view(image_u8: np.ndarray, crop: int) -> np.ndarray:
    """The centre crop of one image that the model attended over, as
    ``data.transforms.eval_transform`` takes it. Lay the sheets over this
    view: the attention grid covers the crop, not the whole frame."""
    H, W = image_u8.shape[:2]
    if crop >= H and crop >= W:
        return image_u8
    top, left = max((H - crop) // 2, 0), max((W - crop) // 2, 0)
    return image_u8[top : top + crop, left : left + crop]


def attention_overlay(image_u8: np.ndarray, alpha: np.ndarray, gamma: float = 0.6) -> np.ndarray:
    """One step's overlay. ``image_u8`` [H, W, 3] uint8, ``alpha`` [L] on a
    square grid. Returns [H, W, 3] uint8 ``img * (0.3 + 0.7 * heat**gamma)``,
    heat being the max-normalised alpha resized bilinearly to the image."""
    from PIL import Image

    H, W = image_u8.shape[:2]
    g = int(round(math.sqrt(alpha.size)))
    assert g * g == alpha.size, f"alpha size {alpha.size} is not a square grid"
    heat = alpha.reshape(g, g).astype(np.float32)
    heat = heat / max(float(heat.max()), 1e-8)
    heat_img = Image.fromarray((heat * 255).astype(np.uint8)).resize((W, H), Image.BILINEAR)
    heat = np.asarray(heat_img, np.float32) / 255.0
    mask = 0.3 + 0.7 * heat[..., None] ** gamma
    return np.clip(image_u8.astype(np.float32) * mask, 0, 255).astype(np.uint8)


def attention_sheet(
    image_u8: np.ndarray,
    alphas: np.ndarray,  # [T, L]
    words: Sequence[str],
    max_cols: int = 5,
    label_height: int = 14,
) -> "object":
    """Contact sheet: the image, then one overlay per word, each panel
    labelled with its word. Returns a PIL Image."""
    from PIL import Image, ImageDraw

    T = min(len(words), alphas.shape[0])
    panels = [("input", image_u8)] + [
        (words[t], attention_overlay(image_u8, alphas[t])) for t in range(T)
    ]
    H, W = image_u8.shape[:2]
    cols = min(max_cols, len(panels))
    rows = math.ceil(len(panels) / cols)
    sheet = Image.new("RGB", (cols * W, rows * (H + label_height)), (255, 255, 255))
    draw = ImageDraw.Draw(sheet)
    for i, (word, panel) in enumerate(panels):
        r, c = divmod(i, cols)
        x, y = c * W, r * (H + label_height)
        sheet.paste(Image.fromarray(panel), (x, y))
        draw.text((x + 2, y + H), word, fill=(0, 0, 0))
    return sheet


def save_attention_sheets(
    images_u8: np.ndarray,  # [B, H, W, 3]
    ids: np.ndarray,  # [B, T]
    alphas: np.ndarray,  # [B, T, L]
    vocab,
    out_paths: Sequence[str],
    max_words: Optional[int] = None,
) -> List[str]:
    """One sheet per image, its caption cut at ``<end>`` by
    ``vocab.decode_batch``. Returns the paths written."""
    sentences = vocab.decode_batch(np.asarray(ids))
    written = []
    for b, path in enumerate(out_paths):
        words = sentences[b].split()
        if max_words:
            words = words[:max_words]
        if not words:  # an empty decode still shows the input panel
            words = ["<no caption>"]
        sheet = attention_sheet(np.asarray(images_u8[b]), np.asarray(alphas[b]), words)
        sheet.save(path)
        written.append(path)
    return written
