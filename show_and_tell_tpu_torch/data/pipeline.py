"""Image ingest: a path or encoded bytes to one uint8 RGB array.

Only the two ingest functions of the JAX package's pipeline so far; the
batch ``Loader`` and the native decoder are not ported (ROADMAP.md A5). PIL
is imported inside the functions, so importing this module needs no PIL.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)


def _load_image(src, size: int = 256) -> np.ndarray:
    """Path or raw encoded bytes -> [size, size, 3] uint8 RGB, resized by
    PIL's default filter when it is not already ``size`` square."""
    import io

    from PIL import Image

    fh = io.BytesIO(src) if isinstance(src, (bytes, bytearray)) else src
    img = Image.open(fh).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size))
    return np.asarray(img, dtype=np.uint8)


def _load_image_checked(src, size: int = 256):
    """``(image, ok)``: a corrupt, truncated, empty or unreadable source
    gives ``(zeros, False)`` and a warning instead of an exception, so one
    bad file does not fail a whole batch."""
    try:
        return _load_image(src, size), True
    except Exception as e:  # PIL raises OSError, SyntaxError, ValueError, ...
        desc = src if isinstance(src, str) else f"<{len(src)}-byte request>"
        log.warning("failed to decode image %s: %s", desc, e)
        return np.zeros((size, size, 3), dtype=np.uint8), False
