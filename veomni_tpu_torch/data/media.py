"""Media preprocessing, the image part.

Port of ``smart_resize`` from ``veomni_tpu/data/media.py`` (``:58``): the
qwen-vl pixel-budget resize target. Video and audio decoding
(``load_video`` with its lazy ``cv2``, ``load_audio`` with ``scipy``, the
mel features) wait for the video and audio paths of the VLM and omni
models (ROADMAP.md slice F).
"""

from __future__ import annotations

import math
from typing import Tuple


def smart_resize(height: int, width: int, *, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """(h, w): both sides rounded to multiples of ``factor`` with h * w kept
    within [min_pixels, max_pixels] (reference ``video_utils.py:226``)."""
    if height < factor or width < factor:
        scale = factor / min(height, width)
        height, width = math.ceil(height * scale), math.ceil(width * scale)
    h = max(factor, round(height / factor) * factor)
    w = max(factor, round(width / factor) * factor)
    if h * w > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w
