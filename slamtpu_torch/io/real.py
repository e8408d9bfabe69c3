"""Real-photograph inputs for validation (counterpart of slamtpu/io/real.py).

matplotlib ships one genuine photograph in its sample data,
``grace_hopper.jpg``, a 600x512 RGB portrait. This module loads it (and any
other image file) as the grayscale uint8 frames the pipeline consumes, so
the detector and matcher can be exercised on real image statistics. PIL and
matplotlib are imported when a function is called, never at import (the
GPU machine has neither).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["load_gray", "grace_hopper"]


def load_gray(path: str) -> np.ndarray:
    """Load an image file as grayscale uint8 [H, W] (ITU-R 601 luma)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)


def grace_hopper() -> np.ndarray:
    """The one real photograph available offline: matplotlib's sample JPEG.

    Returns grayscale uint8 [600, 512]. Raises FileNotFoundError when
    matplotlib's sample data is absent (callers and tests should skip then).
    """
    import matplotlib

    path = os.path.join(
        os.path.dirname(matplotlib.__file__), "mpl-data", "sample_data", "grace_hopper.jpg"
    )
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return load_gray(path)
