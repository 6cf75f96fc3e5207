"""Image IO + comparison.

``compare_img`` is the rebuild of tools/compare_img.cpp:15-29 (per-channel
means of two renders for regression checks), extended with the allclose
metrics the BASELINE demands. A copy of ``snail_tpu.utils.image``; PIL is
imported only by the functions that read or write a file.
"""

from __future__ import annotations

import numpy as np


def save_image(path: str, img: np.ndarray) -> None:
    """Save float [H,W,3] (linear, 0-1) or uint8 image as PNG/TGA-alike."""
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def compare_img(a: np.ndarray, b: np.ndarray) -> dict:
    """Per-channel means (the reference tool's output) + error metrics."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    diff = np.abs(a - b)
    return {
        "mean_a": a.reshape(-1, a.shape[-1]).mean(axis=0).tolist(),
        "mean_b": b.reshape(-1, b.shape[-1]).mean(axis=0).tolist(),
        "mae": float(diff.mean()),
        "max_err": float(diff.max()),
        "bad_frac": float((diff.max(axis=-1) > 2.0 / 255.0).mean()),
    }
