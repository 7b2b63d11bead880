"""The colour augmentation of the training reader (counterpart of
``unopose_tpu/data/color_aug.py``), the gdrnpp recipe in numpy, cv2 and
``PIL.ImageEnhance`` (the ops imgaug's ``pillike`` wraps). The ops run in a
random order, each with its probability:

    0.5 CoarseDropout(p=0.2, size_percent=0.05)
    0.4 GaussianBlur(sigma 0..3)
    0.3 EnhanceSharpness(0..50)     0.3 EnhanceContrast(0.2..50)
    0.5 EnhanceBrightness(0.1..6)   0.3 EnhanceColor(0..20)
    0.5 Add(-25..25, per_channel 0.3)
    0.3 Invert(p=0.2, per_channel)
    0.5 Multiply(0.6..1.4, per_channel 0.5)
    0.5 Multiply(0.6..1.4)
    0.1 AdditiveGaussianNoise(scale 10, per_channel)
    0.5 LinearContrast(0.5..2.2, per_channel 0.3)
    0.5 Grayscale(alpha 0..1)

Every draw comes from the caller's ``np.random.Generator``, in the JAX
package's order, so that one generator gives both packages the same image.
"""

from __future__ import annotations

import cv2
import numpy as np
from PIL import Image, ImageEnhance


def _coarse_dropout(rng, img, p=0.2, size_percent=0.05):
    h, w = img.shape[:2]
    gh, gw = max(1, int(h * size_percent)), max(1, int(w * size_percent))
    grid = rng.random((gh, gw)) < p
    mask = cv2.resize(grid.astype(np.uint8), (w, h), interpolation=cv2.INTER_NEAREST).astype(bool)
    out = img.copy()
    out[mask] = 0
    return out


def _gaussian_blur(rng, img, lo=0.0, hi=3.0):
    sigma = rng.uniform(lo, hi)
    if sigma < 1e-3:
        return img
    k = max(3, int(sigma * 4) | 1)
    return cv2.GaussianBlur(img, (k, k), sigma)


def _pil_enhance(rng, img, enhancer, lo, hi):
    factor = rng.uniform(lo, hi)
    return np.asarray(enhancer(Image.fromarray(img)).enhance(factor))


def _add(rng, img, lo=-25, hi=25, per_channel_p=0.3):
    if rng.random() < per_channel_p:
        delta = rng.uniform(lo, hi, size=(1, 1, img.shape[2]))
    else:
        delta = rng.uniform(lo, hi)
    return np.clip(img.astype(np.float32) + delta, 0, 255).astype(np.uint8)


def _invert(rng, img, p=0.2):
    ch = rng.random(img.shape[2]) < p
    out = img.copy()
    out[..., ch] = 255 - out[..., ch]
    return out


def _multiply(rng, img, lo=0.6, hi=1.4, per_channel_p=0.0):
    if per_channel_p and rng.random() < per_channel_p:
        m = rng.uniform(lo, hi, size=(1, 1, img.shape[2]))
    else:
        m = rng.uniform(lo, hi)
    return np.clip(img.astype(np.float32) * m, 0, 255).astype(np.uint8)


def _gauss_noise(rng, img, scale=10.0):
    noise = rng.normal(0, scale, size=img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def _linear_contrast(rng, img, lo=0.5, hi=2.2, per_channel_p=0.3):
    if rng.random() < per_channel_p:
        a = rng.uniform(lo, hi, size=(1, 1, img.shape[2]))
    else:
        a = rng.uniform(lo, hi)
    return np.clip((img.astype(np.float32) - 128.0) * a + 128.0, 0, 255).astype(np.uint8)


def _grayscale(rng, img, alo=0.0, ahi=1.0):
    alpha = rng.uniform(alo, ahi)
    gray = (img.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
    return np.clip((1 - alpha) * img.astype(np.float32) + alpha * gray, 0, 255).astype(np.uint8)


# the four PIL enhancers and their factor ranges
ENHANCERS = {
    "sharpness": (ImageEnhance.Sharpness, 0.0, 50.0),
    "contrast": (ImageEnhance.Contrast, 0.2, 50.0),
    "brightness": (ImageEnhance.Brightness, 0.1, 6.0),
    "color": (ImageEnhance.Color, 0.0, 20.0),
}


def _enhance(name):
    enhancer, lo, hi = ENHANCERS[name]
    return lambda r, im: _pil_enhance(r, im, enhancer, lo, hi)


class ColorAugmentor:
    """Callable augmentor: (generator, uint8 (H, W, 3)) -> uint8 (H, W, 3)."""

    def __init__(self):
        self.ops = [
            (0.5, _coarse_dropout),
            (0.4, _gaussian_blur),
            (0.3, _enhance("sharpness")),
            (0.3, _enhance("contrast")),
            (0.5, _enhance("brightness")),
            (0.3, _enhance("color")),
            (0.5, _add),
            (0.3, _invert),
            (0.5, lambda r, im: _multiply(r, im, per_channel_p=0.5)),
            (0.5, _multiply),
            (0.1, _gauss_noise),
            (0.5, _linear_contrast),
            (0.5, _grayscale),
        ]

    def __call__(self, rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
        for i in rng.permutation(len(self.ops)):
            p, op = self.ops[i]
            if rng.random() < p:
                img = op(rng, img)
        return img
