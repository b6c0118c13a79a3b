"""Safety filtering (the port of cremage_tpu/services/safety.py).

- Image safety: the CompVis checker (models/safety_checker.py) scores each
  image; flagged ones are replaced by a placeholder (reference
  `sd/image_generator.py:508,539-551`). Without classifier weights
  (SAFETY_CHECKER_PATH unset) images pass unchanged and are reported
  unflagged, as the JAX package does (the reference downloads the weights
  at run time): `default_image_safety` logs that it runs so.
- Text safety: a prompt gate (reference `generate_handler.py:77-83`); the
  port has the JAX package's deny-list fallback only (a prompt containing
  a deny term scores 1.0, which is above the block threshold 0.8). The
  BERT predictor is not ported yet.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

TEXT_BLOCK_THRESHOLD = 0.8  # reference generate_handler.py:77-83
IMAGE_FLAG_THRESHOLD = 0.5
SAFETY_CHECKER_PATH_ENV = "SAFETY_CHECKER_PATH"


class ImageSafetyChecker:
    """`classifier(images_01 (B, H, W, 3) float) -> (B,) scores`; images
    scoring above 0.5 are replaced with `replacement` (black when None)."""

    def __init__(self, classifier: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 replacement: Optional[np.ndarray] = None):
        self.classifier = classifier
        self.replacement = replacement

    def check(self, images: np.ndarray) -> Tuple[np.ndarray, List[bool]]:
        """images: (B, H, W, 3) float [0, 1] -> (images, nsfw flags)."""
        if self.classifier is None:
            return images, [False] * len(images)
        scores = np.asarray(self.classifier(images))
        flags = [bool(s > IMAGE_FLAG_THRESHOLD) for s in scores]
        out = images.copy()
        for i, flagged in enumerate(flags):
            if flagged:
                if self.replacement is not None:
                    out[i] = np.resize(self.replacement, out[i].shape)
                else:
                    out[i] = 0.0
        return out, flags


class TextSafetyChecker:
    """`predict(text)`: 1.0 for a prompt containing a deny term (case
    folded), else 0.0; `should_block` above TEXT_BLOCK_THRESHOLD."""

    def __init__(self, deny_terms: Sequence[str] = ()):
        self.deny_terms = [t.lower() for t in deny_terms]

    def predict(self, text: str) -> float:
        low = text.lower()
        return 1.0 if any(t and t in low for t in self.deny_terms) else 0.0

    def should_block(self, text: str) -> bool:
        return self.predict(text) > TEXT_BLOCK_THRESHOLD


def default_image_safety(cfg=None, device=None) -> ImageSafetyChecker:
    """The checker on the CompVis weights at $SAFETY_CHECKER_PATH (on
    `device`), or a pass-through when the variable is unset. A path that
    names no file raises (the JAX package passes images through then: a
    misspelt path would silently turn the checker off)."""
    weights_path = os.environ.get(SAFETY_CHECKER_PATH_ENV, "")
    classifier = None
    if weights_path:
        if not os.path.exists(weights_path):
            raise FileNotFoundError(f"{SAFETY_CHECKER_PATH_ENV}={weights_path!r} "
                                    "names no file")
        from cremage_tpu_torch.models.safety_checker import load_safety_classifier

        classifier = load_safety_classifier(weights_path, cfg, device)
        logger.info("image safety checker loaded from %s", weights_path)
    else:
        logger.info("no image safety classifier weights (%s=%r): images pass "
                    "unflagged, as the JAX package does without weights",
                    SAFETY_CHECKER_PATH_ENV, weights_path)
    # reference load_replacement: a black image (+ an overlay message)
    return ImageSafetyChecker(classifier=classifier,
                              replacement=np.zeros((8, 8, 3), np.float32))
