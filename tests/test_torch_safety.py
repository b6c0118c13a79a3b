"""The port's image safety checker against the JAX package's
(cremage_tpu/models/safety_checker.py, services/safety.py): the CLIP
vision tower and the concept scores at a tiny width in float32 on the
CPU, the preprocessing's bicubic resize against cv2 (which the JAX
package calls), and the classifier loaded from a file under HF names."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cremage_tpu.models.safety_checker import SafetyCheckerConfig as JConfig
from cremage_tpu.models.safety_checker import StableDiffusionSafetyChecker as JChecker
from cremage_tpu.models.safety_checker import load_safety_classifier as j_classifier
from cremage_tpu.models.safety_checker import preprocess_images01 as j_preprocess
from cremage_tpu.services.safety import ImageSafetyChecker as JSafety
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io.checkpoint import save_safetensors
from cremage_tpu_torch.models.safety_checker import (
    SafetyCheckerConfig, StableDiffusionSafetyChecker, load_safety_classifier,
    preprocess_images01,
)
from cremage_tpu_torch.services.safety import (
    ImageSafetyChecker, TextSafetyChecker, default_image_safety,
)
from tests.test_torch_pipeline import jax_params, cheap_jax  # noqa: F401

torch.set_num_threads(2)

TINY = dict(image_size=56, patch_size=14, hidden_size=32, num_layers=2,
            num_heads=4, intermediate_size=48, projection_dim=16, n_concepts=5,
            n_special=2)


@pytest.fixture(scope="module")
def checkers():
    jm = JChecker(JConfig(**TINY))
    p = jax_params(jm, 31, jnp.zeros((1, 56, 56, 3)))
    tm = convert.load_from_jax(
        StableDiffusionSafetyChecker(SafetyCheckerConfig(**TINY, dtype=torch.float32)),
        p["params"]).eval()
    return jm, p, tm


def test_tower_and_scores_match_jax(checkers):
    jm, p, tm = checkers
    x = np.random.RandomState(32).uniform(-2, 2, (3, 56, 56, 3)).astype(np.float32)
    want_c, want_s = jax.jit(jm.apply)(p, jnp.asarray(x))
    with torch.no_grad():
        got_c, got_s = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("h,w", [(512, 512), (64, 64), (512, 768), (768, 512)])
def test_preprocess_matches_cv2(h, w):
    img = np.random.RandomState(h + w).rand(2, h, w, 3).astype(np.float32)
    want = j_preprocess(img)            # cv2.resize(INTER_CUBIC) + crop + norm
    got = preprocess_images01(img).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_classifier_file_flags_and_swaps_as_jax(checkers, tmp_path, monkeypatch):
    """The classifier read from a file under HF names (position_ids
    included) scores as JAX's, and a flagged image swaps to the
    replacement; the thresholds are set so that some images flag."""
    _, _, tm = checkers
    sd = dict(tm.state_dict())
    sd["concept_embeds_weights"] = torch.full((5,), 0.3)
    sd["special_care_embeds_weights"] = torch.full((2,), 0.99)
    sd["vision_model.vision_model.embeddings.position_ids"] = torch.arange(17)[None]
    path = str(tmp_path / "safety.safetensors")
    save_safetensors(path, sd)
    imgs = np.random.RandomState(33).rand(6, 60, 50, 3).astype(np.float32)
    cfg = SafetyCheckerConfig(**TINY, dtype=torch.float32)
    ours = load_safety_classifier(path, cfg, device="cpu")
    theirs = j_classifier(path, JConfig(**TINY))
    scores = ours(imgs)
    np.testing.assert_array_equal(scores, theirs(imgs))
    assert 0 < scores.sum() < len(imgs)
    rep = np.full((8, 8, 3), 0.5, np.float32)
    got, flags = ImageSafetyChecker(ours, rep).check(imgs)
    want, jflags = JSafety(theirs, rep).check(imgs)
    assert flags == jflags == [bool(s) for s in scores]
    np.testing.assert_array_equal(got, want)
    assert (got[flags.index(True)] == 0.5).all()
    # SAFETY_CHECKER_PATH selects the file; without it images pass
    monkeypatch.setenv("SAFETY_CHECKER_PATH", path)
    assert default_image_safety(cfg=cfg, device="cpu").classifier is not None
    monkeypatch.setenv("SAFETY_CHECKER_PATH", path + ".missing")
    with pytest.raises(FileNotFoundError):
        default_image_safety(cfg=cfg, device="cpu")
    monkeypatch.delenv("SAFETY_CHECKER_PATH")
    passthrough = default_image_safety(device="cpu")
    same, none = passthrough.check(imgs)
    assert same is imgs and none == [False] * 6


def test_text_gate_deny_list():
    gate = TextSafetyChecker(deny_terms=["Forbidden"])
    assert gate.should_block("a FORBIDDEN thing") and not gate.should_block("fine")
    assert not TextSafetyChecker().should_block("anything")
