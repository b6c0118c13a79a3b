"""Checkpoint files -> bundle -> images: the port's loader and pipeline
options against the JAX package's, on the tiny configs of
tests/test_torch_pipeline.py.

One set of files is written in torch key names from seeded random
weights: a single-file checkpoint (with the schedule buffers, an EMA key
and CLIP's position_ids that belong to no model), a standalone VAE, a
kohya LoRA (attention, conv 1x1 proj_in, feed-forward and text-encoder
modules, plus one unmapped and one incomplete module), a TI embedding
(.pt) and a ControlNet (.ckpt nested under state_dict). Both loaders read
them in float32; the weights must agree exactly where no LoRA touched
them and to 1e-6 relative after the float32 merge, and one generate()
with a ControlNet, a TI tag and a wildcard must agree within the 2/255 of
test_txt2img_matches_jax.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from cremage_tpu.core.config import GenerationOptions as JOptions
from cremage_tpu.core.dtypes import FP32_POLICY
from cremage_tpu.io import checkpoint as JCK
from cremage_tpu.models.clip import CLIPTextConfig as JCLIPConfig
from cremage_tpu.models.controlnet import ControlNet as JControlNet
from cremage_tpu.models.unet import UNetConfig as JUNetConfig
from cremage_tpu.models.vae import VAEConfig as JVAEConfig
from cremage_tpu.pipelines import loader as JLOADER
from cremage_tpu.pipelines.loader import load_sd15_bundle as j_load
from cremage_tpu.pipelines.sd15 import SD15Pipeline as JPipeline
from cremage_tpu.services.safety import ImageSafetyChecker as JSafety
from cremage_tpu_torch.core.config import GenerationOptions
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io.png import image_to_uint8
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.controlnet import ControlNet
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.pipelines.loader import load_sd15_bundle
from cremage_tpu_torch.pipelines.sd15 import SD15Pipeline
from cremage_tpu_torch.services.safety import ImageSafetyChecker
from cremage_tpu_torch.services.watermark import decode_watermark
from tests.conftest import assert_img01_close
from tests.test_torch_pipeline import (  # noqa: F401
    CLIP_KW, HID, OPTS, UNET_KW, VAE_KW, jax_noise, shared_template,
    cheap_jax,
)

torch.set_num_threads(2)
F32 = torch.float32

# the tiny UNet's attention blocks under kohya's diffusers names:
# input_blocks.1.1, middle_block.1, output_blocks.2.1 and .3.1
LORA_UNET = [
    ("lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q", (32, 32)),
    ("lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn2_to_k", (32, HID)),
    ("lora_unet_down_blocks_0_attentions_0_proj_in", (32, 32, 1, 1)),
    ("lora_unet_mid_block_attentions_0_transformer_blocks_0_attn1_to_out_0", (64, 64)),
    ("lora_unet_mid_block_attentions_0_transformer_blocks_0_ff_net_0_proj", (512, 64)),
    ("lora_unet_up_blocks_1_attentions_1_transformer_blocks_0_ff_net_2", (32, 128)),
    ("lora_unet_up_blocks_1_attentions_0_proj_out", (32, 32, 1, 1)),
    ("lora_te_text_model_encoder_layers_1_self_attn_v_proj", (HID, HID)),
    ("lora_te_text_model_encoder_layers_0_mlp_fc1", (64, HID)),
]
LORA_WEIGHT = 0.8


def _perturbed(module, gen):
    """The module's state dict plus seeded noise (no trivial layer)."""
    return {k: (v + 0.1 * torch.randn(v.shape, generator=gen)).contiguous()
            for k, v in module.state_dict().items()}


def _lora(gen):
    sd = {}
    for name, shape in LORA_UNET:
        out, inn = shape[0], shape[1]
        r, tail = 2, shape[2:]
        sd[f"{name}.lora_down.weight"] = torch.randn((r, inn) + tail, generator=gen) * 0.1
        sd[f"{name}.lora_up.weight"] = torch.randn((out, r) + tuple(1 for _ in tail),
                                                   generator=gen) * 0.1
        sd[f"{name}.alpha"] = torch.tensor(1.5)
    sd["lora_unet_down_blocks_9_attentions_0_proj_in.lora_down.weight"] = torch.zeros(2, 4)
    sd["lora_unet_down_blocks_9_attentions_0_proj_in.lora_up.weight"] = torch.zeros(4, 2)
    sd["lora_te_text_model_encoder_layers_0_mlp_fc2.alpha"] = torch.tensor(1.0)
    return sd


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    gen = torch.Generator().manual_seed(0)
    with torch.random.fork_rng():
        torch.manual_seed(1)
        unet = UNetModel(UNetConfig(**UNET_KW, dtype=F32))
        vae = AutoencoderKL(VAEConfig(**VAE_KW, dtype=F32))
        clip = CLIPTextModel(CLIPTextConfig(**CLIP_KW, dtype=F32))
        cn = ControlNet(UNetConfig(**UNET_KW, dtype=F32))
    sd = {}
    for prefix, m in (("model.diffusion_model.", unet), ("first_stage_model.", vae),
                      ("cond_stage_model.transformer.text_model.", clip)):
        sd.update({prefix + k: v for k, v in _perturbed(m, gen).items()})
    sd["betas"] = torch.linspace(1e-4, 2e-2, 1000, dtype=torch.float64)
    sd["alphas_cumprod"] = torch.cumprod(1 - sd["betas"], 0)
    sd["model_ema.decay"] = torch.tensor(0.9999)
    sd["cond_stage_model.transformer.text_model.embeddings.position_ids"] = \
        torch.arange(77)[None]
    paths = dict(model=d / "model.safetensors", vae=d / "vae.safetensors",
                 lora=d / "lora.safetensors", cn=d / "control.ckpt",
                 emb=d / "embeddings", wild=d / "wildcards")
    save_file(sd, str(paths["model"]))
    save_file(_perturbed(vae, gen), str(paths["vae"]))
    save_file(_lora(gen), str(paths["lora"]))
    torch.save({"state_dict": {"control_model." + k: v
                               for k, v in _perturbed(cn, gen).items()},
                "global_step": 7}, paths["cn"])
    paths["emb"].mkdir()
    torch.save({"string_to_param": {"*": torch.randn(2, HID, generator=gen)}},
               paths["emb"] / "tok.pt")
    paths["wild"].mkdir()
    (paths["wild"] / "color.txt").write_text("# colours\nred\n\ngreen\nblue\n")
    return {k: str(v) for k, v in paths.items()}


def _jax_bundle(files, monkeypatch):
    # the init traces shared with the run's other workers
    monkeypatch.setattr(JLOADER, "_template", shared_template(JLOADER._template))
    jb = j_load(files["model"], vae_ckpt=files["vae"],
                loras=[(files["lora"], LORA_WEIGHT)],
                embedding_dir=files["emb"], policy=FP32_POLICY,
                use_cache=False, unet_cfg_override=JUNetConfig(**UNET_KW),
                vae_cfg_override=JVAEConfig(**VAE_KW),
                clip_cfg_override=JCLIPConfig(**CLIP_KW))
    # JAX's loader builds the ControlNet's template with a 768-wide context
    # (loader.py), which the tiny ControlNet does not have: the same
    # build_flax_params call, on the tiny template
    jcn = JControlNet(JUNetConfig(**UNET_KW, dtype=jnp.float32))
    tmpl = JLOADER._template(jcn, jnp.zeros((1, 8, 8, 4)),
                             jnp.zeros((1, 64, 64, 3)), jnp.zeros((1,)),
                             jnp.zeros((1, 77, HID)))
    cn_params, _, _ = JCK.build_flax_params(
        tmpl, JCK.load_state_dict(files["cn"]), "control_model.",
        dtype=jnp.float32)
    jb.controlnet = (jcn, {"params": cn_params})
    return jb


@pytest.fixture(scope="module")
def port_bundle(files):
    return load_sd15_bundle(files["model"], vae_ckpt=files["vae"],
                            loras=[(files["lora"], LORA_WEIGHT)],
                            embedding_dir=files["emb"],
                            control_ckpt=files["cn"], device="cpu", dtype=F32,
                            unet_cfg=UNetConfig(**UNET_KW),
                            vae_cfg=VAEConfig(**VAE_KW),
                            clip_cfg=CLIPTextConfig(**CLIP_KW))


def _compare(module, jax_params, rename, lora_targets):
    want = convert.state_dict_from_jax(module, jax_params, rename)
    for k, v in module.state_dict().items():
        if k.rsplit(".", 1)[0] in lora_targets:
            w = want[k].numpy()
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
        else:
            assert torch.equal(v, want[k]), k


def test_loader_and_generate_match_jax(files, port_bundle, monkeypatch):
    """One test, so that the JAX bundle is loaded once per run."""
    monkeypatch.delenv("SAFETY_CHECKER_PATH", raising=False)
    jb, tb = _jax_bundle(files, monkeypatch), port_bundle
    report = tb.load_report
    names = report["lora_modules"]
    assert report["loras"] == [dict(path=files["lora"], merged=len(LORA_UNET),
                                    skipped=2)]
    unet_t = {n[5:] for n in names if n.startswith("unet:")}
    te_t = {n[3:] for n in names if n.startswith("te:")}
    assert len(unet_t) == 7 and len(te_t) == 2
    _compare(tb.unet, jb.unet_params["params"], lambda k: k, unet_t)
    _compare(tb.vae, jb.vae_params["params"], lambda k: k, set())
    _compare(tb.text.model, jb.text.params["params"], convert.clip_jax_name, te_t)
    _compare(tb.controlnet, jb.controlnet[1]["params"], lambda k: k, set())
    # the LoRA moved exactly its targets
    assert unet_t == {
        "input_blocks.1.1.transformer_blocks.0.attn1.to_q",
        "input_blocks.1.1.transformer_blocks.0.attn2.to_k",
        "input_blocks.1.1.proj_in",
        "middle_block.1.transformer_blocks.0.attn1.to_out.0",
        "middle_block.1.transformer_blocks.0.ff.net.0.proj",
        "output_blocks.3.1.transformer_blocks.0.ff.net.2",
        "output_blocks.2.1.proj_out"}
    assert set(report["files"]) == {files[k] for k in ("model", "vae", "lora", "cn")}
    assert all(f["bytes"] > 0 and f["seconds"] >= 0 for f in report["files"].values())

    # one generate() each with a ControlNet, a TI tag and a wildcard
    opts = dict(OPTS, prompt="a __color__ (cat:1.1) <embedding:tok.pt>",
                wildcards_path=files["wild"], safety_check=True)
    control = np.random.RandomState(3).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    want = JPipeline(jb).generate(JOptions(**opts), control_image=control,
                                  control_weight=0.7)
    init, steps = jax_noise(42, 0, (2, 8, 8, 4), 3)
    got = SD15Pipeline(tb, device="cpu").generate(
        GenerationOptions(**opts), control_image=control, control_weight=0.7,
        noise=lambda seed, device: ArrayNoise(init, steps, device))
    assert len(got) == len(want) == 2
    for (gi, gm), (wi, wm) in zip(got, want):
        assert_img01_close(gi, wi, float_tol=2.0 / 255.0)
        assert gm.pop("nsfw") is False        # the port adds the flag
        assert gm == wm
        assert "__" not in gm["prompt"] and gm["prompt"] != opts["prompt"]
    # the hint mattered: without it the port's image differs
    plain = SD15Pipeline(tb, device="cpu").generate(
        GenerationOptions(**dict(opts, n_samples=1)),
        noise=lambda seed, device: ArrayNoise(init[:1], [s[:1] for s in steps],
                                              device))
    assert np.abs(plain[0][0] - got[0][0]).max() > 1e-3
    # and so did the TI tag
    enc = tb.text.encode
    assert np.abs(enc("a cat <embedding:tok.pt>") - enc("a cat")).max() > 1e-3


def test_safety_flags_and_watermark_through_generate(port_bundle):
    tb = port_bundle
    rep = np.full((4, 4, 3), 0.25, np.float32)
    flagger = ImageSafetyChecker(classifier=lambda im: np.array([1.0, 0.0]),
                                 replacement=rep)
    got = SD15Pipeline(tb, device="cpu", safety=flagger).generate(
        GenerationOptions(**dict(OPTS, sampling_steps=1, watermark=True,
                                 safety_check=True)))
    assert [m["nsfw"] for _, m in got] == [True, False]
    np.testing.assert_array_equal(got[0][0][..., :2], 0.25)
    for img, _ in got:
        assert decode_watermark(image_to_uint8(img), 7) == b"Cremage"
    # the JAX checker swaps the same way
    jflag = JSafety(classifier=lambda im: np.array([1.0, 0.0]), replacement=rep)
    imgs = np.random.RandomState(0).rand(2, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(flagger.check(imgs)[0], jflag.check(imgs)[0])


def test_inpainting_checkpoint_loads_into_the_9_channel_unet(files, tmp_path):
    """A checkpoint whose UNet takes 9 input channels loads with
    inpainting=True, and not into the 4-channel UNet."""
    from cremage_tpu_torch.io.checkpoint import load_safetensors

    sd = dict(load_safetensors(files["model"]))
    k = "model.diffusion_model.input_blocks.0.0.weight"
    sd[k] = torch.cat([sd[k], torch.randn(32, 5, 3, 3)], dim=1)
    path = str(tmp_path / "inpaint.safetensors")
    save_file({n: t.contiguous() for n, t in sd.items()}, path)
    kw = dict(device="cpu", dtype=F32, unet_cfg=UNetConfig(**UNET_KW),
              vae_cfg=VAEConfig(**VAE_KW), clip_cfg=CLIPTextConfig(**CLIP_KW))
    b = load_sd15_bundle(path, inpainting=True, **kw)
    assert b.inpaint and torch.equal(b.unet.input_blocks[0][0].weight, sd[k])
    with pytest.raises(ValueError, match="shape"):
        load_sd15_bundle(path, **kw)


def test_loader_refuses_keys_of_no_model(files, tmp_path):
    from cremage_tpu_torch.io.checkpoint import load_safetensors

    sd = dict(load_safetensors(files["model"]))
    sd["something_else.weight"] = torch.zeros(2)
    path = str(tmp_path / "extra.safetensors")
    save_file({n: t.contiguous() for n, t in sd.items()}, path)
    with pytest.raises(KeyError, match="something_else"):
        load_sd15_bundle(path, device="cpu", dtype=F32,
                         unet_cfg=UNetConfig(**UNET_KW),
                         vae_cfg=VAEConfig(**VAE_KW),
                         clip_cfg=CLIPTextConfig(**CLIP_KW))
