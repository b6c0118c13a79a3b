"""Hunyuan-DiT txt2img pipeline — the port of cremage_tpu/pipelines/hunyuan.py.

Behavior contract (the JAX pipeline's):
- the text: the BERT branch's last hidden state over 77 WordPiece ids with
  their mask (`text_len`, clip_dim 1024) and the mT5 branch's over 256
  SentencePiece ids, zero-padded (`text_len_t5`, mt5_dim 2048); without
  the mT5 tower or its tokenizer the mT5 context is zeros, and without the
  BERT tower or its vocabulary both contexts are zeros (even when mT5 is
  loaded), as JAX's loader builds its `text_encode`;
- v-prediction (`VDenoiser`, sigma_data 1) on the scaled-linear DDPM
  table (`default_sd_schedule`) with CFG over the batched [uc; c], the
  learned-sigma half of the output dropped;
- the sampler is the menu's entry named by the job, "DPM++ 2M" for any
  name outside samplers/kdiffusion.py SAMPLER_SCHEDULE, over the model's
  sigmas or Karras's by that table; the initial noise is the batch's
  `NoiseSource.initial` at (B, H/8, W/8, 4) times the first sigma;
- the statuses, the bf16 decode (the SDXL VAE), the safety check, the
  watermark and the metadata as pipelines/sd3.py `dit_generate` gives them.

The speed features, the guidance interval and the meshes are refused as
in pipelines/sd3.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cremage_tpu_torch.core.config import GenerationOptions
from cremage_tpu_torch.core.rng import resolve_device
from cremage_tpu_torch.models.bert import BertModel
from cremage_tpu_torch.models.hunyuan import HunyuanDiT
from cremage_tpu_torch.models.t5 import T5Encoder
from cremage_tpu_torch.models.vae import AutoencoderKL
from cremage_tpu_torch.pipelines.pixart import PixArtPipeline
from cremage_tpu_torch.prompt.sentencepiece import as_t5_tokenize
from cremage_tpu_torch.prompt.wordpiece import WordPieceTokenizer
from cremage_tpu_torch.samplers import schedules as S
from cremage_tpu_torch.samplers.denoiser import VDenoiser, cfg_denoiser
from cremage_tpu_torch.services.safety import ImageSafetyChecker


class HunyuanTextEncoder:
    """`encode(prompt, device)` -> (BERT tokens (clip_len, clip_dim), mT5
    tokens (mt5_len, mt5_dim)), float32 on `device` (JAX's
    `make_hunyuan_text_encode`, with its zero contexts for missing
    branches). `vocab`: a vocab.txt path, dict or list; `mt5_tokenize`: a
    spiece.model path or bytes, or a callable str -> ids."""

    def __init__(self, bert: Optional[BertModel], vocab=None,
                 mt5: Optional[T5Encoder] = None, mt5_tokenize=None,
                 clip_len: int = 77, mt5_len: int = 256,
                 clip_dim: int = 1024, mt5_dim: int = 2048):
        self.wordpiece = (WordPieceTokenizer(vocab)
                          if bert is not None and vocab else None)
        self.bert = bert if self.wordpiece is not None else None
        self.mt5 = mt5
        self.mt5_tokenize = as_t5_tokenize(mt5_tokenize, mt5_len)
        self.clip_len, self.mt5_len = clip_len, mt5_len
        self.clip_dim, self.mt5_dim = clip_dim, mt5_dim

    def models(self):
        return [m for m in (self.bert, self.mt5) if m is not None]

    @torch.no_grad()
    def encode(self, prompt: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
        mt5 = torch.zeros(self.mt5_len, self.mt5_dim, device=device)
        if self.bert is None:
            return torch.zeros(self.clip_len, self.clip_dim, device=device), mt5
        ids, mask = self.wordpiece.encode(prompt, max_length=self.clip_len)
        last, _ = self.bert(torch.from_numpy(ids[None]).long().to(device),
                            torch.from_numpy(mask[None]).to(device))
        if self.mt5 is not None and self.mt5_tokenize is not None:
            tids = np.asarray(self.mt5_tokenize(prompt), np.int64)[: self.mt5_len]
            tids = np.pad(tids, (0, self.mt5_len - len(tids)))
            mt5 = self.mt5(torch.from_numpy(tids[None]).to(device))[0].float()
        return last[0].float(), mt5


@dataclasses.dataclass
class HunyuanBundle:
    dit: HunyuanDiT
    vae: AutoencoderKL
    text: HunyuanTextEncoder
    schedule: S.DiscreteSchedule = dataclasses.field(
        default_factory=S.default_sd_schedule)
    load_report: Optional[Dict] = None


class HunyuanPipeline(PixArtPipeline):
    """`safety`: the image safety checker of jobs with safety_check on (by
    default `default_image_safety`, built at the first such job). The
    sampler choice, the sampling loop, `generate` (4 latent channels,
    check_supported first) and the safety property are PixArt-Σ's."""

    def __init__(self, bundle: HunyuanBundle, device=None,
                 safety: Optional[ImageSafetyChecker] = None):
        self.bundle = bundle
        self.device = resolve_device(device)
        self._safety = safety
        for m in [bundle.dit, bundle.vae] + bundle.text.models():
            m.to(self.device).eval()

    def encode_pair(self, opts: GenerationOptions, batch: int):
        """((BERT, mT5) of the prompt, of the negative prompt), each
        expanded to the batch."""
        def tile(pair):
            return tuple(t[None].expand((batch,) + tuple(t.shape)) for t in pair)
        enc = self.bundle.text.encode
        return (tile(enc(opts.prompt, self.device)),
                tile(enc(opts.negative_prompt, self.device)))

    def denoiser(self, c, uc, scale: float):
        """The CFG denoiser over the DiT's v on (BERT, mT5) tuples, its
        learned-sigma half dropped."""
        dit = self.bundle.dit

        def v_model(xx, tt, cond):
            return dit(xx, tt, *cond)[..., :xx.shape[-1]]

        return cfg_denoiser(VDenoiser(v_model, self.bundle.schedule), c, uc,
                            scale)
