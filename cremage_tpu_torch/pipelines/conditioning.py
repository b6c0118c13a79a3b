"""Text conditioning: weighted prompt -> CLIP hidden states (the port of
cremage_tpu/pipelines/conditioning.py).

Pipeline contract: prompt -> weight grammar -> 77-token weighted chunks
(token embeddings scaled pre-transformer) -> text transformer per chunk
with the clip_skip tap -> concat along the sequence -> filler-pad c/uc to
equal length.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cremage_tpu_torch.io.ti import load_embedding
from cremage_tpu_torch.models.clip import CLIPTextModel, hidden_state_for_clip_skip
from cremage_tpu_torch.prompt.chunking import (
    generate_weighted_chunks, make_ti_fetch, pad_conditioning_to_match,
)
from cremage_tpu_torch.prompt.parser import compute_prompt_score
from cremage_tpu_torch.prompt.tokenizer import CLIPTokenizer


class TextEncoder:
    """Bundles a CLIP text model and a tokenizer into the
    prompt -> (L, dim) conditioning function. The model runs on the device
    its parameters are on; `<embedding:name>` tags load from
    `embedding_dir`."""

    def __init__(self, model: CLIPTextModel, tokenizer: CLIPTokenizer,
                 embedding_dir: Optional[str] = None):
        self.model = model
        self.tokenizer = tokenizer
        self.embedding_dir = embedding_dir
        # memoized conditioning per (prompt, clip_skip): serving workloads
        # repeat prompts across seeds and batches; bounded FIFO, dies with
        # the bundle so reloaded weights never serve stale states. Prompts
        # with TI tags are not memoized: their files can change on disk
        self._encode_cache: dict = {}

    @property
    def device(self) -> torch.device:
        return self.model.embeddings.token_embedding.weight.device

    def _embed_tokens(self, ids) -> np.ndarray:
        with torch.no_grad():
            ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
            return self.model.embed_tokens(ids_t).float().cpu().numpy()

    def encode(self, prompt: str, clip_skip: int = 1) -> np.ndarray:
        """Weighted prompt -> (n*77, hidden) float32 conditioning."""
        cacheable = "<" not in prompt
        ck = (prompt, clip_skip)
        hit = self._encode_cache.get(ck) if cacheable else None
        if hit is not None:
            return hit
        chunks = generate_weighted_chunks(
            self.tokenizer, self._embed_tokens, compute_prompt_score(prompt),
            ti_fetch=make_ti_fetch(self.embedding_dir, load_embedding))
        outs = []
        with torch.no_grad():
            for chunk in chunks:
                _, hidden = self.model(inputs_embeds=torch.as_tensor(
                    chunk[None], device=self.device))
                z = hidden_state_for_clip_skip(hidden, clip_skip)
                outs.append(z[0].float().cpu().numpy())
        out = np.concatenate(outs, axis=0)
        if not cacheable:
            return out
        if len(self._encode_cache) >= 32:
            self._encode_cache.pop(next(iter(self._encode_cache)))
        self._encode_cache[ck] = out
        return out

    def filler(self, clip_skip: int = 1) -> np.ndarray:
        """Empty-prompt 77-token chunk used for c/uc length matching, at
        the job's clip_skip (memoized by `encode`)."""
        return self.encode("", clip_skip)

    def encode_pair(self, prompt: str, negative_prompt: str,
                    clip_skip: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        c = self.encode(prompt, clip_skip)
        uc = self.encode(negative_prompt, clip_skip)
        return pad_conditioning_to_match(c, uc, self.filler(clip_skip))
