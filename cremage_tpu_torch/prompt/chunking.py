"""Weighted-token chunking into 77-token CLIP windows (the port's copy of
cremage_tpu/prompt/chunking.py).

Behavior contract (reference
`modules/cremage/utils/generate_clip_embeddings_from_tokens.py`):

- each (word, score) pair is tokenized separately; its raw token
  embeddings are multiplied by the score (pre-transformer);
- chunks hold at most 75 content tokens; a word that would overflow
  starts a new chunk; the literal word ``BREAK`` (when it fits) forces a
  new chunk and is dropped;
- each chunk is laid out [BOS, content..., PAD...(to 75), EOS] — PADs sit
  *before* the final EOS; PAD == EOS token.

``<embedding:name>`` pairs load textual-inversion vectors from the
embedding directory (SDXL dict embeddings contribute the tower's key) and
are scaled by their score like words; missing files, or no directory, skip
the tag, as in the JAX package.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from cremage_tpu_torch.prompt.tokenizer import BOS, EOS, PAD, CLIPTokenizer
from cremage_tpu_torch.prompt.tokens import embedding_name, is_embedding_tag

logger = logging.getLogger(__name__)

BREAK_MARKER = "BREAK"
CHUNK_CONTENT = 75

EmbedFn = Callable[[Sequence[int]], np.ndarray]
TIFetch = Callable[[str], Optional[np.ndarray]]


def make_ti_fetch(
    embedding_dir: Optional[str],
    load_embedding: Callable[[str], Union[np.ndarray, Dict[str, np.ndarray]]],
) -> TIFetch:
    """File-based TI lookup (embedding_dir/name; a two-tower dict gives its
    CLIP-L entry). A name that would leave the directory counts as
    missing."""

    def fetch(name: str) -> Optional[np.ndarray]:
        if embedding_dir is None:
            return None
        root = os.path.realpath(embedding_dir)
        path = os.path.join(embedding_dir, name)
        inside = os.path.commonpath([root, os.path.realpath(path)]) == root
        if not inside or not os.path.exists(path):
            logger.warning("Ignoring missing %s", path)
            return None
        emb = load_embedding(path)
        if isinstance(emb, dict):
            emb = emb.get("clip_l")
        return None if emb is None else np.asarray(emb, np.float32)

    return fetch


def generate_weighted_chunks(
    tokenizer: CLIPTokenizer,
    embed_fn: EmbedFn,
    word_score_pairs: Sequence[Tuple[str, float]],
    ti_fetch: Optional[TIFetch] = None,
) -> List[np.ndarray]:
    """-> list of (77, dim) fp32 chunks."""
    rows: List[List[np.ndarray]] = [[]]
    i = 0
    cur_len = 0

    empty = len(word_score_pairs) == 1 and len(word_score_pairs[0][0]) == 0
    if not empty:
        for word, score in word_score_pairs:
            emb = None
            if is_embedding_tag(word):
                if ti_fetch is None:
                    continue
                emb = ti_fetch(embedding_name(word))
                if emb is None:
                    continue
                length = emb.shape[0]
            else:
                ids = tokenizer.encode(word)[: CHUNK_CONTENT]
                length = len(ids)

            new_len = cur_len + length
            if new_len > CHUNK_CONTENT:
                rows.append([])
                i += 1
                cur_len = length
            elif word == BREAK_MARKER:
                rows.append([])
                i += 1
                cur_len = 0
                continue
            else:
                cur_len = new_len

            if emb is None:
                if not ids:
                    continue
                emb = np.asarray(embed_fn(ids), np.float32)
            rows[i].append(emb * float(score))

    bos = np.asarray(embed_fn([BOS]), np.float32).reshape(1, -1)
    eos = np.asarray(embed_fn([EOS]), np.float32).reshape(1, -1)
    pad = np.asarray(embed_fn([PAD]), np.float32).reshape(1, -1)

    chunks: List[np.ndarray] = []
    for row in rows:
        pads = np.repeat(pad, CHUNK_CONTENT - sum(e.shape[0] for e in row), axis=0)
        chunks.append(np.concatenate([bos] + row + [pads, eos], axis=0))
    return chunks


def pad_conditioning_to_match(
    c: np.ndarray, uc: np.ndarray, filler: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Filler-pad the shorter of c/uc to the same multiple-of-77 length
    (the filler is an empty-prompt 77-token chunk appended repeatedly)."""
    if filler.shape[0] != 77:
        raise ValueError(f"filler must be one 77-token chunk, got {filler.shape}")
    while c.shape[0] < uc.shape[0]:
        c = np.concatenate([c, filler], axis=0)
    while uc.shape[0] < c.shape[0]:
        uc = np.concatenate([uc, filler], axis=0)
    return c, uc
