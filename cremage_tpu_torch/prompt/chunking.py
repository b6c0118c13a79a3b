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

``<embedding:name>`` textual-inversion tags are skipped, as the JAX
package does when no embedding directory is configured: loading TI files
is not ported yet.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from cremage_tpu_torch.prompt.tokenizer import BOS, EOS, PAD, CLIPTokenizer
from cremage_tpu_torch.prompt.tokens import is_embedding_tag

BREAK_MARKER = "BREAK"
CHUNK_CONTENT = 75

EmbedFn = Callable[[Sequence[int]], np.ndarray]


def generate_weighted_chunks(
    tokenizer: CLIPTokenizer,
    embed_fn: EmbedFn,
    word_score_pairs: Sequence[Tuple[str, float]],
) -> List[np.ndarray]:
    """-> list of (77, dim) fp32 chunks."""
    rows: List[List[np.ndarray]] = [[]]
    i = 0
    cur_len = 0

    empty = len(word_score_pairs) == 1 and len(word_score_pairs[0][0]) == 0
    if not empty:
        for word, score in word_score_pairs:
            if is_embedding_tag(word):
                continue
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
