"""CLIP BPE tokenizer (the port's copy of cremage_tpu/prompt/tokenizer.py).

Byte-level BPE with </w> end-of-word markers over the public OpenAI CLIP
merges file (bpe_simple_vocab_16e6.txt.gz, vendored under
prompt/assets/), lowercased, whitespace collapsed, vocab 49408 with
<|startoftext|>=49406 and <|endoftext|>=49407.

The JAX package pre-splits text with the `regex` pattern
`<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+`. That module is not available to the port, and the
stdlib `re` classes differ (`\\d` misses '²' and '½', which are \\p{N}), so
`pre_tokenize` walks the text with `unicodedata.category` instead: a run
of letters (L*), one number (N*), or a run of anything that is neither
whitespace, letter nor number. `regex`'s `\\s` is `str.isspace` minus the
separators U+001C..U+001F, and so is `_is_space`.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import List

BOS = 49406
EOS = 49407
PAD = 49407
MAX_LEN = 77

_DEFAULT_BPE = os.path.join(
    os.path.dirname(__file__), "assets", "bpe_simple_vocab_16e6.txt.gz"
)
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2 byte <-> printable-unicode bijection (public algorithm)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return unicodedata.normalize("NFC", text.strip())


def _whitespace_clean(text: str) -> str:
    return re.sub(r"[^\S\x1c-\x1f]+", " ", text).strip()


def _is_space(ch: str) -> bool:
    return ch.isspace() and not "\x1c" <= ch <= "\x1f"


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def pre_tokenize(text: str) -> List[str]:
    """Split cleaned, lowercased text into the pieces BPE runs on."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if _is_space(ch):
            i += 1
            continue
        piece = next((s for s in _SPECIALS + _CONTRACTIONS
                      if text.startswith(s, i)), None)
        if piece is not None:
            j = i + len(piece)
        elif _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1
        else:
            j = i + 1
            while j < n and not (_is_space(text[j]) or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    def __init__(self, bpe_path: str = _DEFAULT_BPE):
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(list(_SPECIALS))
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {s: s for s in _SPECIALS}

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> BPE ids, no BOS/EOS."""
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in pre_tokenize(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        parts = text.split("</w>")
        decoded = [
            bytearray(byte_decoder[c] for c in p if c in byte_decoder).decode(
                "utf-8", errors="replace"
            )
            for p in parts
        ]
        return " ".join(decoded).strip()

    def encode_with_specials(self, text: str, max_len: int = MAX_LEN) -> List[int]:
        """BOS + ids(truncated) + EOS, padded with EOS to max_len."""
        ids = self.encode(text)[: max_len - 2]
        seq = [BOS] + ids + [EOS]
        return seq + [PAD] * (max_len - len(seq))


@functools.lru_cache()
def default_tokenizer() -> CLIPTokenizer:
    return CLIPTokenizer()
