"""BERT WordPiece tokenizer (the port's copy of
cremage_tpu/prompt/wordpiece.py): the tokenizer of Hunyuan-DiT's
Chinese-CLIP text branch, from a plain `vocab.txt`.

transformers' BertTokenizer semantics: the basic tokenizer (control
characters dropped, whitespace normalised, each CJK character its own word,
optional lowercasing with accents stripped, punctuation split off), then
greedy longest-match-first WordPiece with `##` continuation prefixes.
`encode` wraps the ids in [CLS] ... [SEP], truncates to `max_length` (the
last kept id made [SEP]) and pads with [PAD], mask 0 on the padding.
"""
from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np


def _is_punct(ch: str) -> bool:
    o = ord(ch)
    if 33 <= o <= 47 or 58 <= o <= 64 or 91 <= o <= 96 or 123 <= o <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(o: int) -> bool:
    return (0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF or
            0x20000 <= o <= 0x2A6DF or 0x2A700 <= o <= 0x2B73F or
            0x2B740 <= o <= 0x2B81F or 0x2B820 <= o <= 0x2CEAF or
            0xF900 <= o <= 0xFAFF or 0x2F800 <= o <= 0x2FA1F)


class WordPieceTokenizer:
    def __init__(self, vocab, lowercase: bool = True,
                 unk_token: str = "[UNK]", max_word_chars: int = 100):
        """vocab: the path of a vocab.txt (one token a line), a dict or a
        list of tokens."""
        if isinstance(vocab, str):
            with open(vocab, encoding="utf-8") as f:
                vocab = [line.rstrip("\n") for line in f]
        self.vocab: Dict[str, int] = (dict(vocab) if isinstance(vocab, dict)
                                      else {t: i for i, t in enumerate(vocab)})
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.max_word_chars = max_word_chars
        self.cls_id = self.vocab.get("[CLS]", 0)
        self.sep_id = self.vocab.get("[SEP]", 0)
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.unk_id = self.vocab.get(unk_token, 0)

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            o, cat = ord(ch), unicodedata.category(ch)
            if o == 0 or o == 0xFFFD or (cat == "Cc" and ch not in "\t\n\r"):
                continue
            if ch in "\t\n\r" or cat == "Zs":
                out.append(" ")
            elif _is_cjk(o):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def basic_tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for w in self._clean(text).split():
            if self.lowercase:
                w = "".join(c for c in unicodedata.normalize("NFD", w.lower())
                            if unicodedata.category(c) != "Mn")
            cur = ""
            for ch in w:
                if _is_punct(ch):
                    if cur:
                        out.append(cur)
                        cur = ""
                    out.append(ch)
                else:
                    cur += ch
            if cur:
                out.append(cur)
        return out

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_word_chars:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            for end in range(len(word), start, -1):
                sub = ("##" if start > 0 else "") + word[start:end]
                if sub in self.vocab:
                    break
            else:
                return [self.unk_token]
            pieces.append(sub)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        return [p for w in self.basic_tokenize(text) for p in self.wordpiece(w)]

    def encode(self, text: str, max_length: Optional[int] = None,
               padding: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """[CLS] tokens [SEP] (+ [PAD]) -> (ids, attention mask), int32."""
        ids = [self.cls_id] + [self.vocab.get(t, self.unk_id)
                               for t in self.tokenize(text)] + [self.sep_id]
        if max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_id]
        mask = [1] * len(ids)
        if max_length is not None and padding and len(ids) < max_length:
            pad = max_length - len(ids)
            ids += [self.pad_id] * pad
            mask += [0] * pad
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)
