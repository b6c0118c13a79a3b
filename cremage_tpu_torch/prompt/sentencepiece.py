"""SentencePiece tokenizer (unigram Viterbi + BPE), stdlib and numpy only —
the port of cremage_tpu/prompt/sentencepiece.py, kept as its own copy.

Three layers:

- `parse_model_proto(data)` — a minimal protobuf wire-format reader for
  the standard `spiece.model` ModelProto (pieces + trainer/normalizer
  specs).
- `SentencePieceProcessor` — normalization (whitespace escaping to
  U+2581, dummy prefix, an NFKC approximation of the nmt_nfkc charsmap,
  or the exact precompiled charsmap when present — see `Precompiled`)
  followed by unigram Viterbi segmentation (or score-ranked BPE merging
  for model_type=BPE), with byte-fallback and fused-unk semantics
  matching sentencepiece.
- `T5Tokenizer` — HF-T5 conventions on top: `<extra_id_N>` sentinel ids
  appended after the spm vocab, EOS append, padding/truncation.
"""
from __future__ import annotations

import dataclasses
import re
import unicodedata
from typing import Dict, List, Tuple

import numpy as np

WS = "▁"  # ▁ (LOWER ONE EIGHTH BLOCK), sentencepiece whitespace escape

# SentencePiece.Type enum (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

UNK_PENALTY = 10.0  # spm kUnkPenalty


# ---------------------------------------------------------------------------
# protobuf wire-format reader (just enough for ModelProto)
# ---------------------------------------------------------------------------

def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.

    wire 0 -> int, wire 1 -> 8 raw bytes, wire 2 -> bytes, wire 5 -> 4
    raw bytes.  Unknown wire types terminate (defensive).
    """
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(data, pos)
        elif wire == 1:
            val, pos = data[pos:pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            val, pos = data[pos:pos + ln], pos + ln
        elif wire == 5:
            val, pos = data[pos:pos + 4], pos + 4
        else:  # groups (3/4) unused by sentencepiece
            return
        yield field, wire, val


@dataclasses.dataclass
class Piece:
    piece: str
    score: float
    type: int = NORMAL


@dataclasses.dataclass
class ModelProto:
    pieces: List[Piece]
    model_type: int = 1           # TrainerSpec.model_type: 1=unigram 2=BPE
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    precompiled_charsmap: bytes = b""


def parse_model_proto(data: bytes) -> ModelProto:
    """Parse a `spiece.model` blob (sentencepiece ModelProto)."""
    mp = ModelProto(pieces=[])
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:  # repeated SentencePiece
            piece, score, typ = "", 0.0, NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = float(np.frombuffer(v2, "<f4")[0])
                elif f2 == 3 and w2 == 0:
                    typ = v2
            mp.pieces.append(Piece(piece, score, typ))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if w2 != 0:
                    continue
                if f2 == 3:
                    mp.model_type = v2
                elif f2 == 40:
                    mp.unk_id = v2
                elif f2 == 41:
                    mp.bos_id = _signed(v2)
                elif f2 == 42:
                    mp.eos_id = _signed(v2)
                elif f2 == 43:
                    mp.pad_id = _signed(v2)
        elif field == 3 and wire == 2:  # NormalizerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 2 and w2 == 2:
                    mp.precompiled_charsmap = v2
                elif f2 == 3 and w2 == 0:
                    mp.add_dummy_prefix = bool(v2)
                elif f2 == 4 and w2 == 0:
                    mp.remove_extra_whitespaces = bool(v2)
                elif f2 == 5 and w2 == 0:
                    mp.escape_whitespaces = bool(v2)
    return mp


def _signed(v: int) -> int:
    """int32 fields of negative ids (pad_id=-1) arrive as 2^64-1."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# precompiled charsmap (darts-clone double-array trie + replacement pool)
# ---------------------------------------------------------------------------

class Precompiled:
    """Exact nmt_nfkc normalization from NormalizerSpec.precompiled_charsmap.

    Blob layout (sentencepiece normalizer.cc DecodePrecompiledCharsMap):
    uint32 LE trie byte-size, then the darts double-array units
    (uint32 LE each), then the NUL-separated replacement string pool.
    """

    def __init__(self, blob: bytes):
        trie_size = int(np.frombuffer(blob[:4], "<u4")[0])
        self.trie = np.frombuffer(blob[4:4 + trie_size], "<u4")
        self.norm = blob[4 + trie_size:]

    # darts-clone unit accessors
    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & 0x200) >> 6)

    @staticmethod
    def _label(unit: int) -> int:
        return unit & 0x800000FF

    @staticmethod
    def _has_leaf(unit: int) -> bool:
        return bool((unit >> 8) & 1)

    @staticmethod
    def _value(unit: int) -> int:
        return unit & 0x7FFFFFFF

    def longest_match(self, key: bytes) -> Tuple[int, int]:
        """(matched_byte_len, pool_offset) of the longest prefix of
        `key` in the trie; (0, -1) when nothing matches."""
        trie = self.trie
        node_pos = 0
        unit = int(trie[node_pos])
        node_pos ^= self._offset(unit)
        best = (0, -1)
        for i, c in enumerate(key):
            if c == 0:
                break
            node_pos ^= c
            if node_pos >= len(trie):
                break
            unit = int(trie[node_pos])
            if self._label(unit) != c:
                break
            node_pos ^= self._offset(unit)
            if self._has_leaf(unit):
                best = (i + 1, self._value(int(trie[node_pos])))
        return best

    def replacement(self, offset: int) -> bytes:
        end = self.norm.index(b"\0", offset)
        return self.norm[offset:end]

    def normalize(self, text: str) -> str:
        data = text.encode("utf-8")
        out = bytearray()
        i = 0
        while i < len(data):
            ln, off = self.longest_match(data[i:])
            if ln > 0:
                out += self.replacement(off)
                i += ln
            else:
                # copy one UTF-8 char unchanged
                n = 1
                while i + n < len(data) and (data[i + n] & 0xC0) == 0x80:
                    n += 1
                out += data[i:i + n]
                i += n
        return out.decode("utf-8", errors="replace")


def _nfkc_nmt_approx(text: str) -> str:
    """Approximation of nmt_nfkc used when no charsmap is present:
    NFKC + NMT control-char/space cleanup (normalization_rule 'nmt')."""
    out = []
    for ch in text:
        o = ord(ch)
        if o in (0x0009, 0x000A, 0x000D):
            out.append(" ")
        elif o < 0x20 or o == 0x7F or 0x0080 <= o <= 0x009F or o in (
                0x200B, 0x200C, 0x200D, 0x200E, 0x200F, 0xFEFF, 0xFFFD,
                0x2028, 0x2029, 0x0085):
            continue
        elif unicodedata.category(ch) == "Zs":
            out.append(" ")
        else:
            out.append(ch)
    return unicodedata.normalize("NFKC", "".join(out))


# ---------------------------------------------------------------------------
# processor
# ---------------------------------------------------------------------------

class SentencePieceProcessor:
    """Normalize + segment; mirrors sentencepiece's encode()."""

    def __init__(self, model: ModelProto, use_charsmap: bool = True):
        self.model = model
        self.vocab: Dict[str, int] = {}
        self.scores: List[float] = []
        self.byte_pieces: Dict[int, int] = {}
        self.user_defined: List[str] = []
        for i, p in enumerate(model.pieces):
            if p.piece not in self.vocab:
                self.vocab[p.piece] = i
            self.scores.append(p.score)
            if p.type == BYTE:
                self.byte_pieces[int(p.piece[1:-1], 16)] = i  # "<0x41>"
            elif p.type == USER_DEFINED:
                self.user_defined.append(p.piece)
        real = [p.score for p in model.pieces if p.type == NORMAL]
        self.min_score = min(real) if real else 0.0
        self.unk_score = self.min_score - UNK_PENALTY
        self.max_piece_len = max(
            (len(p.piece) for p in model.pieces), default=1)
        self.charsmap = (
            Precompiled(model.precompiled_charsmap)
            if (use_charsmap and model.precompiled_charsmap) else None)
        # longest-match-first splitter for user-defined symbols, which
        # always segment as a single piece regardless of score
        self._user_re = (
            re.compile("|".join(
                re.escape(s)
                for s in sorted(self.user_defined, key=len, reverse=True)))
            if self.user_defined else None)

    # -- normalization ------------------------------------------------

    def normalize(self, text: str) -> str:
        m = self.model
        if self.charsmap is not None:
            text = self.charsmap.normalize(text)
        else:
            text = _nfkc_nmt_approx(text)
        if m.remove_extra_whitespaces:
            text = re.sub(" +", " ", text).strip(" ")
        if not text:
            return ""
        if m.add_dummy_prefix:
            text = " " + text
        if m.escape_whitespaces:
            text = text.replace(" ", WS)
        return text

    # -- segmentation ---------------------------------------------------

    def encode_pieces(self, text: str) -> List[str]:
        norm = self.normalize(text)
        if not norm:
            return []
        if self._user_re is None:
            chunks = [(norm, False)]
        else:
            chunks = []
            pos = 0
            for mt in self._user_re.finditer(norm):
                if mt.start() > pos:
                    chunks.append((norm[pos:mt.start()], False))
                chunks.append((mt.group(0), True))
                pos = mt.end()
            if pos < len(norm):
                chunks.append((norm[pos:], False))
        out: List[str] = []
        for chunk, is_user in chunks:
            if is_user:
                out.append(chunk)
            elif self.model.model_type == 2:
                out.extend(self._bpe_segment(chunk))
            else:
                out.extend(self._viterbi(chunk))
        return out

    def encode(self, text: str) -> List[int]:
        unk = self.model.unk_id
        ids: List[int] = []
        for piece in self.encode_pieces(text):
            pid = self.vocab.get(piece)
            if pid is not None and self.model.pieces[pid].type != UNKNOWN:
                ids.append(pid)
            elif self.byte_pieces:
                ids.extend(self.byte_pieces[b]
                           for b in piece.encode("utf-8"))
            else:
                ids.append(unk)
        return ids

    def _viterbi(self, text: str) -> List[str]:
        n = len(text)
        # best[i]: (score, start_of_last_piece, is_unk)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Tuple[int, bool]] = [(0, False)] * (n + 1)
        best[0] = 0.0
        vocab, scores = self.vocab, self.scores
        maxlen = self.max_piece_len
        for i in range(n):
            bi = best[i]
            if bi <= NEG:
                continue
            # unknown single char is always available
            if bi + self.unk_score > best[i + 1]:
                best[i + 1] = bi + self.unk_score
                back[i + 1] = (i, True)
            for j in range(i + 1, min(n, i + maxlen) + 1):
                pid = vocab.get(text[i:j])
                if pid is None:
                    continue
                p = self.model.pieces[pid]
                if p.type in (UNUSED, UNKNOWN):
                    continue
                s = bi + scores[pid]
                if s > best[j]:
                    best[j] = s
                    back[j] = (i, False)
        pieces: List[Tuple[str, bool]] = []
        i = n
        while i > 0:
            j, is_unk = back[i]
            pieces.append((text[j:i], is_unk))
            i = j
        pieces.reverse()
        # fuse consecutive unknown chars into one surface (spm behavior)
        out: List[str] = []
        for surf, is_unk in pieces:
            if is_unk and out and out[-1] not in self.vocab and not \
                    self.byte_pieces:
                out[-1] += surf
            else:
                out.append(surf)
        return out

    def _bpe_segment(self, text: str) -> List[str]:
        symbols = list(text)
        if not symbols:
            return []
        while True:
            best_score, best_i = None, -1
            for i in range(len(symbols) - 1):
                pid = self.vocab.get(symbols[i] + symbols[i + 1])
                if pid is None:
                    continue
                s = self.scores[pid]
                if best_score is None or s > best_score:
                    best_score, best_i = s, i
            if best_i < 0:
                return symbols
            symbols[best_i:best_i + 2] = [
                symbols[best_i] + symbols[best_i + 1]]


def load_processor(path: str, **kw) -> SentencePieceProcessor:
    with open(path, "rb") as f:
        return SentencePieceProcessor(parse_model_proto(f.read()), **kw)


# ---------------------------------------------------------------------------
# T5 / mT5 conventions (HF T5Tokenizer semantics)
# ---------------------------------------------------------------------------

class T5Tokenizer:
    """spm + the HF-T5 contract: 100 `<extra_id_N>` sentinels appended
    after the spm vocab with id = vocab_size + extra_ids - 1 - N, EOS
    (`</s>`) appended to every encoding, pad with pad_id.

    The reference consumes this behavior via transformers
    (`modules/flux/txt2img.py:85-120`, `modules/sd3/txt2img.py:21`).
    """

    def __init__(self, model_path_or_bytes, extra_ids: int = 100):
        data = (model_path_or_bytes
                if isinstance(model_path_or_bytes, (bytes, bytearray))
                else open(model_path_or_bytes, "rb").read())
        self.sp = SentencePieceProcessor(parse_model_proto(bytes(data)))
        self.extra_ids = extra_ids
        self.spm_size = len(self.sp.model.pieces)
        self.vocab_size = self.spm_size + extra_ids
        self.eos_id = self.sp.model.eos_id
        self.pad_id = max(self.sp.model.pad_id, 0)
        self._extra_re = (
            re.compile(r"(<extra_id_\d+>)") if extra_ids else None)

    def extra_token_id(self, n: int) -> int:
        return self.vocab_size - 1 - n

    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        ids: List[int] = []
        parts = (self._extra_re.split(text)
                 if self._extra_re else [text])
        for part in parts:
            if not part:
                continue
            m = re.fullmatch(r"<extra_id_(\d+)>", part)
            if m and self.extra_ids:
                ids.append(self.extra_token_id(int(m.group(1))))
            else:
                ids.extend(self.sp.encode(part))
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def __call__(self, text: str, max_length: int = 512,
                 padding: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, attention_mask) as (max_length,) int32 arrays —
        truncates like transformers (EOS kept at the cut)."""
        ids = self.encode(text, add_eos=False)
        ids = ids[: max_length - 1] + [self.eos_id]
        mask = [1] * len(ids)
        if padding and len(ids) < max_length:
            pad = max_length - len(ids)
            ids = ids + [self.pad_id] * pad
            mask = mask + [0] * pad
        return (np.asarray(ids, np.int32), np.asarray(mask, np.int32))

    def tokenize_fn(self, max_length: int = 512):
        """Adapter for the pipelines' `t5_tokenize` seam: str -> ids."""
        def fn(text: str) -> np.ndarray:
            ids, _ = self(text, max_length=max_length)
            return ids
        return fn


def as_t5_tokenize(spec, max_length: int = 512):
    """Coerce the pipelines' `t5_tokenize` argument to a `str -> ids`
    callable.  Accepts: None / an existing callable (pass-through), a
    `T5Tokenizer`, a path to a `spiece.model` file, or the raw model
    proto bytes — so SD3/FLUX/PixArt/Hunyuan encode prompts end-to-end
    with just a tokenizer-model path in their options."""
    if isinstance(spec, T5Tokenizer):  # before callable(): it has __call__
        return spec.tokenize_fn(max_length)
    if spec is None or callable(spec):
        return spec
    return T5Tokenizer(spec).tokenize_fn(max_length)
