"""Embedding-tag token splitting.

Behavior contract (reference
`modules/cremage/utils/token_process_helper.py`): any
``<embedding:filename>`` substring inside a whitespace-free token is
split out as its own token; '<' sequences that don't form a tag longer
than 'embedding:' are treated as plain characters.

    "abc<embedding:hello.bin>xyz"
      -> (["abc", "<embedding:hello.bin>", "xyz"], [False, True, False])
"""
from __future__ import annotations

from typing import List, Tuple

EMBEDDING_MARKER = "<embedding:"


def split_token_with_embedding_tags(s: str) -> Tuple[List[str], List[bool]]:
    words: List[str] = []
    flags: List[bool] = []
    current = ""
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c != "<":
            current += c
            i += 1
            continue
        rpos = s[i:].find(">")
        if rpos > len("embedding:"):
            tag = s[i : i + rpos + 1]
            if current:
                words.append(current)
                flags.append(False)
            words.append(tag)
            flags.append(True)
            current = ""
            i += len(tag)
        else:
            current += c
            i += 1
    if current:
        words.append(current)
        flags.append(False)
    return words, flags


def is_embedding_tag(token: str) -> bool:
    return token.startswith(EMBEDDING_MARKER) and token.endswith(">")


def embedding_name(token: str) -> str:
    return token[len(EMBEDDING_MARKER):-1]
