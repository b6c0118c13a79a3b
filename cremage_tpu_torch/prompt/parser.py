"""Prompt weight grammar: (phrase:1.2) nested emphasis.

Behavior contract (reference `modules/cremage/utils/prompt_score_parser.py`,
goldens ported from its unit tests in tests/test_prompt.py):

- parentheses open nested emphasis groups; a group's score comes from a
  trailing ``:<float>`` on its last region;
- a group without a valid score gets 1.1; the root gets 1.0 (an invalid
  score string likewise falls back to 1.1 / 1.0);
- scores multiply down the nesting;
- unbalanced parens are tolerated: a stray ')' at root level is ignored,
  an unclosed '(' still creates a scored group;
- ``<embedding:file>`` tags never contribute a ':score' (the colon inside
  the tag is not a score separator) and are split into standalone tokens;
- output is a list of (token, score) with tokens in original text order,
  whitespace-separated.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

from cremage_tpu_torch.prompt.tokens import split_token_with_embedding_tags


class _Node:
    __slots__ = ("chars", "pos", "children", "parent", "score", "product")

    def __init__(self, parent: Optional["_Node"] = None):
        self.chars: List[str] = []
        self.pos: List[int] = []
        self.children: List["_Node"] = []
        self.parent = parent
        self.score = 1.0
        self.product = 1.0


def _build_tree(text: str) -> _Node:
    root = _Node()
    cur = root
    for i, c in enumerate(text):
        if c == "(":
            child = _Node(cur)
            cur.children.append(child)
            cur = child
        elif c == ")":
            if cur.parent is not None:
                cur = cur.parent
            # stray ')' at root: ignored
        else:
            cur.chars.append(c)
            cur.pos.append(i)
    return root


def _regions(node: _Node) -> List[Tuple[str, int]]:
    """Group the node's characters into maximal consecutive runs
    ('regions'), each tagged with its start index in the original text."""
    out: List[Tuple[str, int]] = []
    word = ""
    start = 0
    prev = -2
    for ch, idx in zip(node.chars, node.pos):
        if idx != prev + 1:
            if word:
                out.append((word, start))
            word = ch
            start = idx
        else:
            word += ch
        prev = idx
    out.append((word, start))  # note: may append "" for empty nodes
    return out


def _extract_score(node: _Node, regions: List[Tuple[str, int]], is_root: bool):
    """Score from trailing :float of the last region (embedding-tag aware)."""
    default = 1.0 if is_root else 1.1
    last, start = regions[-1]
    parts, _ = split_token_with_embedding_tags(last)
    if not parts:
        node.score = default
        return regions
    tail = parts[-1]
    colon = tail.rfind(":")
    if 0 <= colon < len(tail) - 1:
        colon_full = last.rfind(":")
        cand = last[colon_full + 1:]
        try:
            node.score = float(cand)
            regions = regions[:-1] + [(last[:colon_full], start)]
            return regions
        except ValueError:
            node.score = default
            return regions
    node.score = default
    return regions


def compute_prompt_score(prompt: str) -> List[Tuple[str, float]]:
    """Parse a weighted prompt into [(token, score), ...]."""
    if len(prompt.strip()) == 0:
        return [("", 1.0)]

    root = _build_tree(prompt)

    # regions + per-node scores (BFS)
    node_regions = {}
    queue = [root]
    while queue:
        node = queue.pop(0)
        regs = _regions(node)
        regs = _extract_score(node, regs, node is root)
        node_regions[id(node)] = regs
        queue.extend(node.children)

    # product scores down the tree
    def _prod(node: _Node, base: float):
        node.product = base * node.score
        for ch in node.children:
            _prod(ch, node.product)

    _prod(root, 1.0)

    # flatten by original start index
    triplets: List[Tuple[str, int, float]] = []
    queue = [root]
    while queue:
        node = queue.pop(0)
        for text, start in node_regions[id(node)]:
            triplets.append((text, start, node.product))
        queue.extend(node.children)
    triplets.sort(key=lambda t: t[1])

    # whitespace-split each region, then split out embedding tags
    out: List[Tuple[str, float]] = []
    for text, _, score in triplets:
        for word in filter(None, re.split(r"\s+", text)):
            parts, _ = split_token_with_embedding_tags(word)
            for p in parts:
                out.append((p, score))
    return out if out else [("", 1.0)]
