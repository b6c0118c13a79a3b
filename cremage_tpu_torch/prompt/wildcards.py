"""__wildcard__ substitution (the port's copy of
cremage_tpu/prompt/wildcards.py).

Behavior contract (reference `modules/cremage/utils/wildcards.py`):
``__name__`` is replaced by a random non-comment, non-blank line from
``<wildcards_dir>/name.txt``; substitution recurses into the selected line
(nested wildcards) up to depth 50, where further expansion stops and the
text is returned as it is; a missing file leaves ``__name__`` untouched; an
unterminated ``__name`` trailer is kept literally. Randomness comes from an
explicit `random.Random` (or seed), so jobs are reproducible, and the same
seed picks the same lines as the JAX package.

A name whose file would lie outside the wildcards directory (``__../x__``)
is treated as a missing file: the prompt is a request's, the directory the
server's.
"""
from __future__ import annotations

import os
import random as _random
from typing import Optional, Union

DEPTH_MAX = 50


def resolve_wildcards(inputs: str, wildcards_dir: str,
                      rng: Optional[Union[int, _random.Random]] = None) -> str:
    if wildcards_dir is None:
        raise ValueError("wildcards_dir is not specified")
    if not os.path.exists(wildcards_dir):
        raise ValueError(f"{wildcards_dir} does not exist")
    if rng is None:
        rng = _random.Random()
    elif isinstance(rng, int):
        rng = _random.Random(rng)
    return _parse(inputs, wildcards_dir, rng, 0)


def _choose_from_file(name: str, wdir: str, rng: _random.Random,
                      depth: int) -> str:
    root = os.path.realpath(wdir)
    path = os.path.realpath(os.path.join(wdir, name) + ".txt")
    if os.path.commonpath([root, path]) != root or not os.path.exists(path):
        return f"__{name}__"
    with open(path, "r") as f:
        lines = f.read().split("\n")
    lines = [ln for ln in lines if not ln.strip().startswith("#") and ln.strip()]
    if not lines:
        return ""
    selected = lines[rng.randint(0, len(lines) - 1)]
    return _parse(selected, wdir, rng, depth)


def _parse(inputs: str, wdir: str, rng: _random.Random, depth: int) -> str:
    if inputs is None:
        return None
    if not inputs:
        return ""
    depth += 1
    if depth > DEPTH_MAX:
        return inputs
    text, name, in_token = "", "", False
    i, n = 0, len(inputs)
    while i < n:
        c = inputs[i]
        if c == "_" and i + 1 < n and inputs[i + 1] == "_":
            if not in_token:
                in_token, name = True, ""
            else:
                text += _choose_from_file(name, wdir, rng, depth)
                name, in_token = "", False
            i += 2
            continue
        if in_token:
            name += c
        else:
            text += c
        i += 1
    if in_token:  # unterminated
        text += "__" + name
    return text
