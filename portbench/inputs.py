"""The general input generator: a configuration file and a seed give the
corpus and the needles that both the program and the reference are handed.

One kind of configuration so far, ``held_corpus``: a corpus file and a
needle file, both under this folder (checked by their sha256), the needles
in an order the seed permutes.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List

import numpy as np

from .spec import ROOT


@dataclasses.dataclass
class Inputs:
    corpus: bytes
    needles: List[bytes]


def rng(seed: int, *use: int) -> np.random.Generator:
    """A generator for one use of ``seed`` (any whole number; ``use`` keeps
    the uses apart)."""
    return np.random.default_rng([seed % (1 << 64), *use])


def _read_checked(rel: str, sha256: str) -> bytes:
    with open(ROOT / rel, "rb") as f:
        data = f.read()
    got = hashlib.sha256(data).hexdigest()
    if got != sha256:
        raise ValueError(f"{rel}: sha256 {got}, the configuration states {sha256}")
    return data


def held_corpus(config: dict, seed: int) -> Inputs:
    c, n = config["corpus"], config["needles"]
    corpus = _read_checked(c["file"], c["sha256"])[: c["bytes"]]
    words = [w for w in _read_checked(n["file"], n["sha256"]).split(n["separator"].encode()) if w]
    if len(corpus) != c["bytes"] or len(words) < n["count"]:
        raise ValueError(f"{config['name']}: the data files hold less than the configuration states")
    words = words[: n["count"]]
    order = rng(seed, 0).permutation(len(words))
    return Inputs(corpus, [words[i] for i in order])


def make(config: dict, seed: int) -> Inputs:
    kind = config["kind"]
    if kind == "held_corpus":
        return held_corpus(config, seed)
    raise ValueError(f"unknown configuration kind {kind!r}")
