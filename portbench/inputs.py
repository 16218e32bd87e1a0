"""The general input generator: a configuration file and a seed give the
corpus and the needles that both the program and the reference are handed.

Each kind of configuration makes them in its own file, ``kinds/<kind>.py``
(``spec.load_kind``); here is what every kind shares: the inputs' form,
the seed's generators and the checked read of a data file.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List

import numpy as np

from .spec import ROOT, load_kind


@dataclasses.dataclass
class Inputs:
    corpus: bytes
    needles: List[bytes]


def rng(seed: int, *use: int) -> np.random.Generator:
    """A generator for one use of ``seed`` (any whole number; ``use`` keeps
    the uses apart)."""
    return np.random.default_rng([seed % (1 << 64), *use])


def read_checked(rel: str, sha256: str) -> bytes:
    """The file ``rel`` of the checkout, refused unless its sha256 is the
    one the configuration states."""
    with open(ROOT / rel, "rb") as f:
        data = f.read()
    got = hashlib.sha256(data).hexdigest()
    if got != sha256:
        raise ValueError(f"{rel}: sha256 {got}, the configuration states {sha256}")
    return data


def make(config: dict, seed: int) -> Inputs:
    """The inputs of ``config`` for ``seed``, made by its kind's ``inputs``."""
    return load_kind(config["kind"]).inputs(config, seed)
