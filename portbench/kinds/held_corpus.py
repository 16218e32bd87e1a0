"""``held_corpus``: one corpus held on the card and swept with one dictionary.

Inputs: a corpus file and a needle file under the benchmark's folder, each
checked by its sha256; the corpus's first ``corpus.bytes`` bytes and the
first ``needles.count`` needles, in an order the seed permutes.

System: ``preprocess`` the corpus onto the device, build one
``BatchedSearcher`` of the needles and (as the configuration says)
``optimize_for`` the corpus; a request is ``find_all``, ``count_all`` or
``positions_all`` of the whole dictionary, answers on the host.
"""

from __future__ import annotations

from portbench.inputs import Inputs, read_checked, rng


def inputs(config: dict, seed: int) -> Inputs:
    c, n = config["corpus"], config["needles"]
    corpus = read_checked(c["file"], c["sha256"])[: c["bytes"]]
    words = [w for w in read_checked(n["file"], n["sha256"]).split(n["separator"].encode()) if w]
    if len(corpus) != c["bytes"] or len(words) < n["count"]:
        raise ValueError(f"{config['name']}: the data files hold less than the configuration states")
    words = words[: n["count"]]
    order = rng(seed, 0).permutation(len(words))
    return Inputs(corpus, [words[i] for i in order])


class HeldCorpus:
    def __init__(self, config: dict, op: str, inputs: Inputs, device):
        from sliceslice_tpu_torch import BatchedSearcher, preprocess

        self.dh = preprocess(inputs.corpus, device=device)
        self.searcher = BatchedSearcher(inputs.needles, device=device)
        if config.get("layout", {}).get("optimize_for"):
            self.searcher.optimize_for(self.dh)
        calls = {"find": self.searcher.find_all, "count": self.searcher.count_all,
                 "positions": self.searcher.positions_all}
        self._call = calls[op]

    def request(self):
        return self._call(self.dh)

    def close(self) -> None:
        self.dh = self.searcher = self._call = None


build = HeldCorpus


def tiny(config: dict) -> dict:
    """The corpus's first 64 KiB and the dictionary's first 64 words."""
    return dict(config, corpus=dict(config["corpus"], bytes=65536),
                needles=dict(config["needles"], count=64))
