"""The system under test: the port's public entry points, built in set-up
from the generated inputs and driven one request at a time.

``held_corpus``: ``preprocess`` the corpus onto the device, build one
``BatchedSearcher`` of the needles and (as the configuration says)
``optimize_for`` the corpus; a request is ``find_all``, ``count_all`` or
``positions_all`` of the whole dictionary, answers on the host.
"""

from __future__ import annotations

from .inputs import Inputs


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


KINDS = {"held_corpus": HeldCorpus}


def build(config: dict, traffic: dict, inputs: Inputs, device):
    return KINDS[config["kind"]](config, traffic["op"], inputs, device)
