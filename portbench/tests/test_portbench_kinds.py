"""Configuration kinds, each a file ``kinds/<kind>.py`` found by name: the
i386 configuration's inputs pinned to what they were before kinds were
files, and a kind written only into a temporary folder running a cell."""

import hashlib
import json
import textwrap
import time

import pytest

from portbench import control, harness, inputs, spec

from .test_portbench_control import _plant_altered_answer

#: seed -> sha256 of the i386 configuration's corpus and of its needles
#: joined by b"\n", in the order the seed gives them.
I386 = {
    2147483659: ("563e894dab529ab3f43f5986c893a084a62da3535cf2e4860c243d0e0ef1a2b4",
                 "5310862914660abb3e6d042a8c62ca847ff07fd1d9257234f4a2b26fc9d3bd3c"),
    4294967373: ("563e894dab529ab3f43f5986c893a084a62da3535cf2e4860c243d0e0ef1a2b4",
                 "31a116823d6ec6cc42b4e6f28522a50d268d969e6b5de52ad9e37e0983fd403f"),
    8589934593: ("563e894dab529ab3f43f5986c893a084a62da3535cf2e4860c243d0e0ef1a2b4",
                 "1a1b3aea66f01179792b5b6dc00448f49b593f331de88035c2ed7811b372d474"),
}


@pytest.mark.parametrize("seed", sorted(I386))
def test_the_i386_inputs_are_pinned(seed):
    cfg = json.loads((spec.HERE / "configs" / "i386-dictionary.json").read_text())
    got = inputs.make(cfg, seed)
    assert (hashlib.sha256(got.corpus).hexdigest(),
            hashlib.sha256(b"\n".join(got.needles)).hexdigest()) == I386[seed]


def test_the_sampling_draw_is_pinned():
    """The requests a window of ``sample_one_in`` 128 checks, by index."""
    draw = inputs.rng(2147483659, 2)
    assert [i for i in range(2000) if draw.random() * 128 < 1.0] == \
        [63, 76, 326, 708, 755, 904, 948, 1114, 1175, 1521, 1688, 1718, 1771, 1823, 1845, 1875]


def test_an_unknown_kind_names_the_file_looked_for(tmp_path):
    with pytest.raises(ValueError, match=str(tmp_path / "no_such_kind.py")):
        spec.load_kind("no_such_kind", tmp_path)
    with pytest.raises(ValueError, match=str(spec.KINDS / "no_such_kind.py")):
        inputs.make({"kind": "no_such_kind"}, 1)


#: A kind of its own: a seeded corpus of four letters (so that the control's
#: unverified first-and-last-byte filter passes many false matches) and
#: needles cut from it, one of each length, at offsets drawn from the seed.
SEEDED = '''
"""A corpus of letters drawn from the seed, searched for needles cut from it."""

import numpy as np

from portbench.inputs import Inputs, rng

LENGTHS = (1, 3, 4, 6, 9, 17, 40)


def inputs(config, seed):
    r = rng(seed, 1)
    corpus = r.integers(97, 101, config["bytes"], dtype=np.uint8).tobytes()
    starts = r.integers(0, config["bytes"] - max(LENGTHS), len(LENGTHS))
    return Inputs(corpus, [corpus[s:s + k] for s, k in zip(starts, LENGTHS)])


class Held:
    def __init__(self, config, op, inputs, device):
        from sliceslice_tpu_torch import BatchedSearcher, preprocess

        self.dh = preprocess(inputs.corpus, device=device)
        self._call = getattr(BatchedSearcher(inputs.needles, device=device), op + "_all")

    def request(self):
        return self._call(self.dh)

    def close(self):
        self.dh = self._call = None


build = Held


def tiny(config):
    # Over the 8 KiB of the flat rung, so that the kernel layout's path runs.
    return dict(config, bytes=12288)
'''


def _seeded_cell(folder, op: str, extra: str = "") -> spec.Cell:
    (folder / "seeded_corpus.py").write_text(SEEDED + textwrap.dedent(extra))
    bench = spec.load_benchmark()
    e2e = "count_query_ms" if op == "count" else "query_ms"
    metrics = [m for m in bench["end_to_end"] if m["name"] in (e2e, "setup_s")]
    traffic = {"name": f"seeded-{op}", "op": op, "loop": "closed", "clients": 1,
               "warmup_requests": 1, "sample_one_in": 2, "trace_requests": 2}
    config = {"name": "seeded-16k", "kind": "seeded_corpus", "bytes": 16384}
    cell = spec.Cell(f"seeded-16k.{op}", 1, config, traffic, metrics, [], kinds=folder)
    cell.config = spec.load_kind("seeded_corpus", folder).tiny(config)
    assert config["bytes"] == 16384  # tiny cut a copy
    return cell


def _run(cell, seed=2**32 + 5, build=None):
    return harness.run_cell(cell, seed, 0.2, False, "cpu", time.perf_counter(), build=build)[0]


@pytest.mark.parametrize("op", ["find", "count", "positions"])
def test_a_kind_added_as_a_file_alone_runs_a_cell(tmp_path, op, monkeypatch):
    cell = _seeded_cell(tmp_path, op)
    sound = _run(cell)
    assert sound["correct"] is True and sound["checks"]["wrong_answers"]["value"] == 0
    assert set(sound["metrics"]) == {m["name"] for m in cell.end_to_end}
    control_run = _run(cell, build=control.build)
    assert control_run["correct"] is False and control_run["checks"]["wrong_answers"]["value"] > 0
    _plant_altered_answer(op, monkeypatch)
    broken = _run(cell)
    assert broken["correct"] is False and broken["checks"]["wrong_answers"]["value"] >= 1


def test_a_kind_brings_its_own_reference(tmp_path):
    """A kind's ``answers`` and ``wrong_answers`` take the place of the
    reference's: answers in the wrong order fail a sound run, and a judge
    that finds nothing wrong passes the control."""
    cell = _seeded_cell(tmp_path, "count", '''
        from portbench import reference


        def answers(op, inputs):
            return reference.answers(op, inputs.corpus, inputs.needles[::-1])
    ''')
    assert _run(cell)["correct"] is False
    (tmp_path / "judge").mkdir()
    cell = _seeded_cell(tmp_path / "judge", "count", '''
        def wrong_answers(op, got, want):
            return 0
    ''')
    assert _run(cell, build=control.build)["correct"] is True
