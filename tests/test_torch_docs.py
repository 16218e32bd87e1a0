"""The port's documentation examples run, on the CPU: the JAX package's
docstring example (tests/test_docs.py) through the port beside the JAX
package, and every line of the port's own docstring example, each ``# ->``
value asserted."""

import functools
import inspect

import numpy as np

import sliceslice_tpu as jst
import sliceslice_tpu_torch as st

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"


def test_package_docstring_example():
    s = st.DynamicSearcher(b"ipsum", device=CPU)
    js = jst.DynamicSearcher(b"ipsum")
    assert s.search_in(b"lorem ipsum dolor") is True is js.search_in(b"lorem ipsum dolor")
    assert s.find(b"lorem ipsum dolor") == 6 == js.find(b"lorem ipsum dolor")
    assert list(s.positions(b"lorem ipsum, ipsum")) == [6, 13] == list(js.positions(b"lorem ipsum, ipsum"))
    assert list(s.find_iter(b"lorem ipsum, ipsum")) == [6, 13] == list(js.find_iter(b"lorem ipsum, ipsum"))
    assert st.DynamicSearcher(b"aba", device=CPU).count_in(b"ababa") == 2  # overlapping
    assert jst.DynamicSearcher(b"aba").count_in(b"ababa") == 2

    corpus = b"some corpus with a needle inside" * 40
    got = st.BatchedSearcher([b"a", b"needle"], device=CPU).find_all(st.preprocess(corpus, device=CPU))
    assert list(got) == [17, 19]
    assert list(jst.BatchedSearcher([b"a", b"needle"]).find_all(jst.preprocess(corpus))) == [17, 19]


def _example_lines() -> list:
    """The statements of the port's docstring example: the indented block
    after ``Public API::``."""
    doc = inspect.getdoc(st)
    block = doc.split("Public API::", 1)[1].strip("\n").split("\n")
    lines = []
    for line in block:
        if line and not line.startswith("    "):
            break
        if line.strip():
            lines.append(line.strip())
    return lines


def test_port_docstring_example(tmp_path, monkeypatch):
    """Every line of the port's docstring example runs, with the card's
    default swapped for the CPU and its files ("corpus", "huge.log") made
    in a temporary directory; each ``# -> value`` is the line's value."""
    monkeypatch.chdir(tmp_path)
    corpus = b"some corpus with a needle inside" * 400
    (tmp_path / "corpus").write_bytes(corpus)
    (tmp_path / "huge.log").write_bytes(b"x" * 100_000 + b"needle" + b"y" * 50)
    names = {"np": np, "array": np.array}
    for name in st.__all__:
        obj = getattr(st, name)
        try:
            takes_device = "device" in inspect.signature(obj).parameters
        except (TypeError, ValueError):  # not a callable with a signature
            takes_device = False
        names[name] = functools.partial(obj, device=CPU) if takes_device else obj
    lines = _example_lines()
    assert lines[0].startswith("from sliceslice_tpu_torch import")
    asserted = []
    for line in lines[1:]:
        code, _, expect = line.partition("# ->")
        code = code.strip()
        if "=" in code.split("(", 1)[0]:
            exec(code, names)
            continue
        value = eval(code, names)
        if expect:
            want = eval(expect.strip(), names)
            assert np.array_equal(np.asarray(value), np.asarray(want)), (code, value, want)
            asserted.append(code)
    assert len(asserted) == 3
    hay = names["hay"]
    assert st.BatchedSearcher([b"a", b"needle"], device=CPU).find_all(hay).tolist() == [
        corpus.find(b"a"), corpus.find(b"needle")]
