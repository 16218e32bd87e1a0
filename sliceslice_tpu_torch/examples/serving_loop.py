"""Example: sustained query serving.  The corpus stays on the card; query
batches are launched back to back with their results kept on the device
(``find_all_device``), and read back once per drain.

    python -m sliceslice_tpu_torch.examples.serving_loop
"""

import time

import numpy as np

import sliceslice_tpu_torch as st


def main(corpus_path: str = "data/i386.txt", words_path: str = "data/words.txt",
         batches: int = 12, per_batch: int = 512, *, device="cuda") -> None:
    hay = open(corpus_path, "rb").read()
    dh = st.preprocess(hay, device=device)  # corpus resident on the device, once
    words = [w for w in open(words_path, "rb").read().split(b"\n") if w]

    # A "query stream": batches of needles arriving over time.
    rng = np.random.default_rng(0)
    queries = [[words[int(i)] for i in rng.integers(0, len(words), per_batch)]
               for _ in range(batches)]

    # Searcher construction is the per-batch host cost.
    searchers = [st.BatchedSearcher(b, device=device) for b in queries]
    for s in searchers:  # warm pass: the kernels' build and first launches
        s.find_all_device(dh)

    t0 = time.perf_counter()
    pending = [s.find_all_device(dh) for s in searchers]  # launched back to back
    results = [r.cpu().numpy() for r in pending]  # one drain
    dt = time.perf_counter() - t0

    n_queries = sum(len(b) for b in queries)
    found = sum(int((r < st.SENTINEL).sum()) for r in results)
    print(f"{n_queries} queries over {len(hay):,} bytes in {dt * 1e3:.1f} ms on {dh.device} "
          f"({n_queries / dt:,.0f} queries/s; {found} matched)")


if __name__ == "__main__":
    main()
