"""Example: the batched workload, many needles over one corpus laid out
on the card once, with results kept on the device for pipelines.

    python -m sliceslice_tpu_torch.examples.corpus_scan data/i386.txt data/words.txt
"""

import sys
import time

import sliceslice_tpu_torch as st


def main(corpus_path: str, words_path: str, *, device="cuda") -> None:
    hay = open(corpus_path, "rb").read()
    words = [w for w in open(words_path, "rb").read().split(b"\n") if w]

    dh = st.preprocess(hay, device=device)                 # device layout, built once
    bs = st.BatchedSearcher(words, device=device)          # probe tables, built once

    t0 = time.perf_counter()
    offsets = bs.find_all(dh)
    dt = time.perf_counter() - t0
    found = int((offsets >= 0).sum())
    print(f"{found}/{len(words)} needles found in {len(hay):,} bytes "
          f"({dt * 1e3:.1f} ms on {dh.device}, the kernels' build included on the first call)")
    for w, o in list(zip(words, offsets))[:5]:
        print(f"  {w.decode(errors='replace')!r:20} -> "
              f"{'offset ' + str(o) if o >= 0 else 'absent'}")


if __name__ == "__main__":
    main(*(sys.argv[1:3] or ("data/i386.txt", "data/words.txt")))
