"""Example: a sharded corpus scan over a mesh of cells.

One process: the mesh's cells lie round-robin on the visible cards, so
one card holds all of them (the counterpart of the JAX package's virtual
devices).  Several processes: call ``parallel.distributed.initialize``
first in each; ``make_mesh`` then spans them all.

    python -m sliceslice_tpu_torch.examples.distributed_scan [D N]
"""

import sys

import numpy as np

import sliceslice_tpu_torch as st
from sliceslice_tpu_torch.parallel import ShardedBatchedSearcher, make_mesh


def main(shape=(4, 2), *, device="cuda") -> None:
    rng = np.random.default_rng(0)
    corpus = bytes(rng.integers(32, 127, (2_000_000,), dtype=np.uint8))
    needles = [corpus[i:i + 8] for i in (0, 999_999, 1_999_990)] + [b"@@@@"]

    mesh = make_mesh(tuple(shape), device=device)
    dh = st.preprocess(corpus, kh=16, device=mesh.home)
    print(f"mesh {mesh.shape} of cells on {sorted({str(d) for d in mesh.devices.reshape(-1)})}, "
          f"{dh.length:,} bytes")

    sb = ShardedBatchedSearcher(needles, mesh)
    for nd, off in zip(needles, sb.find_all(dh)):
        print(f"  {nd[:12]!r} -> {off}")


if __name__ == "__main__":
    main(tuple(int(x) for x in sys.argv[1:3]) if len(sys.argv) > 2 else (4, 2))
