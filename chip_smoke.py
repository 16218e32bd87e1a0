#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sliceslice_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card,
drives the main path (``preprocess`` -> ``BatchedSearcher.find_all`` over
all 4,585 words of data/words.txt in the 857,425-byte data/i386.txt, then
``DynamicSearcher``'s arms and a seeded 256 MiB corpus) against
``bytes.find``, and times the sweep and each kernel with CUDA events.
Every phase prints one line; any failure raises and exits non-zero.  The
next-to-last lines are a JSON object describing the kernels and the card's
name and power limit; the last line is ``{"ok": true, "device": ...}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "sliceslice_tpu_torch/csrc/find.cu"
BIG_BYTES = 256 * 1024 * 1024
SWEEPS = 32


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def phase_env(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from sliceslice_tpu_torch.ops import cuda_lib
    from sliceslice_tpu_torch.utils.profiling import card

    try:
        import triton  # noqa: F401

        triton_ok = True
    except ImportError:
        triton_ok = False
    line = card(0)
    print(line, flush=True)
    say("env", card=line, torch=torch.__version__, cuda=torch.version.cuda,
        device_count=torch.cuda.device_count(), nvcc=cuda_lib.nvcc_path(),
        triton=triton_ok)
    return line


def phase_build():
    from sliceslice_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.load()
    info = cuda_lib.build_info
    summary = [ln.strip() for ln in info.get("ptxas", "").splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    say("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=round(info.get("seconds", 0.0), 3),
        library=os.path.relpath(info["library"], REPO), ptxas=summary)


def _kernel_tables(hay: bytes, rng, t: int):
    """Needles of every length 1..4t (present, absent, and at the last
    valid position) in one width-t table."""
    needles = []
    for k in range(max(1, 4 * t - 11), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - k))
        needles.append(hay[start:start + k])                      # present
        needles.append(bytes(rng.integers(200, 256, k, dtype=np.uint8)))  # absent
        needles.append(hay[-k:])                                   # last position
    return needles


def phase_kernels(torch, device):
    """Find and memchr kernels against their plain versions on the card."""
    from sliceslice_tpu_torch import preprocess
    from sliceslice_tpu_torch.config import SENTINEL
    from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.ops.scan_math import table_bits

    rng = np.random.default_rng(1234)
    body = rng.integers(97, 101, (1 << 20) - 128, dtype=np.uint8)
    tail = rng.permutation(np.arange(128, 256, dtype=np.uint8))  # unique bytes
    hay = np.concatenate([body, tail]).tobytes()
    dh = preprocess(hay, kh=needed_halo_for_t(32), device=device)
    widths = list(range(1, 9)) + [16, 32]
    max_err = 0
    rows = 0
    for t in widths:
        needles = _kernel_tables(hay, rng, t)
        vals, msks, lens = build_probe_table(needles, t_max=t)
        n_pad = len(needles) + 8  # padded rows: mask 0, end 0
        vals = np.pad(vals, ((0, 8), (0, 0)))
        msks = np.pad(msks, ((0, 8), (0, 0)))
        ends = np.pad(np.maximum(len(hay) - lens + 1, 0).astype(np.int64), (0, 8))
        for base, n_real in ((0, n_pad), (4096, n_pad - 11)):
            e = torch.from_numpy((ends + np.where(ends > 0, base, 0)).astype(np.int32)).to(device)
            v, m = table_bits(vals, device), table_bits(msks, device)
            got = scan_kernel.batched_find(dh.flat, v, m, e, base=base, n_real=n_real)
            plain = scan_kernel.batched_find_plain(dh.flat, v, m, e, base=base, n_real=n_real)
            got, plain = got.cpu().numpy(), plain.cpu().numpy()
            max_err = max(max_err, int(np.abs(got.astype(np.int64) - plain).max()))
            check(np.array_equal(got, plain), f"find kernel != plain at t={t} base={base}")
            exp = np.full(n_pad, SENTINEL, np.int64)
            for i, nd in enumerate(needles[:n_real]):
                f = hay.find(nd)
                exp[i] = SENTINEL if f < 0 else f + base
            check(np.array_equal(got, exp), f"find kernel != bytes.find at t={t} base={base}")
            rows += n_pad
    find_err = max_err
    max_err = 0
    cases = 0
    for byte in (97, 100, int(tail[0]), int(tail[-1]), 0, 255):
        for end, base in ((len(hay), 0), (len(hay) // 2, 0), (len(hay) + 4096, 4096)):
            got = int(scan_kernel.memchr_find(dh.flat, byte, end, base))
            plain = int(scan_kernel.memchr_find_plain(dh.flat, byte, end, base))
            max_err = max(max_err, abs(got - plain))
            f = hay.find(bytes([byte]), 0, end - base)
            check(got == plain == (SENTINEL if f < 0 else f + base),
                  f"memchr kernel != plain/bytes.find for byte {byte} end {end} base {base}")
            cases += 1
    say("kernels", find_rows=rows, find_widths=widths, find_max_abs_err=find_err,
        memchr_cases=cases, memchr_max_abs_err=max_err, equal=True)
    return {"batched_find": find_err, "memchr_find": max_err}


def phase_i386(torch, device, hay, words):
    from sliceslice_tpu_torch import BatchedSearcher, preprocess

    dh = preprocess(hay, kh=24, device=device)
    bs = BatchedSearcher(words, device=device)
    exp = np.array([hay.find(w) for w in words])
    got = bs.find_all(dh)
    check(np.array_equal(got, exp), f"i386 sweep: {int((got != exp).sum())} words differ")
    bs.optimize_for(dh)
    got2 = bs.find_all(dh)
    check(np.array_equal(got2, exp), "i386 sweep after optimize_for differs")
    widths = {g.t: g.n for g in bs.groups}
    say("i386", words=len(words), corpus_bytes=len(hay), groups=widths,
        parity=True, parity_after_optimize_for=True)
    return dh, bs


def phase_dynamic(torch, device, hay):
    from sliceslice_tpu_torch import DynamicSearcher, preprocess
    from sliceslice_tpu_torch.ops import scan_kernel

    rng = np.random.default_rng(7)
    small = hay[100_000:106_000]          # bytes, 4096 < len <= 8192: flat rung
    tiny = preprocess(hay[:3000], device=device)   # DeviceHaystack, flat rung
    big = preprocess(hay, kh=64, device=device)    # kernel layout
    m0 = scan_kernel.memchr_find.launches
    lengths = [1, 2, 3, 5, 8, 12, 16, 17, 24, 32, 33, 40, 100, 1000]
    checked = 0
    for k in lengths:
        for h_bytes, h in ((small, small), (hay[:3000], tiny), (hay, big), (hay, hay)):
            start = int(rng.integers(0, len(h_bytes) - k))
            for nd in (h_bytes[start:start + k], h_bytes[-k:], b"\xfe" * k):
                got = DynamicSearcher(nd, device=device).find(h)
                f = h_bytes.find(nd)
                check(got == (None if f < 0 else f), f"DynamicSearcher k={k} differs")
                checked += 1
    memchr_runs = scan_kernel.memchr_find.launches - m0
    check(memchr_runs > 0, "the 1-byte arm never launched the memchr kernel")
    say("dynamic", lengths=lengths, checks=checked, memchr_launches=memchr_runs,
        parity=True)


def phase_big(torch, device):
    from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, preprocess

    rng = np.random.default_rng(2024)
    arr = rng.integers(0, 250, BIG_BYTES, dtype=np.uint8)
    planted = []
    offsets = np.sort(rng.choice(BIG_BYTES - 4096, 32, replace=False))
    for off in offsets:
        k = int(rng.integers(1, 65))
        nd = rng.integers(0, 250, k, dtype=np.uint8)
        arr[off:off + k] = nd
        planted.append(nd.tobytes())
    absent = [bytes([255]) + rng.integers(0, 250, k - 1, dtype=np.uint8).tobytes()
              for k in (1, 2, 3, 4, 7, 12, 24, 40)]
    hay = arr.tobytes()
    needles = planted + absent
    t0 = time.perf_counter()
    dh = preprocess(arr, kh=64, device=device)
    dh.flat[-1].item()  # wait for the upload
    upload_s = time.perf_counter() - t0
    exp = np.array([hay.find(nd) for nd in needles])
    got = BatchedSearcher(needles, device=device).find_all(dh)
    check(np.array_equal(got, exp), f"256 MiB corpus: {int((got != exp).sum())} needles differ")
    last = planted[-1]
    check(DynamicSearcher(last, device=device).find(dh) == hay.find(last),
          "256 MiB corpus: DynamicSearcher differs")
    check(DynamicSearcher(b"\xff", device=device).find(dh) is None,
          "256 MiB corpus: absent byte found")
    say("big", corpus_bytes=BIG_BYTES, planted=len(planted), absent=len(absent),
        max_offset=int(exp.max()), upload_s=round(upload_s, 3), parity=True)
    return dh


def phase_times(torch, device, card, i386_dh, bs, big_dh):
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.utils.profiling import HBM_ROOFLINE, measure

    n_words, hay_len = len(bs), i386_dh.length

    def sweeps():
        for _ in range(SWEEPS):
            bs.find_all_device(i386_dh)

    m = measure(sweeps, f"i386 sweep x{SWEEPS}", warmup=1, samples=5,
                bytes_processed=n_words * hay_len * SWEEPS, device=device)
    per_sweep_ms = m.estimate * 1e3 / SWEEPS
    say("times", what="sustained i386 sweep", card=card, sweeps=SWEEPS,
        ms_per_sweep=per_sweep_ms, low_ms=m.low * 1e3 / SWEEPS,
        high_ms=m.high * 1e3 / SWEEPS,
        effective_GBps=m.gbps(), effective_GBps_means="words x corpus bytes / time")

    calls = [(i386_dh.flat, g.values_dev, g.masks_dev, g.ends_dev(hay_len), 0, g.n)
             for g in bs.groups]

    def kernel_sweep():
        for c in calls:
            scan_kernel.batched_find(*c)

    def plain_sweep():
        for c in calls:
            scan_kernel.batched_find_plain(*c)

    plain = measure(plain_sweep, "find plain", warmup=1, samples=3, device=device)
    kern = measure(kernel_sweep, "find kernel", warmup=1, samples=5, device=device)
    find_ms, find_plain_ms = kern.estimate * 1e3, plain.estimate * 1e3
    say("times", what="find kernel vs plain, one i386 sweep (all width groups)",
        card=card, kernel_ms=find_ms, plain_ms=find_plain_ms,
        speedup=find_plain_ms / find_ms)

    big_end = big_dh.length
    mem_plain = measure(lambda: scan_kernel.memchr_find_plain(big_dh.flat, 255, big_end),
                        "memchr plain", warmup=1, samples=3, device=device)
    mem = measure(lambda: scan_kernel.memchr_find(big_dh.flat, 255, big_end),
                  "memchr kernel", warmup=1, samples=5, bytes_processed=big_end,
                  device=device)
    mem_ms, mem_plain_ms = mem.estimate * 1e3, mem_plain.estimate * 1e3
    say("times", what="memchr kernel vs plain, absent byte over 256 MiB (full scan)",
        card=card, kernel_ms=mem_ms, plain_ms=mem_plain_ms,
        kernel_GBps=mem.gbps(), hbm_roofline_GBps=HBM_ROOFLINE["h100"] / 1e9,
        roofline_share=mem.gbps() * 1e9 / HBM_ROOFLINE["h100"])
    return {"batched_find": (find_ms, find_plain_ms), "memchr_find": (mem_ms, mem_plain_ms)}


def main() -> int:
    import torch

    device = torch.device("cuda", 0)
    card = phase_env(torch)
    phase_build()
    errs = phase_kernels(torch, device)

    from sliceslice_tpu_torch.ops import scan_kernel

    hay = open(os.path.join(REPO, "data/i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(REPO, "data/words.txt"), "rb").read().split(b"\n") if w]
    check(len(words) == 4585 and len(hay) == 857425, "unexpected corpus files")

    # The main path's run: counts start at 0 here and are read right after.
    scan_kernel.batched_find.launches = 0
    scan_kernel.memchr_find.launches = 0
    i386_dh, bs = phase_i386(torch, device, hay, words)
    phase_dynamic(torch, device, hay)
    big_dh = phase_big(torch, device)
    torch.cuda.synchronize()
    launches = {"batched_find": scan_kernel.batched_find.launches,
                "memchr_find": scan_kernel.memchr_find.launches}
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched by the main path")

    times = phase_times(torch, device, card, i386_dh, bs, big_dh)
    replaces = {"batched_find": "sliceslice_tpu/ops/scan_kernel.py:266",
                "memchr_find": "sliceslice_tpu/ops/scan_kernel.py:720"}
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]} for name in replaces]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found; this needs an NVIDIA card", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
