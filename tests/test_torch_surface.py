"""The port's parity ledger: everything the JAX package offers, and every
test of it, has its counterpart in the port or a stated reason not to.

Both packages and the test files are read with ``ast``; neither package is
imported, so this runs in a moment and needs no jax.

* Public names: each public top-level name of every module of
  ``sliceslice_tpu/``, and each name in its ``__all__``, is bound at the top
  level of the port's matching module (and listed in its ``__all__``), under
  the renames of :data:`RENAMED` and the moves of :data:`MOVED`, or stands
  in :data:`NOT_PORTED` with its reason.
* JAX tests: each ``test_*`` function of the JAX test files has a port test
  of the same name in some ``tests/test_torch_*.py``, or a mirror of
  another name in :data:`MIRRORS`, or a reason in :data:`NOT_PORTED_TESTS`.

Neither list may go stale: a name of :data:`NOT_PORTED` that appears in the
port, or a JAX test of :data:`NOT_PORTED_TESTS` that gains a same-named
port test, fails here, as does an entry naming nothing."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "sliceslice_tpu"
PORT = ROOT / "sliceslice_tpu_torch"
TESTS = ROOT / "tests"

#: Module files and public names the port renamed.
RENAMED = {
    "pallas_searcher": "cuda_searcher",
    "xla_searcher": "torch_searcher",
    "xla_backend": "torch_backend",
    "PallasSearcher": "CudaSearcher",
    "XlaSearcher": "TorchSearcher",
}

#: Names the port keeps in another module (JAX "module::name" -> port module).
MOVED = {
    "ops/xla_backend.py::compact_positions": "ops/scan_kernel.py",
    "ops/xla_backend.py::chained_match_bitmap": "ops/chained.py",
}

#: Why a part of the JAX package has no counterpart in the port.
REASONS = {
    "jax": "JAX-only: config.py's jax compile cache and Pallas interpret switch (use_interpret)",
    "graft": "JAX-only: __graft_entry__.py and tests/test_graft.py",
    "layout": "TPU-only: the TPU layout and its helpers (column-major 128-lane tiles, segments, "
              "halo rows, packed windows); the port keeps one flat uint8 layout",
    "cols": "TPU-only: the *_cols entry points over the TPU column layout; the port's are "
            "scan_kernel.batched_find, batched_count and match_bitmap over the flat layout",
    "flat": "TPU-only: the flat XLA rung for short haystacks and its power-of-two buffer; "
            "the port lays every haystack out the one way",
    "premask": "TPU-only: the premask, pen_full and last_full machinery and the SMEM unfound-needle lists",
    "tiles": "TPU-only: the Pallas pair block's tile shape; the port's pair kernel has its own "
             "(kTileN in csrc/pairwise.cu)",
    "segment": "TPU-only: parallel/distributed.local_segment_block, the TPU's segment geometry; "
               "the port's shard_bytes takes its place",
    "scripts": "JAX-only: scripts/check_version.py, make_benchmarks_svg.py, update_readme_bench.py "
               "and lint.py (lint holds the port through tests/test_torch_lint.py)",
    "artifacts": "JAX-only: the artifact writes (bench.py's BENCH_rNN.json, BENCH_DETAIL_rNN.json "
                 "and the README bench block and svg generated from them)",
}

#: JAX "module::name" -> reason.
NOT_PORTED = {
    "config.py::interpret": REASONS["jax"],
    "config.py::use_interpret": REASONS["jax"],
    "ops/layout.py::LANES": REASONS["layout"],
    "ops/layout.py::SEG_CAP_ROWS": REASONS["layout"],
    "ops/layout.py::plan_layout": REASONS["layout"],
    "ops/layout.py::position_grid": REASONS["layout"],
    "ops/layout.py::next_pow2": REASONS["flat"],
    "ops/pairwise.py::PALLAS_BN": REASONS["tiles"],
    "ops/pairwise.py::PALLAS_BH": REASONS["tiles"],
    "ops/scan_kernel.py::LANES": REASONS["layout"],
    "ops/scan_kernel.py::CHUNK_ROWS": REASONS["layout"],
    "ops/scan_kernel.py::NO_ROW": REASONS["premask"],
    "ops/scan_kernel.py::PM_CLASSES": REASONS["premask"],
    "ops/scan_kernel.py::batched_find_cols": REASONS["cols"],
    "ops/scan_kernel.py::batched_count_cols": REASONS["cols"],
    "ops/scan_kernel.py::memchr_find_cols": REASONS["cols"],
    "ops/scan_math.py::LANES": REASONS["layout"],
    "ops/scan_math.py::probe_acc": REASONS["layout"],
    "ops/scan_math.py::value_slicer": REASONS["layout"],
    "ops/scan_math.py::segment_positions": REASONS["layout"],
    "ops/scan_math.py::lane_first_offset": REASONS["layout"],
    "ops/scan_math.py::first_offset": REASONS["layout"],
    "ops/xla_backend.py::find_flat": REASONS["flat"],
    "ops/xla_backend.py::find_batched_flat": REASONS["flat"],
    "ops/xla_backend.py::find_batched_cols": REASONS["cols"],
    "ops/xla_backend.py::match_bitmap_cols": REASONS["cols"],
    "ops/xla_backend.py::bitmap_linear": REASONS["layout"],
    "ops/xla_backend.py::bitmap_from_linear": REASONS["layout"],
    "parallel/distributed.py::local_segment_block": REASONS["segment"],
}

#: JAX "file::test" -> the port test that holds it under another name.
MIRRORS = {
    "test_batched.py::test_mixed_lengths_cols": "test_torch_batched.py::test_mixed_lengths_cols_and_wide_buckets",
    "test_batched.py::test_group_order_preserved": "test_torch_batched.py::test_group_order_and_short_haystacks",
    "test_batched.py::test_needle_longer_than_haystack": "test_torch_batched.py::test_group_order_and_short_haystacks",
    "test_batched.py::test_empty_batch": "test_torch_batched.py::test_group_order_and_short_haystacks",
    "test_batched.py::test_batched_position_contract": "test_torch_batched.py::test_batched_contracts",
    "test_contracts.py::test_exotic_final_mask_pen_full_exact": "test_torch_contracts.py::test_exotic_final_mask_exact",
    "test_contracts.py::test_width_gap_table_raises":
        "test_torch_contracts.py::test_width_gap_table_exact_where_jax_raises",
    "test_contracts.py::test_ensure_halo_cached_and_preserving":
        "test_torch_layout.py::test_ensure_halo_rebuild_and_cache",
    "test_counts.py::test_count_in_device": "test_torch_count.py::test_count_in_matches_jax",
    "test_counts.py::test_count_all_batched": "test_torch_count.py::test_count_all_words_matches_jax",
    "test_counts.py::test_count_segment_boundary": "test_torch_count.py::test_count_ends_clamped_and_chunk_boundaries",
    "test_counts.py::test_count_in_pallas_vs_batched": "test_torch_count.py::test_count_searchers_agree",
    "test_counts.py::test_count_clean_vs_boundary_segments":
        "test_torch_count.py::test_count_ends_clamped_and_chunk_boundaries",
    "test_i386.py::test_long_haystack_sampled": "test_torch_batched.py::test_i386_sample_matches_jax",
    "test_i386.py::test_long_haystack_full": "test_torch_batched.py::test_all_words_full_i386",
    "test_i386.py::test_short_haystack_full": "test_torch_gpu.py::test_full_conformance_on_the_card",
    "test_layout.py::test_flat_short_path": "test_torch_layout.py::test_padding_and_halo",
    "test_layout.py::test_ensure_halo_rebuild": "test_torch_layout.py::test_ensure_halo_rebuild_and_cache",
    "test_needle.py::test_num_probes_and_halo": "test_torch_needle.py::test_halo_and_probe_counts_identical",
    "test_needle.py::test_as_bytes_conversions": "test_torch_needle.py::test_needle_position_and_conversions",
    "test_needle.py::test_needle_position_contract": "test_torch_needle.py::test_needle_contract_errors_identical",
    "test_pairwise.py::test_pairwise_random": "test_torch_pairwise.py::test_pairwise_random_matches_jax",
    "test_pairwise.py::test_pairwise_distinct_haystacks":
        "test_torch_pairwise.py::test_pairwise_distinct_haystacks_multi_block",
    "test_pairwise.py::test_pairwise_pallas_block_differential":
        "test_torch_pairwise.py::test_pairwise_matches_jax_pallas_block",
    "test_pairwise.py::test_pairwise_pallas_edge_cases": "test_torch_pairwise.py::test_pairwise_edge_cases",
    "test_pairwise.py::test_fused_cache_does_not_pin_instances":
        "test_torch_pairwise.py::test_cache_does_not_pin_instances",
    "test_searchers.py::test_random_differential_cols": "test_torch_searchers.py::test_random_differential_cols_vs_jax",
}

#: JAX "file::test" -> reason.
NOT_PORTED_TESTS = {
    "test_batched.py::test_raw_kernel_cols_fallback": REASONS["cols"],
    "test_docs.py::test_version_gate": REASONS["scripts"],
    "test_docs.py::test_readme_bench_block_matches_newest_artifact": REASONS["artifacts"],
    "test_graft.py::test_entry_jits_and_runs": REASONS["graft"],
    "test_graft.py::test_dryrun_multichip": REASONS["graft"],
    "test_layout.py::test_plan_layout_buckets": REASONS["layout"],
    "test_layout.py::test_cols_layout_formula": REASONS["layout"],
    "test_layout.py::test_windows_only_layout": REASONS["layout"],
    "test_layout.py::test_windows_only_without_host_bytes_raises": REASONS["layout"],
    "test_layout.py::test_drop_cols_roundtrip": REASONS["layout"],
}


def _read(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def module_names(path: pathlib.Path):
    """``(public, bound, all_)`` of a module: the public names it defines
    at its top level, every name bound there (imports included), and its
    ``__all__`` (None without one)."""
    public, bound, all_ = set(), set(), None
    for node in _read(path).body:
        names = []
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if "__all__" in names:
                all_ = [ast.literal_eval(e) for e in node.value.elts]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names = [node.target.id]
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound |= {(a.asname or a.name).split(".")[0] for a in node.names}
        bound |= set(names)
        public |= {n for n in names if not n.startswith("_")}
    return public, bound, all_


def jax_modules() -> dict:
    """{JAX module path relative to the package: the port's module path}."""
    out = {}
    for path in sorted(JAX.rglob("*.py")):
        rel = path.relative_to(JAX)
        parts = list(rel.with_suffix("").parts)
        parts[-1] = RENAMED.get(parts[-1], parts[-1])
        out[rel.as_posix()] = "/".join(parts) + ".py"
    return out


def test_every_jax_module_has_a_port_module():
    missing = [jax for jax, port in jax_modules().items() if not (PORT / port).is_file()]
    assert not missing, missing


def test_every_public_jax_name_is_ported_or_excused():
    missing = []
    for jax_rel, port_rel in jax_modules().items():
        public, _, jax_all = module_names(JAX / jax_rel)
        _, port_bound, port_all = module_names(PORT / port_rel)
        for name in sorted(public | set(jax_all or ())):
            key = f"{jax_rel}::{name}"
            if key in NOT_PORTED:
                continue
            target = RENAMED.get(name, name)
            if key in MOVED:
                if target not in module_names(PORT / MOVED[key])[1]:
                    missing.append(f"{key} (moved to {MOVED[key]})")
                continue
            if target not in port_bound:
                missing.append(key)
            elif jax_all is not None and name in jax_all and target not in (port_all or ()):
                missing.append(f"{key} (absent from {port_rel}'s __all__)")
    assert not missing, f"public JAX names with no port counterpart and no reason: {missing}"


def test_excused_names_stay_unported_and_name_something():
    """A NOT_PORTED or MOVED entry names a public JAX name; a NOT_PORTED
    name, or a renamed name's old spelling, bound anywhere in the port
    means the entry went stale."""
    jax_public = set()
    for jax_rel in jax_modules():
        public, _, jax_all = module_names(JAX / jax_rel)
        jax_public |= {f"{jax_rel}::{n}" for n in public | set(jax_all or ())}
    assert not (set(NOT_PORTED) | set(MOVED)) - jax_public
    assert set(NOT_PORTED.values()) <= set(REASONS.values())
    port_bound = set()
    for path in PORT.rglob("*.py"):
        port_bound |= module_names(path)[1]
    stale = {key for key in NOT_PORTED if key.split("::")[1] in port_bound}
    stale |= {old for old, new in RENAMED.items() if not old.islower() and old in port_bound}
    assert not stale, f"listed as not ported, yet in the port: {sorted(stale)}"


def _test_functions(path: pathlib.Path) -> set:
    return {n.name for n in _read(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name.startswith("test_")}


def _port_tests() -> dict:
    return {p.name: _test_functions(p) for p in sorted(TESTS.glob("test_torch_*.py"))}


def _jax_tests() -> dict:
    return {f"{p.name}::{name}": name for p in sorted(TESTS.glob("test_*.py"))
            if not p.name.startswith("test_torch_") for name in _test_functions(p)}


def test_every_jax_test_is_mirrored_or_excused():
    port = _port_tests()
    same_named = set().union(*port.values())
    missing = [key for key, name in _jax_tests().items()
               if name not in same_named and key not in MIRRORS and key not in NOT_PORTED_TESTS]
    assert not missing, f"JAX tests with no port mirror and no reason: {missing}"
    for key, target in MIRRORS.items():
        file, name = target.split("::")
        assert name in port.get(file, ()), f"{key}: its mirror {target} does not exist"


def test_test_ledger_entries_stay_needed():
    """Every entry names a JAX test; none of them has a same-named port
    test (the entry would be redundant, or the test no longer unported)."""
    jax_tests = _jax_tests()
    same_named = set().union(*_port_tests().values())
    for table in (MIRRORS, NOT_PORTED_TESTS):
        assert not set(table) - set(jax_tests)
        assert not {key for key in table if jax_tests[key] in same_named}
    assert not set(MIRRORS) & set(NOT_PORTED_TESTS)
    assert set(NOT_PORTED_TESTS.values()) <= set(REASONS.values())
