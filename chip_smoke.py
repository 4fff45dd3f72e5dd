#!/usr/bin/env python3
"""Drive paimon_tpu_torch's main path on one CUDA card and check it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--rows N] [--c5-keys N] [--c5-commits N]
                          [--c5-rows-per-commit N]

Phases, each of which raises on failure (no result line is printed
then):

1. the card's name and power limit (nvidia-smi), printed again after the
   last phase;
2. build the CUDA kernels from paimon_tpu_torch/csrc with nvcc, and the
   host merge routes' C library from paimon_tpu_torch/native with the
   host compiler (the run fails if it does not load);
3. the port's device_sorted_winners on cuda against cpu (identical
   perm/winner/prev) for 4M random rows, and its segment reductions
   (sum, product, max, min of int32, int64, float32, float64) on cuda
   against cpu;
4. the main path, four tables, each with the kernels' launch counts
   set to 0 just before it and read just after; each is created,
   written as one commit per batch, read merge-on-read, fully
   compacted and read back, on the card:
   - dedup_bigint: bench.py's table (id BIGINT NOT NULL, v1 BIGINT, v2
     DOUBLE, v3 INT; bucket=1, write-only, deduplicate, parquet), 10
     commits of uniform ids in [0, rows/2) drawn from seed 7 (the
     streamed compaction), held row for row against a numpy
     last-writer-wins oracle;
   - device_decode_dedup: dedup_bigint's directory copied after its
     commits and loaded with read.device-decode=true: merge-on-read
     scan, streamed full compaction and read back, each held against
     the same oracle, every file through the device decode plane (no
     fallback), with the seconds of its four steps (DecodeTimer);
   - agg_sum_max_orc: BASELINE config 4 on the same batches
     (aggregation, v1 sum, v2 and v3 max; ORC runs at level 0 through
     file.format.per.level=0:orc, parquet after compaction), held row
     for row against numpy's per-id sum and max; its scan and
     compaction must launch the offset-value-code variant;
   - string_key_coverage: a small table keyed by strings, 1 in 64
     longer than the 16-byte key prefix, so full-order merges of
     truncated keys run the code variant too (a coverage check: its
     rates are not metrics);
   - partial_update_coverage: config 3's shape cut to 256K keys x 5
     commits of 64 columns (a sequence group of 8, a DOUBLE sum, an INT
     count, 1 row in 100 a DELETE), held against the same table run by
     the port on the CPU (exact; the float sum within rtol 1e-12), its
     float sum bit-identical across two scans on the card;
   - changelog_lookup_upsert: BASELINE config 5 (changelog-producer=
     lookup): a 10M-key bucket written and fully compacted, a consumer
     on latest-full with a consumer id, 20 streaming commits of 1M
     upserts (90% updates of live ids) with inline compaction, the
     consumer polling after each; every poll's changelog held against
     a numpy oracle of the state transitions, the folded stream against
     the batch read, a restored consumer finding nothing new; it
     reports sustained upsert rows/s, changelog latency, the stream
     read's rows/s and where the producer's time goes (ChangelogTimer);
   - changelog_producers_coverage: input, lookup and full-compaction at
     256K keys x 5 commits with deletes, each held file for file
     against the same table run by the port on the CPU;
   - device_decode_coverage: 4M rows of INT32, INT64, FLOAT, DOUBLE and
     DATE columns (dictionary pages, 1 value in 8 null, several row
     groups and pages a chunk) read on the card equal to pyarrow, a
     string-keyed table that falls back once and reads the same, and
     fused_decode_merge at 2^24 on the card equal to its CPU run;
   - mesh_compaction: parallel/dryrun.run_engines' tables (id BIGINT
     NOT NULL key, v DOUBLE, 8 buckets, write-only; deduplicate and
     aggregation with v sum; commits of 2.5M ids uniform in [0, 5M)
     from seed 6 until >= 5M rows enter the compaction) compacted by
     compact_table_mesh on 8 lanes of the card, one batched merge a
     window step; each held against a numpy oracle (exact; sums within
     rtol 1e-12), with no retry, fallback or cleanup error and the
     offset-value-code variant launched over 8 lanes at once; then the
     deduplicate table rescaled to 16 buckets: read back equal, every
     row in its formula's bucket, the schema's bucket option set, no row
     dropped.  It reports windows, packing, the window merges' seconds
     against the host run codes', and the launches by (B, N, L);
   - serving: point lookups and the one-replica query service on the
     card (`serving` says what it drives): serve_dedup_5M, the
     reference serving benchmark's table at 5M rows (cold and warm
     /lookup, 64 keep-alive clients of 90% point gets and 10%
     scan(limit=100), the engine's native and numpy probes, a serving
     writer's read-your-writes through the delta tier, a full
     compaction under 8 readers, an unbounded /scan), and
     serve_agg_5M, the same rows under aggregation, whose every
     lookup merges a bucket on the card (4 cold buckets built at once
     from the server's handler threads).  Every answer is held against
     a numpy oracle; no native probe may fall back; the flush, the
     compaction, /scan and the merged builds must launch the kernel.
     It prints a {"serving": ...} line with the card's name and power
     limit;
   - bucket_modes: primary-key tables as users create them without a
     `bucket` option, bench.py's rows (id BIGINT NOT NULL key, v1
     BIGINT, v2 DOUBLE, v3 INT), each read held against a numpy oracle:
     dyn_dedup_20M (dynamic buckets at dynamic-bucket.target-row-num's
     default of 2M: 10 commits of 2M uniform ids in [0, 16M) from one
     writer, a merge-on-read scan, a full compaction and a scan; the
     hash index against the rows: each id in one bucket, every bucket
     but the last at 2M hashes, the files' total the distinct 32-bit
     hashes; a fresh table object's 1M upserts of existing ids landing
     in their old buckets; then ADD COLUMN v4 DOUBLE, v3 INT -> BIGINT,
     RENAME v2 -> v2r and 2 commits of 2M upserts, a merge-on-read scan
     over runs of both schemas, a full compaction and a scan),
     xpart_upsert_8M (cross-partition upsert, partition dt INT of 4
     values: 8M keys in 4 commits, then a fresh table object's 4
     commits of 1M upserts, a quarter moving partition and some twice
     in one batch, so the global index bootstraps; each id once, in the
     partition of its last write, before and after a full compaction)
     and postpone_8M (bucket=-2: 8M rows in 4 commits that a scan does
     not see, then rescale_postpone at the postpone defaults and a
     scan).  It logs the dynamic assigner's and the index bootstrap's
     host seconds and each table's seconds, and prints a
     {"bucket_modes": ...} line;
   Each phase reports rows/s, launches, the merge routes it took
   (ops/merge.PATH_COUNTS), peak device memory and the seconds spent in
   segment reductions (the port's reduction entry point timed between
   two synchronisations); a write, scan or compaction of a 100M-row
   table that took host merge routes only fails the run;
5. each kernel held against its plain PyTorch version on the card
   (exact equality) at every shape the main path gave it, on the inputs
   it gave there, and at further sizes of synthetic keys (among them 10
   clustered coded runs, where the codes decide almost every pair).  At
   each such shape it reports the kernel's device time per launch (the
   profiler's kernel durations), the wrapper's host time per call (host
   clock over 1000 calls), the time of back-to-back calls between two
   CUDA events and the plain version's, beside the
   least time the bytes these inputs need take at the card's memory
   rate and the earlier design's time for the same shape; and the
   wrapper's host cost at n = 1024 split into allocation, the C entry
   point and the launch;
6. both variants held exactly against the plain version at edge sizes
   (n from 1 to 2^21 + 4 around every boundary of the rows a thread,
   a warp and a block take, L in 1, 2, 5, 8), and with inputs that are
   not 16-byte aligned; then the lane stride (B lanes of N rows in one
   launch: B in 1, 3, 8, N in 1024, 2^20, L in 1, 2, 5, random lanes
   and full lanes of one key whose perms and codes run on across every
   boundary), exact and equal to B separate 1-D calls;
7. the changelog diff's key ranks on the card held exactly against
   np.unique on the host (the reference's computation), both timed;
8. merge_routes: every route of device_sorted_winners (device full with
   and without run codes, device packed, bitmask, host native fast,
   host numpy fast, host general up to 2^22, host OVC) at the main
   path's merge shapes (2 lanes, packed BIGINT keys, 10 sorted runs) at
   2^14, 2^20 and 2^22, held equal under each route's contract and
   timed; the link rates at 8 MiB (the cost model's) and 256 MiB; the
   cost model's rates measured on this machine; the model's pick at
   each shape at a winner fraction of 1.0 and at dedup_bigint's.

The last lines of standard output are one JSON object per line: the
config-5 metrics, the device decode results, the mesh compaction, the
serving phase, the merge routes, the bucket modes, the
phases, the kernels with their launches on the main path and their
times (`device_ms` and `host_us` beside `ms`), then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# the earlier design's (one row a thread) kernel time at each shape it
# was timed at, as PERF.md's Findings record it (CUDA events around
# back-to-back wrapper calls), by (variant, lanes, n); "synthetic" marks
# synthetic inputs
EARLIER_MS = {("plain", 2, 1 << 27): 0.9565, ("plain", 2, 1 << 24): 0.1223,
          ("plain", 2, 1 << 22): 0.0338, ("plain", 2, 1 << 21): 0.0307,
          ("plain", 2, 1 << 20): 0.0297, ("ovc", 5, 1 << 18): 0.0290,
          ("ovc", 5, 1 << 15): 0.0244,
          ("plain", 2, 1 << 26, "synthetic"): 0.4828,
          ("plain", 2, (1 << 20) + 37, "synthetic"): 0.0405,
          ("ovc", 2, 1 << 24, "synthetic"): 0.1637}
KERNEL_NAME = "eq_next_kernel"     # the CUDA kernel's symbol


def cuda_ms(fn, iters: int) -> float:
    """Mean time of fn() over `iters` back-to-back calls between two CUDA
    events: the device time where the device is the slower side, the
    host's issue rate where the host is."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns, iters: int = 20) -> list:
    """Each kernel's own device time per launch (ms), from the profiler's
    durations of the kernels named KERNEL_NAME in one session where each
    fn runs `iters` times in turn.  Run after every host-clock timing: a
    profiler session leaves later launches slower on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.elapsed_us())
                   for e in prof.events()
                   if KERNEL_NAME in e.name
                   and e.device_type == torch.autograd.DeviceType.CUDA)
    if len(spans) != iters * len(fns):
        raise AssertionError(f"profiler recorded {len(spans)} launches of "
                             f"{KERNEL_NAME}, expected {iters * len(fns)}")
    return [sum(us for _, us in spans[k * iters:(k + 1) * iters])
            / iters / 1e3 for k in range(len(fns))]


def host_us(fn, calls: int = 1000) -> float:
    """Host clock per call over `calls` calls, synchronised at the end
    only: the wrapper's host cost where the device keeps up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


class KernelStats:
    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.cases = []

    def record(self, launches: int) -> dict:
        # times at the largest shape the main path gave the kernel; the
        # host cost at its smallest, where the device keeps up
        main = [c for c in self.cases if c["main_path"]]
        if not main:
            raise AssertionError(f"{self.name}: no main-path shape checked")
        top = max(main, key=lambda c: c["n"] * c["lanes"])
        low = min(main, key=lambda c: c["n"] * c["lanes"])
        return {"name": self.name, "route": "cuda",
                "source": "paimon_tpu_torch/csrc/eq_next_mask.cu",
                "replaces": self.replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in self.cases),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "n": top["n"], "lanes": top["lanes"],
                "device_ms": top["device_ms"],
                "host_us": low["host_us"], "host_us_n": low["n"],
                # the mesh's batched launches: b lanes of n / b rows
                "batched": [{k: c[k] for k in (
                    "batch", "n", "lanes", "launches", "ms", "device_ms",
                    "bound_ms", "plain_ms")}
                    for c in main if c["batch"] > 1]}


class LaunchCapture:
    """Records what the main path hands the kernel wrapper.

    For the length of the main-path run it wraps the references to
    kernels.eq_next_mask held by the merge (ops/merge.py) and by the
    changelog diff's key ranks (ops/diff.py): it counts the card's calls
    per (table, variant, lanes, n, caller, batched lanes b) and per
    calling thread's name, and keeps a host copy of the
    first call's inputs at each, so the kernels are checked and timed
    afterwards on exactly those inputs.  The wrapper and its launch
    counters are left as they are; the host time spent copying is kept
    out of the phase times."""

    def __init__(self):
        self.cases: dict = {}
        self.calls: dict = {}
        # (table, variant, thread-name prefix) -> launches: the serving
        # phase's launches come from the query server's handler threads
        self.threads: dict = {}
        self.where = ""
        self.seconds = 0.0
        self._lock = threading.Lock()

    def _shim(self, caller: str):
        kernel = self._kernel

        def shim(lanes, invalid, ovc_off=None, perm=None,
                 num_key_lanes=None, seg_len=None):
            if not lanes.is_cuda:       # the CPU reference run
                return kernel(lanes, invalid, ovc_off, perm, num_key_lanes,
                              seg_len)
            n = lanes.shape[1]
            # batched merges (the mesh's bucket lanes): b lanes of
            # seg_len rows in one launch
            b = n // seg_len if seg_len and n else 1
            key = (self.where.split()[0],
                   "ovc" if ovc_off is not None else "plain",
                   lanes.shape[0], n, caller, b)
            thread = (key[0], key[1],
                      threading.current_thread().name.rsplit("_", 1)[0])
            with self._lock:
                self.calls[key] = self.calls.get(key, 0) + 1
                self.threads[thread] = self.threads.get(thread, 0) + 1
                if key not in self.cases:
                    t0 = time.perf_counter()
                    self.cases[key] = {
                        "where": f"{self.where}, {caller}",
                        "args": tuple(None if t is None else t.cpu()
                                      for t in (lanes, invalid, ovc_off,
                                                perm)),
                        "num_key_lanes": num_key_lanes,
                        "seg_len": seg_len if b > 1 else None}
                    self.seconds += time.perf_counter() - t0
            return kernel(lanes, invalid, ovc_off, perm, num_key_lanes,
                          seg_len)
        return shim

    def __enter__(self):
        from paimon_tpu_torch.ops import diff, kernels, merge
        self._modules = (merge, diff)
        self._kernel = kernels.eq_next_mask
        merge.eq_next_mask = self._shim("merge")
        diff.eq_next_mask = self._shim("diff ranks")
        return self

    def __exit__(self, *exc):
        for module in self._modules:
            module.eq_next_mask = self._kernel


def needed_bytes(lanes, ovc_off, perm, seg_len=None):
    """(bytes, share of lane words) the function must move on these
    inputs: invalid of every row (with codes also ovc_off and perm), one
    byte out per row, and the lane words the compare needs.  A pair's
    lane l is needed only where the code leaves the pair open, the pair
    lies within one batched lane (`seg_len`) and lanes 0..l-1 are equal;
    a row's word is needed if either of its pairs needs it."""
    import torch
    num_lanes, n = lanes.shape
    per_row = 4 + 1 + (8 if ovc_off is not None else 0)
    open_pairs = torch.ones(n - 1, dtype=torch.bool, device=lanes.device)
    if ovc_off is not None:
        open_pairs = ~((perm[1:] == perm[:-1] + 1) & (ovc_off[1:] != -1))
    if seg_len is not None:
        open_pairs[seg_len - 1::seg_len] = False
    words = 0
    for lane in range(num_lanes):
        need = torch.zeros(n, dtype=torch.bool, device=lanes.device)
        need[:-1] |= open_pairs
        need[1:] |= open_pairs
        words += int(need.sum())
        open_pairs &= lanes[lane, :-1] == lanes[lane, 1:]
    return n * per_row + 4 * words, words / (num_lanes * n)


def exact(stats_name: str, label: str, args, num_key_lanes,
          seg_len=None) -> int:
    """Kernel against plain version on the card; raises on any
    difference, else returns the largest difference (0)."""
    import torch

    from paimon_tpu_torch.ops import kernels

    lanes, inv, off, perm = args
    got = kernels.eq_next_mask(lanes, inv, off, perm, num_key_lanes,
                               seg_len)
    want = kernels.eq_next_mask_plain(lanes, inv, off, perm, num_key_lanes,
                                      seg_len)
    torch.cuda.synchronize()
    err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
    if err or got.shape != want.shape:
        raise AssertionError(f"{stats_name} != plain on {label}")
    return err


def check_case(stats: KernelStats, label: str, args, num_key_lanes,
               main_path: bool, earlier_key=None, seg_len=None,
               launches: int = 0) -> dict:
    """Hold the kernel against its plain version on the card (exact
    equality), time the kernel's calls on the host clock and between
    CUDA events, time the plain version, and compute the bound; the
    device time per launch comes later (`report_device_times`), so the
    case keeps its inputs."""
    from paimon_tpu_torch.ops import kernels

    lanes, inv, off, perm = args
    err = exact(stats.name, label, args, num_key_lanes, seg_len)
    num_lanes, n = lanes.shape

    def kernel():
        return kernels.eq_next_mask(lanes, inv, off, perm, num_key_lanes,
                                    seg_len)

    iters = 50 if n >= 1 << 26 else 200
    ms = cuda_ms(kernel, iters)
    h_us = host_us(kernel)
    plain_ms = cuda_ms(lambda: kernels.eq_next_mask_plain(
        lanes, inv, off, perm, num_key_lanes, seg_len), max(5, iters // 10))
    nbytes, lane_share = needed_bytes(lanes, off, perm, seg_len)
    case = {"label": label, "n": n, "lanes": num_lanes,
            "batch": n // seg_len if seg_len else 1, "launches": launches,
            "main_path": main_path, "ms": ms, "host_us": h_us,
            "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "lane_share": lane_share, "max_abs_err": err,
            "earlier_ms": EARLIER_MS.get(earlier_key), "call": kernel}
    stats.cases.append(case)
    return case


def host_breakdown(rng) -> dict:
    """The wrapper's host cost per call at the smallest main-path shape
    (n = 1024, L = 2), split by host_us into the output's allocation,
    the bound C entry point alone (n = 0 returns before the launch), the
    entry point with the launch, and the whole wrapper."""
    import torch

    from paimon_tpu_torch.ops import kernels

    lanes, inv, _, _ = sorted_int_keys(rng, 1024)
    kernels.eq_next_mask(lanes, inv)
    out = torch.empty_like(inv, dtype=torch.bool)
    call = [lanes.data_ptr(), 2, 0, inv.data_ptr(), None, None, 2, 1024,
            out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(lanes.device.index)]
    parts = {"alloc": host_us(lambda: torch.empty_like(inv,
                                                       dtype=torch.bool)),
             "entry": host_us(lambda: kernels._fn(*call))}
    call[2] = 1024
    parts["entry_launch"] = host_us(lambda: kernels._fn(*call))
    parts["wrapper"] = host_us(lambda: kernels.eq_next_mask(lanes, inv))
    rest = parts["wrapper"] - parts["alloc"] - parts["entry_launch"]
    log(f"wrapper host cost at n=1024, L=2: {parts['wrapper']:.2f} us/call "
        f"= allocation {parts['alloc']:.2f} + C entry through ctypes "
        f"{parts['entry']:.2f} + launch "
        f"{parts['entry_launch'] - parts['entry']:.2f} + checks and the "
        f"rest {rest:.2f}")
    return parts


def report_device_times(stats_list) -> None:
    """Device time per launch of every case, in one profiler session;
    then one line per case with all its numbers.  Drops the inputs."""
    import torch

    cases = [(st, c) for st in stats_list for c in st.cases]
    times = device_ms([c.pop("call") for _, c in cases])
    for (st, c), dev_ms in zip(cases, times):
        c["device_ms"] = dev_ms
        earlier = c["earlier_ms"]
        log(f"{st.name} {c['label']} n={c['n']} L={c['lanes']}: exact; "
            f"device {c['device_ms']:.4f} ms = "
            f"{c['bound_ms'] / c['device_ms']:.1%} of bound "
            f"{c['bound_ms']:.4f} ms; host {c['host_us']:.2f} us/call; "
            f"back-to-back {c['ms']:.4f} ms (earlier design: "
            f"{'not timed' if earlier is None else f'{earlier:.4f} ms'}"
            f"); plain {c['plain_ms']:.4f} ms; lane words needed "
            f"{c['lane_share']:.1%}")
    torch.cuda.empty_cache()


def sorted_int_keys(rng, n: int):
    """Sorted 2-lane keys with ~2 rows per key and a padded tail, as a
    merge of one fixed-width key hands them over."""
    import torch
    keys = np.sort(rng.integers(0, n // 2, n, dtype=np.uint64))
    lanes = torch.from_numpy(np.stack([
        (keys >> np.uint64(32)).astype(np.uint32),
        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
        .view(np.int32)).cuda()
    inv = torch.zeros(n, dtype=torch.int32, device="cuda")
    inv[n - n // 8:] = 1
    return lanes, inv, None, None


def coded_runs(rng, n: int, runs: int = 10, clustered: bool = False):
    """2-lane keys of `runs` sorted runs with their offset-value codes,
    then sorted as a merge sorts them.  Uniform keys overlap across runs,
    so sorted neighbours rarely come from one run; clustered runs each
    hold consecutive ids of a range of their own, so the codes decide
    almost every pair."""
    import torch

    from paimon_tpu_torch.ops.ovc import run_ovc_offsets
    per = n // runs
    if clustered:
        parts = [np.arange(k * per, (k + 1) * per, dtype=np.uint64)
                 for k in rng.permutation(runs)]
    else:
        parts = [np.sort(rng.integers(0, n // 2, per, dtype=np.uint64))
                 for _ in range(runs)]
    parts.append(np.zeros(n - per * runs, dtype=np.uint64))
    keys = np.concatenate(parts)
    mat = np.stack([(keys >> np.uint64(32)).astype(np.uint32),
                    (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                   axis=1)
    starts = np.arange(0, per * runs + 1, per, dtype=np.int64)
    off = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    off[:per * runs] = run_ovc_offsets(mat[:per * runs], starts)
    valid = np.arange(n) < per * runs
    order = np.lexsort((np.arange(n), keys, ~valid))
    return (torch.from_numpy(np.ascontiguousarray(mat[order].T)
                             .view(np.int32)).cuda(),
            torch.from_numpy((~valid[order]).astype(np.int32)).cuda(),
            torch.from_numpy(off[order].view(np.int32)).cuda(),
            torch.from_numpy(order.astype(np.int32)).cuda())


def check_kernels(captured: LaunchCapture, k1: KernelStats,
                  k2: KernelStats) -> None:
    """Every shape the main path gave each kernel, on the inputs it gave
    at that shape first; then further sizes of synthetic keys."""
    for key in sorted(captured.cases,
                      key=lambda k: (k[1], k[0], k[3], k[2], k[4], k[5])):
        case = captured.cases.pop(key)
        args = tuple(None if t is None else t.cuda() for t in case["args"])
        check_case(k2 if key[1] == "ovc" else k1,
                   f"main path ({case['where']}, {captured.calls[key]} "
                   f"launches at this shape)", args,
                   case["num_key_lanes"], main_path=True,
                   earlier_key=key[1:4], seg_len=case["seg_len"],
                   launches=captured.calls[key])
    host_breakdown(np.random.default_rng(17))
    rng = np.random.default_rng(11)
    for n in (1 << 26, (1 << 20) + 37):
        check_case(k1, "sorted int keys", sorted_int_keys(rng, n), 2,
                   main_path=False, earlier_key=("plain", 2, n, "synthetic"))
    check_case(k2, "10 coded runs of int keys", coded_runs(rng, 1 << 24), 2,
               main_path=False, earlier_key=("ovc", 2, 1 << 24, "synthetic"))
    check_case(k2, "10 clustered coded runs of int keys",
               coded_runs(rng, 1 << 24, clustered=True), 2,
               main_path=False)
    report_device_times([k1, k2])


EDGE_SIZES = (1, 2, 3, 4, 5, 8, 31, 32, 33, 124, 127, 128, 129, 132, 252,
              256, 260, 508, 512, 516, 1020, 1023, 1024, 1025, 1028, 2044,
              2048, 2052, (1 << 20) + 3, (1 << 20) + 4, (1 << 20) + 37,
              (1 << 21) + 4)
EDGE_LANES = (1, 2, 5, 8)


def edge_inputs(rng, n: int, num_lanes: int):
    """Host inputs in sorted order as a merge hands them over: up to four
    sorted runs of keys drawn from {0, 1, 2} per lane (so neighbours are
    often equal), concatenated and sorted by (invalid, lanes), with an
    invalid padded tail; (lanes[L, n], invalid, ovc_off, perm) as int32."""
    from paimon_tpu_torch.ops.ovc import run_ovc_offsets
    real = n - int(rng.integers(0, n // 8 + 1))
    lanes = rng.integers(0, 3, (n, num_lanes)).astype(np.uint32)
    lanes[real:] = 0
    cuts = np.sort(rng.choice(np.arange(1, real), min(3, real - 1),
                              replace=False)) if real > 1 else []
    starts = np.concatenate([[0], cuts, [real]]).astype(np.int64)
    for a, b in zip(starts[:-1], starts[1:]):
        lanes[a:b] = lanes[a:b][np.lexsort(lanes[a:b].T[::-1])]
    invalid = (np.arange(n) >= real).astype(np.uint32)
    off = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    off[:real] = run_ovc_offsets(lanes[:real], starts)
    order = np.lexsort((np.arange(n),) + tuple(lanes.T[::-1]) + (invalid,))
    return (np.ascontiguousarray(lanes[order].T).view(np.int32),
            invalid[order].view(np.int32), off[order].view(np.int32),
            order.astype(np.int32))


def on_card(a, shift: int = 0, device: str = "cuda"):
    """A contiguous copy of int32 `a` on the card, starting `shift` words
    into a buffer."""
    import torch
    buf = torch.empty(a.size + shift, dtype=torch.int32, device=device)
    t = buf[shift:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


def check_edges() -> int:
    """Both variants exact at every edge size and lane count, and with
    inputs that start 4 bytes past a 16-byte boundary; returns the
    number of cases checked."""
    rng = np.random.default_rng(13)
    cases = 0
    for n in EDGE_SIZES:
        for num_lanes in EDGE_LANES:
            host = edge_inputs(rng, n, num_lanes)
            shifts = (0, 1) if n in (1024, 2048, (1 << 20) + 4) else (0,)
            for shift in shifts:
                lanes, inv, off, perm = (on_card(a, shift) for a in host)
                where = f"edge n={n} L={num_lanes} shift={shift}"
                exact("eq_next_mask", where, (lanes, inv, None, None),
                      num_lanes)
                exact("eq_next_mask_ovc", where, (lanes, inv, off, perm),
                      num_lanes)
                cases += 2
    return cases


SEG_BATCHES = (1, 3, 8)
SEG_ROWS = (1024, 1 << 20)
SEG_LANES = (1, 2, 5)


def seg_inputs(rng, b: int, n: int, num_lanes: int, kind: str):
    """b batched lanes of n rows each, end to end, as (lanes[L, b*n],
    invalid, ovc_off, perm) int32 host arrays.  "random": each lane
    edge_inputs' sorted runs with their own perm and codes; "equal":
    full lanes of one key (0), perms counting on across every lane
    boundary and codes claiming equality everywhere, so only the lane
    stride may cut a pair there."""
    if kind == "random":
        parts = [edge_inputs(rng, n, num_lanes) for _ in range(b)]
        return (np.ascontiguousarray(np.concatenate([p[0] for p in parts],
                                                    axis=1)),
                *(np.concatenate([p[k] for p in parts]) for k in (1, 2, 3)))
    return (np.zeros((num_lanes, b * n), dtype=np.int32),
            np.zeros(b * n, dtype=np.int32),
            np.full(b * n, num_lanes, dtype=np.int32),
            np.arange(b * n, dtype=np.int32))


def check_seg_edges(device: str = "cuda") -> int:
    """The lane stride (seg_len) of both variants: for each batch B,
    lane rows N and key lanes L, the kernel exact against the plain
    version with the stride, and the plain version with the stride
    equal to B separate 1-D calls (jax.vmap's semantics); returns the
    number of cases checked."""
    import torch

    from paimon_tpu_torch.ops import kernels

    rng = np.random.default_rng(29)
    cases = 0
    for b in SEG_BATCHES:
        for n in SEG_ROWS:
            for num_lanes in SEG_LANES:
                for kind in ("random", "equal"):
                    lanes, inv, off, perm = (on_card(a, device=device)
                                             for a in seg_inputs(
                                                 rng, b, n, num_lanes, kind))
                    where = f"seg_len={n} B={b} L={num_lanes} {kind}"
                    for name, args in (("eq_next_mask",
                                        (lanes, inv, None, None)),
                                       ("eq_next_mask_ovc",
                                        (lanes, inv, off, perm))):
                        if device == "cuda":
                            exact(name, where, args, num_lanes, n)
                        la, iv, of, pm = args
                        whole = kernels.eq_next_mask_plain(
                            la, iv, of, pm, num_lanes, n)
                        apart = torch.cat([kernels.eq_next_mask_plain(
                            la[:, k * n:(k + 1) * n], iv[k * n:(k + 1) * n],
                            None if of is None else of[k * n:(k + 1) * n],
                            None if pm is None else pm[k * n:(k + 1) * n],
                            num_lanes) for k in range(b)])
                        if not torch.equal(whole, apart):
                            raise AssertionError(f"{name} {where}: the "
                                                 f"stride differs from B "
                                                 f"1-D calls")
                        cases += 1
    return cases


def check_sorted_winners() -> None:
    from paimon_tpu_torch.ops.merge import device_sorted_winners

    rng = np.random.default_rng(5)
    n = 4 << 20
    lanes = rng.integers(0, 1 << 21, (n, 2), dtype=np.uint64) \
        .astype(np.uint32)
    seq = rng.permutation(n).astype(np.int64)
    runs = 10
    starts = np.linspace(0, n, runs + 1).astype(np.int64)
    sorted_runs = np.concatenate([
        lanes[a:b][np.lexsort(lanes[a:b].T[::-1])]
        for a, b in zip(starts[:-1], starts[1:])])
    cases = [("keep=last", dict(lanes=lanes, keep="last")),
             ("keep=first", dict(lanes=lanes, keep="first")),
             ("keep=last winners-only", dict(lanes=lanes, keep="last",
                                             winners_only=True)),
             ("ovc full order", dict(lanes=sorted_runs, keep="last",
                                     run_starts=starts))]
    for name, kw in cases:
        lanes_arg = kw.pop("lanes")
        t0 = time.perf_counter()
        on_card = device_sorted_winners(lanes_arg, seq, device="cuda", **kw)
        t1 = time.perf_counter()
        on_cpu = device_sorted_winners(lanes_arg, seq, device="cpu", **kw)
        t2 = time.perf_counter()
        for what, a, b in zip(("perm", "winner", "prev"), on_card, on_cpu):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"device_sorted_winners {name}: {what} "
                                     f"differs between cuda and cpu")
        log(f"device_sorted_winners n={n} {name}: cuda == cpu "
            f"(cuda {t1 - t0:.3f} s, cpu {t2 - t1:.3f} s host clock)")


def check_segment_reductions(device: str = "cuda") -> None:
    """The port's segment reductions on `device` against the same calls
    on the CPU, 4M rows in segments of 1 to 8: integers and float
    max/min exact (NaN, infinities and -0.0 among the floats; a NaN's
    payload may differ), float sum and product within rtol 1e-12
    (float64) and 1e-5 (float32); says whether the float folds were
    bit-identical too."""
    from paimon_tpu_torch.ops.agg import Segments, segment_reduce

    rng = np.random.default_rng(19)
    n = 1 << 22
    seg = np.repeat(np.arange(n), rng.integers(1, 9, n))[:n]
    num = int(seg[-1]) + 1
    card, cpu = Segments(seg, num, device), Segments(seg, num, "cpu")
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0])
    for dtype in (np.int32, np.int64, np.float32, np.float64):
        if np.issubdtype(dtype, np.floating):
            vals = rng.standard_normal(n).astype(dtype)
            pick = rng.random(n) < 0.01
            vals[pick] = specials[rng.integers(0, 5, pick.sum())]
        else:
            vals = rng.integers(-1000, 1000, n).astype(dtype)
        bits = []
        for op in ("sum", "prod", "max", "min"):
            got = segment_reduce(vals, op, card)
            want = segment_reduce(vals, op, cpu)
            # bit for bit, but for the payload of a NaN
            itype = np.uint64 if got.itemsize == 8 else np.uint32
            nan = np.isnan(got) & np.isnan(want) \
                if np.issubdtype(dtype, np.floating) else False
            same = bool(((got.view(itype) == want.view(itype)) | nan).all())
            if not same:
                if op in ("max", "min") or \
                        not np.issubdtype(dtype, np.floating):
                    raise AssertionError(f"segment {op} of {dtype.__name__}:"
                                         f" card != cpu")
                rtol = 1e-12 if dtype == np.float64 else 1e-5
                if not np.allclose(got, want, rtol=rtol, atol=0.0,
                                   equal_nan=True):
                    raise AssertionError(f"segment {op} of {dtype.__name__}:"
                                         f" card beyond rtol {rtol} of cpu")
            bits.append(f"{op} {'bit-identical' if same else 'within rtol'}")
        log(f"segment reductions of {dtype.__name__}, {n} rows in {num} "
            f"segments: {device} against cpu: {', '.join(bits)}")


def last_writer_oracle(ids: np.ndarray, order=None) -> np.ndarray:
    """Global row index of the last write of each id, in id order
    (`order`: a stable argsort of `ids`, when already at hand)."""
    if order is None:
        order = np.argsort(ids, kind="stable")
    s = ids[order]
    last = np.flatnonzero(np.r_[s[1:] != s[:-1], True])
    return order[last]


def check_rows(what: str, got, cols: dict, win: np.ndarray,
               key: str) -> None:
    import pyarrow as pa
    import pyarrow.compute as pc
    if got.num_rows != len(win):
        raise AssertionError(f"{what}: {got.num_rows} rows, oracle "
                             f"{len(win)}")
    got = got.take(pc.sort_indices(got, sort_keys=[(key, "ascending")]))
    for name, full in cols.items():
        col = got.column(name).combine_chunks()
        want = full.take(pa.array(win)) if isinstance(full, pa.Array) \
            else full[win]
        if isinstance(full, pa.Array):
            same = col.equals(want)
        else:
            same = np.array_equal(col.to_numpy(zero_copy_only=False), want)
        if not same:
            raise AssertionError(f"{what}: column {name} differs from the "
                                 f"oracle")


def agg_oracle(cols: dict, order: np.ndarray) -> dict:
    """Config 4's aggregation by numpy alone: per id (in id order) the
    sum of v1, the max of v2 and the max of v3, by reduceat over the
    id-sorted rows."""
    ids = cols["id"][order]
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    return {"id": ids[starts],
            "v1": np.add.reduceat(cols["v1"][order], starts),
            "v2": np.maximum.reduceat(cols["v2"][order], starts),
            "v3": np.maximum.reduceat(cols["v3"][order], starts)}


def check_agg(what: str, got, want: dict) -> None:
    """Row for row, every column exactly equal to the oracle's."""
    import pyarrow.compute as pc
    if got.num_rows != len(want["id"]):
        raise AssertionError(f"{what}: {got.num_rows} rows, oracle "
                             f"{len(want['id'])}")
    got = got.take(pc.sort_indices(got, sort_keys=[("id", "ascending")]))
    for name, col in want.items():
        have = got.column(name).combine_chunks()
        if have.null_count or not np.array_equal(have.to_numpy(), col):
            raise AssertionError(f"{what}: column {name} differs from the "
                                 f"oracle")


class ReduceTimer:
    """Seconds the aggregation engines spend in segment reductions.

    For as long as it is entered it wraps the port's reduction entry
    point (ops.agg.segment_reduce) and the upload of each merge's
    segment ids (ops.agg.Segments), synchronising the card before and
    after each call, and sums their host-clock time; the two merge
    threads of a streamed compaction may overlap, so the sum can exceed
    the time they cover."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._lock = threading.Lock()

    def _timed(self, fn):
        import torch

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            with self._lock:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
            return out
        return call

    def __enter__(self):
        from paimon_tpu_torch.ops import agg
        self._agg = agg
        self._reduce = agg.segment_reduce
        self._init = agg.Segments.__init__
        agg.segment_reduce = self._timed(self._reduce)
        agg.Segments.__init__ = self._timed(self._init)
        return self

    def __exit__(self, *exc):
        self._agg.segment_reduce = self._reduce
        self._agg.Segments.__init__ = self._init


class Recorder:
    """Runs the phases of the main path: each timed on the host clock
    between two synchronisations of the card, with its kernel launches,
    segment-reduction seconds and peak device memory, appended to
    `phases` and logged."""

    def __init__(self, counts, phases: list, capture: LaunchCapture,
                 reducer: ReduceTimer):
        self.counts = counts
        self.phases = phases
        self.capture = capture
        self.reducer = reducer

    def run(self, name: str, what: str, rows, device, fn):
        """`rows`: the phase's row count, or a callable that gives it
        after the phase."""
        import torch

        on_card = device.type == "cuda"
        capture, reducer = self.capture, self.reducer
        from paimon_tpu_torch.ops import merge
        capture.where = f"{name} {what}"
        before = self.counts()
        routes = dict(merge.PATH_COUNTS)
        copied = capture.seconds
        reduced, reduce_calls = reducer.seconds, reducer.calls
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0 - (capture.seconds - copied)
        launches = tuple(a - b for a, b in zip(self.counts(), before))
        if callable(rows):
            rows = rows()
        self.add(name, what, rows, device, dt, launches,
                 reducer.seconds - reduced, reducer.calls - reduce_calls,
                 routes={k: v - routes[k]
                         for k, v in merge.PATH_COUNTS.items()})
        return out

    def add(self, name: str, what: str, rows: int, device, seconds: float,
            launches, seg_reduce_s: float = 0.0, seg_reduce_calls: int = 0,
            **extra) -> dict:
        """Record one phase measured by the caller (peak device memory
        since the last reset of the card's peak)."""
        import torch

        rec = {"table": name, "phase": what, "device": device.type,
               "rows": rows, "s": seconds, "rows_per_s": rows / seconds,
               "launches_plain": launches[0], "launches_ovc": launches[1],
               "seg_reduce_s": seg_reduce_s,
               "seg_reduce_calls": seg_reduce_calls,
               "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if device.type == "cuda" else None), **extra}
        self.phases.append(rec)
        peak = "n/a" if rec["peak_gib"] is None \
            else f"{rec['peak_gib']:.2f} GiB"
        log(f"  {name} {what} ({device.type}): {rows} rows in "
            f"{seconds:.2f} s = {rows / seconds:,.0f} rows/s; launches "
            f"plain={launches[0]} ovc={launches[1]}; segment reductions "
            f"{seg_reduce_s:.3f} s in {seg_reduce_calls} calls; peak "
            f"device memory {peak}"
            + (f"; merge routes {extra['routes']}" if "routes" in extra
               else ""))
        return rec


def drive_table(path, schema, batches, check, rec: Recorder,
                row_kinds=None, device=None,
                repeat_scan: bool = False, after_write=None) -> dict:
    """create -> write one commit per batch -> merge-on-read scan (twice
    with `repeat_scan`) -> compact(full=True) -> read back, on `device`
    (None: the card); hands every read to `check(what, table)` and
    records each phase through `rec`; calls `after_write()` between the
    write and the scan.  Returns the reads by phase."""
    from paimon_tpu_torch.table import FileStoreTable

    rows = sum(b.num_rows for b in batches)
    name = os.path.basename(path)
    table = FileStoreTable.create(path, schema, device=device)

    def phase(what, fn):
        return rec.run(name, what, rows, table.device, fn)

    def write():
        for k, b in enumerate(batches):
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b, None if row_kinds is None else row_kinds[k])
                wb.new_commit().commit(w.prepare_commit())

    phase("write", write)
    if after_write is not None:
        after_write()
    reads = {}
    for what in ("scan", "scan again") if repeat_scan else ("scan",):
        reads[what] = phase(what, table.to_arrow)
        check(f"{name} merge-on-read {what}", reads[what])
    if phase("compact", lambda: table.compact(full=True)) is None:
        raise AssertionError("full compaction committed nothing")
    reads["read"] = phase("read", table.to_arrow)
    check(f"{name} read after compaction", reads["read"])
    return reads


def bigint_batches(rows: int, runs: int = 10, seed: int = 7):
    """bench.py's build_table batches: `runs` commits of uniform ids in
    [0, rows/2), v1 BIGINT, v2 DOUBLE, v3 INT, from `seed`."""
    import pyarrow as pa
    per_run = rows // runs
    rng = np.random.default_rng(seed)
    return [pa.table({
        "id": pa.array(rng.integers(0, rows // 2, per_run), pa.int64()),
        "v1": pa.array(rng.integers(0, 1 << 40, per_run), pa.int64()),
        "v2": pa.array(rng.random(per_run), pa.float64()),
        "v3": pa.array(rng.integers(0, 100, per_run).astype(np.int32),
                       pa.int32())}) for _ in range(runs)]


def string_key_batches(rows: int = 1 << 18, runs: int = 10, seed: int = 7):
    """Kernel coverage: string keys, 1 in 64 ids longer than the 16-byte
    key prefix, so merges take the full-order path with run codes."""
    import pyarrow as pa
    per = rows // runs
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(runs):
        ids = rng.integers(0, rows // 2, per)
        names = [f"user-{i:09d}" + ("-profile-archive" if i % 64 == 0
                                    else "") for i in ids.tolist()]
        out.append(pa.table({
            "name": pa.array(names, pa.string()),
            "v1": pa.array(rng.integers(0, 1 << 40, per), pa.int64())}))
    return out


PU_MEMBERS = [f"m{i}" for i in range(8)]
PU_PLAIN = [f"c{i}" for i in range(52)]
PU_TYPES = ("BIGINT", "DOUBLE", "INT", "STRING")


COVERAGE_KEYS = 1 << 16          # keys of the partial-update and
                                 # changelog-producer coverage tables


def partial_update_table(keys: int = COVERAGE_KEYS, commits: int = 5,
                         seed: int = 7):
    """Config 3's shape cut to a coverage check: a partial-update table
    of 64 columns (id; sequence field g with its group of 8 members; a
    DOUBLE sum column and an INT count column; 52 plain columns), one
    commit per pass over all `keys` keys in a random order.  Every
    commit writes the key, g and its members, the sum and count
    columns, and 14 plain columns of its own (a window that moves 14
    columns a commit), nulls elsewhere; 1 row in 100 is a DELETE.
    Returns (schema, batches, row kinds per batch)."""
    import pyarrow as pa

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import parse_type_string
    from paimon_tpu_torch.types import RowKind

    rng = np.random.default_rng(seed)
    plain_types = {c: PU_TYPES[i % 4] for i, c in enumerate(PU_PLAIN)}
    builder = Schema.builder().column("id", parse_type_string(
        "BIGINT NOT NULL")).column("g", parse_type_string("BIGINT"))
    for c in PU_MEMBERS:
        builder = builder.column(c, parse_type_string("INT"))
    builder = builder.column("fsum", parse_type_string("DOUBLE")) \
        .column("cnt", parse_type_string("INT"))
    for c in PU_PLAIN:
        builder = builder.column(c, parse_type_string(plain_types[c]))
    schema = builder.primary_key("id").options({
        "bucket": "1", "write-only": "true",
        "parquet.enable.dictionary": "false",
        "merge-engine": "partial-update",
        "fields.g.sequence-group": ",".join(PU_MEMBERS),
        "fields.fsum.aggregate-function": "sum",
        "fields.cnt.aggregate-function": "count"}).build()
    arrow = {"BIGINT": pa.int64(), "DOUBLE": pa.float64(),
             "INT": pa.int32(), "STRING": pa.string()}

    def values(t, n):
        if t == "STRING":
            return pa.array([f"s{v}" for v in rng.integers(0, 1000, n)])
        if t == "DOUBLE":
            return pa.array(rng.standard_normal(n))
        return pa.array(rng.integers(-1000, 1000, n), arrow[t])

    batches, kinds = [], []
    for j in range(commits):
        ids = rng.permutation(keys)
        own = {PU_PLAIN[(14 * j + i) % 52] for i in range(14)}
        cols = {"id": pa.array(ids, pa.int64()),
                "g": pa.array(rng.integers(0, 1000, keys), pa.int64())}
        for c in PU_MEMBERS:
            cols[c] = values("INT", keys)
        cols["fsum"] = values("DOUBLE", keys)
        cols["cnt"] = values("INT", keys)
        for c in PU_PLAIN:
            cols[c] = values(plain_types[c], keys) if c in own \
                else pa.nulls(keys, arrow[plain_types[c]])
        batches.append(pa.table(cols))
        kinds.append(np.where(rng.random(keys) < 0.01, RowKind.DELETE,
                              RowKind.INSERT).astype(np.int8))
    return schema, batches, kinds


def same_tables(what: str, got, want, approx=(), rtol: float = 0.0) -> None:
    """Exactly equal tables, except the `approx` float columns, equal
    within `rtol` with the same nulls."""
    if got.column_names != want.column_names or \
            got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: shape or columns differ")
    for name in want.column_names:
        g = got.column(name).combine_chunks()
        w = want.column(name).combine_chunks()
        if name not in approx:
            if not g.equals(w):
                raise AssertionError(f"{what}: column {name} differs")
            continue
        gv = g.to_numpy(zero_copy_only=False)
        wv = w.to_numpy(zero_copy_only=False)
        if not (np.array_equal(np.isnan(gv), np.isnan(wv))
                and np.allclose(gv, wv, rtol=rtol, atol=0.0,
                                equal_nan=True)):
            raise AssertionError(f"{what}: column {name} beyond rtol {rtol}")


# BASELINE config 5 (changelog-producer=lookup): the bucket's state, its
# streaming commits and the share of commits that update a live id
C5_KEYS = 10_000_000
C5_COMMITS = 20
C5_PER_COMMIT = 1_000_000        # one 5 s checkpoint at 200k rows/s
C5_UPDATE_SHARE = 0.9
C5_VALUE_COLS = ("v1", "v2", "v3")


def rss_gib() -> float:
    """The host's resident set of this process, GiB (/proc)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


class ChangelogTimer:
    """Where the compaction changelog producers spend their time.

    For as long as it is entered it wraps, from this script, the
    manager's producer (MergeTreeCompactManager._produce_changelog), the
    merges made while a producer runs (_merge_tables: the lookup
    replay's state merges), the diff as the manager calls it
    (keyed_changelog_diff) and the diff's two key-rank parts in
    ops/diff.py: _encode_lanes (host lane encode) and _device_ranks
    (upload, sort, the kernel, running count), each between two
    synchronisations of the card.  The diff's Arrow take, value compare
    and concatenation are its time less those two.  At the end of each
    producer run, while the compaction's file memo is still held, it
    samples the host's resident set."""

    FIELDS = ("producer", "state_merge", "diff", "encode", "ranks")

    def __init__(self):
        self.s = {f: 0.0 for f in self.FIELDS}
        self.calls = {f: 0 for f in self.FIELDS}
        self.rss_max_gib = 0.0
        self._in_producer = False

    def snapshot(self) -> dict:
        out = {f"{f}_s": v for f, v in self.s.items()}
        out.update({f"{f}_calls": v for f, v in self.calls.items()})
        return out

    def delta(self, before: dict) -> dict:
        now = self.snapshot()
        out = {k: now[k] - before[k] for k in now}
        out["arrow_s"] = out["diff_s"] - out["encode_s"] - out["ranks_s"]
        return out

    def _timed(self, field: str, fn, only_in_producer: bool = False):
        import torch

        def call(*args, **kwargs):
            if only_in_producer and not self._in_producer:
                return fn(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if field == "producer":
                self._in_producer = True
            try:
                out = fn(*args, **kwargs)
            finally:
                if field == "producer":
                    self._in_producer = False
                    self.rss_max_gib = max(self.rss_max_gib, rss_gib())
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.s[field] += time.perf_counter() - t0
            self.calls[field] += 1
            return out
        return call

    def __enter__(self):
        from paimon_tpu_torch.compact import manager
        from paimon_tpu_torch.ops import diff
        mgr = manager.MergeTreeCompactManager
        self._saved = []
        for owner, attr, field, only in (
                (manager, "keyed_changelog_diff", "diff", False),
                (diff, "_encode_lanes", "encode", False),
                (diff, "_device_ranks", "ranks", False),
                (mgr, "_produce_changelog", "producer", False),
                (mgr, "_merge_tables", "state_merge", True)):
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._timed(field, fn, only))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)


def bigint_schema(options):
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import BigIntType, DoubleType, IntType
    return (Schema.builder().column("id", BigIntType(False))
            .column("v1", BigIntType()).column("v2", DoubleType())
            .column("v3", IntType()).primary_key("id")
            .options(options).build())


def random_values(rng, n: int) -> dict:
    """bench.py's value columns: v1 BIGINT, v2 DOUBLE, v3 INT."""
    return {"v1": rng.integers(0, 1 << 40, n),
            "v2": rng.random(n),
            "v3": rng.integers(0, 100, n).astype(np.int32)}


def value_table(ids: np.ndarray, vals: dict):
    import pyarrow as pa
    return pa.table({"id": pa.array(ids, pa.int64()),
                     "v1": pa.array(vals["v1"], pa.int64()),
                     "v2": pa.array(vals["v2"], pa.float64()),
                     "v3": pa.array(vals["v3"], pa.int32())})


class DenseState:
    """The visible rows of a table whose ids are dense non-negative
    integers, held in numpy: the oracle of the changelog and the fold of
    a consumer's stream."""

    def __init__(self, capacity: int):
        self.live = np.zeros(capacity, dtype=bool)
        self.cols = {"v1": np.zeros(capacity, np.int64),
                     "v2": np.zeros(capacity, np.float64),
                     "v3": np.zeros(capacity, np.int32)}

    def transitions(self, ids: np.ndarray, vals: dict) -> dict:
        """Apply one commit of upserts (the last value of an id in the
        commit wins) and return the changelog it implies: +I for an id
        that was not live, -U with the old row then +U with the new one
        for a changed value, nothing for an unchanged one."""
        order = np.argsort(ids, kind="stable")
        s = ids[order]
        last = order[np.r_[s[1:] != s[:-1], True]]
        u = ids[last]
        new = {c: v[last] for c, v in vals.items()}
        was = self.live[u]
        changed = was & np.any([self.cols[c][u] != new[c]
                                for c in C5_VALUE_COLS], axis=0)
        ins, upd = ~was, u[changed]
        out = {"id": np.concatenate([u[ins], upd, upd]),
               "kind": np.concatenate([
                   np.full(int(ins.sum()), 0, np.int8),
                   np.full(len(upd), 1, np.int8),
                   np.full(len(upd), 2, np.int8)])}
        for c in C5_VALUE_COLS:
            out[c] = np.concatenate([new[c][ins], self.cols[c][upd],
                                     new[c][changed]])
        self.live[u] = True
        for c in C5_VALUE_COLS:
            self.cols[c][u] = new[c]
        return out

    def fold(self, rows: dict) -> None:
        """Apply changelog rows in their order: an id's last row decides
        (+I/+U sets the row, -U/-D removes it)."""
        ids = rows["id"]
        _, first_rev = np.unique(ids[::-1], return_index=True)
        last = len(ids) - 1 - first_rev
        u, kinds = ids[last], rows["kind"][last]
        keep = (kinds == 0) | (kinds == 2)
        self.live[u[~keep]] = False
        self.live[u[keep]] = True
        for c in C5_VALUE_COLS:
            self.cols[c][u[keep]] = rows[c][last][keep]

    def rows(self) -> dict:
        ids = np.flatnonzero(self.live)
        return {"id": ids, **{c: v[ids] for c, v in self.cols.items()}}


def arrow_rows(t) -> dict:
    """Column arrays of a stream read: id, the values, kind, sequence."""
    from paimon_tpu_torch.core.read import ROW_KIND_COL
    from paimon_tpu_torch.ops.merge import SEQ_COL
    out = {c: t.column(c).combine_chunks().to_numpy()
           for c in ("id",) + C5_VALUE_COLS}
    out["kind"] = t.column(ROW_KIND_COL).combine_chunks().to_numpy()
    out["seq"] = t.column(SEQ_COL).combine_chunks().to_numpy()
    return out


def same_multiset(what: str, got: dict, want: dict) -> None:
    """Equal rows (kind, id, values) counted with multiplicity."""
    cols = ("kind", "id") + C5_VALUE_COLS
    if len(got["id"]) != len(want["id"]):
        raise AssertionError(f"{what}: {len(got['id'])} changelog rows, "
                             f"oracle {len(want['id'])}")
    og = np.lexsort([got[c] for c in reversed(cols)])
    ow = np.lexsort([want[c] for c in reversed(cols)])
    for c in cols:
        if not np.array_equal(got[c][og], want[c][ow]):
            raise AssertionError(f"{what}: column {c} differs from the "
                                 f"oracle")


def check_adjacent_updates(what: str, rows: dict) -> None:
    """Every -U directly followed by the +U of the same id, and no +U
    without its -U."""
    kinds, ids = rows["kind"], rows["id"]
    ub = np.flatnonzero(kinds == 1)
    nxt = ub + 1
    if (nxt >= len(kinds)).any() or not (kinds[nxt] == 2).all() or \
            not (ids[nxt] == ids[ub]).all() or \
            int((kinds == 2).sum()) != len(ub):
        raise AssertionError(f"{what}: a -U is not directly followed by "
                             f"its +U")


def latency_stats(seconds: list, commits: list) -> dict:
    """p50 and max of the changelog latencies, in seconds and in commits
    (None where no commit's changelog arrived within the loop)."""
    out = {}
    for unit, values in (("s", seconds), ("commits", commits)):
        out[f"latency_{unit}_p50"] = \
            float(np.percentile(values, 50)) if values else None
        out[f"latency_{unit}_max"] = max(values) if values else None
    return out


def changelog_lookup_upsert(work: str, rec: Recorder, timer: ChangelogTimer,
                            keys: int = C5_KEYS, commits: int = C5_COMMITS,
                            per_commit: int = C5_PER_COMMIT,
                            device=None) -> dict:
    """BASELINE config 5 at full size: a `keys`-row bucket (ids 0 ..
    keys-1) written as one commit and fully compacted (the first
    changelog: every row +I), a consumer on the default startup mode
    (latest-full) with a consumer id, then `commits` streaming commits
    of `per_commit` upserts (each an update of a live id with
    probability C5_UPDATE_SHARE, else a new id; values from seed 7)
    with inline compaction, the consumer polling after each until it is
    caught up.  Every poll's changelog is held against a numpy oracle of
    the state transitions, the folded stream against the batch read,
    and a restored consumer must find nothing new.  Returns the
    config's metrics."""
    from paimon_tpu_torch.table import FileStoreTable

    name = "changelog_lookup_upsert"
    table = FileStoreTable.create(os.path.join(work, name), bigint_schema({
        "bucket": "1", "parquet.enable.dictionary": "false",
        "changelog-producer": "lookup"}), device=device)
    dev = table.device
    capture = rec.capture
    rng = np.random.default_rng(7)
    capacity = keys + commits * per_commit
    oracle = DenseState(capacity)
    ids = np.arange(keys, dtype=np.int64)
    vals = random_values(rng, keys)
    oracle.transitions(ids, vals)

    def write_state():
        wb = table.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(value_table(ids, vals))
            wb.new_commit().commit(w.prepare_commit())

    rec.run(name, "state write", keys, dev, write_state)
    t_before = timer.snapshot()
    if rec.run(name, "state full compaction", keys, dev,
               lambda: table.compact(full=True)) is None:
        raise AssertionError(f"{name}: the full compaction committed "
                             f"nothing")
    state_split = timer.delta(t_before)
    first_cl = table.latest_snapshot().changelog_record_count
    if first_cl != keys:
        raise AssertionError(f"{name}: the first changelog holds "
                             f"{first_cl} rows, expected {keys} +I")
    del ids, vals

    consumer = table.copy({"consumer-id": "config5",
                           "table-read.sequence-number.enabled": "true"})
    rb = consumer.new_read_builder()
    scan, read = rb.new_stream_scan(), rb.new_read()
    first = arrow_rows(rec.run(name, "stream first plan (latest-full)",
                               keys, dev, lambda: read.to_arrow(scan.plan())))
    scan.notify_checkpoint_complete(scan.checkpoint())
    want = oracle.rows()
    order = np.argsort(first["id"], kind="stable")
    if (first["kind"] != 0).any() or not all(
            np.array_equal(first[c][order], want[c])
            for c in ("id",) + C5_VALUE_COLS):
        raise AssertionError(f"{name}: the first plan is not the state "
                             f"as +I")
    fold = DenseState(capacity)
    fold.fold(first)
    del first, want, order

    seq0 = keys                      # the first streaming row's sequence
    expected: dict = {}
    commit_done: dict = {}
    delivered: dict = {}             # commit -> (poll time, at commit)
    stats = {"cycle_s": [], "poll_s": 0.0, "poll_rows": 0, "polls": 0,
             "changelog_snapshots": 0}

    def poll(at: int) -> None:
        """Poll until caught up; check each plan's changelog and fold
        it into the consumer's state."""
        while True:
            t0 = time.perf_counter()
            plan = scan.plan()
            if plan is None:
                stats["poll_s"] += time.perf_counter() - t0
                return
            got = read.to_arrow(plan)
            scan.notify_checkpoint_complete(scan.checkpoint())
            t1 = time.perf_counter()
            stats["poll_s"] += t1 - t0
            stats["polls"] += 1
            stats["poll_rows"] += got.num_rows
            if not got.num_rows:
                continue
            rows = arrow_rows(got)
            stats["changelog_snapshots"] += 1
            newer = (rows["kind"] == 0) | (rows["kind"] == 2)
            covered = np.unique((rows["seq"][newer] - seq0) // per_commit
                                + 1)
            what = f"{name} snapshot {plan.snapshot_id}"
            if covered.min() < 1 or covered.max() > at or \
                    any(int(c) in delivered for c in covered):
                raise AssertionError(f"{what}: changelog of commits "
                                     f"{covered.tolist()} at commit {at}")
            want = [expected.pop(int(c)) for c in covered]
            same_multiset(what, rows, {c: np.concatenate([w[c] for w in want])
                                       for c in want[0]})
            check_adjacent_updates(what, rows)
            for c in covered:
                delivered[int(c)] = (t1, at)
            fold.fold(rows)

    writer_builder = table.new_stream_write_builder() \
        .with_commit_user("config5")
    writer, committer = writer_builder.new_write(), writer_builder.new_commit()
    live = keys
    launches_before = rec.counts()
    t_before = timer.snapshot()
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    capture.where = f"{name} upsert"
    try:
        for k in range(1, commits + 1):
            update = rng.random(per_commit) < C5_UPDATE_SHARE
            ids = np.empty(per_commit, dtype=np.int64)
            ids[update] = rng.integers(0, live, int(update.sum()))
            fresh = per_commit - int(update.sum())
            ids[~update] = live + np.arange(fresh)
            live += fresh
            vals = random_values(rng, per_commit)
            expected[k] = oracle.transitions(ids, vals)
            batch = value_table(ids, vals)
            copied = capture.seconds
            t0 = time.perf_counter()
            writer.write_arrow(batch)
            committer.commit(writer.prepare_commit(), commit_identifier=k)
            commit_done[k] = time.perf_counter()
            stats["cycle_s"].append(commit_done[k] - t0
                                    - (capture.seconds - copied))
            poll(k)
    finally:
        writer.close()
    upsert_split = timer.delta(t_before)
    launches = tuple(a - b for a, b in zip(rec.counts(), launches_before))
    upserts = commits * per_commit
    upsert_s = float(sum(stats["cycle_s"]))
    rec.add(name, f"upsert ({commits} streaming commits, inline "
            f"compaction)", upserts, dev, upsert_s, launches,
            **{f"changelog_{k}": v for k, v in upsert_split.items()})
    rec.add(name, "stream read (changelog polls)", stats["poll_rows"], dev,
            stats["poll_s"], (0, 0))

    lat_s = [delivered[k][0] - commit_done[k] for k in sorted(delivered)]
    lat_commits = [delivered[k][1] - k for k in sorted(delivered)]
    pending = [k for k in range(1, commits + 1) if k not in delivered]
    # the commits still in L0 get their changelog from one more full
    # compaction (outside the latency figures)
    rec.run(name, "final full compaction", live, dev,
            lambda: table.compact(full=True))
    poll(commits)
    if expected:
        raise AssertionError(f"{name}: no changelog for commits "
                             f"{sorted(expected)}")
    batch_read = table.to_arrow()
    want = fold.rows()
    order = np.argsort(batch_read.column("id").to_numpy(), kind="stable")
    if batch_read.num_rows != len(want["id"]) or not all(
            np.array_equal(batch_read.column(c).combine_chunks()
                           .to_numpy()[order], want[c])
            for c in ("id",) + C5_VALUE_COLS):
        raise AssertionError(f"{name}: the folded stream differs from the "
                             f"batch read")
    if not all(np.array_equal(want[c], v) for c, v in oracle.rows().items()):
        raise AssertionError(f"{name}: the folded stream differs from the "
                             f"oracle")
    restored = rb.new_stream_scan()
    restored.restore(scan.checkpoint())
    if restored.plan() is not None or rb.new_stream_scan().plan() \
            is not None:
        raise AssertionError(f"{name}: a restored consumer found new rows")
    out = {
        "keys": keys, "commits": commits, "rows_per_commit": per_commit,
        "upsert_rows_per_s": upserts / upsert_s,
        "upsert_s": upsert_s, "cycle_s": stats["cycle_s"],
        **latency_stats(lat_s, lat_commits),
        "delivered_in_loop": len(lat_s), "pending_at_end": pending,
        "stream_read_rows_per_s": stats["poll_rows"] / stats["poll_s"],
        "stream_read_rows": stats["poll_rows"], "polls": stats["polls"],
        "changelog_snapshots": stats["changelog_snapshots"],
        "state_compaction_split": state_split,
        "upsert_split": upsert_split,
        "host_rss_max_gib": timer.rss_max_gib,
        "live_keys_at_end": len(want["id"])}
    latency = (f"p50 {out['latency_s_p50']:.2f} s / "
               f"{out['latency_commits_p50']:.1f} commits, max "
               f"{out['latency_s_max']:.2f} s / "
               f"{out['latency_commits_max']} commits" if lat_s
               else "none within the loop")
    log(f"  {name}: {upserts / upsert_s:,.0f} upsert rows/s over "
        f"{commits} commits; changelog latency {latency} ({len(pending)} "
        f"commits pending at the end); stream read "
        f"{out['stream_read_rows_per_s']:,.0f} rows/s; diffs "
        f"{upsert_split['diff_s']:.2f} s = encode "
        f"{upsert_split['encode_s']:.2f} + device ranks "
        f"{upsert_split['ranks_s']:.2f} + Arrow "
        f"{upsert_split['arrow_s']:.2f}; state merges "
        f"{upsert_split['state_merge_s']:.2f} s; host RSS max "
        f"{timer.rss_max_gib:.2f} GiB; checks passed")
    table.file_io.delete(table.path, recursive=True)
    return out


def check_joint_ranks(n: int = 1 << 21, seed: int = 23) -> dict:
    """The diff's key ranks on the card against their plain numpy
    version (np.unique over the lanes, the reference's computation) on
    the host, on three tables shaped like a lookup replay's before,
    after and delta (key-sorted BIGINT ids, n rows in all): equal
    exactly, and both timed on the host clock."""
    import pyarrow as pa

    from paimon_tpu_torch.ops import diff
    from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder

    rng = np.random.default_rng(seed)
    state = np.sort(rng.choice(4 * n, n * 9 // 20, replace=False))
    delta = np.sort(rng.choice(4 * n, n // 10, replace=False))
    tables = [pa.table({"_KEY_id": pa.array(k, pa.int64())})
              for k in (state, np.union1d(state, delta), delta)]
    enc = NormalizedKeyEncoder([pa.int64()], nullable=[False])
    rows = sum(t.num_rows for t in tables)
    diff.joint_key_ranks(tables, ["_KEY_id"], enc)          # warm
    t0 = time.perf_counter()
    got = diff.joint_key_ranks(tables, ["_KEY_id"], enc)
    t1 = time.perf_counter()
    want = diff.joint_key_ranks_plain(tables, ["_KEY_id"], enc)
    t2 = time.perf_counter()
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("joint key ranks: card != np.unique")
    out = {"rows": rows, "card_s": t1 - t0, "plain_host_s": t2 - t1}
    log(f"joint key ranks of {rows} rows: card == np.unique; card "
        f"{out['card_s']:.3f} s (encode, upload, sort, kernel, download), "
        f"np.unique on the host {out['plain_host_s']:.3f} s")
    return out


def changelog_files(table) -> dict:
    """{snapshot id: [each changelog file's rows as Arrow, in manifest
    order]}, read with pyarrow alone."""
    import pyarrow.parquet as pq
    scan = table.new_scan()
    out = {}
    for snap in table.snapshot_manager.snapshots():
        files = [pq.read_table(scan.path_factory.data_file_path(
                     s.partition, s.bucket, f.file_name))
                 for s in scan.plan_changelog(snap).splits
                 for f in s.data_files]
        if files:
            out[snap.id] = files
    return out


def coverage_producer(path: str, producer: str, device,
                      keys: int = COVERAGE_KEYS, commits: int = 5,
                      seed: int = 7):
    """One producer at coverage size: `commits` streaming commits (inline
    compaction on), each every key in a random order with random values
    and 1 row in 100 a DELETE, then a full compaction.  Returns (the
    changelog files by snapshot, the batch read)."""
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import RowKind

    table = FileStoreTable.create(path, bigint_schema({
        "bucket": "1", "parquet.enable.dictionary": "false",
        "changelog-producer": producer}), device=device)
    rng = np.random.default_rng(seed)
    wb = table.new_stream_write_builder().with_commit_user("coverage")
    with wb.new_write() as w:
        c = wb.new_commit()
        for k in range(1, commits + 1):
            kinds = np.where(rng.random(keys) < 0.01, RowKind.DELETE,
                             RowKind.INSERT).astype(np.int8)
            w.write_arrow(value_table(rng.permutation(keys),
                                      random_values(rng, keys)), kinds)
            c.commit(w.prepare_commit(), commit_identifier=k)
    table.compact(full=True)
    return changelog_files(table), table.to_arrow()


def changelog_producers_coverage(work: str, rec: Recorder) -> None:
    """input, lookup and full-compaction on the card, each held against
    the same table run by the port on the CPU: the changelog files of
    every snapshot, file for file and row for row, and the batch read."""
    import torch

    name = "changelog_producers_coverage"
    for producer in ("input", "lookup", "full-compaction"):
        card = rec.run(name, producer, 5 * COVERAGE_KEYS,
                       torch.device("cuda"),
                       lambda: coverage_producer(
                           os.path.join(work, f"cov-{producer}-card"),
                           producer, None))
        cpu = coverage_producer(os.path.join(work, f"cov-{producer}-cpu"),
                                producer, "cpu")
        what = f"{name} {producer}"
        if not card[0] or sorted(card[0]) != sorted(cpu[0]):
            raise AssertionError(f"{what}: changelog snapshots "
                                 f"{sorted(card[0])} vs cpu "
                                 f"{sorted(cpu[0])}")
        for sid in card[0]:
            a, b = card[0][sid], cpu[0][sid]
            if len(a) != len(b) or not all(x.equals(y)
                                           for x, y in zip(a, b)):
                raise AssertionError(f"{what}: the changelog of snapshot "
                                     f"{sid} differs from the cpu run")
        if not card[1].equals(cpu[1]):
            raise AssertionError(f"{what}: the batch read differs from the "
                                 f"cpu run")
        rows = sum(t.num_rows for f in card[0].values() for t in f)
        log(f"  {what}: card == cpu: {len(card[0])} changelog snapshots, "
            f"{rows} changelog rows, batch read of {card[1].num_rows} rows")
        for d in ("card", "cpu"):
            shutil.rmtree(os.path.join(work, f"cov-{producer}-{d}"),
                          ignore_errors=True)


MESH_ROWS = 5_000_000            # cut from 10M in PR 8 (script time)
MESH_LANES = 8


class OvcTimer:
    """Host seconds in the run-code offsets (ops.ovc.run_ovc_offsets)
    while entered: the mesh engine computes them on the host for every
    lane of every window."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0

    def __enter__(self):
        from paimon_tpu_torch.ops import ovc
        self._ovc = ovc
        self._fn = fn = ovc.run_ovc_offsets

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        ovc.run_ovc_offsets = timed
        return self

    def __exit__(self, *exc):
        self._ovc.run_ovc_offsets = self._fn


def check_sums(what: str, got, ids: np.ndarray, vals: np.ndarray) -> None:
    """Per-id sums of v: ids exact, sums within rtol 1e-12 of numpy's
    (the engine adds in sequence order, numpy in id-sorted order)."""
    import pyarrow.compute as pc
    order = np.argsort(ids, kind="stable")
    s = ids[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    got = got.take(pc.sort_indices(got, sort_keys=[("id", "ascending")]))
    if got.num_rows != len(starts) or not np.array_equal(
            got.column("id").to_numpy(), s[starts]):
        raise AssertionError(f"{what}: ids differ from the oracle")
    if not np.allclose(got.column("v").to_numpy(),
                       np.add.reduceat(vals[order], starts),
                       rtol=1e-12, atol=0.0):
        raise AssertionError(f"{what}: sums beyond rtol 1e-12 of numpy's")


def check_rescaled(what: str, table, buckets: int) -> None:
    """Every row of every split in the bucket that the reference's
    formula (core/bucket._bucket_from_hash) gives its key."""
    from paimon_tpu_torch.core.bucket import KeyHasher, _bucket_from_hash

    hasher = KeyHasher(["id"], [table.schema.logical_row_type()
                                .get_field("id").type])
    read = table.new_read_builder().new_read()
    for split in table.new_scan().plan().splits:
        rows = read.read_split(split)
        h = (hasher.hashes(rows) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        if not (_bucket_from_hash(h, buckets) == split.bucket).all():
            raise AssertionError(f"{what}: a row of bucket {split.bucket} "
                                 f"belongs elsewhere")


def mesh_compaction(work: str, rec: Recorder, rows: int = MESH_ROWS,
                    device="cuda") -> dict:
    """parallel/dryrun.run_engines on the card: deduplicate and
    aggregation (v sum) tables of >= `rows` input rows, MESH_LANES
    buckets, compacted by compact_table_mesh on MESH_LANES lanes of one
    card (one batched merge a window step); each read held against a
    numpy oracle, the engine's retries, fallbacks and cleanup errors 0,
    the offset-value-code variant launched with MESH_LANES lanes in one
    launch; then the deduplicate table rescaled to twice the buckets,
    read back equal, every row in its formula's bucket, the schema's
    bucket option updated and no row dropped by the dispatch."""
    from paimon_tpu_torch.metrics import COMPACTION_WINDOW_MS, global_registry
    from paimon_tpu_torch.parallel import (
        bucket_mesh, compact_table_mesh, rescale, rescale_table_buckets,
    )
    from paimon_tpu_torch.parallel.dryrun import engine_table, input_rows
    from paimon_tpu_torch.table import FileStoreTable

    mesh = bucket_mesh(MESH_LANES, device=device)
    window_ms = global_registry().compaction_metrics().histogram(
        COMPACTION_WINDOW_MS)
    out = {"lanes": MESH_LANES, "device": str(mesh.device)}
    for engine in ("deduplicate", "aggregation"):
        name = f"mesh_{engine}"
        path = os.path.join(work, name)
        # the table of parallel/dryrun.run_engines, with every row
        # written kept for the oracles
        built = []
        rec.run(name, "write", lambda: len(built[0][1]), mesh.device,
                lambda: built.append(engine_table(path, engine, MESH_LANES,
                                                  rows, device)))
        table, ids, vals = built[0]
        if engine == "deduplicate":
            win = last_writer_oracle(ids)

            def check(what, got):
                check_rows(what, got, {"id": ids, "v": vals}, win, "id")
        else:
            def check(what, got):
                check_sums(what, got, ids, vals)
        n_in = input_rows(table)
        w0, timer = window_ms.total_sum, OvcTimer()
        with timer:
            stats = rec.run(name, "compact", n_in, table.device,
                            lambda: compact_table_mesh(table, mesh))
        compact_s, compact_gib = (rec.phases[-1]["s"],
                                  rec.phases[-1]["peak_gib"])
        if stats.snapshot_id is None or stats.retries or stats.fallbacks \
                or stats.cleanup_errors:
            raise AssertionError(f"{name}: snapshot {stats.snapshot_id}, "
                                 f"{stats.retries} retries, "
                                 f"{stats.fallbacks} fallbacks, "
                                 f"{stats.cleanup_errors} cleanup errors")
        got = rec.run(name, "read", n_in, table.device, table.to_arrow)
        check(f"{name} read after mesh compaction", got)
        if stats.output_rows != got.num_rows:
            raise AssertionError(f"{name}: {stats.output_rows} output rows, "
                                 f"{got.num_rows} read")
        batched = sorted((k[5], k[3] // k[5], k[2], k[1], n)
                         for k, n in rec.capture.calls.items()
                         if k[0] == name and k[5] > 1)
        if not any(b == MESH_LANES and v == "ovc"
                   for b, _, _, v, _ in batched):
            raise AssertionError(f"{name}: no offset-value-code launch of "
                                 f"{MESH_LANES} lanes ({batched})")
        res = {"input_rows": n_in, "output_rows": stats.output_rows,
               "commits": len(ids) // (rows // 2), "compact_s": compact_s,
               "rows_per_s": n_in / compact_s, "windows": stats.windows,
               "peak_window_rows": stats.peak_window_rows,
               "peak_buffered_rows": stats.peak_buffered_rows,
               "skew": stats.skew, "lane_rows": stats.lane_rows,
               "window_s": (window_ms.total_sum - w0) / 1e3,
               "ovc_host_s": timer.seconds, "ovc_calls": timer.calls,
               "peak_gib": compact_gib,
               "batched_launches": [
                   {"b": b, "n": n, "lanes": la, "variant": v,
                    "launches": c} for b, n, la, v, c in batched]}
        if engine == "deduplicate":
            dispatches = []
            kernel = rescale._dispatch_kernel

            def recorded(*args, **kwargs):
                blocks, dropped = kernel(*args, **kwargs)
                dispatches.append({"cap": args[4], "dropped": dropped})
                return blocks, dropped
            rescale._dispatch_kernel = recorded
            try:
                sid = rec.run(name, "rescale", got.num_rows, table.device,
                              lambda: rescale_table_buckets(
                                  table, 2 * MESH_LANES, mesh))
            finally:
                rescale._dispatch_kernel = kernel
            again = FileStoreTable.load(path, device=device)
            if sid is None or again.options.bucket != 2 * MESH_LANES or \
                    not dispatches or dispatches[-1]["dropped"]:
                raise AssertionError(f"{name} rescale: snapshot {sid}, "
                                     f"bucket {again.options.bucket}, "
                                     f"dispatches {dispatches}")
            check(f"{name} read after rescale", rec.run(
                name, "read rescaled", got.num_rows, table.device,
                again.to_arrow))
            check_rescaled(f"{name} rescale", again, 2 * MESH_LANES)
            res["rescale"] = {"rows": got.num_rows,
                              "s": rec.phases[-2]["s"],
                              "rows_per_s": rec.phases[-2]["rows_per_s"],
                              "peak_gib": rec.phases[-2]["peak_gib"],
                              "buckets": 2 * MESH_LANES,
                              "dispatches": dispatches}
        out[engine] = res
        log(f"  {name}: {json.dumps(res)}")
        shutil.rmtree(path, ignore_errors=True)
    return out


# -- primary-key tables in the bucket modes users create by default --------

BM_TARGET = 2_000_000            # dynamic-bucket.target-row-num's default
DYN_ROWS = 20_000_000            # dyn_dedup_20M: 10 commits of 2M
DYN_KEYS = 16_000_000            # ids uniform in [0, 16M)
DYN_COMMITS = 10
DYN_FRESH = 1_000_000            # upserts of existing ids, a fresh table
DYN_EVOLVED = 2_000_000          # upserts a commit under the new schema
XPART_KEYS = 8_000_000           # xpart_upsert_8M: 4 commits of 2M keys
XPART_UPSERTS = 1_000_000        # then 4 commits of 1M upserts
XPART_PARTS = 4
POSTPONE_ROWS = 8_000_000        # postpone_8M: 4 commits of 2M
POSTPONE_TARGET = 5_000_000      # postpone.target-row-num-per-bucket


class Clock:
    """Host seconds of a table's steps outside its recorded phases (data
    and oracles, checks), summed into `out[key]`."""

    def __init__(self, out: dict):
        self.out = out

    def __call__(self, key: str, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        self.out[key] = self.out.get(key, 0.0) + time.perf_counter() - t0
        return res


def bucket_ids(table) -> tuple:
    """(ids, bucket of each) of every live row, read split by split."""
    rb = table.new_read_builder().with_projection(["id"])
    read = rb.new_read()
    ids, buckets = [], []
    for split in rb.new_scan().plan().splits:
        got = read.read_split(split).column("id").to_numpy()
        ids.append(got)
        buckets.append(np.full(len(got), split.bucket, np.int32))
    ids, buckets = np.concatenate(ids), np.concatenate(buckets)
    order = np.argsort(ids, kind="stable")
    return ids[order], buckets[order]


def distinct(x: np.ndarray) -> np.ndarray:
    """Sorted distinct values (np.unique without its return arrays,
    which numpy 2.3 runs through a hash table 40x slower than a sort at
    ten million int32 values on the H100 machine's host)."""
    s = np.sort(x)
    return s[np.r_[True, s[1:] != s[:-1]]] if len(s) else s


def check_hash_index(what: str, table, ids, buckets, target: int) -> dict:
    """The dynamic-bucket hash index against the rows: each id in
    exactly one bucket, whose index file holds the distinct hashes of
    that bucket's ids and no other; every bucket but the last full at
    `target` hashes, the last at most that; the files' total the
    distinct 32-bit hashes of the live ids."""
    import pyarrow as pa

    from paimon_tpu_torch.core.bucket import KeyHasher
    from paimon_tpu_torch.core.dynamic_bucket import (
        as_int32, hash_index_entries,
    )
    from paimon_tpu_torch.types import BigIntType

    if len(ids) > 1 and not (ids[1:] > ids[:-1]).all():
        raise AssertionError(f"{what}: an id lives in two buckets")
    scan = table.new_scan()
    entries = sorted(hash_index_entries(
        scan, table.snapshot_manager.latest_snapshot()),
        key=lambda e: e.bucket)
    counts = [e.index_file.row_count for e in entries]
    if [e.bucket for e in entries] != list(range(len(entries))) or \
            any(c != target for c in counts[:-1]) or counts[-1] > target:
        raise AssertionError(f"{what}: index buckets "
                             f"{[(e.bucket, c) for e, c in zip(entries, counts)]}")
    hashes = as_int32(KeyHasher(["id"], [BigIntType(False)]).hashes(
        pa.table({"id": pa.array(ids, pa.int64())})))
    if sum(counts) != len(distinct(hashes)):
        raise AssertionError(f"{what}: {sum(counts)} hashes indexed, "
                             f"{len(distinct(hashes))} distinct")
    for e in entries:
        data = table.file_io.read_bytes(
            scan.path_factory.index_file_path(e.index_file.file_name))
        listed = np.sort(np.frombuffer(data, ">i4").astype(np.int32))
        if not np.array_equal(distinct(hashes[buckets == e.bucket]),
                              listed):
            raise AssertionError(f"{what}: bucket {e.bucket}'s index file "
                                 f"differs from its rows' hashes")
    return {"buckets": len(entries), "hashes": counts}


def check_evolved(what: str, got, cols: dict, win: np.ndarray,
                  old: np.ndarray) -> None:
    """The evolved schema's rows against the oracle: v2 renamed v2r, v3
    widened exactly, v4 null on the rows written before the evolution
    (`old`: per row of `cols`)."""
    import pyarrow.compute as pc
    check_rows(what, got.drop_columns(["v4"]).rename_columns(
        ["id", "v1", "v2", "v3"]), {k: cols[k] for k in
                                    ("id", "v1", "v2", "v3")}, win, "id")
    got = got.take(pc.sort_indices(got, sort_keys=[("id", "ascending")]))
    v4 = got.column("v4").combine_chunks()
    nulls = np.asarray(v4.is_null())
    if got.column("v3").type != "int64" or \
            not np.array_equal(nulls, old[win]) or \
            not np.array_equal(v4.to_numpy(zero_copy_only=False)[~nulls],
                               cols["v4"][win][~nulls]):
        raise AssertionError(f"{what}: v3 or v4 differs from the oracle")


def dyn_dedup(work: str, rec: Recorder, device, scale: int) -> dict:
    """dyn_dedup_20M: Paimon's default bucket mode (no `bucket` option),
    deduplicate, write-only; 10 commits of uniform ids from one writer,
    a full compaction and a scan, the hash index
    held against the rows, a fresh table object's upserts of existing
    ids routed to their old buckets; then ADD COLUMN v4 DOUBLE, v3 INT
    -> BIGINT, RENAME v2 -> v2r, 2 commits of upserts under the new
    schema, a merge-on-read scan over runs of both schema ids, a full
    compaction and a scan."""
    import pyarrow as pa

    from paimon_tpu_torch.schema import SchemaChange
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, DoubleType

    name = "dyn_dedup_20M"
    path = os.path.join(work, name)
    rows, keys = DYN_ROWS // scale, DYN_KEYS // scale
    target, per = BM_TARGET // scale, DYN_ROWS // scale // DYN_COMMITS
    opts = {"write-only": "true", "parquet.enable.dictionary": "false"}
    if target != BM_TARGET:
        opts["dynamic-bucket.target-row-num"] = str(target)
    out = {"rows": rows, "commits": DYN_COMMITS}
    clock = Clock(out)
    rng = np.random.default_rng(7)
    batches = clock("data_s", lambda: [
        value_table(rng.integers(0, keys, per), random_values(rng, per))
        for _ in range(DYN_COMMITS)])
    cols = clock("data_s", lambda: {
        c: np.concatenate([b.column(c).to_numpy() for b in batches])
        for c in ("id", "v1", "v2", "v3")})
    win = clock("oracle_s", last_writer_oracle, cols["id"])
    table = FileStoreTable.create(path, bigint_schema(opts), device=device)
    dev = table.device

    def write():
        wb = table.new_stream_write_builder()
        with wb.new_write() as w:
            commit = wb.new_commit()
            for k, b in enumerate(batches):
                w.write_arrow(b)
                commit.commit(w.prepare_commit(), commit_identifier=k)
            out["assign_s"] = w._write.assign_seconds

    t0 = time.perf_counter()
    rec.run(name, "write", rows, dev, write)
    del batches
    if rec.run(name, "compact", rows, dev,
               lambda: table.compact(full=True)) is None:
        raise AssertionError(f"{name}: full compaction committed nothing")
    clock("check_s", check_rows, f"{name} read after compaction",
          rec.run(name, "read", len(win), dev, table.to_arrow), cols, win,
          "id")
    ids, buckets = clock("bucket_ids_s", bucket_ids, table)
    out["index"] = clock("index_check_s", check_hash_index, name, table,
                         ids, buckets, target)

    # a fresh table object upserts existing ids: every one to its bucket
    fresh = value_table(rng.choice(ids, DYN_FRESH // scale, replace=False),
                        random_values(rng, DYN_FRESH // scale))
    index_before = table.latest_snapshot().index_manifest
    again = FileStoreTable.load(path, device=device)

    def upsert():
        wb = again.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(fresh)
            wb.new_commit().commit(w.prepare_commit())
            out["fresh_assign_s"] = w._write.assign_seconds

    rec.run(name, "fresh upsert", fresh.num_rows, dev, upsert)
    ids2, buckets2 = clock("bucket_ids_s", bucket_ids, again)
    if not (np.array_equal(ids, ids2) and np.array_equal(buckets, buckets2)
            and again.latest_snapshot().index_manifest == index_before):
        raise AssertionError(f"{name}: a fresh writer moved an existing "
                             f"id to another bucket")
    for c in cols:
        cols[c] = np.concatenate([cols[c], fresh.column(c).to_numpy()])
    out["before_evolution_s"] = time.perf_counter() - t0

    # schema evolution (Paimon docs, "Schema Evolution")
    t0 = time.perf_counter()
    again.schema_manager.commit_changes(
        SchemaChange.add_column("v4", DoubleType()),
        SchemaChange.update_column_type("v3", BigIntType()),
        SchemaChange.rename_column("v2", "v2r"))
    evolved = FileStoreTable.load(path, device=device)
    old = np.ones(len(cols["id"]), dtype=bool)
    cols["v3"] = cols["v3"].astype(np.int64)
    cols["v4"] = np.zeros(len(cols["id"]))
    new = []
    for _ in range(2):
        n = DYN_EVOLVED // scale
        vals = random_values(rng, n)
        new.append(pa.table({
            "id": pa.array(rng.integers(0, keys, n), pa.int64()),
            "v1": pa.array(vals["v1"], pa.int64()),
            "v2r": pa.array(vals["v2"], pa.float64()),
            "v3": pa.array(rng.integers(1 << 40, 1 << 41, n), pa.int64()),
            "v4": pa.array(rng.random(n), pa.float64())}))
    for b in new:
        for c, src in (("id", "id"), ("v1", "v1"), ("v2", "v2r"),
                       ("v3", "v3"), ("v4", "v4")):
            cols[c] = np.concatenate([cols[c], b.column(src).to_numpy()])
        old = np.concatenate([old, np.zeros(b.num_rows, dtype=bool)])
    # the last writers among the first winners and every later row
    later = np.concatenate([win, np.arange(rows, len(old))])
    win = later[clock("oracle_s", last_writer_oracle, cols["id"][later])]
    n_new = sum(b.num_rows for b in new)

    def write_evolved():
        for b in new:
            wb = evolved.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())

    rec.run(name, "evolved write", n_new, dev, write_evolved)
    schema_ids = {f.schema_id for s in evolved.new_scan().plan().splits
                  for f in s.data_files}
    if schema_ids != {0, 1}:
        raise AssertionError(f"{name}: runs of schemas {schema_ids}")
    total = len(cols["id"])
    clock("check_s", check_evolved, f"{name} evolved merge-on-read scan",
          rec.run(name, "evolved scan", total, dev, evolved.to_arrow),
          cols, win, old)
    if rec.run(name, "evolved compact", total, dev,
               lambda: evolved.compact(full=True)) is None:
        raise AssertionError(f"{name}: evolved compaction committed nothing")
    clock("check_s", check_evolved, f"{name} evolved read after compaction",
          rec.run(name, "evolved read", len(win), dev, evolved.to_arrow),
          cols, win, old)
    ids, buckets = clock("bucket_ids_s", bucket_ids, evolved)
    out["evolved_index"] = clock("index_check_s", check_hash_index,
                                 f"{name} evolved", evolved, ids, buckets,
                                 target)
    out["evolution_s"] = time.perf_counter() - t0
    clock("cleanup_s", shutil.rmtree, path, True)
    return out


def xpart_upsert(work: str, rec: Recorder, device, scale: int) -> dict:
    """xpart_upsert_8M: cross-partition upsert (primary key id, partition
    dt INT of 4 values, bucket unset): 8M keys in 4 commits from one
    writer; then a fresh table object's writer (the global index
    bootstraps from the table) upserts 1M ids a commit for 4 commits, a
    quarter of them moving partition and 1% of those moving again later
    in the same batch; each id held once, in the partition of its last
    write, before and after a full compaction."""
    import pyarrow as pa

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, DoubleType, IntType

    name = "xpart_upsert_8M"
    path = os.path.join(work, name)
    keys, target = XPART_KEYS // scale, BM_TARGET // scale
    opts = {"write-only": "true", "parquet.enable.dictionary": "false"}
    if target != BM_TARGET:
        opts["dynamic-bucket.target-row-num"] = str(target)
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v1", BigIntType()).column("v2", DoubleType())
              .column("v3", IntType()).column("dt", IntType(False))
              .partition_keys("dt").primary_key("id").options(opts)
              .build())
    rng = np.random.default_rng(7)

    def batch(ids, dt):
        t = value_table(ids, random_values(rng, len(ids)))
        return t.append_column("dt", pa.array(dt.astype(np.int32),
                                              pa.int32()))

    out = {"keys": keys}
    clock = Clock(out)
    t0 = time.perf_counter()
    cur = rng.integers(0, XPART_PARTS, keys)        # partition of each id
    first = [batch(ids, cur[ids])
             for ids in np.array_split(rng.permutation(keys), 4)]
    upserts, moved = [], 0
    for _ in range(4):
        ids = rng.choice(keys, XPART_UPSERTS // scale, replace=False)
        dt = cur[ids].copy()
        move = rng.random(len(ids)) < 0.25
        dt[move] = (dt[move] + rng.integers(1, XPART_PARTS,
                                            move.sum())) % XPART_PARTS
        twice = np.flatnonzero(move)[:len(ids) // 100]
        dt2 = (dt[twice] + rng.integers(1, XPART_PARTS, len(twice))) \
            % XPART_PARTS
        ids, dt = np.concatenate([ids, ids[twice]]), np.concatenate([dt, dt2])
        moved += int(move.sum()) + len(twice)
        cur[ids] = dt
        upserts.append(batch(ids, dt))
    allb = first + upserts
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in allb])
            for c in ("id", "v1", "v2", "v3", "dt")}
    out["data_s"] = time.perf_counter() - t0
    win = clock("oracle_s", last_writer_oracle, cols["id"])
    table = FileStoreTable.create(path, schema, device=device)
    dev = table.device
    out.update(upserts=sum(b.num_rows for b in upserts), moved_rows=moved)

    def write(t, batches, what):
        wb = t.new_stream_write_builder()
        with wb.new_write() as w:
            commit = wb.new_commit()
            for k, b in enumerate(batches):
                w.write_arrow(b)
                commit.commit(w.prepare_commit(), commit_identifier=k)
            out[f"{what}_bootstrap_s"] = w._write.bootstrap_seconds
            out[f"{what}_assign_s"] = w._write.inner.assign_seconds

    rec.run(name, "write", keys, dev, lambda: write(table, first, "write"))
    fresh = FileStoreTable.load(path, device=device)
    rec.run(name, "upsert", out["upserts"], dev,
            lambda: write(fresh, upserts, "upsert"))
    total = len(cols["id"])
    clock("check_s", check_rows, f"{name} merge-on-read scan",
          rec.run(name, "scan", total, dev, fresh.to_arrow), cols, win, "id")
    if rec.run(name, "compact", total, dev,
               lambda: fresh.compact(full=True)) is None:
        raise AssertionError(f"{name}: full compaction committed nothing")
    clock("check_s", check_rows, f"{name} read after compaction",
          rec.run(name, "read", keys, dev, fresh.to_arrow), cols, win, "id")
    clock("cleanup_s", shutil.rmtree, path, True)
    return out


def postpone(work: str, rec: Recorder, device, scale: int) -> dict:
    """postpone_8M: bucket=-2, deduplicate, write-only; 8M rows in 4
    commits staged un-hashed (a scan sees none of them, as the
    reference's does), then rescale_postpone at the postpone defaults
    (5M rows a bucket) and a scan held against the oracle, the rescaled
    hash index against the rows."""
    from paimon_tpu_torch.table import FileStoreTable

    name = "postpone_8M"
    path = os.path.join(work, name)
    rows, per_bucket = POSTPONE_ROWS // scale, POSTPONE_TARGET // scale
    opts = {"bucket": "-2", "write-only": "true",
            "parquet.enable.dictionary": "false"}
    if per_bucket != POSTPONE_TARGET:
        opts["postpone.target-row-num-per-bucket"] = str(per_bucket)
    out = {"rows": rows}
    clock = Clock(out)
    rng = np.random.default_rng(7)
    batches = clock("data_s", lambda: [
        value_table(rng.integers(0, rows, rows // 4),
                    random_values(rng, rows // 4)) for _ in range(4)])
    cols = clock("data_s", lambda: {
        c: np.concatenate([b.column(c).to_numpy() for b in batches])
        for c in ("id", "v1", "v2", "v3")})
    win = clock("oracle_s", last_writer_oracle, cols["id"])
    table = FileStoreTable.create(path, bigint_schema(opts), device=device)
    dev = table.device

    def write():
        wb = table.new_stream_write_builder()
        with wb.new_write() as w:
            commit = wb.new_commit()
            for k, b in enumerate(batches):
                w.write_arrow(b)
                commit.commit(w.prepare_commit(), commit_identifier=k)

    rec.run(name, "write", rows, dev, write)
    staged = rec.run(name, "scan staged", rows, dev, table.to_arrow)
    if staged.num_rows:
        raise AssertionError(f"{name}: {staged.num_rows} staged rows read")
    if rec.run(name, "rescale", rows, dev, table.rescale_postpone) is None:
        raise AssertionError(f"{name}: the rescale committed nothing")
    clock("check_s", check_rows, f"{name} read after rescale",
          rec.run(name, "read", len(win), dev, table.to_arrow), cols, win,
          "id")
    ids, buckets = clock("bucket_ids_s", bucket_ids, table)
    out["index"] = clock("index_check_s", check_hash_index, name, table, ids,
                         buckets, per_bucket)
    clock("cleanup_s", shutil.rmtree, path, True)
    return out


def bucket_modes(work: str, rec: Recorder, device="cuda",
                 scale: int = 1) -> dict:
    """The three bucket-mode tables on the card (`scale` divides every
    row count and bucket target, for a rehearsal); their seconds by
    table."""
    out = {}
    t_all = time.perf_counter()
    for name, fn in (("dyn_dedup_20M", dyn_dedup),
                     ("xpart_upsert_8M", xpart_upsert),
                     ("postpone_8M", postpone)):
        t0 = time.perf_counter()
        out[name] = fn(work, rec, device, scale)
        out[name]["s"] = time.perf_counter() - t0
        out[name]["phases"] = {p["phase"]: {k: p[k] for k in (
            "rows", "s", "rows_per_s", "launches_plain", "launches_ovc",
            "peak_gib")} for p in rec.phases if p["table"] == name}
        log(f"  {name}: {out[name]['s']:.1f} s {json.dumps(out[name])}")
    out["s"] = time.perf_counter() - t_all
    if device != "cpu":
        out["card"] = card_line()
    return out


# -- the serving plane: point lookups and the one-replica query service ------

SERVE_ROWS = 5_000_000           # cut from 10M in PR 8 (script time)
SERVE_COMMITS = 4
SERVE_BUCKETS = 4
SERVE_BATCH = 8                  # keys of a point-get request
SERVE_WRITER_ROWS = 100_000
SERVE_WRITER_BATCH = 10_000


def serving_batches(rows: int, commits: int = SERVE_COMMITS, seed: int = 11):
    """benchmarks/serve_bench.py build_serving_table's commits: `commits`
    batches of rows / commits ids uniform in [0, rows), v uniform in
    [0, 1), name "c<commit>-<id % 997>", from `seed`."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    per = rows // commits
    out = []
    for c in range(commits):
        ids = rng.integers(0, rows, per)
        out.append(pa.table({
            "id": pa.array(ids, pa.int64()),
            "v": pa.array(rng.random(per), pa.float64()),
            "name": pa.array(np.char.add(f"c{c}-",
                                         (ids % 997).astype(str)))}))
    return out


class ServeOracle:
    """The served table by numpy alone, dense over the id range: per id
    whether it is live, its v (the last writer's, or the per-id sum
    under aggregation) and the tag of the last writer's name ("c<tag>-"
    for a commit of serving_batches, "w<tag - 100>-" for a serving
    writer batch)."""

    def __init__(self, rows: int, batches, summed: bool = False):
        self.rows = rows
        self.live = np.zeros(rows, bool)
        self.v = np.zeros(rows, np.float64)
        self.tag = np.zeros(rows, np.int16)
        for c, b in enumerate(batches):
            ids = b.column("id").to_numpy()
            v = b.column("v").to_numpy()
            if summed:
                self.v += np.bincount(ids, weights=v, minlength=rows)
                self.live[ids] = True
                last = np.unique(ids[::-1], return_index=True)[1]
                self.tag[ids[::-1][last]] = c
            else:
                self.upsert(ids, v, c)

    def upsert(self, ids, v, tag: int) -> None:
        # within a batch the last occurrence of an id wins
        keep = len(ids) - 1 - np.unique(ids[::-1], return_index=True)[1]
        self.live[ids[keep]] = True
        self.v[ids[keep]] = v[keep]
        self.tag[ids[keep]] = tag

    def name(self, i: int) -> str:
        t = int(self.tag[i])
        return f"c{t}-{i % 997}" if t < 100 else f"w{t - 100}-{i % 997}"

    def check(self, what: str, ids, rows, rtol: float = 0.0) -> None:
        """Every answer of a lookup batch: None for a dead id, else the
        row (v exact, or within rtol under aggregation)."""
        for i, row in zip(ids, rows):
            i = int(i)
            if not self.live[i]:
                if row is not None:
                    raise AssertionError(f"{what}: id {i} is not live, "
                                         f"got {row}")
                continue
            want_v = float(self.v[i])
            if row is None or row["id"] != i or \
                    row["name"] != self.name(i) or not (
                        row["v"] == want_v if rtol == 0.0 else
                        abs(row["v"] - want_v) <= rtol * abs(want_v)):
                raise AssertionError(f"{what}: id {i}: got {row}, want "
                                     f"v={want_v!r} name={self.name(i)}")

    def check_scan(self, what: str, rows, complete: bool = False) -> None:
        """Scanned rows, vectorized: distinct live ids, each row exactly
        the oracle's (`complete`: every live id)."""
        n = len(rows)
        ids = np.fromiter((r["id"] for r in rows), np.int64, n)
        v = np.fromiter((r["v"] for r in rows), np.float64, n)
        if len(np.unique(ids)) != n or not self.live[ids].all():
            raise AssertionError(f"{what}: an id repeats or is not live")
        if complete and n != int(self.live.sum()):
            raise AssertionError(f"{what}: {n} rows, oracle "
                                 f"{int(self.live.sum())}")
        tags = self.tag[ids].astype(np.int64)
        prefix = np.where(tags < 100, np.char.add("c", tags.astype(str)),
                          np.char.add("w", (tags - 100).astype(str)))
        names = np.char.add(np.char.add(prefix, "-"),
                            (ids % 997).astype(str))
        if not np.array_equal(v, self.v[ids]) or \
                [r["name"] for r in rows] != names.tolist():
            raise AssertionError(f"{what}: a row differs from the oracle")


class BuildTimer:
    """Seconds of the lookup store's SST builds: each `_spill` (lane
    encode, host sort, SST write) with its rows, and each data-file read
    of the fast path; the merged fallback's reads are timed by the
    caller on its query's reader."""

    def __init__(self):
        self.spills = []         # (seconds, rows)
        self.reads = []          # seconds

    def __enter__(self):
        from paimon_tpu_torch.lookup.local_query import LocalTableQuery
        self._cls = LocalTableQuery
        self._orig = (LocalTableQuery._spill,
                      LocalTableQuery._file_reader_load)
        spill, load = self._orig

        def timed_spill(q, key, t):
            t0 = time.perf_counter()
            out = spill(q, key, t)
            self.spills.append((time.perf_counter() - t0, t.num_rows))
            return out

        def timed_load(q, split, meta):
            t0 = time.perf_counter()
            out = load(q, split, meta)
            self.reads.append(time.perf_counter() - t0)
            return out
        LocalTableQuery._spill = timed_spill
        LocalTableQuery._file_reader_load = timed_load
        return self

    def __exit__(self, *exc):
        self._cls._spill, self._cls._file_reader_load = self._orig

    def summary(self, since=(0, 0)) -> dict:
        spills = self.spills[since[0]:]
        reads = self.reads[since[1]:]
        return {"ssts": len(spills),
                "sst_rows": sum(r for _, r in spills),
                "spill_s": sum(s for s, _ in spills),
                "max_spill_s": max((s for s, _ in spills), default=0.0),
                "file_reads": len(reads), "file_read_s": sum(reads)}

    def mark(self):
        return len(self.spills), len(self.reads)


def pct(vals, p: float) -> float:
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(p / 100 * len(vals)))] if vals \
        else 0.0


def client_load(server, oracle: ServeOracle, clients: int, seconds: float,
                scan_share: float, what: str, rtol: float = 0.0) -> dict:
    """`clients` keep-alive client threads for `seconds`: point gets of
    SERVE_BATCH keys uniform over the id range, and scan(limit=100) with
    probability `scan_share`; every answer kept and held against the
    oracle after the window (a 5xx or any other error fails)."""
    from paimon_tpu_torch.service import KvQueryClient, ServiceBusyError
    stop = threading.Event()
    lock = threading.Lock()
    got = {"lookups": [], "scans": [], "lat": [], "busy": 0, "errors": []}

    def worker(seed):
        r = np.random.default_rng(1000 + seed)
        mine = {"lookups": [], "scans": [], "lat": [], "busy": 0}
        try:
            with KvQueryClient(address=server.address,
                               tenant=f"t{seed % 8}") as c:
                while not stop.is_set():
                    try:
                        if r.random() >= scan_share:
                            ids = r.integers(0, oracle.rows, SERVE_BATCH)
                            t1 = time.perf_counter()
                            rows = c.lookup([{"id": int(i)} for i in ids])
                            mine["lat"].append(
                                (time.perf_counter() - t1) * 1000.0)
                            mine["lookups"].append((ids, rows))
                        else:
                            mine["scans"].append(c.scan(limit=100))
                    except ServiceBusyError:
                        mine["busy"] += 1
                        time.sleep(0.002)
        except Exception as e:      # noqa: BLE001 -- reported, then raised
            with lock:
                got["errors"].append(repr(e))
        with lock:
            for k in ("lookups", "scans", "lat"):
                got[k].extend(mine[k])
            got["busy"] += mine["busy"]

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(clients)]
    counters0 = lookup_counters()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    elapsed = time.perf_counter() - t0
    if got["errors"] or any(t.is_alive() for t in threads):
        raise AssertionError(f"{what}: client errors {got['errors'][:3]}")
    t1 = time.perf_counter()
    for ids, rows in got["lookups"]:
        oracle.check(what, ids, rows, rtol)
    for rows in got["scans"]:
        if len(rows) != 100:
            raise AssertionError(f"{what}: scan(limit=100) gave "
                                 f"{len(rows)} rows")
        oracle.check_scan(what, rows)
    n_l, n_s = len(got["lookups"]), len(got["scans"])
    return {"clients": clients, "seconds": elapsed,
            "lookup_counters": lookup_counters(counters0),
            "qps": (n_l + n_s) / elapsed, "lookup_qps": n_l / elapsed,
            "scan_qps": n_s / elapsed, "busy_429": got["busy"],
            "lookups": n_l, "scans": n_s,
            "p50_ms": pct(got["lat"], 50), "p95_ms": pct(got["lat"], 95),
            "p99_ms": pct(got["lat"], 99),
            "checked_s": time.perf_counter() - t1}


def lookup_counters(since=None) -> dict:
    """The lookup metric group's counters (block cache, SST builds and
    reuses, native probes), as deltas from `since` when given."""
    from paimon_tpu_torch.metrics import global_registry
    now = {k: v for k, v in global_registry().snapshot().get(
        "lookup", {}).items() if isinstance(v, int)}
    return now if since is None else \
        {k: v - since.get(k, 0) for k, v in now.items()}


def served_rows(load: dict) -> int:
    """Keys looked up plus rows scanned in a client_load window."""
    return load["lookups"] * SERVE_BATCH + load["scans"] * 100


def thread_launches(capture, name: str) -> dict:
    """{thread-name prefix: (plain, ovc) launches} of table `name`."""
    out = {}
    for (table, variant, thread), n in capture.threads.items():
        if table == name:
            c = out.setdefault(thread, [0, 0])
            c[variant == "ovc"] += n
    return out


def serve_dedup(work: str, rec: Recorder, batches, rows: int, device,
                clients: int, seconds: float) -> dict:
    """serve_dedup_5M: the reference serving benchmark's table at
    `rows`, served by one KvQueryServer on the card; see `serving`."""
    import torch

    from paimon_tpu_torch.lookup.sst import force_python_probe
    from paimon_tpu_torch.metrics import (
        LOOKUP_NATIVE_FALLBACKS, LOOKUP_NATIVE_PROBES, global_registry,
    )
    from paimon_tpu_torch.service import KvQueryClient, KvQueryServer
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, DoubleType, VarCharType
    from paimon_tpu_torch import Schema

    name = "serve_dedup_5M"
    path = os.path.join(work, name)
    dev = torch.device(device)
    lookups = global_registry().lookup_metrics()
    probes0 = lookups.counter(LOOKUP_NATIVE_PROBES).count
    fallbacks0 = lookups.counter(LOOKUP_NATIVE_FALLBACKS).count
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v", DoubleType())
              .column("name", VarCharType.string_type()).primary_key("id")
              .options({"bucket": str(SERVE_BUCKETS), "write-only": "true",
                        "parquet.enable.dictionary": "false"}).build())
    table = FileStoreTable.create(path, schema, device=device)

    def write():
        for b in batches:
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())
    rec.run(name, "write", rows, dev, write)
    oracle = ServeOracle(rows, batches)
    out = {"rows": rows, "live": int(oracle.live.sum())}
    served = FileStoreTable.load(path, device=device, dynamic_options={
        "service.lookup.refresh-interval": "1000"})
    rng = np.random.default_rng(3)
    timer = BuildTimer()
    server = KvQueryServer(served).start()
    try:
        with timer, KvQueryClient(address=server.address) as c:
            ids = rng.integers(0, rows, SERVE_BATCH)
            t0 = time.perf_counter()
            got = c.lookup([{"id": int(i)} for i in ids])
            out["cold_lookup_ms"] = (time.perf_counter() - t0) * 1000.0
            oracle.check(f"{name} cold lookup", ids, got)
            out["cold_builds"] = timer.summary()
            mark = timer.mark()
            ids = rng.integers(0, rows, 2048)
            got = rec.run(name, "warm-up lookup", len(ids), dev,
                          lambda: c.lookup([{"id": int(i)} for i in ids]))
            oracle.check(f"{name} warm-up", ids, got)
            out["warmup_builds"] = timer.summary(mark)
            q = server.query()
            n_files = sum(len(s.data_files) for s in q._splits.values())
            if len(q.store.keys()) != n_files:
                raise AssertionError(f"{name}: {len(q.store.keys())} SSTs "
                                     f"after the warm-up, {n_files} files")
            warm, single = [], []
            for _ in range(300):
                ids = rng.integers(0, rows, SERVE_BATCH)
                t0 = time.perf_counter()
                got = c.lookup([{"id": int(i)} for i in ids])
                warm.append((time.perf_counter() - t0) * 1000.0)
                oracle.check(f"{name} warm batch", ids, got)
            for _ in range(100):
                i = int(rng.integers(0, rows))
                t0 = time.perf_counter()
                got = c.lookup_row({"id": i})
                single.append((time.perf_counter() - t0) * 1000.0)
                oracle.check(f"{name} warm single", [i], [got])
            out["warm_batch_p50_ms"] = pct(warm, 50)
            out["warm_single_p50_ms"] = pct(single, 50)
        out["mixed"] = mixed = {}
        rec.run(name, "mixed 90/10", lambda: served_rows(mixed), dev,
                lambda: mixed.update(client_load(
                    server, oracle, clients, seconds, 0.1,
                    f"{name} mixed")))
        # the engine's warm probe over the same readers, native and numpy
        keys = [{"id": int(i)} for i in rng.integers(0, rows, SERVE_BATCH)]
        q.lookup(keys)

        def per_batch_us():
            reps, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < 0.5:
                q.lookup(keys)
                reps += 1
            return (time.perf_counter() - t0) / reps * 1e6
        out["engine_native_us_per_batch"] = per_batch_us()
        with force_python_probe():
            out["engine_numpy_us_per_batch"] = per_batch_us()
        out["engine_native_again_us_per_batch"] = per_batch_us()

        def serving_writer():
            wr = np.random.default_rng(5)
            sw = server.new_serving_writer()
            res = {"batches": 0, "delta_read_s": 0.0, "commit_s": 0.0}
            try:
                with KvQueryClient(address=server.address) as wc:
                    for k in range(SERVE_WRITER_ROWS // SERVE_WRITER_BATCH):
                        live = np.flatnonzero(oracle.live)
                        ids = wr.choice(live, SERVE_WRITER_BATCH,
                                        replace=False)
                        v = wr.random(len(ids))
                        tag = 100 + k
                        import pyarrow as pa
                        sw.write_arrow(pa.table({
                            "id": pa.array(ids, pa.int64()),
                            "v": pa.array(v, pa.float64()),
                            "name": pa.array(np.char.add(
                                f"w{k}-", (ids % 997).astype(str)))}))
                        oracle.upsert(ids, v, tag)
                        t0 = time.perf_counter()
                        for part in np.array_split(ids, 10):
                            oracle.check(f"{name} writer batch {k} before "
                                         f"commit", part, wc.lookup(
                                             [{"id": int(i)} for i in part]))
                        res["delta_read_s"] += time.perf_counter() - t0
                        t0 = time.perf_counter()
                        if sw.commit() is None:
                            raise AssertionError(f"{name}: writer batch "
                                                 f"{k} committed nothing")
                        res["commit_s"] += time.perf_counter() - t0
                        q.refresh()
                        for part in np.array_split(ids, 10):
                            oracle.check(f"{name} writer batch {k} after "
                                         f"commit", part, wc.lookup(
                                             [{"id": int(i)} for i in part]))
                        delta = server._delta.stats()
                        if delta["rows"]:
                            raise AssertionError(f"{name}: delta tier holds "
                                                 f"{delta} after the plan "
                                                 f"covers the commit")
                        res["batches"] += 1
            finally:
                sw.close()
            return res
        out["writer"] = rec.run(name, "serving writer", SERVE_WRITER_ROWS,
                                dev, serving_writer)
        out["writer"]["launches"] = rec.phases[-1]["launches_plain"]

        # full compaction while 8 clients keep reading
        old = {f.file_name for s in q._splits.values()
               for f in s.data_files}
        stop = threading.Event()
        answers, errors = [], []

        def reader(seed):
            r = np.random.default_rng(2000 + seed)
            try:
                with KvQueryClient(address=server.address) as rc:
                    while not stop.is_set():
                        ids = r.integers(0, rows, SERVE_BATCH)
                        answers.append((ids, rc.lookup(
                            [{"id": int(i)} for i in ids])))
            except Exception as e:      # noqa: BLE001 -- raised below
                errors.append(repr(e))
        threads = [threading.Thread(target=reader, args=(i,), daemon=True)
                   for i in range(8)]
        for t in threads:
            t.start()
        try:
            sid = rec.run(name, "compact", rows, dev,
                          lambda: served.copy({"write-only": "false"})
                          .compact(full=True))
            q.refresh()
            time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
        if sid is None or errors:
            raise AssertionError(f"{name} compaction: snapshot {sid}, "
                                 f"reader errors {errors[:3]}")
        for ids, got in answers:
            oracle.check(f"{name} during compaction", ids, got)
        stale = [k for k in q.store.keys() if any(f in k for f in old)]
        if stale:
            raise AssertionError(f"{name}: readers of compacted-away files "
                                 f"survive: {stale[:3]}")
        out["compaction"] = {"reads": len(answers),
                             "s": rec.phases[-1]["s"],
                             "launches": rec.phases[-1]["launches_plain"]}
        with KvQueryClient(address=server.address) as c:
            full = rec.run(name, "unbounded scan", out["live"], dev,
                           lambda: c.scan(limit=rows))
        oracle.check_scan(f"{name} unbounded scan", full, complete=True)
        out["unbounded_scan_s"] = rec.phases[-1]["s"]
        stats = server.stats()
    finally:
        server.stop()
    out["native_probes"] = lookups.counter(LOOKUP_NATIVE_PROBES).count \
        - probes0
    out["native_fallbacks"] = \
        lookups.counter(LOOKUP_NATIVE_FALLBACKS).count - fallbacks0
    out["server_lookup_p95_ms"] = stats["lookup_ms"]["p95"]
    out["handler_cpu_per_key_ms_p50"] = stats["lookup_cpu_per_key_ms"]["p50"]
    if out["native_probes"] <= 0 or out["native_fallbacks"]:
        raise AssertionError(f"{name}: native probes {out['native_probes']}, "
                             f"fallbacks {out['native_fallbacks']}")
    shutil.rmtree(path, ignore_errors=True)
    return out


def serve_agg(work: str, rec: Recorder, batches, rows: int, device,
              clients: int, seconds: float) -> dict:
    """serve_agg_5M: the same rows under aggregation (v sum), whose
    every /lookup takes the merged fallback; see `serving`."""
    import torch

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.service import KvQueryClient, KvQueryServer
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, DoubleType, VarCharType

    name = "serve_agg_5M"
    path = os.path.join(work, name)
    dev = torch.device(device)
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v", DoubleType())
              .column("name", VarCharType.string_type()).primary_key("id")
              .options({"bucket": str(SERVE_BUCKETS), "write-only": "true",
                        "parquet.enable.dictionary": "false",
                        "merge-engine": "aggregation",
                        "fields.v.aggregate-function": "sum"}).build())
    table = FileStoreTable.create(path, schema, device=device)

    def write():
        for b in batches:
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())
    rec.run(name, "write", rows, dev, write)
    oracle = ServeOracle(rows, batches, summed=True)
    out = {"rows": rows, "live": int(oracle.live.sum())}
    served = FileStoreTable.load(path, device=device, dynamic_options={
        "service.lookup.refresh-interval": "1000"})
    server = KvQueryServer(served).start()
    try:
        q = server.query()
        builds, read_split = [], q._read.read_split

        def timed_read(split):
            t0 = time.perf_counter()
            res = read_split(split)
            builds.append((split.bucket, t0, time.perf_counter(),
                           res.num_rows))
            return res
        q._read.read_split = timed_read
        # one key of each bucket from its own client thread at once
        from paimon_tpu_torch.core.bucket import FixedBucketAssigner
        import pyarrow as pa
        probe = np.arange(4096)
        bucket = FixedBucketAssigner(["id"], [BigIntType(False)],
                                     SERVE_BUCKETS).assign(
            pa.table({"id": pa.array(probe, pa.int64())}))
        firsts = [int(probe[np.flatnonzero(bucket == b)[0]])
                  for b in range(SERVE_BUCKETS)]
        answers, errors = {}, []

        def cold(i):
            try:
                with KvQueryClient(address=server.address) as c:
                    answers[i] = c.lookup_row({"id": i})
            except Exception as e:      # noqa: BLE001 -- raised below
                errors.append(repr(e))

        def cold_builds():
            threads = [threading.Thread(target=cold, args=(i,), daemon=True)
                       for i in firsts]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        rec.run(name, "cold merged builds", rows, dev, cold_builds)
        if errors or len(answers) != SERVE_BUCKETS:
            raise AssertionError(f"{name}: cold builds {errors[:3]}")
        for i, row in answers.items():
            oracle.check(f"{name} cold", [i], [row], rtol=1e-12)
        if sorted(b for b, *_ in builds) != list(range(SERVE_BUCKETS)):
            raise AssertionError(f"{name}: merged builds {builds}")
        # how many bucket builds ran at once
        edges = sorted([(t0, 1) for _, t0, _, _ in builds]
                       + [(t1, -1) for _, _, t1, _ in builds])
        overlap = max(np.cumsum([d for _, d in edges]))
        out["merged_build_s"] = {str(b): t1 - t0 for b, t0, t1, _ in builds}
        out["merged_rows"] = {str(b): n for b, _, _, n in builds}
        out["builds_at_once"] = int(overlap)
        out["cold_peak_gib"] = rec.phases[-1]["peak_gib"]
        out["cold_s"] = rec.phases[-1]["s"]
        if overlap < 2:
            raise AssertionError(f"{name}: the bucket builds did not "
                                 f"overlap ({builds})")
        out["cold_thread_launches"] = thread_launches(rec.capture, name)
        rng = np.random.default_rng(4)
        with KvQueryClient(address=server.address) as c:
            ids = rng.integers(0, rows, 2048)
            oracle.check(f"{name} warm-up", ids,
                         c.lookup([{"id": int(i)} for i in ids]),
                         rtol=1e-12)
        out["point_gets"] = gets = {}
        rec.run(name, "point gets", lambda: served_rows(gets), dev,
                lambda: gets.update(client_load(
                    server, oracle, clients, seconds, 0.0,
                    f"{name} point gets", rtol=1e-12)))
    finally:
        server.stop()
    shutil.rmtree(path, ignore_errors=True)
    return out


def serving(work: str, rec: Recorder, rows: int = SERVE_ROWS,
            device="cuda", clients: int = 64, seconds: float = 5.0,
            agg_seconds: float = 3.0) -> dict:
    """The serving plane on the card.

    serve_dedup_5M: benchmarks/serve_bench.py's table (id BIGINT NOT
    NULL key, v DOUBLE, name STRING; bucket=4, write-only, no parquet
    dictionary; 4 commits of rows / 4 ids uniform in [0, rows) from seed
    11) served by one KvQueryServer with a refresh interval of 1000 ms:
    the cold first /lookup of 8 keys, a 2048-key warm-up that builds
    every file's SST, 300 warm batches of 8 and 100 single gets on one
    keep-alive client, `clients` client threads for `seconds` (90% gets
    of 8 keys, 10% scan(limit=100)), the engine's warm probe native
    against numpy over the same readers, a serving writer's 100k
    upserts of live ids in batches of 10k (each read back through the
    delta tier before its commit and from the LSM after), a full
    compaction while 8 clients read, and one unbounded /scan.
    serve_agg_5M: the same rows under aggregation (v sum): 4 cold
    buckets built at once from 4 client threads, each a full
    merge-on-read on the card, a 2048-key warm-up, then `clients` client
    threads of point gets for `agg_seconds`.  Every answer is held
    against a numpy oracle; native probes must run and none fall back;
    the flush, the compaction, /scan and the merged builds must launch
    the winner-select kernel."""
    t0 = time.perf_counter()
    batches = serving_batches(rows)
    out = {"card": card_line() if device == "cuda" else None,
           "batch": SERVE_BATCH, "make_rows_s": time.perf_counter() - t0}
    out["dedup"] = serve_dedup(work, rec, batches, rows, device, clients,
                               seconds)
    launches = {p["phase"]: (p["launches_plain"], p["launches_ovc"])
                for p in rec.phases if p["table"] == "serve_dedup_5M"}
    for what in ("mixed 90/10", "serving writer", "compact"):
        if launches[what][0] == 0:
            raise AssertionError(f"serve_dedup_5M {what}: no launch of the "
                                 f"winner-select ({launches})")
    out["agg"] = serve_agg(work, rec, batches, rows, device, clients,
                           agg_seconds)
    ovc = sum(o for _, o in out["agg"]["cold_thread_launches"].values())
    from_workers = sum(o for t, (_, o) in
                       out["agg"]["cold_thread_launches"].items()
                       if t.startswith("paimon-serve"))
    if ovc == 0 or from_workers == 0:
        raise AssertionError(f"serve_agg_5M: the offset-value-code "
                             f"variant did not launch from the handler "
                             f"threads ({out['agg']['cold_thread_launches']})")
    out["launches"] = {f"{p['table']} {p['phase']}":
                       [p["launches_plain"], p["launches_ovc"]]
                       for p in rec.phases
                       if p["table"].startswith("serve_")}
    out["peak_gib"] = {f"{p['table']} {p['phase']}": p["peak_gib"]
                       for p in rec.phases if p["table"].startswith("serve_")}
    out["s"] = time.perf_counter() - t0
    return out


class DecodeTimer:
    """Seconds the device decode plane spends in each of its four steps
    (format/rawpage.py): host parse and decompression, the upload, the
    device expansion and the download.  For as long as it is entered it
    wraps the four step functions, synchronising the card before and
    after each call; scan threads overlap, so the sums can exceed the
    time they cover."""

    STEPS = {"_plan_chunk": "host_parse_s", "_upload_chunk": "upload_s",
             "_expand_chunk": "expand_s", "_download_chunk": "download_s"}

    def __init__(self):
        self.seconds = dict.fromkeys(self.STEPS.values(), 0.0)
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.seconds)

    def delta(self, before: dict) -> dict:
        now = self.snapshot()
        return {k: now[k] - before[k] for k in now}

    def _timed(self, field: str, fn):
        import torch

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            with self._lock:
                self.seconds[field] += time.perf_counter() - t0
            return out
        return call

    def __enter__(self):
        from paimon_tpu_torch.format import rawpage
        self._module = rawpage
        self._fns = {name: getattr(rawpage, name) for name in self.STEPS}
        for name, field in self.STEPS.items():
            setattr(rawpage, name, self._timed(field, self._fns[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._fns.items():
            setattr(self._module, name, fn)


def device_decode_dedup(path: str, rows: int, rec: Recorder, cols: dict,
                        win: np.ndarray, timer: DecodeTimer) -> dict:
    """dedup_bigint's directory as it stood after its 10 commits, loaded
    with read.device-decode=true: a merge-on-read scan, the streamed
    full compaction and a read back on the card, each held row for row
    against dedup_bigint's last-writer-wins oracle, with every file read
    through the device decode plane (no fallback) and the seconds of its
    four steps."""
    from paimon_tpu_torch.format import rawpage
    from paimon_tpu_torch.table import FileStoreTable

    name = "device_decode_dedup"
    table = FileStoreTable.load(path, dynamic_options={
        "read.device-decode": "true"})
    rawpage.DECODE_COUNTS.update(files=0, fallbacks=0)
    out = {}
    for what, fn in (("scan", table.to_arrow),
                     ("compact", lambda: table.compact(full=True)),
                     ("read", table.to_arrow)):
        before, files = timer.snapshot(), rawpage.DECODE_COUNTS["files"]
        got = rec.run(name, what, rows, table.device, fn)
        out[what] = {"rows_per_s": rec.phases[-1]["rows_per_s"],
                     "s": rec.phases[-1]["s"],
                     "files": rawpage.DECODE_COUNTS["files"] - files,
                     **timer.delta(before)}
        if what == "compact":
            if got is None:
                raise AssertionError(f"{name}: the full compaction "
                                     f"committed nothing")
        else:
            check_rows(f"{name} {what}", got, cols, win, "id")
        del got
    counts = dict(rawpage.DECODE_COUNTS)
    if counts["files"] == 0 or counts["fallbacks"] != 0:
        raise AssertionError(f"{name}: decode counts {counts}")
    out["decode_counts"] = counts
    for what, split in out.items():
        if what != "decode_counts":
            log(f"  {name} {what}: {split['files']} files through the "
                f"device decode plane; host parse and decompression "
                f"{split['host_parse_s']:.2f} s, upload "
                f"{split['upload_s']:.2f} s, device expand "
                f"{split['expand_s']:.2f} s, download "
                f"{split['download_s']:.2f} s (summed over threads)")
    shutil.rmtree(path, ignore_errors=True)
    return out


def device_decode_coverage(work: str, rows: int = 1 << 22,
                           seed: int = 29, device: str = "cuda") -> dict:
    """read_parquet_device on the card against pyarrow on ~4M rows of
    INT32, INT64, FLOAT, DOUBLE and DATE columns (dictionary pages on,
    1 value in 8 null, 4 row groups a file, several pages a chunk), a
    string-keyed table that must fall back (counted) and read the same,
    and fused_decode_merge at 2^24 on the card against its CPU run."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.format import rawpage
    from paimon_tpu_torch.fs import LocalFileIO
    from paimon_tpu_torch.ops.decode import fused_decode_merge
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, VarCharType

    rng = np.random.default_rng(seed)
    fio = LocalFileIO()
    rawpage.DECODE_COUNTS.update(files=0, fallbacks=0)
    files = 4
    per = rows // files
    out = {"rows": rows, "decode_s": 0.0, "pyarrow_s": 0.0}
    for k in range(files):
        def col(values, typ):
            return pa.array(values, typ, mask=rng.random(per) < 0.125)
        table = pa.table({
            "i32": col(rng.integers(-1 << 31, 1 << 31, per).astype(np.int32),
                       pa.int32()),
            "i64": col(rng.integers(0, 1000, per), pa.int64()),
            "f32": col(rng.random(per).astype(np.float32), pa.float32()),
            "f64": col(rng.integers(0, 50, per) / 4.0, pa.float64()),
            "day": col(rng.integers(0, 20_000, per).astype(np.int32),
                       pa.date32())})
        path = os.path.join(work, f"coverage-{k}.parquet")
        pq.write_table(table, path, compression="zstd",
                       row_group_size=per // 4, data_page_size=256 << 10)
        t0 = time.perf_counter()
        got = rawpage.read_parquet_device(fio, path, device=device)
        t1 = time.perf_counter()
        want = pq.read_table(path)
        out["decode_s"] += t1 - t0
        out["pyarrow_s"] += time.perf_counter() - t1
        if not got.equals(want):
            raise AssertionError(f"device_decode_coverage: file {k} differs "
                                 f"from pyarrow")
        os.unlink(path)
    if rawpage.DECODE_COUNTS != {"files": files, "fallbacks": 0}:
        raise AssertionError(f"device_decode_coverage: decode counts "
                             f"{rawpage.DECODE_COUNTS}")

    schema = (Schema.builder().column("name", VarCharType(nullable=False))
              .column("v1", BigIntType()).primary_key("name")
              .options({"bucket": "1", "read.device-decode": "true"})
              .build())
    t = FileStoreTable.create(os.path.join(work, "coverage-strings"), schema,
                              device=device)
    wb = t.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(pa.table({
            "name": pa.array([f"key-{i}" for i in range(1 << 16)]),
            "v1": pa.array(np.arange(1 << 16), pa.int64())}))
        wb.new_commit().commit(w.prepare_commit())
    got = t.to_arrow()
    want = t.copy({"read.device-decode": "false"}).to_arrow()
    if not got.equals(want) or rawpage.DECODE_COUNTS["fallbacks"] != 1:
        raise AssertionError(f"device_decode_coverage: the string-keyed "
                             f"table did not fall back once and read the "
                             f"same ({rawpage.DECODE_COUNTS})")
    t.file_io.delete(t.path, recursive=True)

    n = 1 << 24
    keys = rng.integers(-1 << 40, 1 << 40, n // 2).repeat(2)
    rng.shuffle(keys)
    seq = rng.permutation(n).astype(np.int64)
    host = [torch.from_numpy(keys.view(np.uint8).copy()),
            torch.from_numpy(seq.view(np.uint8).copy()),
            torch.zeros(n, dtype=torch.int32)]
    card = fused_decode_merge(*(x.to(device) for x in host))
    cpu = fused_decode_merge(*host)
    for what, a, b in zip(("perm", "winner", "packed"), card, cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"fused_decode_merge at 2^24: {what} "
                                 f"card != cpu")
    out["decode_counts"] = dict(rawpage.DECODE_COUNTS)
    log(f"  device_decode_coverage: {files} files of {per} rows (INT32, "
        f"INT64, FLOAT, DOUBLE, DATE; dictionary on, 1 in 8 null) equal to "
        f"pyarrow, no fallback (card {out['decode_s']:.2f} s, pyarrow "
        f"{out['pyarrow_s']:.2f} s); the string-keyed table fell back once "
        f"and read the same; fused_decode_merge at 2^24: card == cpu")
    return out


def route_inputs(n: int, runs: int = 10, seed: int = 37):
    """The main path's merge shapes: packed BIGINT keys (ids uniform in
    [0, n/2), bench.py's duplicate ratio) in `runs` (key, seq)-sorted
    runs, oldest first: (lanes u32[n, 2], seq, packed u64, run_starts)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(n // 2, 1), n)
    starts = np.linspace(0, n, runs + 1).astype(np.int64)
    for a, b in zip(starts[:-1], starts[1:]):
        ids[a:b] = np.sort(ids[a:b])
    packed = ids.view(np.uint64) ^ np.uint64(1 << 63)
    lanes = np.stack([(packed >> np.uint64(32)).astype(np.uint32),
                      (packed & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                     axis=1)
    return lanes, np.arange(n, dtype=np.int64), packed, starts


# route: (switches, winners_only, pass packed, pass run_starts, full order)
ROUTES = {
    "device full": (("PAIMON_FORCE_DEVICE_SORT",), False, True, False, True),
    "device full, run codes": (("PAIMON_FORCE_DEVICE_SORT",), False, True,
                               True, True),
    "device packed": (("PAIMON_FORCE_DEVICE_SORT",), True, True, False,
                      False),
    "bitmask": (("PAIMON_FORCE_BITMASK_SORT",), True, True, False, False),
    "host native fast": (("PAIMON_FORCE_HOST_SORT",), True, True, False,
                         False),
    "host numpy fast": (("PAIMON_FORCE_HOST_SORT", "PAIMON_DISABLE_NATIVE"),
                        True, True, False, False),
    "host general": (("PAIMON_FORCE_HOST_SORT",), False, False, False, True),
    "host ovc": (("PAIMON_FORCE_HOST_SORT",), False, True, True, True),
}
ROUTE_SWITCHES = ("PAIMON_FORCE_DEVICE_SORT", "PAIMON_FORCE_HOST_SORT",
                  "PAIMON_FORCE_BITMASK_SORT", "PAIMON_DISABLE_NATIVE",
                  "PAIMON_DISABLE_OVC")
HOST_GENERAL_MAX = 1 << 22


class switched:
    """Sets the given routing switches for the length of a block."""

    def __init__(self, *names):
        self.names = names

    def __enter__(self):
        self.saved = {k: os.environ.pop(k, None) for k in ROUTE_SWITCHES}
        for name in self.names:
            os.environ[name] = "1"

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def model_pick(n: int, overlapped: bool) -> str:
    """The route device_sorted_winners' cost model takes for a
    winners-only merge of `n` packed BIGINT keys on the card."""
    from paimon_tpu_torch.ops import merge
    if merge._bitmask_device_pays(n, 2, overlapped):
        return "bitmask"
    return "device" if merge._device_path_pays(n, 2, True, True) \
        else "host"


def measure_constants(dev) -> dict:
    """The cost model's rates on this machine: the device's sort passes
    plus the winner-select kernel on resident data (2 lanes, 2^24), and
    the host's C radix fast route, numpy argsort fast route and general
    lexsort route at 2^22, each the best of 3 host-clock runs."""
    import torch

    from paimon_tpu_torch.ops import merge

    def best(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return min(times)

    n = 1 << 24
    lanes, seq, packed, _ = route_inputs(n)
    args = merge._upload(lanes, seq, None, packed, dev)
    out = {"device_sort_rows_per_s": n / best(
        lambda: merge.segmented_merge_body(*args, "last", 2))}
    del args
    m = HOST_GENERAL_MAX
    lanes, seq, packed, _ = route_inputs(m)
    out["host_fast_native_rows_per_s"] = m / best(
        lambda: merge._host_sorted_winners_fast(lanes, seq, "last", packed))
    with switched("PAIMON_DISABLE_NATIVE"):
        out["host_fast_numpy_rows_per_s"] = m / best(
            lambda: merge._host_sorted_winners_fast(lanes, seq, "last",
                                                    packed))
    out["host_general_rows_per_s"] = m / best(
        lambda: merge._host_sorted_winners(lanes, seq, "last", 2))
    log("cost-model rates measured here: " + ", ".join(
        f"{k} {v:,.0f}" for k, v in out.items()))
    return out


def merge_routes(dedup_winner_frac: float, device: str = "cuda",
                 shapes=(14, 20, 22)) -> dict:
    """Every route of device_sorted_winners at the main path's merge
    shapes (2 lanes, packed BIGINT keys, 10 sorted runs) at 2^14, 2^20
    and 2^22 (2^24 until PR 8): the same winner rows
    in key order on every route, and the full routes also the same perm
    and prev on the real rows; each route timed on the host clock (best
    of 3, one run at 2^24 on the host routes), the measured link rates
    at 8 MiB (the model's) and 256 MiB, and the model's pick at each
    shape, at the winner fraction 1.0 of a fresh process and at the
    dedup table's."""
    import torch

    from paimon_tpu_torch import native
    from paimon_tpu_torch.ops import merge

    if native.load() is None:
        raise AssertionError("merge_routes: the native library did not load")
    dev = torch.device(device)
    links = {f"{size >> 20}MiB": merge.link_bandwidth(dev, size)
             for size in (8 << 20, 256 << 20)}
    for k, (h2d, d2h) in links.items():
        log(f"link at {k}: host to device {h2d / 1e9:.2f} GB/s, device to "
            f"host {d2h / 1e9:.2f} GB/s (pageable)")
    saved = (merge._LINK_BW, dict(merge._WINNER_FRAC))
    merge._LINK_BW = links["8MiB"]
    out = {"links": links, "constants": measure_constants(dev),
           "shapes": {}}
    for log2 in shapes:
        n = 1 << log2
        lanes, seq, packed, starts = route_inputs(n)
        picks = {}
        for frac_name, frac in (("1.0", None),
                                ("dedup", dedup_winner_frac)):
            merge._WINNER_FRAC.update(
                num=0.0 if frac is None else frac * n,
                den=0.0 if frac is None else float(n))
            for overlapped in (False, True):
                picks[f"frac {frac_name}, overlapped {overlapped}"] = \
                    model_pick(n, overlapped)
        times, winners, full = {}, {}, {}
        for route, (switches, winners_only, with_packed, with_runs,
                    full_order) in ROUTES.items():
            if route == "host general" and n > HOST_GENERAL_MAX:
                continue
            reps = 1 if n >= 1 << 24 and route.startswith("host") else 3
            best = None
            with switched(*switches):
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    perm, winner, prev = merge.device_sorted_winners(
                        lanes, seq, "last", winners_only=winners_only,
                        packed=packed if with_packed else None,
                        run_starts=starts if with_runs else None,
                        device=dev)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
            times[route] = best
            real = perm < n
            winners[route] = perm[winner & real]
            if full_order:
                full[route] = (perm[real], np.asarray(prev)[real])
        first = winners["device packed"]
        for route, w in winners.items():
            if not np.array_equal(w, first):
                raise AssertionError(f"merge_routes n=2^{log2}: {route}'s "
                                     f"winners differ from device packed's")
        base = full["device full"]
        for route, (p, q) in full.items():
            if not (np.array_equal(p, base[0]) and np.array_equal(q, base[1])):
                raise AssertionError(f"merge_routes n=2^{log2}: {route}'s "
                                     f"perm or prev differs from device "
                                     f"full's")
        out["shapes"][f"2^{log2}"] = {"seconds": times, "model": picks}
        log(f"merge routes at n=2^{log2} ({len(first)} winners): equal on "
            f"every route; " + ", ".join(f"{r} {t * 1e3:.2f} ms"
                                         for r, t in times.items())
            + "; model picks " + ", ".join(f"{k}: {v}"
                                           for k, v in picks.items()))
    merge._LINK_BW, frac = saved
    merge._WINNER_FRAC.update(frac)
    return out


# the 100M-row tables: none of their merge phases may take host routes only
BIG_TABLES = ("dedup_bigint", "agg_sum_max_orc", "device_decode_dedup")


def main_path(rows: int, phases: list, capture: LaunchCapture,
              reducer: ReduceTimer, timer: ChangelogTimer,
              c5: dict, decode_timer: DecodeTimer, decoded: dict,
              mesh: dict, served: dict, bucketed: dict) -> tuple:
    import pyarrow as pa

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.ops import kernels
    from paimon_tpu_torch.types import BigIntType, VarCharType

    def counts():
        return (kernels.EQ_NEXT_LAUNCHES - kernels.EQ_NEXT_OVC_LAUNCHES,
                kernels.EQ_NEXT_OVC_LAUNCHES)

    totals = [0, 0]
    work = tempfile.mkdtemp(prefix="paimon-chip-smoke-")
    rec = Recorder(counts, phases, capture, reducer)

    def path(name, fn):
        """One path of the main path on the card: the launch counts set
        to 0 just before it and read just after."""
        kernels.EQ_NEXT_LAUNCHES = 0
        kernels.EQ_NEXT_OVC_LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        launched = counts()
        totals[0] += launched[0]
        totals[1] += launched[1]
        log(f"  {name}: launches plain={launched[0]} ovc={launched[1]} "
            f"in {time.perf_counter() - t0:.1f} s")
        return out

    def drive(name, schema, batches, check, **kw):
        def run():
            out = drive_table(os.path.join(work, name), schema, batches,
                              check, rec, **kw)
            shutil.rmtree(os.path.join(work, name), ignore_errors=True)
            return out
        return path(name, run)

    try:
        t0 = time.perf_counter()
        batches = bigint_batches(rows)
        log(f"batches of {rows} rows made in {time.perf_counter() - t0:.1f} "
            f"s")
        cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
                for c in ("id", "v1", "v2", "v3")}
        t0 = time.perf_counter()
        order = np.argsort(cols["id"], kind="stable")
        win = last_writer_oracle(cols["id"], order)
        agg_want = agg_oracle(cols, order)
        del order
        log(f"numpy oracles of {rows} rows: {time.perf_counter() - t0:.1f} s")
        base = {"bucket": "1", "write-only": "true",
                "parquet.enable.dictionary": "false"}

        decode_dir = os.path.join(work, "device_decode_dedup")

        def copy_dedup():
            t0 = time.perf_counter()
            shutil.copytree(os.path.join(work, "dedup_bigint"), decode_dir)
            log(f"  dedup_bigint copied after its commits for "
                f"device_decode_dedup in {time.perf_counter() - t0:.1f} s")

        with capture, reducer, timer, decode_timer:
            drive("dedup_bigint", bigint_schema(base), batches,
                  lambda what, got: check_rows(what, got, cols, win, "id"),
                  after_write=copy_dedup)
            # the same files read through the device decode plane
            decoded["dedup"] = path("device_decode_dedup",
                                    lambda: device_decode_dedup(
                                        decode_dir, rows, rec, cols, win,
                                        decode_timer))
            decoded["dedup_winner_frac"] = len(win) / rows
            decoded["pyarrow_rows_per_s"] = {
                p["phase"]: p["rows_per_s"] for p in phases
                if p["table"] == "dedup_bigint"}
            # BASELINE config 4 (bench.py BENCH_SHAPE=config4): the same
            # batches under aggregation sum/max, ORC runs at level 0,
            # parquet after compaction
            drive("agg_sum_max_orc", bigint_schema({
                **base, "merge-engine": "aggregation",
                "fields.v1.aggregate-function": "sum",
                "fields.v2.aggregate-function": "max",
                "fields.v3.aggregate-function": "max",
                "file.format": "parquet",
                "file.format.per.level": "0:orc"}), batches,
                lambda what, got: check_agg(what, got, agg_want))
            del batches, cols, win, agg_want

            s_batches = string_key_batches()
            s_cols = {"name": pa.concat_arrays(
                          [b.column("name").combine_chunks()
                           for b in s_batches]),
                      "v1": np.concatenate([b.column("v1").to_numpy()
                                            for b in s_batches])}
            s_win = last_writer_oracle(np.asarray(
                s_cols["name"].to_pylist(), dtype=object))
            s_schema = (Schema.builder().column("name", VarCharType(False))
                        .column("v1", BigIntType()).primary_key("name")
                        .options(base).build())
            drive("string_key_coverage", s_schema, s_batches,
                  lambda what, got: check_rows(what, got, s_cols, s_win,
                                               "name"))

            pu_keys = COVERAGE_KEYS
            pu_schema, pu_batches, pu_kinds = partial_update_table(pu_keys)

            def pu_check(what, got):
                # a scan folds a DELETE into its key's row; compaction
                # then drops keys whose last version is a DELETE, as the
                # reference does
                if got.column_names != [f.name for f in pu_schema.fields] \
                        or not 0 < got.num_rows <= pu_keys or \
                        ("scan" in what and got.num_rows != pu_keys):
                    raise AssertionError(f"{what}: {got.num_rows} rows")
            card = drive("partial_update_coverage", pu_schema, pu_batches,
                         pu_check, row_kinds=pu_kinds, repeat_scan=True)
            # the same table run by the port on the CPU, as its reference
            cpu = drive_table(os.path.join(work, "partial_update_cpu"),
                              pu_schema, pu_batches, pu_check, rec,
                              row_kinds=pu_kinds, device="cpu")
            # BASELINE config 5: changelog-producer=lookup
            c5.update(path("changelog_lookup_upsert",
                           lambda: changelog_lookup_upsert(
                               work, rec, timer, **c5)))
            path("changelog_producers_coverage",
                 lambda: changelog_producers_coverage(work, rec))
            decoded["coverage"] = path("device_decode_coverage",
                                       lambda: device_decode_coverage(work))
            # many buckets compacted as lanes of one batched merge, and
            # the all_to_all rescale
            mesh.update(path("mesh_compaction",
                             lambda: mesh_compaction(work, rec)))
            # point lookups and the one-replica query service
            served.update(path("serving", lambda: serving(work, rec)))
            # primary-key tables in Paimon's default (dynamic), postpone
            # and cross-partition bucket modes, and schema evolution
            bucketed.update(path("bucket_modes",
                                 lambda: bucket_modes(work, rec)))
        for what in ("scan", "read"):
            same_tables(f"partial_update_coverage {what}: card vs cpu",
                        card[what], cpu[what], approx=("fsum",), rtol=1e-12)
        again = card["scan again"].column("fsum").combine_chunks()
        if card["scan"].column("fsum").combine_chunks().to_numpy(
                zero_copy_only=False).tobytes() != again.to_numpy(
                zero_copy_only=False).tobytes():
            raise AssertionError("partial_update_coverage: the float sum "
                                 "differs between two scans on the card")
        log("partial_update_coverage: card == cpu (fsum within rtol 1e-12); "
            "fsum bit-identical across two scans on the card")
        log(f"main path launches: plain={totals[0]} ovc={totals[1]}; by "
            f"(table, variant, lanes, n): {sorted(capture.calls.items())}; "
            f"inputs copied aside in {capture.seconds:.2f} s (not in phase "
            f"times)")
        for p in phases:
            if p["device"] == "cuda" and p["phase"] in ("write", "scan",
                                                         "compact") and \
                    p["launches_plain"] + p["launches_ovc"] == 0:
                raise AssertionError(f"{p['table']} {p['phase']}: no kernel "
                                     f"launch")
            if p["table"] in BIG_TABLES and p["device"] == "cuda" and \
                    p["phase"] in ("write", "scan", "compact") and \
                    p["routes"]["device"] == 0:
                raise AssertionError(f"{p['table']} {p['phase']}: host merge "
                                     f"routes only ({p['routes']})")
            if p["table"] == "agg_sum_max_orc" and \
                    p["phase"] in ("scan", "compact") and \
                    p["launches_ovc"] == 0:
                raise AssertionError(f"agg_sum_max_orc {p['phase']}: the "
                                     f"offset-value-code variant did not "
                                     f"launch")
        for caller in ("merge", "diff ranks"):
            if not any(k[0] == "changelog_lookup_upsert" and k[4] == caller
                       for k in capture.calls):
                raise AssertionError(f"changelog_lookup_upsert: no kernel "
                                     f"launch from the {caller}")
        if totals[0] == 0 or totals[1] == 0:
            raise AssertionError(f"a kernel was not launched on the main "
                                 f"path: {totals}")
        return tuple(totals)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000,
                    help="rows of the main-path table (10 commits)")
    ap.add_argument("--c5-keys", type=int, default=C5_KEYS,
                    help="keys of the config-5 bucket")
    ap.add_argument("--c5-commits", type=int, default=C5_COMMITS,
                    help="streaming commits of config 5")
    ap.add_argument("--c5-rows-per-commit", type=int, default=C5_PER_COMMIT,
                    help="upserts in each config-5 commit")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import paimon_tpu_torch  # noqa: F401  (fails outside a checkout)
    from paimon_tpu_torch import native
    from paimon_tpu_torch.ops import kernels

    log(card_line())
    t_start = time.perf_counter()
    log(f"kernel build: {kernels.build():.2f} s (nvcc, sm_90a)")
    t0 = time.perf_counter()
    if native.load() is None:
        raise AssertionError("the host merge routes' C library did not "
                             "build or load")
    log(f"C library build and load: {time.perf_counter() - t0:.2f} s "
        f"({native.load()._name})")

    with switched("PAIMON_FORCE_DEVICE_SORT"):
        check_sorted_winners()
    check_segment_reductions()
    phases: list = []
    capture = LaunchCapture()
    c5 = {"keys": args.c5_keys, "commits": args.c5_commits,
          "per_commit": args.c5_rows_per_commit}
    decoded: dict = {}
    mesh: dict = {}
    served: dict = {}
    bucketed: dict = {}
    launches = main_path(args.rows, phases, capture, ReduceTimer(),
                         ChangelogTimer(), c5, DecodeTimer(), decoded, mesh,
                         served, bucketed)
    k1 = KernelStats("eq_next_mask", "paimon_tpu/ops/pallas_kernels.py:72")
    k2 = KernelStats("eq_next_mask_ovc",
                     "paimon_tpu/ops/pallas_kernels.py:72")
    t0 = time.perf_counter()
    check_kernels(capture, k1, k2)
    log(f"kernel checks at the main path's shapes: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"edge sizes: {check_edges()} cases exact (sizes {EDGE_SIZES}, "
        f"lanes {EDGE_LANES}, aligned and shifted by 4 bytes) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"lane stride: {check_seg_edges()} cases exact and equal to "
        f"separate 1-D calls (B {SEG_BATCHES}, N {SEG_ROWS}, L "
        f"{SEG_LANES}, random and all-equal lanes) in "
        f"{time.perf_counter() - t0:.1f} s")

    c5["joint_ranks"] = check_joint_ranks()
    t0 = time.perf_counter()
    routes = merge_routes(decoded["dedup_winner_frac"])
    log(f"merge routes: {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    # again at the end, so a reader of the output's tail has it too
    log(card_line())
    print(json.dumps({"changelog_lookup_upsert": c5}))
    print(json.dumps({"device_decode": decoded}))
    print(json.dumps({"mesh_compaction": mesh}))
    print(json.dumps({"serving": served}))
    print(json.dumps({"merge_routes": routes}))
    print(json.dumps({"bucket_modes": bucketed}))
    print(json.dumps({"phases": phases}))
    print(json.dumps({"kernels": [k1.record(launches[0]),
                                  k2.record(launches[1])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
