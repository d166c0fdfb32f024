#!/usr/bin/env python
"""Proof that the mapping and calling path runs on one NVIDIA GPU and
agrees byte for byte with the host oracle there.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # reads-sharded mapping on 4 cards
                                        # against the same run on 1 card

Phases (any failure ends the run with a non-zero exit and no result line):
  1. gate: JAX's default backend must be "gpu"; prints the card's name
     and power limit (nvidia-smi), which every later line repeats.
  2. kernel: ops/sw_cuda.sw_align_x_cuda against ops/sw2.sw_align_x at
     B=16384, M=112, N=144 (bisulfite off and on), element for element;
     warm median times of both.
  3. bacterial mapping: 4.6 Mb genome, 100k pairs of 100 bp through
     run_mapper(device=True) and the host oracle (device=False);
     pileup, indel, summary and both .mfiles must be byte-equal.
     Compile seconds cold and from the cache, and XLA's memory analysis
     of the fused step.
  4. chromosome-scale mapping: 47 Mb genome, 50k pairs (quartered-key
     probe), the same comparison.
  5. caller: 3-sample 30x cohort with the default config,
     host_screen=False and device_screen=False; .base, .snp and .dist
     byte-equal across the three.  Then the f32 phase-1 margins from
     the card against a float64 NumPy evaluation on >= 1e5 UNRES sites,
     and one phase-1 dispatch+fetch round trip.

The last line is {"ok": true, "device": {...}} as JAX reports the device.
Inputs come from bench.py's generators with fixed seeds and are cached
in .bench/smoke/ (git-ignored).  Everything runs in this one process, so
one JAX client holds the card(s).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SMOKE_DIR = os.path.join(REPO, ".bench", "smoke")
MAP_ARGS = dict(paired=True, max_dist=500, min_dist=0, min_align=0.9)
CARD = "card not identified"


def say(phase: str, **numbers) -> None:
    """One result line: the card's identity, the phase, its numbers."""
    print(f"[{CARD}] {phase}: {json.dumps(numbers, default=str)}",
          flush=True)


class CompileClock:
    """Seconds XLA spends compiling programs (or loading them from the
    persistent cache), and persistent-cache hits/misses.  Tracing and
    lowering are left out: their events nest for nested jits, so their
    durations would count twice.

    ``cold_compile_s`` is what the same programs cost with no cache: the
    compiles of cache misses plus, for each hit, the compile time stored
    with the cache entry.  ``cache_load_s`` is the hits' load time."""

    def __init__(self):
        import jax.monitoring as mon
        self.seconds = 0.0
        self.saved = 0.0
        self.load = 0.0
        self.hits = 0
        self.misses = 0
        mon.register_event_duration_secs_listener(self._duration)
        mon.register_event_listener(self._event)

    def _duration(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration
        elif event == "/jax/compilation_cache/compile_time_saved_sec":
            self.saved += duration
        elif event == "/jax/compilation_cache/cache_retrieval_time_sec":
            self.load += duration

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def snapshot(self):
        return (self.seconds, self.saved, self.load, self.hits, self.misses)

    def since(self, snap):
        compile_s = self.seconds - snap[0]
        return dict(compile_s=round(compile_s, 3),
                    cold_compile_s=round(compile_s + self.saved - snap[1], 3),
                    cache_load_s=round(self.load - snap[2], 3),
                    cache_hits=self.hits - snap[3],
                    cache_misses=self.misses - snap[4])


def warm_median(fn, reps: int = 5) -> float:
    """Median seconds of ``fn()`` (which must block) after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# --------------------------------------------------------------------------
# phase 2: the SW align kernel against the XLA scan

def make_sw_inputs(rng, B: int, N: int, M: int):
    """Realistic windows: each read is its window's middle with ~2%
    substitutions, an occasional 1-3 base indel and rare N bases, at
    read lengths 90..M; windows are (B, N) xcodes (0-3 bases, 4 = N)."""
    rlens = rng.integers(max(M - 22, 1), M + 1, B).astype(np.int32)
    refs = rng.integers(0, 4, (B, N)).astype(np.uint8)
    reads = rng.integers(0, 4, (B, M)).astype(np.uint8)
    blens = np.zeros(B, np.int32)
    for b in range(B):
        L = int(rlens[b])
        pre = int(rng.integers(0, 11))
        src = refs[b, pre:pre + L + 4].copy()
        if rng.random() < 0.3:
            p = int(rng.integers(5, max(6, L - 5)))
            k = int(rng.integers(1, 4))
            src = (np.concatenate([src[:p], src[p + k:]])
                   if rng.random() < 0.5 else
                   np.concatenate([src[:p], rng.integers(0, 4, k)
                                   .astype(np.uint8), src[p:]]))
        read = src[:L]
        sub = rng.random(len(read)) < 0.02
        read[sub] = rng.integers(0, 4, int(sub.sum()))
        reads[b, :len(read)] = read
        blens[b] = min(N, pre + L + int(rng.integers(0, 11)))
    reads = np.where(rng.random((B, M)) < 0.003, 4, reads).astype(np.uint8)
    refs = np.where(rng.random((B, N)) < 0.002, 4, refs).astype(np.uint8)
    return refs, blens, reads, rlens


def kernel_check(align, B: int, M: int, N: int, bisulfite: bool,
                 seed: int = 0, reps: int = 5) -> dict:
    """Compare ``align`` (sw2.sw_align_x's signature) with the XLA scan
    element for element; returns both warm median times."""
    import jax
    import jax.numpy as jnp
    from pecaller_tpu.ops import sw2

    rng = np.random.default_rng(seed)
    args = [jnp.asarray(x) for x in make_sw_inputs(rng, B, N, M)]
    got = jax.block_until_ready(align(*args, bisulfite=bisulfite,
                                      n_rows=N))
    want = jax.block_until_ready(sw2.sw_align_x(*args, bisulfite=bisulfite,
                                                n_rows=N))
    for name, g, w in zip(("score", "bk", "bi", "tie"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        bad = np.flatnonzero(g != w)
        if len(bad):
            raise AssertionError(
                f"{name}: {len(bad)} of {B} differ, first at {bad[0]}: "
                f"{g[bad[0]]} vs {w[bad[0]]}")
    t_k = warm_median(lambda: jax.block_until_ready(
        align(*args, bisulfite=bisulfite, n_rows=N)), reps)
    t_x = warm_median(lambda: jax.block_until_ready(
        sw2.sw_align_x(*args, bisulfite=bisulfite, n_rows=N)), reps)
    return dict(B=B, M=M, N=N, bisulfite=bisulfite, equal=True,
                kernel_ms=round(1e3 * t_k, 3), xla_ms=round(1e3 * t_x, 3),
                ties=int(np.asarray(want[3]).sum()))


# --------------------------------------------------------------------------
# phases 3-4: mapping against the host oracle

def map_artifacts(out_dir: str, tag: str) -> dict:
    """The artifacts a mapping run wrote, decompressed, by name."""
    base = os.path.join(out_dir, tag)
    arts = {}
    for ext in (".pileup.gz", ".indel.txt.gz"):
        with gzip.open(base + ext, "rb") as f:
            arts[ext[:-3]] = f.read()
    for ext in (".summary.txt", ".r1.mfile", ".r2.mfile"):
        with open(base + ext, "rb") as f:
            arts[ext] = f.read()
    return arts


def assert_equal_artifacts(a: dict, b: dict, what: str) -> None:
    for name in a:
        if a[name] != b[name]:
            x, y = a[name], b[name]
            n = min(len(x), len(y))
            first = next((i for i in range(n) if x[i] != y[i]), n)
            raise AssertionError(
                f"{what}: {name} differs ({len(x)} vs {len(y)} bytes, "
                f"first difference at byte {first})")


def step_memory(eng) -> list:
    """XLA's memory analysis of each single-batch fused step ``eng``
    compiled.  The step is lowered again for its shapes, so its compile
    is a cache hit when the persistent cache holds it."""
    import jax
    sds = lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)  # noqa: E731
    fixed = [eng.dev_counts, *eng._dnbr.args, eng._gcode, eng._gmask,
             eng._ist_dev, eng._st_pad_dev]
    report = []
    for key, fn in eng._fns.items():
        if len(key) != 5:       # K-batch scan programs
            continue
        B, M, N, s_max, mr = key
        one = eng._prep_end2(np.zeros((B, M), np.uint8),
                             np.full(B, M, np.int64), B, M, s_max)
        ins = [np.concatenate([x, x]) for x in one] if eng.paired else one
        t0 = time.perf_counter()
        ma = fn.lower(*map(sds, fixed + list(ins))).compile() \
            .memory_analysis()
        report.append(dict(
            B=B, M=M, N=N, s_max=s_max,
            relower_compile_s=round(time.perf_counter() - t0, 3),
            **{k: getattr(ma, k + "_in_bytes") for k in (
                "argument_size", "output_size", "alias_size", "temp_size",
                "generated_code_size")}))
    return report


def run_map(data_dir: str, sdx: str, out_dir: str, tag: str, *,
            device: bool, mesh_shards: int | None, nthreads: int,
            clock: CompileClock | None) -> dict:
    """One run_mapper call on data_dir's r1/r2.fastq; the .mfiles are
    moved next to the other artifacts under ``tag``."""
    from pecaller_tpu.mapper import MapperConfig, run_mapper

    r1 = os.path.join(data_dir, "r1.fastq")
    r2 = os.path.join(data_dir, "r2.fastq")
    cfg = MapperConfig(out_base=os.path.join(out_dir, tag),
                       sdx_path=os.path.join(data_dir, sdx),
                       files1=[r1], files2=[r2], nthreads=nthreads,
                       device=device, mesh_shards=mesh_shards, **MAP_ARGS)
    snap = clock.snapshot() if clock else None
    t0 = time.perf_counter()
    eng = run_mapper(cfg)
    wall = time.perf_counter() - t0
    for f, tail in ((r1, ".r1.mfile"), (r2, ".r2.mfile")):
        os.replace(f + ".mfile", os.path.join(out_dir, tag + tail))
    reads = 2 * int(eng.stats.mate_counts.sum())
    res = dict(run=tag, reads=reads, wall_s=round(wall, 3))
    if device:
        res.update(clock.since(snap))
        busy = wall - res["compile_s"]
        res["reads_per_s_excl_compile"] = round(reads / busy, 1)
        res["n_fallback"] = int(eng.n_fallback)
        res["n_tiefix"] = int(eng.n_tiefix)
        mt = eng.mesh_timing
        if mt["batches"]:
            res["dispatch_ms_per_batch"] = round(
                1e3 * mt["dispatch_s"] / mt["batches"], 3)
            res["fetch_ms_per_batch"] = round(
                1e3 * mt["fetch_s"] / mt["batches"], 3)
        if mesh_shards == 1:
            res["fused_step"] = step_memory(eng)
    else:
        res["reads_per_s"] = round(reads / wall, 1)
    return res


def map_parity(data_dir: str, sdx: str, out_dir: str, runs, *,
               nthreads: int, clock: CompileClock | None) -> list:
    """Run each (tag, device, mesh_shards) of ``runs``; every run's
    artifacts must equal the first run's byte for byte."""
    os.makedirs(out_dir, exist_ok=True)
    results, ref = [], None
    for tag, device, mesh_shards in runs:
        results.append(run_map(data_dir, sdx, out_dir, tag, device=device,
                               mesh_shards=mesh_shards, nthreads=nthreads,
                               clock=clock))
        arts = map_artifacts(out_dir, tag)
        if ref is None:
            ref = (tag, arts)
        else:
            assert_equal_artifacts(ref[1], arts, f"{tag} vs {ref[0]}")
    return results


# --------------------------------------------------------------------------
# phase 5: caller

CALLER_RUNS = (("default", {}), ("device_phase0", {"host_screen": False}),
               ("native", {"device_screen": False}))


def caller_artifacts(out_base: str) -> dict:
    with gzip.open(out_base + ".base.gz", "rb") as f:
        arts = {".base": f.read()}
    for ext in (".snp", ".dist"):
        with open(out_base + ext, "rb") as f:
            arts[ext] = f.read()
    return arts


def caller_parity(cohort_dir: str, out_dir: str, nthreads: int) -> list:
    """run_caller three ways on the cohort; artifacts byte-equal.  One
    untimed default run first fills the per-process screen tables and
    the page cache, so no timed run pays them."""
    from pecaller_tpu.caller import CallerConfig, run_caller

    os.makedirs(out_dir, exist_ok=True)
    results, ref = [], None
    for tag, kw in (("warm-up", {}),) + CALLER_RUNS:
        cfg = CallerConfig(pileup_ext="pileup",
                           sdx_path=os.path.join(cohort_dir, "g.sdx"),
                           out_base=os.path.join(out_dir, tag),
                           prob_to_call=0.95, theta=0.001, haploid=False,
                           directory=cohort_dir, nthreads=nthreads, **kw)
        if tag == "warm-up":
            run_caller(cfg)
            continue
        t0 = time.perf_counter()
        r = run_caller(cfg)
        wall = time.perf_counter() - t0
        results.append(dict(
            run=tag, sites=int(r["n_sites"]), wall_s=round(wall, 3),
            sites_per_s=round(r["n_sites"] / wall, 1),
            device_sites_phase0=int(r["device_sites_phase0"]),
            device_sites_phase1=int(r["device_sites_phase1"])))
        arts = caller_artifacts(cfg.out_base)
        if ref is None:
            ref = (tag, arts)
        else:
            assert_equal_artifacts(ref[1], arts, f"{tag} vs {ref[0]}")
    by_tag = {r["run"]: r for r in results}
    if by_tag["device_phase0"]["device_sites_phase0"] <= 0:
        raise AssertionError("host_screen=False classified no site on "
                             "the device")
    return results


def unres_sites(screen, n_min: int, indiv: int, seed: int):
    """>= n_min sites that the device phase-0 program leaves UNRES:
    seeded 30x-ish counts with several alternate kinds per sample."""
    from pecaller_tpu.caller.device_screen import UNRES
    rng = np.random.default_rng(seed)
    keep_r, keep_ref, n = [], [], 0
    while n < n_min:
        S = 1 << 17
        ref = rng.integers(0, 4, S).astype(np.uint8)
        depth = rng.poisson(30, (S, indiv))
        reads = np.zeros((S, indiv, 6), np.int64)
        reads[np.arange(S)[:, None], np.arange(indiv)[None, :],
              ref[:, None]] = depth
        for _ in range(3):      # a few alternate reads of random kinds
            k = rng.integers(0, 6, (S, indiv))
            c = rng.binomial(depth, 0.08)
            np.add.at(reads, (np.arange(S)[:, None],
                              np.arange(indiv)[None, :], k), c)
        reads = np.minimum(reads, 65535).astype(np.uint16)
        ctype = np.zeros(S, np.uint8)
        codes = np.asarray(screen._fn0(reads, ref, ctype))
        sel = codes == UNRES
        keep_r.append(reads[sel])
        keep_ref.append(ref[sel])
        n += int(sel.sum())
    return np.concatenate(keep_r), np.concatenate(keep_ref)


def margin_check(n_min: int = 100_000, indiv: int = 3,
                 seed: int = 5) -> dict:
    """Max |f32 device margin - float64 NumPy margin| over active,
    depth-gated samples of >= n_min UNRES sites; must stay < BAND/2."""
    import jax
    from pecaller_tpu.caller import device_screen as ds

    screen = ds.CallerScreen(indiv, haploid=False)
    reads, ref = unres_sites(screen, n_min, indiv, seed)
    ta, tota, a1 = ds._tables(False)
    fn = jax.jit(lambda r, x: ds.pass1_margins(r, x, haploid=False, ta=ta,
                                               tota=tota, a1=a1))
    m32, m32_any = (np.asarray(x, np.float64) for x in fn(reads, ref))
    m64, m64_any = ds.pass1_margins_np(reads, ref, haploid=False)
    r = reads.astype(np.int64)
    tot = r[..., :5].sum(-1)
    use = (tot > 2) & (tot + r[..., 5] <= ds.DEPTH_GATE)
    err = max(float(np.abs(m32 - m64)[use].max()),
              float(np.abs(m32_any - m64_any)[use].max()))
    if not err < ds.BAND / 2:
        raise AssertionError(f"f32 margin error {err} >= BAND/2")
    one = (reads[:1], ref[:1], np.zeros(1, np.uint8))
    rt = warm_median(lambda: screen.phase1(*one), reps=20)
    return dict(unres_sites=int(len(ref)), samples_compared=int(use.sum()),
                max_abs_err=err, limit=ds.BAND / 2,
                phase1_round_trip_ms=round(1e3 * rt, 3))


# --------------------------------------------------------------------------
# entry point

def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip() if out else "nvidia-smi listed no card"


def prepare(four_cards: bool):
    """Inputs plus the device seed indexes run_mapper will load (the
    nbr index for 4.6 Mb, the quartered-key index for 47 Mb): a genome's
    indexes are built once, so the mapping runs time mapping."""
    import bench
    from pecaller_tpu.formats.index_files import load_index
    from pecaller_tpu.index.nbr import load_nbr_index
    from pecaller_tpu.index.quarter import load_quarter_index
    d = bench._prepare_data(os.path.join(SMOKE_DIR, "bact"),
                            write_idx=False)
    load_nbr_index(os.path.join(d, "g"), load_index(os.path.join(d, "g")))
    if four_cards:
        return d, None, None
    md = bench._prepare_mid(SMOKE_DIR, write_idx=False)
    load_quarter_index(os.path.join(md, "m"),
                       load_index(os.path.join(md, "m")))
    cb = bench._prepare_caller_data(d)
    return d, md, cb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="only the reads-sharded mapping on 4 cards vs 1")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
              "not 'gpu'", file=sys.stderr)
        return 1
    if args.four_cards and len(jax.devices()) < 4:
        print("chip_smoke: --four-cards needs 4 visible cards",
              file=sys.stderr)
        return 1
    global CARD
    CARD = card_identity()
    dev = jax.devices()[0]
    from pecaller_tpu.utils import enable_compilation_cache
    cache_dir = enable_compilation_cache()
    warm = os.path.isdir(cache_dir) and bool(os.listdir(cache_dir))
    print(f"card: {CARD}", flush=True)
    say("gate", platform=dev.platform, device_kind=dev.device_kind,
        devices=len(jax.devices()), jax=jax.__version__,
        compile_cache=cache_dir, cache_warm=warm)
    clock = CompileClock()
    nthreads = os.cpu_count() or 2
    t0 = time.perf_counter()
    d, md, cb = prepare(args.four_cards)
    say("data", prepare_s=round(time.perf_counter() - t0, 3))

    if args.four_cards:
        out = map_parity(d, "g.sdx", os.path.join(SMOKE_DIR, "out4"),
                         [("one_card", True, 1), ("four_cards", True, 4)],
                         nthreads=nthreads, clock=clock)
        for r in out:
            say("mapping 4 vs 1 card", **r)
    else:
        from pecaller_tpu.ops.sw_cuda import sw_align_x_cuda
        for bis in (False, True):
            snap = clock.snapshot()
            r = kernel_check(sw_align_x_cuda, B=16384, M=112, N=144,
                             bisulfite=bis)
            say("kernel sw_align_x", **r, **clock.since(snap))
        for phase, data, sdx in (("bacterial mapping", d, "g.sdx"),
                                 ("47Mb mapping", md, "m.sdx")):
            out = map_parity(data, sdx, os.path.join(data, "out"),
                             [("host", False, None), ("device", True, 1)],
                             nthreads=nthreads, clock=clock)
            for r in out:
                say(phase, **r)
            say(phase, process_peak_bytes_in_use=dev.memory_stats().get(
                "peak_bytes_in_use"))
        for r in caller_parity(cb, os.path.join(SMOKE_DIR, "call_out"),
                               nthreads):
            say("caller", **r)
        say("caller f32 margins", **margin_check())
    say("total", seconds=round(time.perf_counter() - t0, 3),
        **clock.since((0.0, 0.0, 0.0, 0, 0)))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.four_cards else 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
