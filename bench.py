#!/usr/bin/env python
"""End-to-end throughput benchmarks on one chip: caller sites/s, then
mapping reads/s (the final line; the driver records the last line).

Generates (once, cached in .bench/) an E. coli-scale genome + 100 bp
paired reads + a 3-sample 30x synthetic pileup cohort, runs the
device-backed engines, and prints JSON lines:

  {"metric": "pecaller sites/s", "value": N, "unit": "sites/s",
   "vs_baseline": R}
  {"metric": "mapped reads/s/chip", "value": N, "unit": "reads/s",
   "vs_baseline": R}

vs_baseline extrapolates the reference C binaries measured on this
host's CPUs linearly to the 64-core node of BASELINE.json
(ours / (per_core * 64)); baselines are cached in .bench/*.json.
The caller baseline uses the -O0 build: it is the only
correct-semantics build (the -O3 producer/consumer race floods .snp
with bogus rows) AND it is 6.7x faster than -O3 on this workload, so
it is the strongest honest baseline."""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

BENCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench")


def _median3(one_pass, n=5):
    """Median of five timed passes + relative spread (ambient load on
    the host varies run to run; median-of-5 with the spread reported is
    the honest summary)."""
    vals = sorted(one_pass() for _ in range(n))
    mid = vals[len(vals) // 2]
    spread = (vals[-1] - vals[0]) / mid if mid else 0.0
    return mid, round(spread, 3)
GENOME_LEN = 4_600_000
N_READS = 100_000
READ_LEN = 100


def _prepare_data(d=BENCH_DIR, genome_len=GENOME_LEN, n_reads=N_READS,
                  write_idx=True):
    """E. coli-scale genome + 100 bp read pairs + index in ``d``
    (cached).  write_idx=False skips the full .idx, which only the C
    reference reads."""
    os.makedirs(d, exist_ok=True)
    fa = os.path.join(d, "genome.fa")
    if not os.path.exists(os.path.join(d, "r1.fastq")):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        from util import make_genome, write_fasta, sample_reads, write_fastq
        rng = np.random.default_rng(2024)
        names, seqs = make_genome(rng, [genome_len], names=["ecoli"])
        write_fasta(fa, names, seqs)
        reads = sample_reads(rng, names, seqs, n_reads, read_len=READ_LEN,
                             err_rate=0.005, paired=True, insert_lo=150,
                             insert_hi=450, indel_rate=0.02, max_indel=4)
        write_fastq(os.path.join(d, "r1.fastq"), reads, which=0)
        write_fastq(os.path.join(d, "r2.fastq"), reads, which=1)
    if not os.path.exists(os.path.join(d, "g.sdx")):
        from pecaller_tpu.index import build_index
        build_index(fa, os.path.join(d, "g"), write_idx=write_idx)
    return d


def _c_map_rate(bindir, cwd, sdx, out, n_pairs, threads, ncpu):
    """Steady-state reads/s of the reference pemapper via DIFFERENCE
    of full and 1/8-load runs.  Rationale: the per-run fixed costs
    (the .idx gunzip-inflate is 40-130 s of ambient-dependent CPU, the
    final pileup dump 10-60 s) are the same order as the mapping
    itself on these configs, so both the original single-pass timing
    and an (elapsed - separately_timed_setup) subtraction were
    ill-conditioned — observed swings from 0.18x to 6x-inflated
    baselines run to run.  A full and a small run pay identical fixed
    costs, so their difference isolates the marginal mapping rate,
    which is also what our one_pass measures (batches pre-read, warm
    compiles, no output write) and what a production-size run
    amortizes to.  NOTE pemapper's max_reads arg counts fastq RECORDS
    per file (= pairs in `p` mode, pemapper.c:709), so the diff is
    2*(n_pairs - small) reads.  Interleaved q,n pairs bound ambient
    drift; a pair with tn - tq < 1 s is discarded as unmeasurable."""
    import os as _os

    def timed(cnt, tag):
        t0 = time.time()
        subprocess.run(
            [_os.path.join(bindir, "pemapper"), tag, sdx, "p",
             "r1.fastq", "r2.fastq", "500", "0", "n", "0.9",
             str(threads), str(cnt)],
            cwd=cwd, check=True, capture_output=True, timeout=7200)
        return time.time() - t0

    small = max(n_pairs // 8, 1)
    timed(small, out + "w")            # cold-cache warmup, discarded
    rates = []
    for i in range(2):
        tq = timed(small, out + "q")
        tn = timed(n_pairs, out)
        if tn - tq > 1.0:
            rates.append(2 * (n_pairs - small) / (tn - tq))
    if not rates:
        return {"reads_per_s": None, "cores": ncpu,
                "error": "diff below timing resolution"}
    rates.sort()
    bspread = (rates[-1] - rates[0]) / rates[0] if len(rates) > 1 else 0.0
    # report the FASTER pass: ambient load only slows the C runs down
    # (which would flatter our ratio); the faster baseline is the
    # conservative denominator
    return {"reads_per_s": rates[-1], "cores": ncpu,
            "passes": rates, "spread": round(bspread, 3)}


def _c_baseline(d):
    """reads/s of the reference pemapper on this host (cached)."""
    cache = os.path.join(d, "c_baseline.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    try:
        from util import ref_binaries, have_reference
        if not have_reference():
            raise RuntimeError("no reference")
        bindir = ref_binaries()
        ncpu = os.cpu_count() or 2
        threads = ncpu + 1          # reference reserves one for I/O
        result = _c_map_rate(bindir, d, "g.sdx", "cbase", N_READS,
                             threads, ncpu)
    except Exception as e:  # reference unavailable: skip baseline
        result = {"reads_per_s": None, "cores": None, "error": str(e)}
    with open(cache, "w") as f:
        json.dump(result, f)
    return result


N_SAMP = 3
CALL_DEPTH = 30


def _prepare_caller_data(d):
    """3-sample 30x pileup cohort over the bench genome (cached)."""
    cb = os.path.join(d, "callbench")
    os.makedirs(cb, exist_ok=True)
    if os.path.exists(os.path.join(cb, f"s{N_SAMP-1}.pileup.gz")):
        return cb
    import shutil
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.formats.pileup import write_pileup
    sdx = read_sdx(os.path.join(d, "g.sdx"))
    genome = read_seq(os.path.join(d, "g.seq"), sdx.genome_size)
    gs = sdx.genome_size
    lut = np.full(256, -1, np.int16)
    for ch, i in zip(b"ACGT", range(4)):
        lut[ch] = i
    ref = lut[genome]
    ok = ref >= 0
    rng = np.random.default_rng(77)
    is_snp = rng.random(gs) < 1 / 1500
    alt = (ref + rng.integers(1, 4, gs)) % 4
    is_del = rng.random(gs) < 1 / 8000
    is_ins = rng.random(gs) < 1 / 8000
    pos_all = np.arange(gs, dtype=np.uint32)
    for s in range(N_SAMP):
        depth = rng.poisson(CALL_DEPTH, gs).astype(np.int32)
        cnt = np.zeros((gs, 6), np.int32)
        rows = np.arange(gs)
        rc = np.maximum(ref, 0)
        cnt[rows, rc] = depth
        err = np.minimum(rng.poisson(0.005 * CALL_DEPTH, gs), depth)
        ecol = (ref + rng.integers(1, 4, gs)) % 4
        cnt[rows, rc] -= err
        cnt[rows, ecol] += err
        gt = rng.integers(0, 3, gs)
        m = is_snp & (gt > 0)
        half = np.where(gt[m] == 1, cnt[m, :4].max(1) // 2,
                        cnt[m, :4].max(1))
        cnt[np.nonzero(m)[0], alt[m]] += half
        cnt[np.nonzero(m)[0], rc[m]] -= half
        md = is_del & (gt > 0)
        cnt[md, 4] = np.where(gt[md] == 1, depth[md] // 2, depth[md])
        cnt[np.nonzero(md)[0], rc[md]] -= cnt[md, 4]
        mi = is_ins & (gt > 0)
        cnt[mi, 5] = np.where(gt[mi] == 1, depth[mi] // 2, depth[mi])
        cnt = np.clip(cnt, 0, 65535).astype(np.uint16)
        keep = ok & (depth > 0)
        write_pileup(os.path.join(cb, f"s{s}.pileup.gz"),
                     pos_all[keep], cnt[keep])
    for f in ("g.sdx", "g.seq"):
        shutil.copy(os.path.join(d, f), os.path.join(cb, f))
    return cb


def _c_caller_baseline(d, cb):
    """sites/s of the reference pecaller (-O0, see module doc) on this
    host (cached)."""
    cache = os.path.join(d, "c_caller_baseline.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    try:
        from util import ref_binaries, have_reference
        if not have_reference():
            raise RuntimeError("no reference")
        import gzip as _gz
        bindir = ref_binaries()
        ncpu = os.cpu_count() or 2
        rates = []
        n = 0
        for _ in range(3):          # median-of-3 (see _c_baseline)
            t0 = time.time()
            subprocess.run(
                [os.path.join(bindir, "pecaller_O0"), "pileup", "g.sdx",
                 str(N_SAMP), "cref", "0.95", "0.001", "n",
                 str(ncpu + 1), "n"],
                cwd=cb, check=True, capture_output=True, timeout=7200)
            elapsed = time.time() - t0
            if not n:
                with _gz.open(os.path.join(cb, "cref.base.gz"),
                              "rb") as f:
                    while True:
                        b = f.read(1 << 24)
                        if not b:
                            break
                        n += b.count(b"\n")
            rates.append(n / elapsed)
        rates.sort()
        bspread = (rates[-1] - rates[0]) / rates[1]
        result = {"sites_per_s": rates[1], "cores": ncpu,
                  "sites": n, "passes": rates,
                  "spread": round(bspread, 3)}
    except Exception as e:
        result = {"sites_per_s": None, "cores": None, "error": str(e)}
    with open(cache, "w") as f:
        json.dump(result, f)
    return result


def bench_caller(d):
    cb = _prepare_caller_data(d)
    from pecaller_tpu.caller import run_caller, CallerConfig

    def one_pass():
        t0 = time.time()
        cfg = CallerConfig(pileup_ext="pileup",
                           sdx_path=os.path.join(cb, "g.sdx"),
                           out_base=os.path.join(cb, "ours"),
                           prob_to_call=0.95, theta=0.001, haploid=False,
                           directory=cb, nthreads=os.cpu_count() or 2)
        r = run_caller(cfg)
        return r["n_sites"] / (time.time() - t0)

    one_pass()                      # compile + page-cache warmup
    sites_per_s, spread = _median3(one_pass)

    cbase = _c_caller_baseline(d, cb)
    vs = None
    if cbase.get("sites_per_s"):
        per_core = cbase["sites_per_s"] / cbase["cores"]
        vs = sites_per_s / (per_core * 64.0)
    print(json.dumps({
        "metric": "pecaller sites/s",
        "value": round(sites_per_s, 1),
        "unit": "sites/s",
        "vs_baseline": round(vs, 3) if vs is not None else None,
        "spread": spread,
    }), flush=True)


MID_LEN = 47_000_000          # human chr21 scale
MID_READS = 50_000


def _prepare_mid(d, write_idx=True):
    """47 Mb single-contig genome + 50k read pairs (cached).  This is
    past the nbr-closure gate, so run_mapper's device path probes the
    quartered-key index."""
    md = os.path.join(d, "mid")
    os.makedirs(md, exist_ok=True)
    fa = os.path.join(md, "m.fa")
    if not os.path.exists(os.path.join(md, "r1.fastq")):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        from util import make_genome, write_fasta, sample_reads, write_fastq
        rng = np.random.default_rng(2025)
        names, seqs = make_genome(rng, [MID_LEN], names=["chr21x"])
        write_fasta(fa, names, seqs)
        reads = sample_reads(rng, names, seqs, MID_READS, read_len=READ_LEN,
                             err_rate=0.005, paired=True, insert_lo=150,
                             insert_hi=450, indel_rate=0.02, max_indel=4)
        write_fastq(os.path.join(md, "r1.fastq"), reads, which=0)
        write_fastq(os.path.join(md, "r2.fastq"), reads, which=1)
    if not os.path.exists(os.path.join(md, "m.sdx")):
        from pecaller_tpu.index import build_index
        build_index(fa, os.path.join(md, "m"), write_idx=write_idx)
    return md


def _c_mid_baseline(md):
    cache = os.path.join(md, "c_baseline.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    try:
        from util import ref_binaries, have_reference
        if not have_reference():
            raise RuntimeError("no reference")
        bindir = ref_binaries()
        ncpu = os.cpu_count() or 2
        threads = ncpu + 1
        result = _c_map_rate(bindir, md, "m.sdx", "cmid",
                             MID_READS, threads, ncpu)
    except Exception as e:
        result = {"reads_per_s": None, "cores": None, "error": str(e)}
    with open(cache, "w") as f:
        json.dump(result, f)
    return result


def bench_mid(d):
    md = _prepare_mid(d)
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.formats.index_files import load_index
    from pecaller_tpu.formats.fastq import FastqBatcher
    from pecaller_tpu.index.quarter import load_quarter_index
    from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2

    sdx = read_sdx(os.path.join(md, "m.sdx"))
    genome = read_seq(os.path.join(md, "m.seq"), sdx.genome_size)
    index = load_index(os.path.join(md, "m"))
    quarter = load_quarter_index(os.path.join(md, "m"), index)
    eng = FusedMapperEngine2(sdx, genome, index, quarter=quarter,
                             paired=True, min_align=0.9, min_dist=0,
                             max_dist=500, nthreads=os.cpu_count() or 2)
    batches = list(FastqBatcher(os.path.join(md, "r1.fastq"),
                                os.path.join(md, "r2.fastq"),
                                batch_size=8192).batches())
    s1, l1, s2, l2, nos = batches[0]
    eng.map_batch(s1, l1, s2, l2, read_nos=nos)
    st, lt, s2t, l2t, nt = batches[-1]
    eng.map_batch(st, lt, s2t, l2t, read_nos=nt)

    def one_pass():
        t0 = time.time()
        total = 0
        pend = []
        for s1, l1, s2, l2, nos in batches:
            pend.append(eng.map_batch_async(s1, l1, s2, l2,
                                            read_nos=nos))
            total += 2 * len(l1)
            if len(pend) >= 5:
                eng.resolve(pend.pop(0))
        while pend:
            eng.resolve(pend.pop(0))
        np.asarray(eng.dev_counts[:8])
        return total / (time.time() - t0)

    reads_per_s, spread = _median3(one_pass)
    cb = _c_mid_baseline(md)
    vs = None
    if cb.get("reads_per_s"):
        per_core = cb["reads_per_s"] / cb["cores"]
        vs = reads_per_s / (per_core * 64.0)
    print(json.dumps({
        "metric": "mapped reads/s/chip (47Mb genome, v2.5 engine)",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(vs, 3) if vs is not None else None,
        "spread": spread,
    }), flush=True)


def main():
    d = _prepare_data()
    only = os.environ.get("PECALLER_BENCH_ONLY", "")
    if only not in ("map", "mid"):
        bench_caller(d)
    if only != "map" and os.environ.get("PECALLER_BENCH_MID", "1") != "0":
        bench_mid(d)
    if only == "mid":
        return
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.formats.index_files import load_index
    from pecaller_tpu.formats.fastq import FastqBatcher
    from pecaller_tpu.index.nbr import load_nbr_index
    from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2

    sdx = read_sdx(os.path.join(d, "g.sdx"))
    genome = read_seq(os.path.join(d, "g.seq"), sdx.genome_size)
    index = load_index(os.path.join(d, "g"))
    nbr = load_nbr_index(os.path.join(d, "g"), index)
    eng = FusedMapperEngine2(sdx, genome, index, nbr=nbr, paired=True,
                             min_align=0.9, min_dist=0, max_dist=500,
                             nthreads=os.cpu_count() or 2)

    batches = []
    batcher = FastqBatcher(os.path.join(d, "r1.fastq"),
                           os.path.join(d, "r2.fastq"), batch_size=8192)
    for b in batcher.batches():
        batches.append(b)

    # warmup (compiles the K-batch scan program for the steady bucket
    # plus the single-batch program for the tail bucket)
    K = getattr(eng, "_group_k", 1)
    warm = [eng.map_batch_async(s1, l1, s2, l2, read_nos=nos)
            for s1, l1, s2, l2, nos in batches[:K]]
    for h in warm:
        eng.resolve(h)
    st, lt, s2t, l2t, nt = batches[-1]
    eng.map_batch(st, lt, s2t, l2t, read_nos=nt)

    def one_pass():
        t0 = time.time()
        total = 0
        depth = max(5, 2 * K + 1)
        pend = []
        for s1, l1, s2, l2, nos in batches:
            pend.append(eng.map_batch_async(s1, l1, s2, l2,
                                            read_nos=nos))
            total += 2 * len(l1)
            if len(pend) >= depth:
                eng.resolve(pend.pop(0))
        while pend:
            eng.resolve(pend.pop(0))
        np.asarray(eng.dev_counts[:8])   # sync device work (the full
        # pileup is fetched once per RUN, not per benchmark window)
        return total / (time.time() - t0)

    reads_per_s, spread = _median3(one_pass)

    cb = _c_baseline(d)
    vs = None
    if cb.get("reads_per_s"):
        per_core = cb["reads_per_s"] / cb["cores"]
        vs = reads_per_s / (per_core * 64.0)
    print(json.dumps({
        "metric": "mapped reads/s/chip",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(vs, 3) if vs is not None else None,
        "spread": spread,
    }))


if __name__ == "__main__":
    main()
