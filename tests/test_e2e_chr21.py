"""Config-3 (chr21-scale, 3-sample) pipeline in CI-sized form
: index -> v2.5 quartered-key device mapping ->
caller -> snplist -> merger -> indel substitution -> VCF, end to end on
a multi-contig genome, gated on byte parity against the reference
binaries from the pileups onward (mapping parity itself is gated by the
oracle-equality check inside this test plus tests/test_quarter.py; the
full 47 Mb run is bench_mid on real hardware)."""

import gzip
import os
import subprocess

import numpy as np
import pytest

from util import (have_reference, ref_binaries, make_genome, write_fasta,
                  sample_reads, write_fastq, BASES)

pytestmark = pytest.mark.skipif(not have_reference(),
                                reason="reference sources unavailable")

PERL_ENV = dict(os.environ, PERL_HASH_SEED="0", PERL_PERTURB_KEYS="0")


def _plant(rng, g, n_events=120):
    L = len(g)
    pos = np.sort(rng.choice(np.arange(2000, L - 2000), size=n_events,
                             replace=False))
    events = []
    for k, p in enumerate(pos):
        kind = ("S", "I", "D")[k % 3 if k % 7 < 3 else 0]
        events.append((int(p), kind))
    alt = {}
    for p, kind in events:
        if kind == "S":
            choices = [x for x in b"ACGT" if x != g[p]]
            alt[p] = choices[p % 3]

    def hap(mask):
        parts, last = [], 0
        for i, (p, kind) in enumerate(events):
            if not mask[i]:
                continue
            parts.append(g[last:p])
            if kind == "S":
                parts.append(np.array([alt[p]], dtype=np.uint8))
                last = p + 1
            elif kind == "I":
                parts.append(g[p:p + 1])
                parts.append(BASES[rng.integers(0, 4, size=3)])
                last = p + 1
            else:
                last = p + 3
        parts.append(g[last:])
        return np.concatenate(parts)
    return events, hap


def test_config3_pipeline(tmp_path):
    from pecaller_tpu.index import build_index
    from pecaller_tpu.mapper import run_mapper, MapperConfig
    from pecaller_tpu.caller import run_caller, CallerConfig
    from pecaller_tpu.cohort import (run_merger, merge_indel_snp,
                                     snp_to_vcf, make_snplist)

    d = str(tmp_path)
    rng = np.random.default_rng(321)
    names, seqs = make_genome(rng, [100_000, 30_000, 12_000],
                              names=["chr21", "chr21_gl1", "chrM"],
                              n_blocks=[(0, 20_000, 40)])
    fa = os.path.join(d, "genome.fa")
    write_fasta(fa, names, seqs)
    build_index(fa, os.path.join(d, "g"), write_idx=False)

    # 3 samples with planted het/hom SNPs + indels on the main contig
    events, hap = _plant(rng, seqs[0], n_events=60)
    for si in range(3):
        gt = rng.integers(0, 3, size=len(events))
        reads = []
        for h in (hap(gt >= 1), hap(gt == 2)):
            reads += sample_reads(rng, ["c"], [h], 3000, read_len=100,
                                  err_rate=0.005, paired=True,
                                  insert_lo=150, insert_hi=400)
        reads += sample_reads(rng, ["c"], [seqs[1]], 1400, read_len=100,
                              err_rate=0.005, paired=True,
                              insert_lo=150, insert_hi=400)
        rng.shuffle(reads)
        f1 = os.path.join(d, f"s{si}_1.fastq")
        f2 = os.path.join(d, f"s{si}_2.fastq")
        write_fastq(f1, reads, which=0)
        write_fastq(f2, reads, which=1)

    # device mapping through the v2.5 quartered-key engine
    os.environ["PECALLER_FORCE_Q4"] = "1"
    try:
        for si in range(3):
            cfg = MapperConfig(
                out_base=os.path.join(d, f"sample{si}"),
                sdx_path=os.path.join(d, "g.sdx"), paired=True,
                files1=[os.path.join(d, f"s{si}_1.fastq")],
                files2=[os.path.join(d, f"s{si}_2.fastq")],
                max_dist=500, min_dist=0, min_align=0.9,
                batch_size=2048, device=True, mesh_shards=1,
                nthreads=2)
            eng = run_mapper(cfg)
            assert eng._dnbr.mode == "quarter"
    finally:
        del os.environ["PECALLER_FORCE_Q4"]

    # host-oracle mapping of sample 0 must agree on the decision layer
    os.makedirs(os.path.join(d, "oracle"), exist_ok=True)
    cfg0 = MapperConfig(
        out_base=os.path.join(d, "oracle", "oracle0"),
        sdx_path=os.path.join(d, "g.sdx"), paired=True,
        files1=[os.path.join(d, "s0_1.fastq")],
        files2=[os.path.join(d, "s0_2.fastq")],
        max_dist=500, min_dist=0, min_align=0.9,
        batch_size=2048, device=False, nthreads=2)
    run_mapper(cfg0)
    with open(os.path.join(d, "sample0.summary.txt"), "rb") as a, \
            open(os.path.join(d, "oracle", "oracle0.summary.txt"),
                 "rb") as b:
        assert a.read() == b.read()

    # our caller vs the reference caller on the same pileups
    run_caller(CallerConfig(
        pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
        out_base=os.path.join(d, "ours"), prob_to_call=0.95,
        theta=0.001, haploid=False, directory=d, nthreads=2))
    bindir = ref_binaries()
    subprocess.run([os.path.join(bindir, "pecaller_O0"), "pileup",
                    "g.sdx", "5", "refcall", "0.95", "0.001", "n", "2",
                    "n"], cwd=d, check=True, stdout=subprocess.DEVNULL)
    assert open(os.path.join(d, "ours.snp")).read() == \
        open(os.path.join(d, "refcall.snp")).read()
    assert open(os.path.join(d, "ours.dist")).read() == \
        open(os.path.join(d, "refcall.dist")).read()
    with gzip.open(os.path.join(d, "ours.base.gz"), "rb") as f1, \
            gzip.open(os.path.join(d, "refcall.base.gz"), "rb") as f2:
        assert f1.read() == f2.read()
    n_var = sum(1 for ln in open(os.path.join(d, "ours.snp"))
                if "\t" in ln) - 1
    assert n_var > 30          # planted variants actually called

    # cohort tail: snplist -> merger -> indel substitution -> VCF,
    # ours vs the reference Perl/C chain
    os.rename(os.path.join(d, "ours.base.gz"),
              os.path.join(d, "run1.base.gz"))
    make_snplist(os.path.join(d, "g.sdx"), os.path.join(d, "good"),
                 directory=d)
    subprocess.run(["perl", os.path.join(bindir,
                                         "make_snplist_formerge.pl"),
                    "g.sdx", "refgood"], cwd=d, check=True, env=PERL_ENV,
                   capture_output=True)
    assert open(os.path.join(d, "good.good.bed")).read() == \
        open(os.path.join(d, "refgood.good.bed")).read()

    run_merger(os.path.join(d, "good.good.bed"),
               os.path.join(d, "merged.snp"), os.path.join(d, "g.sdx"),
               False, directory=d)
    subprocess.run([os.path.join(bindir, "pecall_merger_O0"), "100000",
                    "10", "good.good.bed", "refmerged.snp", "g.sdx",
                    "n"], cwd=d, check=True, capture_output=True)
    assert open(os.path.join(d, "merged.snp")).read() == \
        open(os.path.join(d, "refmerged.snp")).read()

    merge_indel_snp(os.path.join(d, "g.sdx"),
                    os.path.join(d, "merged.snp"), d,
                    os.path.join(d, "sub.snp"))
    subprocess.run(["perl", os.path.join(bindir, "merge_indel_snp.pl"),
                    "g.sdx", "refmerged.snp", ".", "refsub.snp"],
                   cwd=d, check=True, env=PERL_ENV, capture_output=True)
    assert open(os.path.join(d, "sub.snp")).read() == \
        open(os.path.join(d, "refsub.snp")).read()

    import io
    buf = io.StringIO()
    snp_to_vcf(os.path.join(d, "g.sdx"), os.path.join(d, "sub.snp"),
               buf, 0.3)
    vcf = buf.getvalue()
    with open(os.path.join(d, "ref.vcf"), "w") as vf:
        subprocess.run([os.path.join(bindir, "snp_to_vcf"), "g.sdx",
                        "refsub.snp", "0.3"], cwd=d, check=True,
                       stdout=vf, stderr=subprocess.DEVNULL)
    ref_vcf = open(os.path.join(d, "ref.vcf")).read()
    assert _strip_dates(vcf) == _strip_dates(ref_vcf)
    assert ref_vcf.count("\n") > 30


def _strip_dates(v: str) -> str:
    # fileDate varies with wall clock; reference= echoes the sdx path
    # as given (absolute here vs cwd-relative in the C run)
    return "\n".join(ln for ln in v.split("\n")
                     if not (ln.startswith("##fileDate")
                             or ln.startswith("##reference")))
