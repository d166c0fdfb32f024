"""Caller parity: .base.gz/.snp/.piles.gz/.dist byte-equal to the
reference pecaller (built race-free at -O0; see util.ref_binaries)."""

import gzip
import os
import shutil
import subprocess

import numpy as np
import pytest

from pecaller_tpu.caller import run_caller, CallerConfig
from pecaller_tpu.mapper import run_mapper, MapperConfig

from util import (golden_ready,
                  have_reference, ref_binaries, run_ref_indexer, make_genome,
                  write_fasta, sample_reads, write_fastq, golden_dir, BASES)

pytestmark = pytest.mark.skipif(not have_reference(),
                                reason="reference sources unavailable")


def _plant_and_map(d, rng, n_samples=3, contig_lens=(30000,),
                   names=None):
    """Create genome + per-sample variant haplotypes, map with our
    (parity-proven) mapper to produce per-sample pileups."""
    names, seqs = make_genome(rng, list(contig_lens), names=names)
    write_fasta(os.path.join(d, "genome.fa"), names, seqs)
    g = seqs[0]
    L = len(g)
    nvar = 60
    var_pos = np.sort(rng.choice(np.arange(1000, L - 1000),
                                 size=nvar + 12, replace=False))
    snp_pos = set(var_pos[:nvar].tolist())
    ins_pos = set(var_pos[nvar:nvar + 6].tolist())
    del_pos = set(var_pos[nvar + 6:].tolist())
    events = sorted([(p, "S") for p in snp_pos] + [(p, "I") for p in ins_pos]
                    + [(p, "D") for p in del_pos])
    alt = {}
    for i, p in enumerate(sorted(snp_pos)):
        choices = [x for x in b"ACGT" if x != g[p]]
        alt[p] = choices[i % 3]

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

    for si in range(n_samples):
        gt = rng.integers(0, 3, size=len(events))
        reads = []
        for h in (hap(gt >= 1), hap(gt == 2)):
            reads += sample_reads(rng, ["c"], [h], 2500, read_len=100,
                                  err_rate=0.005, paired=True,
                                  insert_lo=150, insert_hi=400)
        rng.shuffle(reads)
        f1 = os.path.join(d, f"s{si}_1.fastq")
        f2 = os.path.join(d, f"s{si}_2.fastq")
        write_fastq(f1, reads, which=0)
        write_fastq(f2, reads, which=1)
        run_ref_indexer("genome.fa", "g", cwd=d) if si == 0 else None
        cfg = MapperConfig(out_base=os.path.join(d, f"sample{si}"),
                           sdx_path=os.path.join(d, "g.sdx"), paired=True,
                           files1=[f1], files2=[f2], max_dist=500,
                           min_dist=0, min_align=0.9, max_reads=100000)
        run_mapper(cfg)


@pytest.fixture(scope="module")
def call_golden():
    d = golden_dir("call_3samp")
    if not golden_ready(os.path.join(d, "refcall.snp")):
        rng = np.random.default_rng(99)
        _plant_and_map(d, rng)
        subprocess.run([os.path.join(ref_binaries(), "pecaller_O0"),
                        "pileup", "g.sdx", "5", "refcall", "0.95", "0.001",
                        "n", "2", "n"], cwd=d, check=True,
                       stdout=subprocess.DEVNULL)
    return d


def _compare(d, out_base, ref_base):
    assert open(out_base + ".snp").read() == \
        open(os.path.join(d, ref_base + ".snp")).read()
    assert open(out_base + ".dist").read() == \
        open(os.path.join(d, ref_base + ".dist")).read()
    for ext in [".base.gz", ".piles.gz"]:
        with gzip.open(out_base + ext, "rb") as f1, \
                gzip.open(os.path.join(d, ref_base + ext), "rb") as f2:
            assert f1.read() == f2.read()


@pytest.mark.parametrize("beam", [False, True])
def test_caller_parity_3samples(call_golden, tmp_path, beam):
    d = call_golden
    cfg = CallerConfig(pileup_ext="pileup",
                       sdx_path=os.path.join(d, "g.sdx"),
                       out_base=str(tmp_path / "ourcall"),
                       prob_to_call=0.95, theta=0.001, haploid=False,
                       directory=d, nthreads=2, device_beam=beam)
    run_caller(cfg)
    _compare(d, str(tmp_path / "ourcall"), "refcall")


def test_caller_parity_haploid(call_golden, tmp_path):
    d = call_golden
    if not golden_ready(os.path.join(d, "refhap.snp")):
        subprocess.run([os.path.join(ref_binaries(), "pecaller_O0"),
                        "pileup", "g.sdx", "5", "refhap", "0.95", "0.001",
                        "y", "2", "n"], cwd=d, check=True,
                       stdout=subprocess.DEVNULL)
    cfg = CallerConfig(pileup_ext="pileup",
                       sdx_path=os.path.join(d, "g.sdx"),
                       out_base=str(tmp_path / "ourhap"),
                       prob_to_call=0.95, theta=0.001, haploid=True,
                       directory=d, nthreads=2)
    run_caller(cfg)
    _compare(d, str(tmp_path / "ourhap"), "refhap")


def test_caller_parity_guide_bed(call_golden, tmp_path):
    d = call_golden
    bed = os.path.join(d, "regions.bed")
    if not golden_ready(os.path.join(d, "refbed.snp")):
        with open(bed, "w") as f:
            f.write("chr1\t2000\t9000\nchr1\t15000\t23000\n")
        subprocess.run([os.path.join(ref_binaries(), "pecaller_O0"),
                        "pileup", "g.sdx", "5", "refbed", "0.95", "0.001",
                        "n", "2", "n", "regions.bed"], cwd=d, check=True,
                       stdout=subprocess.DEVNULL)
    cfg = CallerConfig(pileup_ext="pileup",
                       sdx_path=os.path.join(d, "g.sdx"),
                       out_base=str(tmp_path / "ourbed"),
                       prob_to_call=0.95, theta=0.001, haploid=False,
                       guide_path=bed, directory=d, nthreads=2)
    run_caller(cfg)
    _compare(d, str(tmp_path / "ourbed"), "refbed")


def test_caller_guide_bed_windowed_chunks(call_golden, tmp_path):
    """The streamed guide path with a tiny chunk size (forcing many
    chunks + the early-stop reduction mid-chunk) must still match the
    reference bytes — guide memory is bounded by the chunk, not the
    bed span."""
    d = call_golden
    bed = os.path.join(d, "regions.bed")
    if not golden_ready(os.path.join(d, "refbed.snp")):
        pytest.skip("guide golden not built")
    cfg = CallerConfig(pileup_ext="pileup",
                       sdx_path=os.path.join(d, "g.sdx"),
                       out_base=str(tmp_path / "ourbedw"),
                       prob_to_call=0.95, theta=0.001, haploid=False,
                       guide_path=bed, directory=d, nthreads=2,
                       window_positions=1 << 10)
    run_caller(cfg)
    _compare(d, str(tmp_path / "ourbedw"), "refbed")


def test_caller_guide_early_stop_windowed_matches_legacy(tmp_path):
    """Early-stop semantics of the streamed guide path: with a bed
    extending far past the last pileup record, the windowed reduction
    (first site >= max delivered position, +1) must process exactly
    the same site set as the per-site legacy walk."""
    import gzip as _gz
    from unittest import mock
    from pecaller_tpu.formats.pileup import write_pileup
    from pecaller_tpu.index import build_index
    from pecaller_tpu.caller import runner as crunner
    d = str(tmp_path)
    rng = np.random.default_rng(8)
    names, seqs = make_genome(rng, [8000])
    write_fasta(os.path.join(d, "genome.fa"), names, seqs)
    build_index(os.path.join(d, "genome.fa"), os.path.join(d, "g"),
                write_idx=False)
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    sdx = read_sdx(os.path.join(d, "g.sdx"))
    genome = read_seq(os.path.join(d, "g.seq"), sdx.genome_size)
    lut = np.full(256, 0, np.int16)
    for ch, i in zip(b"ACGT", range(4)):
        lut[ch] = i
    ref = lut[genome]
    # streams end at different positions, all well before the bed end
    for s, stop in enumerate((3000, 2500, 3500)):
        pos = np.arange(stop, dtype=np.uint32)
        cnt = np.zeros((stop, 6), np.uint16)
        cnt[np.arange(stop), ref[:stop]] = 20
        write_pileup(os.path.join(d, f"s{s}.pileup.gz"), pos, cnt)
    with open(os.path.join(d, "b.bed"), "w") as f:
        f.write(f"{names[0]}\t100\t7900\n")
    base = dict(pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
                prob_to_call=0.95, theta=0.001, haploid=False,
                guide_path=os.path.join(d, "b.bed"), directory=d,
                nthreads=2, window_positions=1 << 9)
    run_caller(CallerConfig(out_base=os.path.join(d, "win"), **base))
    with mock.patch.object(crunner, "_run_guide_windowed",
                           crunner._run_guide_legacy):
        run_caller(CallerConfig(out_base=os.path.join(d, "leg"),
                                **base))
    for ext in (".base.gz", ".piles.gz"):
        with _gz.open(os.path.join(d, "win" + ext), "rb") as f1, \
                _gz.open(os.path.join(d, "leg" + ext), "rb") as f2:
            assert f1.read() == f2.read(), ext
    assert open(os.path.join(d, "win.snp"), "rb").read() == \
        open(os.path.join(d, "leg.snp"), "rb").read()
    assert open(os.path.join(d, "win.dist")).read() == \
        open(os.path.join(d, "leg.dist")).read()


@pytest.fixture(scope="module")
def denovo_golden():
    """Hand-crafted trio pileups that force DENOVO_ rows."""
    import gzip as _gz
    from pecaller_tpu.formats.pileup import write_pileup
    d = golden_dir("call_denovo")
    if not golden_ready(os.path.join(d, "refdn.snp")):
        rng = np.random.default_rng(5)
        names, seqs = make_genome(rng, [2000])
        write_fasta(os.path.join(d, "genome.fa"), names, seqs)
        run_ref_indexer("genome.fa", "g", cwd=d)
        with _gz.open(os.path.join(d, "g.seq"), "rb") as f:
            g = f.read()
        base_col = {65: 0, 67: 1, 71: 2, 84: 3}
        pos = np.arange(200, 220, dtype=np.uint32)

        def mk(name, het_sites, dp):
            cnt = np.zeros((20, 6), dtype=np.uint16)
            for k, p in enumerate(pos):
                rc = base_col[g[p]]
                if k in het_sites:
                    cnt[k, rc] = dp // 2
                    cnt[k, (rc + 1) % 4] = dp // 2
                else:
                    cnt[k, rc] = dp
            write_pileup(os.path.join(d, f"{name}.pileup.gz"), pos, cnt)

        mk("dad", set(), 60)
        mk("mom", set(), 60)
        mk("kid", {5, 11}, 100)
        with open(os.path.join(d, "trio.ped"), "w") as f:
            f.write("fam1\tdad\t0\t0\t1\nfam1\tmom\t0\t0\t2\n"
                    "fam1\tkid\tdad\tmom\t1\n")
        subprocess.run([os.path.join(ref_binaries(), "pecaller_O0"),
                        "pileup", "g.sdx", "5", "refdn", "0.95", "0.001",
                        "n", "2", "y", "trio.ped", "1e-8"], cwd=d,
                       check=True, stdout=subprocess.DEVNULL)
    return d


def test_caller_parity_denovo(denovo_golden, tmp_path):
    d = denovo_golden
    cfg = CallerConfig(pileup_ext="pileup",
                       sdx_path=os.path.join(d, "g.sdx"),
                       out_base=str(tmp_path / "ourdn"),
                       prob_to_call=0.95, theta=0.001, haploid=False,
                       use_ped=True, ped_path=os.path.join(d, "trio.ped"),
                       denovo_rate=1e-8, directory=d, nthreads=2)
    run_caller(cfg)
    ref = open(os.path.join(d, "refdn.snp")).read()
    assert "DENOVO_" in ref          # the probe must exercise the path
    assert open(str(tmp_path / "ourdn.snp")).read() == ref
    with gzip.open(str(tmp_path / "ourdn.base.gz"), "rb") as f1, \
            gzip.open(os.path.join(d, "refdn.base.gz"), "rb") as f2:
        assert f1.read() == f2.read()


def test_dump_pileups_parity(call_golden, tmp_path):
    d = call_golden
    if not golden_ready(os.path.join(d, "refdump.base.gz")):
        subprocess.run([os.path.join(ref_binaries(), "dump_pileups_O0"),
                        "pileup", "g.sdx", "5", "refdump", "0.95", "0.001",
                        "n", "2", "n"], cwd=d, check=True,
                       stdout=subprocess.DEVNULL)
    cfg = CallerConfig(pileup_ext="pileup",
                       sdx_path=os.path.join(d, "g.sdx"),
                       out_base=str(tmp_path / "ourdump"),
                       prob_to_call=0.95, theta=0.001, haploid=False,
                       directory=d, nthreads=2, dump_mode=True)
    run_caller(cfg)
    for ext in (".base.gz", ".piles.gz"):
        with gzip.open(str(tmp_path / "ourdump") + ext, "rb") as f1, \
                gzip.open(os.path.join(d, "refdump" + ext), "rb") as f2:
            assert f1.read() == f2.read()
    assert open(str(tmp_path / "ourdump.dist")).read() == \
        open(os.path.join(d, "refdump.dist")).read()


def test_windowed_streaming_equivalence(call_golden, tmp_path):
    """Tiny streaming windows must produce byte-identical artifacts."""
    d = call_golden
    cfg = CallerConfig(pileup_ext="pileup",
                       sdx_path=os.path.join(d, "g.sdx"),
                       out_base=str(tmp_path / "win"),
                       prob_to_call=0.95, theta=0.001, haploid=False,
                       directory=d, nthreads=2, window_positions=1111)
    run_caller(cfg)
    _compare(d, str(tmp_path / "win"), "refcall")


def test_caller_checkpoint_resume(call_golden, tmp_path, monkeypatch):
    """Crash the caller mid-run; the rerun resumes at the last completed
    window and every artifact still byte-matches the reference."""
    import pecaller_tpu.caller.runner as runner_mod
    d = call_golden
    cfg = CallerConfig(pileup_ext="pileup",
                       sdx_path=os.path.join(d, "g.sdx"),
                       out_base=str(tmp_path / "ck"),
                       prob_to_call=0.95, theta=0.001, haploid=False,
                       directory=d, nthreads=2, window_positions=1111,
                       checkpoint=True)
    orig = runner_mod._process_window
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        if calls["n"] > 3:
            raise RuntimeError("simulated crash")
        return orig(*a, **k)

    monkeypatch.setattr(runner_mod, "_process_window", boom)
    with pytest.raises(RuntimeError):
        run_caller(cfg)
    monkeypatch.setattr(runner_mod, "_process_window", orig)
    assert os.path.exists(str(tmp_path / "ck.cckpt.npz"))
    run_caller(cfg)
    assert not os.path.exists(str(tmp_path / "ck.cckpt.npz"))
    _compare(d, str(tmp_path / "ck"), "refcall")
