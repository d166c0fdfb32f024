"""FusedMapperEngine2 (device_map2: nbr index + scatter-free pipeline)
equivalence vs the exact host engine — same contract as test_fused.py."""

import numpy as np
import pytest

from util import (make_genome, write_fasta, sample_reads, write_fastq)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused2")
    rng = np.random.default_rng(43)
    names, seqs = make_genome(rng, [30000, 20000], n_blocks=[(0, 5000, 30)])
    fa = str(d / "g.fa")
    write_fasta(fa, names, seqs)
    from pecaller_tpu.index import build_index
    build_index(fa, str(d / "g"), write_idx=False)
    reads = sample_reads(rng, names, seqs, 900, read_len=100, err_rate=0.01,
                         paired=True, insert_lo=150, insert_hi=450,
                         indel_rate=0.15, max_indel=4)
    write_fastq(str(d / "r1.fastq"), reads, which=0)
    write_fastq(str(d / "r2.fastq"), reads, which=1)
    return d


def _engines(d, **kw):
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.formats.index_files import load_index
    from pecaller_tpu.mapper.engine import MapperEngine
    from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2
    sdx = read_sdx(str(d / "g.sdx"))
    genome = read_seq(str(d / "g.seq"), sdx.genome_size)
    index = load_index(str(d / "g"))
    return (MapperEngine(sdx, genome, index, **kw),
            FusedMapperEngine2(sdx, genome, index, **kw))


def test_fused2_matches_oracle(data):
    from pecaller_tpu.formats.fastq import FastqBatcher
    e_ref, e_fus = _engines(data, paired=True, min_align=0.9, min_dist=0,
                            max_dist=500, nthreads=2)
    batches = list(FastqBatcher(str(data / "r1.fastq"),
                                str(data / "r2.fastq"),
                                batch_size=900).batches())
    for s1, l1, s2, l2, nos in batches:
        rm1, rm2, rc = e_ref.map_batch(s1, l1, s2, l2, read_nos=nos)
        fm1, fm2, fc = e_fus.map_batch(s1, l1, s2, l2, read_nos=nos)
        assert np.array_equal(rc, fc)
        assert np.array_equal(rm1, fm1)
        assert np.array_equal(rm2, fm2)

    assert np.array_equal(e_ref.stats.mate_counts, e_fus.stats.mate_counts)
    assert e_ref.stats.total_dist == e_fus.stats.total_dist
    assert e_ref.stats.no_dists == e_fus.stats.no_dists
    assert e_ref.stats.total_bases == e_fus.stats.total_bases

    # round 5: FULL byte equality — walk/argmax/decide exact-score ties
    # are detected on device and re-resolved with the bit-exact f64
    # native walk
    p_ref = e_ref.final_pileup().astype(np.int64)
    p_fus = e_fus.final_pileup().astype(np.int64)
    assert np.array_equal(p_ref, p_fus)

    assert sorted(e_ref.ins_records) == sorted(e_fus.ins_records)


def test_fused2_grouped_scan(data):
    """group_k>1 (K batches fused into one scanned device program, one
    fetch per group) must be bit-identical to the single-batch path,
    including partial-group flush on shape change and at stream end."""
    from pecaller_tpu.formats.fastq import FastqBatcher
    kw = dict(paired=True, min_align=0.9, min_dist=0, max_dist=500,
              nthreads=2)
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.formats.index_files import load_index
    from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2
    sdx = read_sdx(str(data / "g.sdx"))
    genome = read_seq(str(data / "g.seq"), sdx.genome_size)
    index = load_index(str(data / "g"))
    e_one = FusedMapperEngine2(sdx, genome, index, group_k=1, **kw)
    e_grp = FusedMapperEngine2(sdx, genome, index, group_k=3, **kw)
    # batch 128: 900 pairs -> 7 full batches (2 groups of 3 + 1 partial)
    # + a 4-pair tail in a different shape bucket (flush-on-key-change)
    batches = list(FastqBatcher(str(data / "r1.fastq"),
                                str(data / "r2.fastq"),
                                batch_size=128).batches())
    res_one, res_grp = [], []
    pend = []
    for b in batches:
        s1, l1, s2, l2, nos = b
        res_one.append(e_one.map_batch(s1, l1, s2, l2, read_nos=nos))
        pend.append(e_grp.map_batch_async(s1, l1, s2, l2, read_nos=nos))
    for h in pend:
        res_grp.append(e_grp.resolve(h))
    for (a1, a2, ac), (b1, b2, bc) in zip(res_one, res_grp):
        assert np.array_equal(ac, bc)
        assert np.array_equal(a1, b1)
        assert np.array_equal(a2, b2)
    assert np.array_equal(e_one.stats.mate_counts, e_grp.stats.mate_counts)
    assert np.array_equal(e_one.final_pileup(), e_grp.final_pileup())
    assert sorted(e_one.ins_records) == sorted(e_grp.ins_records)


def test_fused2_single_end(data):
    from pecaller_tpu.formats.fastq import FastqBatcher
    e_ref, e_fus = _engines(data, paired=False, min_align=0.9, nthreads=2)
    batches = list(FastqBatcher(str(data / "r1.fastq"), None,
                                batch_size=512).batches())
    for s1, l1, s2, l2, nos in batches:
        rm1, _, rc = e_ref.map_batch(s1, l1, read_nos=nos)
        fm1, _, fc = e_fus.map_batch(s1, l1, read_nos=nos)
        assert np.array_equal(rc, fc)
        assert np.array_equal(rm1, fm1)
    assert np.array_equal(e_ref.stats.mate_counts, e_fus.stats.mate_counts)
    p_ref = e_ref.final_pileup().astype(np.int64)
    p_fus = e_fus.final_pileup().astype(np.int64)
    assert np.array_equal(p_ref, p_fus)


def test_fused2_bisulfite(data, tmp_path):
    """Bisulfite mode: C->T converted keys + asymmetric SW match rule
    (ref C ~ read T) through the whole v2 device pipeline."""
    import numpy as np
    from pecaller_tpu.formats.fastq import FastqBatcher
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.index import build_index
    from pecaller_tpu.formats.index_files import load_index
    from pecaller_tpu.mapper.engine import MapperEngine
    from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2

    rng = np.random.default_rng(77)
    names, seqs = make_genome(rng, [20000])
    fa = str(tmp_path / "b.fa")
    write_fasta(fa, names, seqs)
    build_index(fa, str(tmp_path / "b"), bisulfite=True, write_idx=False)
    reads = sample_reads(rng, names, seqs, 400, read_len=100,
                         err_rate=0.01, paired=True, insert_lo=150,
                         insert_hi=400, indel_rate=0.05, max_indel=3)
    # simulate bisulfite conversion: most C's read as T
    conv = []
    for r1, r2, info in reads:
        def cv(s):
            s = s.copy()
            m = (s == ord("C")) & (rng.random(len(s)) < 0.8)
            s[m] = ord("T")
            return s
        conv.append((cv(r1), cv(r2), info))
    reads = conv
    write_fastq(str(tmp_path / "b1.fastq"), reads, which=0)
    write_fastq(str(tmp_path / "b2.fastq"), reads, which=1)

    sdx = read_sdx(str(tmp_path / "b.sdx"))
    genome = read_seq(str(tmp_path / "b.seq"), sdx.genome_size)
    index = load_index(str(tmp_path / "b"))
    kw = dict(paired=True, min_align=0.9, min_dist=0, max_dist=500,
              bisulfite=True, nthreads=2)
    e_ref = MapperEngine(sdx, genome, index, **kw)
    e_fus = FusedMapperEngine2(sdx, genome, index, **kw)
    for s1, l1, s2, l2, nos in FastqBatcher(
            str(tmp_path / "b1.fastq"), str(tmp_path / "b2.fastq"),
            batch_size=400).batches():
        rm1, rm2, rc = e_ref.map_batch(s1, l1, s2, l2, read_nos=nos)
        fm1, fm2, fc = e_fus.map_batch(s1, l1, s2, l2, read_nos=nos)
        assert np.array_equal(rc, fc)
        assert np.array_equal(rm1, fm1)
        assert np.array_equal(rm2, fm2)
    p_ref = e_ref.final_pileup().astype(np.int64)
    p_fus = e_fus.final_pileup().astype(np.int64)
    assert np.array_equal(p_ref, p_fus)


def test_runner_device_engine_selection(data, tmp_path):
    """run_mapper(device=True) selects the v2 fused engine for small
    genomes and produces artifacts equivalent to the host path."""
    import gzip
    import numpy as np
    from pecaller_tpu.mapper.runner import MapperConfig, run_mapper, \
        write_outputs
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2

    sdx = read_sdx(str(data / "g.sdx"))
    genome = read_seq(str(data / "g.seq"), sdx.genome_size)
    outs = {}
    for dev in (False, True):
        base = str(tmp_path / ("dev" if dev else "host"))
        cfg = MapperConfig(out_base=base, sdx_path=str(data / "g.sdx"),
                           paired=True, files1=[str(data / "r1.fastq")],
                           files2=[str(data / "r2.fastq")],
                           max_dist=500, min_dist=0, batch_size=600,
                           device=dev, nthreads=2)
        eng = run_mapper(cfg)
        if dev:
            assert isinstance(eng, FusedMapperEngine2)
        write_outputs(cfg, eng, sdx, genome, 900)
        with gzip.open(base + ".pileup.gz", "rb") as f:
            pile = f.read()
        with open(base + ".summary.txt", "rb") as f:
            summ = f.read()
        outs[dev] = (pile, summ)
    # round 5: summary AND pileup byte-equal (tie routing makes the
    # device path bit-exact vs the host oracle)
    assert outs[False][1] == outs[True][1]
    assert outs[False][0] == outs[True][0]


def test_fused2_threshold_boundary_reads(tmp_path):
    """Reads whose exact best score sits ON the min_align threshold
    (score 90.0 for len 100 at 0.9: 94 matches + 6 mismatches + one
    1-base deletion = 3240/36) are boundary-ambiguous in the C f64
    `smax >= good_score` gate — the device step must route them to the
    host engine and match it byte-for-byte (whatever side the f64
    rounding lands on)."""
    from pecaller_tpu.index import build_index
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.formats.index_files import load_index
    from pecaller_tpu.mapper.engine import MapperEngine
    from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2

    rng = np.random.default_rng(99)
    names, seqs = make_genome(rng, [20000])
    fa = str(tmp_path / "t.fa")
    write_fasta(fa, names, seqs)
    build_index(fa, str(tmp_path / "t"), write_idx=False)
    sdx = read_sdx(str(tmp_path / "t.sdx"))
    genome = read_seq(str(tmp_path / "t.seq"), sdx.genome_size)
    index = load_index(str(tmp_path / "t"))

    bases = np.frombuffer(b"ACGT", np.uint8)
    B = 64
    reads = np.zeros((B, 100), np.uint8)
    lens = np.full(B, 100, np.int64)
    for b in range(B):
        start = int(rng.integers(200, 18000))
        ref = genome[start:start + 101].copy()   # 101 ref bases
        # delete ref base 50 from the read; 6 substitutions
        read = np.concatenate([ref[:50], ref[51:101]])
        subs = rng.choice(100, size=6, replace=False)
        for p in subs:
            c = read[p]
            read[p] = bases[(np.searchsorted(bases, c) + 1) % 4] \
                if c in bases else ord("A")
        reads[b] = read
    kw = dict(paired=False, min_align=0.9, nthreads=2)
    e_ref = MapperEngine(sdx, genome, index, **kw)
    e_fus = FusedMapperEngine2(sdx, genome, index, **kw)
    nos = np.arange(B)
    rm1, _, rc = e_ref.map_batch(reads, lens, read_nos=nos)
    fm1, _, fc = e_fus.map_batch(reads, lens, read_nos=nos)
    assert np.array_equal(rc, fc)
    assert np.array_equal(rm1, fm1)
    assert np.array_equal(e_ref.final_pileup(), e_fus.final_pileup())
    assert np.array_equal(e_ref.stats.mate_counts,
                          e_fus.stats.mate_counts)
