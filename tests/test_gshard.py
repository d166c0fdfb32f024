"""Genome-sharded octile mapping (mapper/gshard.py, index/shard.py):
the mm10/hg38-scale design of docs/SCALING.md on a CPU mesh.

Parity contract: the 2-shard genome-mesh engine must reproduce the
exact host oracle (and therefore the single-shard engine) on mapping
codes, positions, stats, pileup, and insertion records — the sharding
mechanics (local coordinates, boundary-overlap ownership, pmax chain
ratchet, gathered decide, owner-local traceback) must be invisible in
the outputs.  Scaled-down genome; the mechanics are the real ones
"""

import numpy as np
import pytest

from util import (make_genome, write_fasta, sample_reads, write_fastq)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("gshard")
    rng = np.random.default_rng(91)
    # two contigs + a repeated block spanning the shard boundary region
    names, seqs = make_genome(rng, [150_000, 110_000],
                              n_blocks=[(0, 9000, 25)])
    fa = str(d / "g.fa")
    write_fasta(fa, names, seqs)
    from pecaller_tpu.index import build_index
    build_index(fa, str(d / "g"), write_idx=False)
    reads = sample_reads(rng, names, seqs, 1200, read_len=100,
                         err_rate=0.01, paired=True, insert_lo=150,
                         insert_hi=450, indel_rate=0.1, max_indel=4)
    write_fastq(str(d / "r1.fastq"), reads, which=0)
    write_fastq(str(d / "r2.fastq"), reads, which=1)
    return d


def _load(d):
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.formats.index_files import load_index
    sdx = read_sdx(str(d / "g.sdx"))
    genome = read_seq(str(d / "g.seq"), sdx.genome_size)
    index = load_index(str(d / "g"))
    return sdx, genome, index


def _mesh(n):
    import jax
    from jax.sharding import Mesh
    dev = np.asarray(jax.devices()[:n])
    return Mesh(dev, axis_names=("genome",))


def _run_engine(eng, d, batch=600):
    from pecaller_tpu.formats.fastq import FastqBatcher
    outs = []
    for s1, l1, s2, l2, nos in FastqBatcher(
            str(d / "r1.fastq"), str(d / "r2.fastq"),
            batch_size=batch).batches():
        outs.append(eng.map_batch(s1, l1, s2, l2, read_nos=nos))
    return outs


@pytest.mark.parametrize("n_shards", [1, 2])
def test_gshard_matches_oracle(data, n_shards):
    from pecaller_tpu.mapper.engine import MapperEngine
    from pecaller_tpu.mapper.gshard import OctileShardedEngine
    sdx, genome, index = _load(data)
    kw = dict(paired=True, min_align=0.9, min_dist=0, max_dist=500,
              nthreads=2)
    e_ref = MapperEngine(sdx, genome, index, **kw)
    e_sh = OctileShardedEngine(sdx, genome, index, _mesh(n_shards), **kw)
    ref_outs = _run_engine(e_ref, data)
    sh_outs = _run_engine(e_sh, data)
    for (rm1, rm2, rc), (fm1, fm2, fc) in zip(ref_outs, sh_outs):
        assert np.array_equal(rc, fc)
        assert np.array_equal(rm1, fm1)
        assert np.array_equal(rm2, fm2)
    assert np.array_equal(e_ref.stats.mate_counts, e_sh.stats.mate_counts)
    assert e_ref.stats.total_dist == e_sh.stats.total_dist
    assert e_ref.stats.total_bases == e_sh.stats.total_bases
    p_ref = e_ref.final_pileup().astype(np.int64)
    p_sh = e_sh.final_pileup().astype(np.int64)
    assert np.array_equal(p_ref, p_sh)
    kr = sorted((k, len(s)) for k, _, s in e_ref.ins_records)
    kf = sorted((k, len(s)) for k, _, s in e_sh.ins_records)
    assert kr == kf


def test_gshard_plan_geometry(data):
    """Shard plan invariants: disjoint owned intervals covering the
    genome, overlap >= read length + slop, local spans < 2^28."""
    from pecaller_tpu.index.shard import plan_shards, LM, OV
    sdx, _, _ = _load(data)
    plan = plan_shards(sdx, 4)
    ist = sdx.istarts
    assert plan.bounds[0] == 0 and plan.bounds[-1] == ist[-1]
    for g in range(plan.n_shards):
        assert plan.own_hi[g] - max(plan.own_lo[g], 0) > 0
        assert plan.cover_idx[g] <= (plan.bounds[g + 1]
                                     - plan.bounds[g]) + LM + OV
        assert plan.cover_idx[g] < (1 << 28)
        if g > 0:
            # owned intervals tile exactly
            assert (plan.bases_idx[g] + plan.own_lo[g]
                    == plan.bounds[g])


def test_gshard_cross_shard_ties(tmp_path):
    """Adversarial: exact repeat copies placed in DIFFERENT shards (and
    straddling the boundary) force cross-shard score ties — the
    gathered decide must classify UNIQUE/SLIP/NON exactly like the
    global-view oracle."""
    rng = np.random.default_rng(17)
    names, seqs = make_genome(rng, [200_000])
    s = seqs[0]
    block = s[20_000:20_400].copy()
    # copies in shard 0, in shard 1, and straddling the 100k boundary
    s[150_000:150_400] = block
    s[99_800:100_200] = block
    d = tmp_path
    fa = str(d / "g.fa")
    write_fasta(fa, names, seqs)
    from pecaller_tpu.index import build_index
    build_index(fa, str(d / "g"), write_idx=False)
    reads = sample_reads(rng, names, seqs, 600, read_len=100,
                         err_rate=0.005, paired=True, insert_lo=150,
                         insert_hi=450)
    write_fastq(str(d / "r1.fastq"), reads, which=0)
    write_fastq(str(d / "r2.fastq"), reads, which=1)

    from pecaller_tpu.mapper.engine import MapperEngine
    from pecaller_tpu.mapper.gshard import OctileShardedEngine
    sdx, genome, index = _load(d)
    kw = dict(paired=True, min_align=0.9, min_dist=0, max_dist=500,
              nthreads=2)
    e_ref = MapperEngine(sdx, genome, index, **kw)
    e_sh = OctileShardedEngine(sdx, genome, index, _mesh(2), **kw)
    for (rm1, rm2, rc), (fm1, fm2, fc) in zip(
            _run_engine(e_ref, d), _run_engine(e_sh, d)):
        assert np.array_equal(rc, fc)
        assert np.array_equal(rm1, fm1)
        assert np.array_equal(rm2, fm2)
    assert np.array_equal(e_ref.stats.mate_counts,
                          e_sh.stats.mate_counts)
    assert np.array_equal(e_ref.final_pileup().astype(np.int64),
                            e_sh.final_pileup().astype(np.int64))


def test_octile_single_vs_quarter_engine(data):
    """The octile index through the unsharded fused engine matches the
    quarter-seeded engine batch outputs (same candidate semantics via a
    different projection split)."""
    from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2
    from pecaller_tpu.mapper.gshard import OctileShardedEngine
    from pecaller_tpu.index.quarter import build_quarter_index
    sdx, genome, index = _load(data)
    kw = dict(paired=True, min_align=0.9, min_dist=0, max_dist=500,
              nthreads=2)
    e_q = FusedMapperEngine2(sdx, genome, index,
                             quarter=build_quarter_index(index), **kw)
    e_o = OctileShardedEngine(sdx, genome, index, _mesh(1), **kw)
    for (rm1, rm2, rc), (fm1, fm2, fc) in zip(
            _run_engine(e_q, data), _run_engine(e_o, data)):
        assert np.array_equal(rc, fc)
        assert np.array_equal(rm1, fm1)
        assert np.array_equal(rm2, fm2)
