"""Mesh/sharding: the multichip dry run must compile and execute on the
virtual 8-device CPU mesh, and sharded results must match single-device."""

import numpy as np
import pytest


def test_dryrun_multichip():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_v2_sharded_matches_single():
    """The v2 fused step sharded over 8 devices must produce the same
    raw decisions and the same total pileup as the single-device step."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import __graft_entry__ as g
    from pecaller_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(4, 2)
    packed, dc, single, single_dc = g.v2_sharded_smoke(mesh, compare=True)
    # decisions: m1/m2/code/orb1/orb2/fb per pair
    # NOTE: exact equality is only guaranteed below the capacity caps —
    # the batch-coupled fallbacks (cumsum(tot) > H_CAP, heavy-spill HV)
    # are evaluated per shard-local batch and can legitimately diverge
    # from the single-device run on cap-hitting batches.  The smoke data
    # is sized to stay below every cap (v2_sharded_smoke asserts the
    # per-shard insertion-record marker), so strict equality holds here.
    assert np.array_equal(packed, single)
    # pileup partials over shards sum to the single-device pileup
    assert np.array_equal(dc.sum(axis=0, dtype=np.uint32), single_dc)


def test_run_mapper_sharded_artifacts_match_single(tmp_path):
    """run_mapper with the auto-selected 8-device mesh must write
    byte-identical artifacts to the single-device fused path (the mesh
    wired into production)."""
    import gzip
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from util import make_genome, write_fasta, sample_reads, write_fastq
    from pecaller_tpu.index import build_index
    from pecaller_tpu.mapper import run_mapper, MapperConfig

    d = str(tmp_path)
    rng = np.random.default_rng(17)
    names, seqs = make_genome(rng, [25000, 15000])
    write_fasta(f"{d}/genome.fa", names, seqs)
    build_index(f"{d}/genome.fa", f"{d}/g", write_idx=False)
    reads = sample_reads(rng, names, seqs, 700, read_len=100,
                         err_rate=0.01, paired=True, insert_lo=150,
                         insert_hi=400, indel_rate=0.1, max_indel=3)
    write_fastq(f"{d}/r1.fastq", reads, which=0)
    write_fastq(f"{d}/r2.fastq", reads, which=1)

    outs = {}
    for shards in (1, None):            # None = auto (all 8 devices)
        base = f"{d}/out_sh{shards}"
        cfg = MapperConfig(out_base=base, sdx_path=f"{d}/g.sdx",
                           paired=True, files1=[f"{d}/r1.fastq"],
                           files2=[f"{d}/r2.fastq"], max_dist=500,
                           min_dist=0, min_align=0.9, batch_size=700,
                           device=True, mesh_shards=shards, nthreads=2)
        eng = run_mapper(cfg)
        if shards is None:
            assert eng._n_sh == 8      # the mesh really was selected
        arts = {}
        for ext in (".pileup.gz", ".indel.txt.gz"):
            with gzip.open(base + ext, "rb") as f:
                arts[ext] = f.read()
        with open(base + ".summary.txt", "rb") as f:
            arts[".summary.txt"] = f.read()
        outs[shards] = arts
    assert outs[1] == outs[None]


def test_sharded_map_matches_single():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import __graft_entry__ as g
    from pecaller_tpu.parallel.mesh import make_mesh, sharded_map_step
    from pecaller_tpu.ops import sw as dsw
    mesh = make_mesh(4, 2)
    gs = 2048
    step = sharded_map_step(mesh, gs)
    refs, blens, reads, rlens = g._example_batch(B=64, N=64, M=48, seed=3)
    score, bk, bi, counts = step(refs, blens, reads, rlens)
    s1, k1, i1 = dsw.sw_align_device(refs, blens, reads, rlens)
    assert np.array_equal(np.asarray(score), np.asarray(s1))
    assert np.array_equal(np.asarray(bk), np.asarray(k1))
    # single-device pileup for comparison
    ev_pos, ev_kind, ins_j, _ = dsw.sw_traceback_device(
        refs, blens, reads, rlens, np.asarray(k1), np.asarray(i1))
    single = dsw.pileup_scatter(
        np.asarray(ev_pos).reshape(-1), np.asarray(ev_kind).reshape(-1),
        (np.asarray(ins_j) >= 0).reshape(-1), genome_size=gs)
    # note: sharded step scatters per-shard windows at the same local
    # coordinates; with identical inputs the reduced pileup must equal the
    # single-device scatter
    assert np.array_equal(np.asarray(counts), np.asarray(single))
