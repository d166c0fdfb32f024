"""Indexer parity: our .seq/.sdx/.mdx/.idx must match the C indexer's
(decompressed) bytes exactly."""

import os
import subprocess

import numpy as np
import pytest

from pecaller_tpu.index import build_index
from pecaller_tpu.formats.sdx import read_sdx
from pecaller_tpu.formats.index_files import load_index, read_mdx

from util import (golden_ready,
                  have_reference, run_ref_indexer, make_genome, write_fasta,
                  gz_bytes, golden_dir)

pytestmark = pytest.mark.skipif(not have_reference(),
                                reason="reference sources unavailable")


@pytest.fixture(scope="module")
def small_golden():
    """C-indexed small genome (10 contigs, N runs), cached across runs;
    our index is built alongside it (also cached)."""
    d = golden_dir("index_small")
    fasta = os.path.join(d, "genome.fa")
    if not golden_ready(os.path.join(d, "ref.sdx")):
        rng = np.random.default_rng(42)
        names, seqs = make_genome(
            rng, [5000, 3000, 2000, 1500, 1200, 1000, 900, 800, 700, 600],
            n_blocks=[(0, 100, 30), (1, 0, 5), (2, 1990, 10)])
        write_fasta(fasta, names, seqs)
        run_ref_indexer(fasta, os.path.join(d, "ref"), cwd=d)
    if not os.path.exists(os.path.join(d, "ours.sdx")):
        build_index(fasta, os.path.join(d, "ours"))
    return d, fasta


def test_seq_sdx_mdx_idx_match(small_golden):
    d, fasta = small_golden
    ours = os.path.join(d, "ours")

    assert gz_bytes(ours + ".seq") == gz_bytes(os.path.join(d, "ref.seq"))
    with open(ours + ".sdx") as f1, open(os.path.join(d, "ref.sdx")) as f2:
        assert f1.read() == f2.read()
    m1 = read_mdx(ours + ".mdx")
    m2 = read_mdx(os.path.join(d, "ref.mdx"))
    assert np.array_equal(m1, m2)
    # compare .idx via the sparse loader on both (full 16GB diff is wasteful;
    # sparse equality of (keys, starts) + total implies dense equality)
    i1 = load_index(ours)
    i2 = load_index(os.path.join(d, "ref"))
    assert np.array_equal(i1.keys, i2.keys)
    assert np.array_equal(i1.starts, i2.starts)
    assert np.array_equal(np.asarray(i1.positions), np.asarray(i2.positions))


def test_chunked_scan_equivalence(tmp_path):
    """The bounded-chunk contig scan must produce identical artifacts to
    a whole-contig scan (hg38-scale memory envelope)."""
    rng = np.random.default_rng(3)
    names, seqs = make_genome(rng, [300000, 50000],
                              n_blocks=[(0, 1000, 25), (0, 65530, 40)])
    fasta = str(tmp_path / "g.fa")
    write_fasta(fasta, names, seqs)
    build_index(fasta, str(tmp_path / "whole"), write_idx=False,
                chunk=1 << 30)
    build_index(fasta, str(tmp_path / "chunked"), write_idx=False,
                chunk=1 << 14)
    assert gz_bytes(str(tmp_path / "whole.seq")) == \
        gz_bytes(str(tmp_path / "chunked.seq"))
    with open(str(tmp_path / "whole.sdx")) as f1, \
            open(str(tmp_path / "chunked.sdx")) as f2:
        assert f1.read() == f2.read()
    assert np.array_equal(read_mdx(str(tmp_path / "whole.mdx")),
                          read_mdx(str(tmp_path / "chunked.mdx")))
    i1 = load_index(str(tmp_path / "whole"), cache=False)
    i2 = load_index(str(tmp_path / "chunked"), cache=False)
    assert np.array_equal(i1.keys, i2.keys)
    assert np.array_equal(i1.starts, i2.starts)


def test_bisulfite_mode(tmp_path):
    rng = np.random.default_rng(7)
    names, seqs = make_genome(rng, [2000])
    fasta = str(tmp_path / "g.fa")
    write_fasta(fasta, names, seqs)
    ours = str(tmp_path / "bis")
    build_index(fasta, ours, bisulfite=True, write_idx=False)
    idx = load_index(ours, cache=False)
    # in bisulfite space C==T: no key may contain the code pattern of C (01)
    # distinguishable from T; spot-check that C-containing 16-mers map to the
    # same key as their C->T converted version
    from pecaller_tpu.ops.encode import BISULFITE_BASE_BITS, rolling_kmers
    seq = seqs[0]
    conv = seq.copy()
    conv[conv == ord("C")] = ord("T")
    k1 = rolling_kmers(BISULFITE_BASE_BITS[seq])
    k2 = rolling_kmers(BISULFITE_BASE_BITS[conv])
    assert np.array_equal(k1, k2)
    assert idx.positions.shape[0] == 2000 - 15
