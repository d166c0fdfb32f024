"""Device-screen safety: run_caller with the screen must be byte-equal
to the pure native-engine path on fuzzed pileups that hover around every
gate (bad-base averages, min-depth, the 2.3 beam margin, indel-support
counts).  The native path is the parity-proven oracle (test_caller.py),
so equality here extends parity to the screened production path."""

import gzip
import os

import numpy as np
import pytest

from pecaller_tpu.caller import run_caller, CallerConfig
from pecaller_tpu.formats.pileup import write_pileup

from util import make_genome, write_fasta


def _mk_sdx(d, rng, L=4000):
    names, seqs = make_genome(rng, [L], names=["chr1"])
    write_fasta(os.path.join(d, "genome.fa"), names, seqs)
    from pecaller_tpu.index import build_index
    build_index(os.path.join(d, "genome.fa"), os.path.join(d, "g"),
                write_idx=False)
    return seqs[0]


def _fuzz_counts(rng, g, indiv, n_sites):
    """Counts engineered to hit borderline regions of every screen gate."""
    base_col = {65: 0, 67: 1, 71: 2, 84: 3}
    pos = np.sort(rng.choice(np.arange(20, len(g) - 20), size=n_sites,
                             replace=False)).astype(np.uint32)
    cnt = np.zeros((indiv, n_sites, 6), dtype=np.uint16)
    for k, p in enumerate(pos):
        rc = base_col[g[p]]
        kind = rng.integers(0, 8)
        for i in range(indiv):
            depth = int(rng.integers(0, 40))
            if kind == 1:        # shallow site (bad-base boundary)
                depth = int(rng.integers(0, 12))
            c = np.zeros(6, np.int64)
            c[rc] = depth
            if kind == 2 and depth > 2:       # het-ish mixture
                alt = (rc + 1) % 4
                c[alt] = rng.integers(0, depth)
                c[rc] -= c[alt] // 2
            if kind == 3:        # low-level errors (margin boundary)
                alt = (rc + int(rng.integers(1, 4))) % 4
                c[alt] = rng.integers(0, 4)
            if kind == 4:        # indel support around the <3 gate
                c[4] = rng.integers(0, 6)
            if kind == 5:
                c[5] = rng.integers(0, 6)
            if kind == 6 and depth > 4:       # hom alt
                c[(rc + 2) % 4] = c[rc]
                c[rc] = rng.integers(0, 3)
            cnt[i, k] = np.minimum(c, 65535)
    return pos, cnt


def _run_both(d, indiv, tmp_path, haploid=False, use_ped=False,
              guide=None):
    args = dict(pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
                prob_to_call=0.95, theta=0.001, haploid=haploid,
                use_ped=use_ped,
                ped_path=os.path.join(d, "trio.ped") if use_ped else None,
                denovo_rate=1e-8, guide_path=guide, directory=d,
                nthreads=2)
    run_caller(CallerConfig(out_base=str(tmp_path / "scr"),
                            device_screen=True, **args))
    run_caller(CallerConfig(out_base=str(tmp_path / "nat"),
                            device_screen=False, **args))
    for ext in (".snp", ".dist"):
        assert open(str(tmp_path / "scr") + ext).read() == \
            open(str(tmp_path / "nat") + ext).read(), ext
    for ext in (".base.gz", ".piles.gz"):
        with gzip.open(str(tmp_path / "scr") + ext, "rb") as f1, \
                gzip.open(str(tmp_path / "nat") + ext, "rb") as f2:
            assert f1.read() == f2.read(), ext


@pytest.mark.parametrize("indiv,haploid", [(3, False), (5, False),
                                           (2, True)])
def test_screen_matches_native(tmp_path, indiv, haploid):
    rng = np.random.default_rng(42 + indiv + (100 if haploid else 0))
    d = str(tmp_path / "work")
    os.makedirs(d)
    g = _mk_sdx(d, rng)
    pos, cnt = _fuzz_counts(rng, g, indiv, 600)
    for i in range(indiv):
        write_pileup(os.path.join(d, f"s{i}.pileup.gz"), pos, cnt[i])
    _run_both(d, indiv, tmp_path, haploid=haploid)


def test_screen_matches_native_ped(tmp_path):
    """Pedigree mode: denovo accounting must survive the screen split."""
    rng = np.random.default_rng(7)
    d = str(tmp_path / "work")
    os.makedirs(d)
    g = _mk_sdx(d, rng)
    pos, cnt = _fuzz_counts(rng, g, 3, 400)
    for i, nm in enumerate(["dad", "mom", "kid"]):
        write_pileup(os.path.join(d, f"{nm}.pileup.gz"), pos, cnt[i])
    with open(os.path.join(d, "trio.ped"), "w") as f:
        f.write("fam1\tdad\t0\t0\t1\nfam1\tmom\t0\t0\t2\n"
                "fam1\tkid\tdad\tmom\t1\n")
    _run_both(d, 3, tmp_path, use_ped=True)


def test_screen_adversarial_boundaries(tmp_path):
    """Manufacture sites exactly at the screen's decision boundaries:
    margin transitions around the 2.3 beam threshold (ref/alt mixes
    sweeping the alt count at every depth), the DEPTH_GATE f32-error
    gate, the phase-0 TMAX/CMAX table ceilings, and Ins-read
    ineligibility — byte parity vs the pure native path at each
   ."""
    rng = np.random.default_rng(1234)
    d = str(tmp_path / "work")
    os.makedirs(d)
    g = _mk_sdx(d, rng, L=8000)
    base_col = {65: 0, 67: 1, 71: 2, 84: 3}
    from pecaller_tpu.caller.device_screen import (DEPTH_GATE, TMAX,
                                                   CMAX)
    patterns = []
    # margin sweep: at every depth the EASY->HARD transition happens at
    # some alt count; sweeping c guarantees sites on both sides of
    # 2.3 +- BAND
    for depth in range(8, 49, 4):
        for c in range(0, 6):
            for alt_off in (1, 2, 3):
                patterns.append(("snp", depth, c, alt_off))
    # indel support around the <3 gate at several depths
    for depth in (10, 24, 40):
        for c in range(0, 5):
            patterns.append(("del", depth, c, 0))
            patterns.append(("ins", depth, c, 0))
    # phase-0 table ceilings
    for depth in (TMAX - 2, TMAX - 1, TMAX, TMAX + 1, TMAX + 2):
        for c in (0, 1, CMAX, CMAX + 1):
            patterns.append(("snp", depth, c, 1))
    # f32 depth gate
    for depth in (DEPTH_GATE - 2, DEPTH_GATE, DEPTH_GATE + 2):
        for c in (0, 2):
            patterns.append(("snp", depth, c, 1))
    n_sites = len(patterns)
    pos = np.sort(rng.choice(np.arange(20, len(g) - 20), size=n_sites,
                             replace=False)).astype(np.uint32)
    indiv = 3
    cnt = np.zeros((indiv, n_sites, 6), dtype=np.uint16)
    for k, (kind, depth, c, alt_off) in enumerate(patterns):
        rc = base_col[g[pos[k]]]
        for i in range(indiv):
            cc = np.zeros(6, np.int64)
            cc[rc] = depth - (c if kind == "snp" else 0)
            if kind == "snp":
                cc[(rc + alt_off) % 4] = c
            elif kind == "del":
                cc[4] = c
            else:
                cc[5] = c
            cnt[i, k] = np.minimum(cc, 65535)
    for i in range(indiv):
        write_pileup(os.path.join(d, f"s{i}.pileup.gz"), pos, cnt[i])
    _run_both(d, indiv, tmp_path)


def test_screen_matches_native_guide(tmp_path):
    """Guide-bed path (per-site haploid chrY/chrMT forcing)."""
    rng = np.random.default_rng(11)
    d = str(tmp_path / "work")
    os.makedirs(d)
    names, seqs = make_genome(rng, [3000, 1500], names=["chr1", "chrY"])
    write_fasta(os.path.join(d, "genome.fa"), names, seqs)
    from pecaller_tpu.index import build_index
    build_index(os.path.join(d, "genome.fa"), os.path.join(d, "g"),
                write_idx=False)
    for i in range(3):
        p1, c1 = _fuzz_counts(rng, seqs[0], 1, 300)
        p2, c2 = _fuzz_counts(rng, seqs[1], 1, 150)
        # chrY global positions: contig 0 stored length + 15 pad
        off = len(seqs[0]) + 15
        pos = np.concatenate([p1, p2 + off]).astype(np.uint32)
        cnt = np.concatenate([c1[0], c2[0]], axis=0)
        write_pileup(os.path.join(d, f"s{i}.pileup.gz"), pos, cnt)
    bed = os.path.join(d, "regions.bed")
    with open(bed, "w") as f:
        f.write("chr1\t10\t2990\nchrY\t10\t1490\n")
    _run_both(d, 3, tmp_path, guide=bed)
