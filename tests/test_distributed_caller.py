"""Multi-process caller scale-out: a 2-process
jax.distributed CPU run of run_caller_distributed over a genome-span
partition, merged with merge_caller_parts, must reproduce the
single-process artifacts byte-for-byte (decompressed streams + .snp +
.dist).  The reference's equivalent is one pecaller process per cohort
via qsub (call_directory.pl:52); here the site axis itself
partitions."""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from util import REPO, make_genome, write_fasta

_DRIVER = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
d = sys.argv[2]
pid = int(sys.argv[3])
coord = sys.argv[4]
sys.path.insert(0, sys.argv[1])
from pecaller_tpu.parallel.distributed import (init_distributed,
                                               run_caller_distributed)
init_distributed(coord, 2, pid)
from pecaller_tpu.caller import CallerConfig
cfg = CallerConfig(pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
                   out_base=os.path.join(d, "dist"), prob_to_call=0.95,
                   theta=0.001, haploid=False, directory=d, nthreads=1,
                   window_positions=1 << 14)
run_caller_distributed(cfg, coordinator=coord, num_processes=2,
                       process_id=pid)
import jax as j
assert j.process_count() == 2, j.process_count()
print("proc", pid, "done")
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_cohort(d, rng, gs=60_000, indiv=3, depth=20):
    from pecaller_tpu.index import build_index
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.formats.pileup import write_pileup
    names, seqs = make_genome(rng, [gs])
    write_fasta(os.path.join(d, "genome.fa"), names, seqs)
    build_index(os.path.join(d, "genome.fa"), os.path.join(d, "g"),
                write_idx=False)
    sdx = read_sdx(os.path.join(d, "g.sdx"))
    genome = read_seq(os.path.join(d, "g.seq"), sdx.genome_size)
    lut = np.full(256, -1, np.int16)
    for ch, i in zip(b"ACGT", range(4)):
        lut[ch] = i
    ref = lut[genome]
    n = sdx.genome_size
    pos_all = np.arange(n, dtype=np.uint32)
    is_snp = rng.random(n) < 1 / 500
    alt = (ref + rng.integers(1, 4, n)) % 4
    for s in range(indiv):
        dep = rng.poisson(depth, n).astype(np.int32)
        cnt = np.zeros((n, 6), np.int32)
        rows = np.arange(n)
        rc = np.maximum(ref, 0)
        cnt[rows, rc] = dep
        gt = rng.integers(0, 3, n)
        m = is_snp & (gt > 0)
        half = np.where(gt[m] == 1, dep[m] // 2, dep[m])
        cnt[np.nonzero(m)[0], alt[m]] += half
        cnt[np.nonzero(m)[0], rc[m]] -= half
        keep = (ref >= 0) & (dep > 0)
        write_pileup(os.path.join(d, f"s{s}.pileup.gz"),
                     pos_all[keep],
                     np.clip(cnt, 0, 65535).astype(np.uint16)[keep])


@pytest.mark.timeout(600)
def test_two_process_caller_merges_to_single(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(55)
    _make_cohort(d, rng)

    coord = f"localhost:{_free_port()}"
    driver = os.path.join(d, "driver.py")
    with open(driver, "w") as f:
        f.write(_DRIVER)
    # each process is one CPU device of its own (no virtual mesh)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen([sys.executable, driver, REPO, d, str(p),
                               coord],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for p in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=540)
        assert p.returncode == 0, out.decode()[-2000:]

    from pecaller_tpu.caller import run_caller, CallerConfig
    from pecaller_tpu.parallel.distributed import merge_caller_parts
    cfg = CallerConfig(pileup_ext="pileup",
                       sdx_path=os.path.join(d, "g.sdx"),
                       out_base=os.path.join(d, "dist"),
                       prob_to_call=0.95, theta=0.001, haploid=False,
                       directory=d, nthreads=1,
                       window_positions=1 << 14)
    merge_caller_parts(cfg, 2)

    scfg = CallerConfig(pileup_ext="pileup",
                        sdx_path=os.path.join(d, "g.sdx"),
                        out_base=os.path.join(d, "single"),
                        prob_to_call=0.95, theta=0.001, haploid=False,
                        directory=d, nthreads=1,
                        window_positions=1 << 14)
    run_caller(scfg)

    for ext in (".base.gz", ".piles.gz"):
        with gzip.open(os.path.join(d, "dist" + ext), "rb") as f:
            a = f.read()
        with gzip.open(os.path.join(d, "single" + ext), "rb") as f:
            b = f.read()
        assert a == b, f"{ext} differs"
    with open(os.path.join(d, "dist.snp"), "rb") as f:
        a = f.read()
    with open(os.path.join(d, "single.snp"), "rb") as f:
        b = f.read()
    assert a == b
    with open(os.path.join(d, "dist.dist")) as f:
        a = f.read()
    with open(os.path.join(d, "single.dist")) as f:
        b = f.read()
    assert a == b
