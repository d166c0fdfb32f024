"""Multi-process scale-out: 2-process jax.distributed CPU run of
run_mapper_distributed on a split fastq list must produce partial
pileups that merge to exact equality with a single-process run
(SURVEY §2.4: the reference's SGE fan-out becomes jax.distributed +
deterministic file partitioning)."""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from util import REPO, make_genome, write_fasta, sample_reads, write_fastq

_DRIVER = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
d = sys.argv[2]
pid = int(sys.argv[3])
coord = sys.argv[4]
sys.path.insert(0, sys.argv[1])
# distributed init MUST precede anything that may touch the backend
from pecaller_tpu.parallel.distributed import init_distributed
init_distributed(coord, 2, pid)
from pecaller_tpu.mapper import MapperConfig
from pecaller_tpu.parallel.distributed import run_mapper_distributed
cfg = MapperConfig(out_base=os.path.join(d, "dist"),
                   sdx_path=os.path.join(d, "g.sdx"), paired=True,
                   files1=[os.path.join(d, f"a{i}_1.fastq")
                           for i in range(2)],
                   files2=[os.path.join(d, f"a{i}_2.fastq")
                           for i in range(2)],
                   max_dist=500, min_dist=0, min_align=0.9,
                   batch_size=400, nthreads=1)
eng = run_mapper_distributed(cfg, coordinator=coord, num_processes=2,
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


@pytest.mark.timeout(600)
def test_two_process_mapper_merges_to_single(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(31)
    names, seqs = make_genome(rng, [25000])
    write_fasta(os.path.join(d, "genome.fa"), names, seqs)
    from pecaller_tpu.index import build_index
    build_index(os.path.join(d, "genome.fa"), os.path.join(d, "g"),
                write_idx=False)
    for i in range(2):
        reads = sample_reads(rng, names, seqs, 400, read_len=100,
                             err_rate=0.01, paired=True, insert_lo=150,
                             insert_hi=400, indel_rate=0.1, max_indel=3)
        write_fastq(os.path.join(d, f"a{i}_1.fastq"), reads, which=0)
        write_fastq(os.path.join(d, f"a{i}_2.fastq"), reads, which=1)

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

    # single-process reference over the same file list
    from pecaller_tpu.mapper import run_mapper, MapperConfig
    cfg = MapperConfig(out_base=os.path.join(d, "single"),
                       sdx_path=os.path.join(d, "g.sdx"), paired=True,
                       files1=[os.path.join(d, f"a{i}_1.fastq")
                               for i in range(2)],
                       files2=[os.path.join(d, f"a{i}_2.fastq")
                               for i in range(2)],
                       max_dist=500, min_dist=0, min_align=0.9,
                       batch_size=400, nthreads=1)
    run_mapper(cfg)

    from pecaller_tpu.formats.pileup import read_pileup
    gs = 25000 + 64
    merged = np.zeros((gs, 6), np.int64)
    for p in range(2):
        path = os.path.join(d, f"dist.part{p}.pileup.gz")
        assert os.path.exists(path), "partial pileup missing"
        pos, cnt = read_pileup(path)
        merged[pos] += cnt
    spos, scnt = read_pileup(os.path.join(d, "single.pileup.gz"))
    single = np.zeros((gs, 6), np.int64)
    single[spos] += scnt
    assert np.array_equal(merged, single)

    # partial artifacts keep the standard contract: mfiles are written
    # by exactly one process each and match the single run's
    for i in range(2):
        mf = os.path.join(d, f"a{i}_1.fastq.mfile")
        assert os.path.getsize(mf) > 0
