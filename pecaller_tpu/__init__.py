"""pecaller_tpu — a JAX short-read WGS mapping + calling engine for GPUs.

A from-scratch JAX/XLA/Pallas re-design of the PEMapper/PECaller pipeline
(reference: wingolab-org/pecaller, C/pthreads).  The pipeline stages:

  genome indexing   -> pecaller_tpu.index      (16-mer CSR seed index)
  read mapping      -> pecaller_tpu.mapper     (seed/chain/Smith-Waterman)
  base calling      -> pecaller_tpu.caller     (multi-sample empirical-Bayes EM)
  cohort merge/VCF  -> pecaller_tpu.cohort
  device kernels    -> pecaller_tpu.ops        (batched SW DP, pileup scatter)
  mesh scale-out    -> pecaller_tpu.parallel

File formats (.sdx/.seq/.idx/.mdx, binary pileup, .snp, .base.gz, VCF) are
byte-compatible with the reference so the two implementations interoperate
and can be golden-diffed against each other.
"""

__version__ = "0.1.0"

# Install the hugepage-backed numpy allocator (native/npalloc.c): on
# hosts that fault fresh 4 KiB pages slowly (lazy-paging VMs) this is a
# 4-30x speedup for every large host-side array the pipeline touches.
# Opt out with PECALLER_NO_HUGEPAGES=1.
from .utils.npalloc import install as _npalloc_install  # noqa: E402

_npalloc_install()
