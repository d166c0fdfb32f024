"""Multi-host orchestration (SURVEY §2.4/§5.8: the reference's scale-out
is one process per directory via SGE qsub + shared filesystem; here it is
jax.distributed over a global device mesh plus deterministic work
partitioning).

Two levels:

* **In-core**: a global Mesh spanning all hosts' devices; the mapping /
  calling steps from parallel.mesh shard over it; collectives run over
  the cards' interconnect within a host and the network across hosts.
* **File-level**: fastq (pairs) and caller site intervals are partitioned
  deterministically across processes (round-robin by index), preserving
  the reference's file-format contract so partial artifacts merge with
  the standard cohort tools.

One process drives the cards it sees; with several processes on one
host, each process must see exactly one card (``CUDA_VISIBLE_DEVICES``),
because a JAX process reserves most of a card's memory when it starts.
``n_processes=1`` exercises the full code path in one process.
"""

from __future__ import annotations

import os


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Initialize jax.distributed when configured; returns
    (process_id, num_processes).  No-op single-process otherwise."""
    import jax
    coordinator = coordinator or os.environ.get("PECALLER_COORDINATOR")
    if coordinator:
        num_processes = int(num_processes or
                            os.environ.get("PECALLER_NUM_PROCESSES", "1"))
        process_id = int(process_id if process_id is not None
                         else os.environ.get("PECALLER_PROCESS_ID", "0"))
        from jax._src import distributed as _dist
        if getattr(_dist.global_state, "client", None) is None:
            jax.distributed.initialize(coordinator_address=coordinator,
                                       num_processes=num_processes,
                                       process_id=process_id)
        return process_id, num_processes
    return 0, 1


def partition_files(files1, files2, process_id: int, num_processes: int):
    """Deterministic round-robin fastq(-pair) assignment per process."""
    sel = list(range(process_id, len(files1), num_processes))
    return ([files1[i] for i in sel],
            [files2[i] for i in sel] if files2 else [])


def partition_intervals(bed_rows, process_id: int, num_processes: int):
    """Caller guide intervals split by genome span: contiguous blocks of
    roughly equal total bases per process (keeps site streams sequential
    per process, the cache-friendly layout for the site merge)."""
    spans = [(c, s, e, e - s + 1) for (c, s, e) in bed_rows]
    total = sum(x[3] for x in spans)
    target = total / max(num_processes, 1)
    out, acc, pid = [], 0.0, 0
    for c, s, e, ln in spans:
        if pid == process_id:
            out.append((c, s, e))
        acc += ln
        while acc >= target * (pid + 1) and pid < num_processes - 1:
            pid += 1
    return out


def partition_genome(genome_size: int, process_id: int,
                     num_processes: int, align: int = 1 << 20):
    """Contiguous genome-position span per process, window-aligned so
    part boundaries coincide with caller window boundaries."""
    per = (genome_size + num_processes - 1) // num_processes
    per = ((per + align - 1) // align) * align
    lo = min(process_id * per, genome_size)
    hi = min(lo + per, genome_size)
    return lo, hi


def run_caller_distributed(cfg, coordinator=None, num_processes=None,
                           process_id=None):
    """Call this process's contiguous genome span (non-guide) or guide-
    interval block; parts merge byte-exactly with merge_caller_parts
    (the reference's calling scale-out is one pecaller process per
    cohort via qsub, call_directory.pl:52 — here the site axis itself
    is partitioned)."""
    from dataclasses import replace
    from ..caller import run_caller
    from ..formats.sdx import read_sdx
    pid, n = init_distributed(coordinator, num_processes, process_id)
    if n == 1:
        return run_caller(cfg)
    if cfg.guide_path is not None:
        rows = []
        with open(cfg.guide_path) as f:
            for line in f:
                tok = line.split()
                if len(tok) >= 3:
                    rows.append((tok[0], int(tok[1]), int(tok[2])))
        mine = partition_intervals(rows, pid, n)
        gp = cfg.out_base + f".part{pid}.bed"
        with open(gp, "w") as f:
            for c, s, e in mine:
                f.write(f"{c}\t{s}\t{e}\n")
        local = replace(cfg, guide_path=gp,
                        out_base=cfg.out_base + f".part{pid}",
                        write_header=(pid == 0),
                        site_range=(0, 1 << 62))
        return run_caller(local)
    sdx = read_sdx(cfg.sdx_path)
    lo, hi = partition_genome(sdx.genome_size, pid, n,
                              align=cfg.window_positions)
    local = replace(cfg, out_base=cfg.out_base + f".part{pid}",
                    site_range=(lo, hi), write_header=(pid == 0),
                    checkpoint=False)
    return run_caller(local)


def merge_caller_parts(cfg, num_processes: int) -> None:
    """Concatenate part artifacts into the single-process byte stream:
    multi-member gzip parts concatenate raw (decompressed concat ==
    stream concat), .snp parts are headerless text after part 0, and
    the .dist accumulators reduce exactly."""
    import numpy as np
    from ..caller.runner import _write_dist, _discover_pileups
    parts = [cfg.out_base + f".part{p}" for p in range(num_processes)]
    for ext in (".base.gz", ".piles.gz", ".snp"):
        with open(cfg.out_base + ext, "wb") as out:
            for p in parts:
                if not os.path.exists(p + ext):
                    continue
                with open(p + ext, "rb") as f:
                    while True:
                        b = f.read(1 << 22)
                        if not b:
                            break
                        out.write(b)
    tot_bases = 0
    hist = mean_sum = base_count = max_cov = None
    for p in parts:
        sp = p + ".dstat.npz"
        if not os.path.exists(sp):
            continue
        z = np.load(sp)
        tot_bases += int(z["tot_bases"])
        if hist is None:
            hist = z["counts_hist"].copy()
            mean_sum = z["mean_sum"].astype(np.float64)
            base_count = z["base_count"].copy()
            max_cov = z["max_cov"].copy()
        else:
            hist += z["counts_hist"]
            mean_sum += z["mean_sum"]
            base_count += z["base_count"]
            max_cov = np.maximum(max_cov, z["max_cov"])
    if hist is not None:
        names, _ = _discover_pileups(cfg.directory, cfg.pileup_ext)
        mean = np.where(base_count > 0,
                        mean_sum / np.maximum(base_count, 1), mean_sum)
        _write_dist(cfg, names, tot_bases, hist, mean, base_count,
                    max_cov)


def run_mapper_distributed(cfg, coordinator=None, num_processes=None,
                           process_id=None):
    """Map this process's share of the fastq list; artifacts are written
    with a per-process suffix and remain pipeline-compatible (the caller
    scans a directory of pileups; the merger unions .base.gz files)."""
    from ..mapper import run_mapper
    pid, n = init_distributed(coordinator, num_processes, process_id)
    files1, files2 = partition_files(cfg.files1, cfg.files2, pid, n)
    if not files1:
        return None
    from dataclasses import replace
    local = replace(cfg, files1=files1, files2=files2,
                    out_base=cfg.out_base + (f".part{pid}" if n > 1 else ""))
    return run_mapper(local)
