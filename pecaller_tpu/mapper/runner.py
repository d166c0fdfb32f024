"""File-level mapper orchestration and output writers.

Reproduces the reference pemapper's artifact set byte-for-byte (after
decompression): <out>.pileup.gz, <out>.indel.txt.gz, <out>.summary.txt and
per-fastq .mfile position dumps (pemapper.c:374-393, 775-781, 788-898).
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

import numpy as np

from ..formats.fastq import FastqBatcher
from ..formats.index_files import load_index
from ..formats.sdx import read_sdx, read_seq, find_chrom_mapper
from ..utils.log import get_logger, stage_timer, event
from .engine import MapperEngine

_log = get_logger("mapper")

MATE_NAMES_PAIRED = [
    "Unique Mate-Paired", "Unique Mate-Paired with slip", "Unique Single End",
    "Unique Mis-size", "Non-Unique Mate-Paired", "Non-Unique Mis-size",
    "Fragment Mismatch", "Non-unique with no map", "Neither Map"]
MATE_NAMES_SINGLE = [
    "Not Used", "Not Used", "Unique Mapping", "Not Used", "Not Used",
    "Not Used", "Not Used", "Non-Unique Mapping, discarded",
    "No mapping reaches threshold"]


@dataclass
class MapperConfig:
    out_base: str
    sdx_path: str
    paired: bool
    files1: list
    files2: list = field(default_factory=list)
    max_dist: int = 0
    min_dist: int = 0
    bisulfite: bool = False
    min_align: float = 0.9
    max_reads: int = 2 * 10**9
    nthreads: int = 2
    batch_size: int = 20000
    device: bool = False      # True: the fused mapping step on the device
    # pemapper_tsw extensions (pemapper_tsw.c): fixed trimming applied to
    # every read, and optional per-file output-group basenames that flush
    # and reset the pileup between groups (dump_output :848-962)
    trim_start: int = 0
    trim_end: int = 0
    out_names: list = field(default_factory=list)
    # batch-granular resumability (SURVEY §5.4): snapshot accumulated
    # pileup + stats after each completed fastq (pair); restart skips them
    checkpoint: bool = False
    # device-mesh scale-out for the v2 fused engine: None = use every
    # visible device (1 leaves the single-device step); reads shard over
    # the mesh, each shard accumulating a pileup partial (the reference's
    # per-directory SGE fan-out, map_directory_array.pl:101)
    mesh_shards: int | None = None


def _strip_sdx(path: str) -> str:
    if ".sdx" in path:
        return path[:path.rfind(".")]
    return path


def run_mapper(cfg: MapperConfig) -> MapperEngine:
    sdx = read_sdx(cfg.sdx_path)
    base = _strip_sdx(cfg.sdx_path)
    genome = read_seq(base + ".seq", sdx.genome_size)
    index = load_index(base)
    kw = dict(bisulfite=cfg.bisulfite, min_align=cfg.min_align,
              min_dist=cfg.min_dist, max_dist=cfg.max_dist,
              paired=cfg.paired, nthreads=cfg.nthreads)
    eng = None
    if cfg.device:
        if sdx.genome_size < 2**30:
            try:
                # fused pipeline: nbr index for small genomes (fastest
                # probe), quartered-key index (v2.5) past the nbr
                # closure's ~49x blow-up cap
                import jax
                from .device_map2 import FusedMapperEngine2
                nbr = quarter = None
                if os.environ.get("PECALLER_FORCE_Q4") == "1":
                    from ..index.quarter import load_quarter_index
                    quarter = load_quarter_index(base, index)
                else:
                    try:
                        from ..index.nbr import load_nbr_index
                        nbr = load_nbr_index(base, index)
                    except ValueError:
                        from ..index.quarter import load_quarter_index
                        quarter = load_quarter_index(base, index)
                n_sh = cfg.mesh_shards
                if n_sh is None:
                    n_sh = len(jax.devices())
                mesh = None
                if n_sh > 1:
                    from ..parallel.mesh import make_mesh
                    mesh = make_mesh(n_sh, 1)
                eng = FusedMapperEngine2(sdx, genome, index, nbr=nbr,
                                         quarter=quarter, mesh=mesh,
                                         **kw)
            except ValueError:
                # even the quarter index refused: v1 fused pipeline
                from .device_pipeline import FusedMapperEngine
                eng = FusedMapperEngine(sdx, genome, index, **kw)
        else:
            # int32 device coordinates overflow past 2^30 bases: keep
            # seeds on host, SW/traceback on device
            from .device_engine import DeviceMapperEngine
            eng = DeviceMapperEngine(sdx, genome, index, **kw)
    else:
        eng = MapperEngine(sdx, genome, index, **kw)
    tot_pairs = 0
    order_base = 0
    cur_base = cfg.out_base
    start_iter = 0
    ckpt_path = cfg.out_base + ".ckpt.npz"
    if cfg.checkpoint and os.path.exists(ckpt_path):
        start_iter, tot_pairs, order_base = _load_ckpt(ckpt_path, eng)
        event(_log, "resume", from_file=start_iter)
    for it in range(len(cfg.files1)):
        if it < start_iter:
            continue
        new_name = cfg.out_names[it] if it < len(cfg.out_names) and \
            cfg.out_names[it] else None
        if new_name is not None and new_name != cur_base and it > 0:
            write_outputs(cfg, eng, sdx, genome, tot_pairs,
                          out_base=cur_base)
            eng.reset_group()
            tot_pairs = 0
        if new_name is not None:
            cur_base = new_name
        f1 = cfg.files1[it]
        f2 = cfg.files2[it] if cfg.paired else None
        batcher = FastqBatcher(f1, f2, batch_size=cfg.batch_size,
                               max_reads=cfg.max_reads,
                               trim_start=cfg.trim_start,
                               trim_end=cfg.trim_end)
        eng._order_counter = order_base
        maps1_parts, maps2_parts = [], []
        if hasattr(eng, "map_batch_async"):
            # keep enough batches in flight that the device computes the
            # next (possibly K-batch-grouped) program while the host
            # fetches/post-processes earlier ones
            depth = 2 * getattr(eng, "_group_k", 1) + 1
            pend = []
            for batch in batcher.batches():
                s1, l1, s2, l2, nos = batch
                pend.append(eng.map_batch_async(s1, l1, s2, l2,
                                                read_nos=nos))
                if len(pend) >= depth:
                    m1, m2, _ = eng.resolve(pend.pop(0))
                    maps1_parts.append(m1)
                    maps2_parts.append(m2)
            while pend:
                m1, m2, _ = eng.resolve(pend.pop(0))
                maps1_parts.append(m1)
                maps2_parts.append(m2)
        else:
            for batch in batcher.batches():
                s1, l1, s2, l2, nos = batch
                m1, m2, _ = eng.map_batch(s1, l1, s2, l2, read_nos=nos)
                maps1_parts.append(m1)
                maps2_parts.append(m2)
        n_rec = batcher.total_records
        maps1 = (np.concatenate(maps1_parts) if maps1_parts
                 else np.zeros(0, np.uint32))
        maps1.astype("<u4").tofile(f1 + ".mfile")
        if cfg.paired:
            maps2 = (np.concatenate(maps2_parts) if maps2_parts
                     else np.zeros(0, np.uint32))
            maps2.astype("<u4").tofile(f2 + ".mfile")
        tot_pairs += n_rec
        order_base += n_rec
        event(_log, "file_done", file=f1, records=n_rec)
        if cfg.checkpoint:
            _save_ckpt(ckpt_path, eng, it + 1, tot_pairs, order_base)

    mt = getattr(eng, "mesh_timing", None)
    if mt and mt["batches"]:
        # sharded-path overhead accounting: host shard-staging +
        # result-fetch walls per batch — the measurable part of the
        # >=80% scaling-efficiency target
        event(_log, "mesh_overhead", n_shards=eng._n_sh,
              batches=mt["batches"],
              dispatch_ms_per_batch=round(
                  1e3 * mt["dispatch_s"] / mt["batches"], 2),
              fetch_ms_per_batch=round(
                  1e3 * mt["fetch_s"] / mt["batches"], 2))
    with stage_timer(_log, "write_outputs"):
        write_outputs(cfg, eng, sdx, genome, tot_pairs, out_base=cur_base)
    if cfg.checkpoint and os.path.exists(ckpt_path):
        os.remove(ckpt_path)
    return eng


def _save_ckpt(path, eng, next_iter, tot_pairs, order_base):
    import pickle
    counts = eng.final_pileup()
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp, counts=counts,
        mate_counts=eng.stats.mate_counts,
        scalars=np.asarray([next_iter, tot_pairs, order_base,
                            eng.stats.total_reads, eng.stats.total_bases,
                            eng.stats.total_dist, eng.stats.no_dists],
                           dtype=np.int64),
        ins=np.frombuffer(pickle.dumps(eng.ins_records), dtype=np.uint8))
    os.replace(tmp + (".npz" if not tmp.endswith(".npz") else ""), path)


def _load_ckpt(path, eng):
    import pickle
    z = np.load(path, allow_pickle=False)
    sc = z["scalars"]
    eng.pileup[:] = 0
    eng.pileup[0] = z["counts"]
    if hasattr(eng, "dev_counts"):
        eng.dev_counts = eng._jnp.zeros_like(eng.dev_counts)
    eng.stats.mate_counts = z["mate_counts"].copy()
    eng.stats.total_reads = int(sc[3])
    eng.stats.total_bases = int(sc[4])
    eng.stats.total_dist = int(sc[5])
    eng.stats.no_dists = int(sc[6])
    eng.ins_records = pickle.loads(z["ins"].tobytes())
    return int(sc[0]), int(sc[1]), int(sc[2])


def write_outputs(cfg: MapperConfig, eng: MapperEngine, sdx, genome,
                  tot_pairs: int, out_base: str | None = None) -> None:
    if out_base is None:
        out_base = cfg.out_base
    st = eng.stats
    names = MATE_NAMES_PAIRED if cfg.paired else MATE_NAMES_SINGLE

    if st.total_bases <= 0:
        # reference exits early: empty (unclosed) gz outputs + zero summary
        open(out_base + ".pileup.gz", "wb").close()
        open(out_base + ".indel.txt.gz", "wb").close()
        with open(out_base + ".summary.txt", "w") as f:
            f.write("\n" + "=" * 64)
            f.write("\n================= Summary " + "=" * 38)
            f.write("\n" + "=" * 64)
            f.write("\n" + "=" * 64)
            f.write("\n\nTotal Number of Mapping reads of Any Kind\t0"
                    "\tWith average Length\t0\tAverage Depth\t0"
                    "\tAverage Insert Size\t0")
            f.write("\n\nMapping Type\tCount\tFraction")
            f.write("\nAll\t%ld\t1".replace("%ld", str(tot_pairs)))
            for i in range(9):
                if "Not Used" not in names[i]:
                    frac = (st.mate_counts[i] / tot_pairs if tot_pairs
                            else float("nan"))
                    f.write("\n%s\t%d\t%g" % (names[i], st.mate_counts[i],
                                              frac))
            f.write("\n")
        return

    counts = eng.final_pileup()                     # (gs, 6) uint16
    tot_c = counts.astype(np.int64).sum(axis=1)
    nz = np.nonzero(tot_c > 0)[0]

    from ..formats.pileup import write_pileup
    write_pileup(out_base + ".pileup.gz", nz, counts[nz])

    # group insertion strings per position in canonical arrival order
    ins_by_pos = {}
    for key, gpos, s in sorted(eng.ins_records, key=lambda t: t[0]):
        ins_by_pos.setdefault(gpos, []).append(s)

    sstarts = sdx.sstarts
    with gzip.open(out_base + ".indel.txt.gz", "wt") as f:
        f.write("Fragment\tPositions\tReference Base\tTotal Coverage"
                "\tReference Reads\tNo Deletions\tNo Insertions"
                "\tInsertion Sequence")
        ins_pos = nz[counts[nz, 5] > 0]
        if len(ins_pos):
            chroms = find_chrom_mapper(sstarts, sdx.n_contigs, ins_pos)
            for pos, which in zip(ins_pos, chroms):
                ref = chr(genome[pos])
                row = counts[pos]
                if ref == "A":
                    ref_reads = row[0]
                elif ref == "C":
                    ref_reads = row[1]
                elif ref == "G":
                    ref_reads = row[2]
                else:
                    ref_reads = row[3]
                contig_pos = 1 + pos - sstarts[which]
                f.write("\n%s\t%d\t%c\t%d\t%d\t%d\t%d" % (
                    sdx.names[which], contig_pos, ref, tot_c[pos],
                    ref_reads, row[4], row[5]))
                for s in ins_by_pos.get(int(pos), []):
                    f.write("\t%s" % s)

    avg_readlen = float(st.total_bases)
    if st.total_reads > 0:
        avg_readlen /= float(st.total_reads)
    avg_dist = float(st.total_dist)
    if st.no_dists > 0:
        avg_dist /= float(st.no_dists)
    avg_reads = float(st.total_bases) / float(sdx.genome_size)

    with open(out_base + ".summary.txt", "w") as f:
        f.write("\n" + "=" * 64)
        f.write("\n================= Summary " + "=" * 38)
        f.write("\n" + "=" * 64)
        f.write("\n" + "=" * 64)
        f.write("\n\nTotal Number of Mapping reads of Any Kind\t%d"
                "\tWith average Length\t%g\tAverage Depth\t%g"
                "\tAverage Insert Size\t%g" % (
                    st.total_reads, avg_readlen, avg_reads, avg_dist))
        f.write("\n\nMapping Type\tCount\tFraction")
        f.write("\nAll\t%d\t1" % tot_pairs)
        for i in range(9):
            if "Not Used" not in names[i]:
                f.write("\n%s\t%d\t%g" % (
                    names[i], st.mate_counts[i],
                    st.mate_counts[i] / tot_pairs))
        f.write("\n")
