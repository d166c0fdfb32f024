"""Argv-compatible command-line surface for every pipeline stage.

`python -m pecaller_tpu <command> ...` where <command> mirrors the
reference binary/script it replaces:

  index_genome      stdin answer-file protocol (index_genome_whole)
  pemapper          pemapper.c CLI (plus --device for the GPU path)
  pemapper_tsw      pemapper_tsw.c CLI (trimming + output groups)
  pecaller          pecaller.c CLI
  pecall_merger     pecall_merger.c CLI
  snp_to_vcf        snp_to_vcf.c CLI (stdout)
  make_snplist      make_snplist_formerge.pl
  make_snplist_restricted  make_snplist_formerge_restricted.pl
  merge_indel_snp   merge_indel_snp.pl
  snp_tran_counter  snp_tran_counter.pl (stdout)
  snp_tran_silent_rep  snp_tran_silent_rep.pl (stdout)
  map_directory     map_directory_array.pl (runs locally, no qsub)
  call_directory    call_directory.pl (runs locally, no qsub)
  merge_dir_fa      merge_dir_fa.pl
"""

from __future__ import annotations

import os
import sys


def _yes(s: str) -> bool:
    return "y" in s.lower()


def _read_list(path):
    names, out_names = [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or len(tok[0]) <= 2:
                break
            names.append(tok[0])
            out_names.append(tok[1] if len(tok) > 1 else "")
    return names, out_names


def cmd_pemapper(argv, tsw: bool = False):
    from .mapper import run_mapper, MapperConfig
    device = "--device" in argv
    argv = [a for a in argv if a != "--device"]
    out, sdxp, mode = argv[0], argv[1], argv[2]
    c_end, c_array = mode[0].upper(), (mode[1].upper() if len(mode) > 1
                                       else "")
    paired = c_end == "P"
    extra = 2 if tsw else 0
    if paired:
        f1, f2 = argv[3], argv[4]
        max_dist, min_dist = int(argv[5]), int(argv[6])
        bis, min_align = _yes(argv[7]), float(argv[8])
        threads, max_reads = int(argv[9]), int(argv[10])
        trim = (int(argv[11]), int(argv[12])) if tsw else (0, 0)
    else:
        f1, f2 = argv[3], None
        max_dist = min_dist = 0
        bis, min_align = _yes(argv[4]), float(argv[5])
        threads, max_reads = int(argv[6]), int(argv[7])
        trim = (int(argv[8]), int(argv[9])) if tsw else (0, 0)
    out_names = []
    if c_array == "A":
        files1, out_names = _read_list(f1)
        files2, _ = _read_list(f2) if paired else ([], [])
    else:
        files1 = [f1]
        files2 = [f2] if paired else []
    cfg = MapperConfig(out_base=out, sdx_path=sdxp, paired=paired,
                       files1=files1, files2=files2, max_dist=max_dist,
                       min_dist=min_dist, bisulfite=bis,
                       min_align=min_align, max_reads=max_reads,
                       nthreads=max(1, threads - 1), device=device,
                       trim_start=trim[0], trim_end=trim[1],
                       out_names=out_names if tsw else [])
    run_mapper(cfg)
    return 0


def cmd_pecaller(argv):
    from .caller import run_caller, CallerConfig
    ext, sdxp = argv[0], argv[1]
    out = argv[3]
    prob, theta = float(argv[4]), float(argv[5])
    haploid = _yes(argv[6])
    threads = int(argv[7])
    use_ped = _yes(argv[8])
    ped = dn = guide = None
    rest = argv[9:]
    if use_ped:
        ped, dn = rest[0], float(rest[1])
        guide = rest[2] if len(rest) > 2 else None
    else:
        guide = rest[0] if rest else None
    cfg = CallerConfig(pileup_ext=ext, sdx_path=sdxp, out_base=out,
                       prob_to_call=prob, theta=theta, haploid=haploid,
                       use_ped=use_ped, ped_path=ped,
                       denovo_rate=dn if dn else 1e-8, guide_path=guide,
                       nthreads=max(1, threads - 1))
    run_caller(cfg)
    return 0


def cmd_dump_pileups(argv):
    from .caller import run_caller, CallerConfig
    cfg = CallerConfig(pileup_ext=argv[0], sdx_path=argv[1],
                       out_base=argv[3], prob_to_call=float(argv[4]),
                       theta=float(argv[5]), haploid=_yes(argv[6]),
                       nthreads=max(1, int(argv[7]) - 1), dump_mode=True)
    run_caller(cfg)
    return 0


def cmd_pecall_merger(argv):
    from .cohort import run_merger
    # maxsnps/maxsamples (argv[0:2]) are allocation hints; unused here
    run_merger(bedfile=argv[2], outfile=argv[3], sdxfile=argv[4],
               is_haploid=_yes(argv[5]))
    return 0


def cmd_snp_to_vcf(argv):
    from .cohort import snp_to_vcf
    min_prob = float(argv[2]) if len(argv) > 2 else 0.0
    snp_to_vcf(argv[0], argv[1], sys.stdout, min_prob=min_prob)
    return 0


def cmd_map_directory(argv):
    """Pair fastqs in a directory and map them (map_directory_array.pl,
    run locally instead of qsub)."""
    directory, sdxp = argv[0], argv[1]
    fastqs = sorted(set(
        f.split(".")[0] for f in os.listdir(directory)
        if "fastq" in f and not f.endswith("mfile")))
    tails = {}
    for f in os.listdir(directory):
        if "fastq" in f and not f.endswith("mfile"):
            parts = f.split(".")
            tails[parts[0]] = "." + ".".join(parts[1:])
    matches = {}
    for a in fastqs:
        b = a.replace("_1_", "_2_").replace("_R1_", "_R2_")
        if b != a and b in fastqs:
            matches[a] = b
            matches[b] = a
    files1, files2 = [], []
    done = set()
    paired = False
    for a in fastqs:
        if a in done:
            continue
        if a in matches:
            paired = True
            b = matches[a]
            done.update((a, b))
            files1.append(os.path.join(directory, a + tails[a]))
            files2.append(os.path.join(directory, b + tails[b]))
        else:
            done.add(a)
            files1.append(os.path.join(directory, a + tails[a]))
    from .mapper import run_mapper, MapperConfig
    cfg = MapperConfig(out_base=directory.rstrip("/"), sdx_path=sdxp,
                       paired=paired, files1=files1, files2=files2,
                       max_dist=500, min_dist=0, min_align=0.85,
                       max_reads=200000000, nthreads=23)
    run_mapper(cfg)
    return 0


def cmd_call_directory(argv):
    directory, sdxp = argv[0], argv[1]
    guide = argv[2] if len(argv) > 2 else None
    ped = argv[3] if len(argv) > 3 else None
    from .caller import run_caller, CallerConfig
    cfg = CallerConfig(pileup_ext="pileup", sdx_path=sdxp,
                       out_base=directory.rstrip("/"), prob_to_call=0.95,
                       theta=0.001, haploid=False, use_ped=ped is not None,
                       ped_path=ped, denovo_rate=1e-8, guide_path=guide,
                       directory=directory, nthreads=23)
    run_caller(cfg)
    return 0


def cmd_merge_dir_fa(argv):
    """Merge per-chromosome .fa.gz into one fasta (merge_dir_fa.pl)."""
    import argparse
    import gzip
    import time
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--dir", required=True)
    ap.add_argument("-c", "--chr_list", required=True)
    ap.add_argument("-o", "--out", required=True)
    ns = ap.parse_args(argv)
    chrs = []
    for part in ns.chr_list.split(","):
        if "-" in part and part[0].isdigit():
            a, b = part.split("-")
            chrs += [f"chr{i}" for i in range(int(a), int(b) + 1)]
        else:
            chrs.append(f"chr{part}")
    found = {}
    for f in sorted(os.listdir(ns.dir)):
        if f.endswith(".fa.gz"):
            with gzip.open(os.path.join(ns.dir, f), "rt") as fh:
                found[f[:-6]] = fh.read()
    stamp = time.strftime("%Y-%m-%d")
    outpath = f"{ns.out}.{stamp}.fa"
    with open(outpath, "w") as out:
        printed = set()
        for c in chrs:
            if c not in found:
                raise SystemExit(f"ERROR: Did not find expected chr '{c}'")
            out.write(found[c])
            printed.add(c)
        for c in sorted(found):
            if c not in printed:
                out.write(found[c])
    print(f"Wrote {outpath}")
    return 0


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "index_genome":
        from .index import index_genome_cli
        return index_genome_cli(rest)
    if cmd == "pemapper":
        return cmd_pemapper(rest, tsw=False)
    if cmd == "pemapper_tsw":
        return cmd_pemapper(rest, tsw=True)
    if cmd == "pecaller":
        return cmd_pecaller(rest)
    if cmd == "dump_pileups":
        return cmd_dump_pileups(rest)
    if cmd == "pecall_merger":
        return cmd_pecall_merger(rest)
    if cmd == "snp_to_vcf":
        return cmd_snp_to_vcf(rest)
    if cmd == "make_snplist":
        from .cohort import make_snplist
        make_snplist(rest[0], rest[1])
        return 0
    if cmd == "make_snplist_restricted":
        from .cohort import make_snplist_restricted
        make_snplist_restricted(rest[0], rest[1])
        return 0
    if cmd == "merge_indel_snp":
        from .cohort import merge_indel_snp
        merge_indel_snp(rest[0], rest[1], rest[2], rest[3])
        return 0
    if cmd == "snp_tran_counter":
        from .cohort import snp_tran_counter
        snp_tran_counter(rest[0], sys.stdout)
        return 0
    if cmd == "snp_tran_silent_rep":
        from .cohort import snp_tran_silent_rep
        snp_tran_silent_rep(rest[0], rest[1], rest[2], sys.stdout)
        return 0
    if cmd == "map_directory":
        return cmd_map_directory(rest)
    if cmd == "call_directory":
        return cmd_call_directory(rest)
    if cmd == "merge_dir_fa":
        return cmd_merge_dir_fa(rest)
    print(f"unknown command: {cmd}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
