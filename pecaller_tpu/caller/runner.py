"""Caller orchestration: pileup stream merge, site dispatch to the exact
native model, and the .base.gz/.snp/.piles.gz/.dist artifact writers.

Reproduces pecaller's outputs byte-for-byte (after decompression) when the
reference is run with 2 threads (1 worker => deterministic row order);
see pecaller.c:226-1146 for the orchestration being mirrored.
"""

from __future__ import annotations

import ctypes
import gzip
import os
from dataclasses import dataclass, field

import numpy as np

from ..formats.pileup import read_pileup
from ..formats.sdx import read_sdx, find_chrom_caller
from ..native.build import ptr
from .native import load_pecall

INT_TO_GEN = "ACGTDIMRWSYKEH" + "N"
GEN_TO_INT = {c: i for i, c in enumerate(INT_TO_GEN[:14])}
GEN_TO_INT["N"] = 14
_GEN_LUT = np.full(256, -1, dtype=np.int16)
for _c, _i in GEN_TO_INT.items():
    _GEN_LUT[ord(_c)] = _i
SNP_TYPE = ["", "SNP", "DEL", "INS", "LOW", "MULTIALLELIC", "MESS"]
ALLELE_CHAR = "ACGTDI"
AUTO, CHRX, CHRY, CHRMT = 0, 1, 2, 3
MAX_DIST = 501


@dataclass
class CallerConfig:
    pileup_ext: str
    sdx_path: str
    out_base: str
    prob_to_call: float = 0.95
    theta: float = 0.001
    haploid: bool = False
    use_ped: bool = False
    ped_path: str | None = None
    denovo_rate: float = 1e-8
    guide_path: str | None = None
    directory: str = "."
    nthreads: int = 2
    chunk_sites: int = 8192
    # dump_pileups mode (src/dump_pileups.c): EM disabled, every site gets
    # a .piles.gz row, calls print as N (p=0 for deep samples, p=1 shallow),
    # no .snp rows
    dump_mode: bool = False
    # genome positions per streaming window (non-guide path); bounds RAM
    # at ~window*indiv*12 bytes regardless of genome size.  Small
    # windows pipeline best: read-ahead inflate, the window compute,
    # the background write task, and the deflate pool all overlap
    # (measured optimum on the 2-core bench host)
    window_positions: int = 1 << 20
    # device site screen: resolves provably-boring sites on
    # device and routes only interesting sites into the exact native
    # float64 engine (see caller/device_screen.py for the parity proof)
    device_screen: bool = True
    # host-native phase-0 screen (native/screen.c): the SAME simple-
    # pattern/table classification as the device phase-0, but run on the
    # host where it costs one byte-gather per sample and no transfer of
    # the count window (36 B/site) to the device.  The transcendental
    # phase-1 screen and the config beam stay on the device.  Set False
    # to screen phase 0 on the device too.
    host_screen: bool = True
    # device joint-configuration beam for HARD sites: the f32
    # device search proposes each site's surviving config set, an exact
    # float64 host finisher reproduces the native engine's bytes, and
    # flagged (boundary/tie/overflow/EM-continuation) sites fall back
    # to the native engine (see caller/device_beam.py).  Opt-in: after
    # the two-phase screen the residual is ~0.1% of sites, where the
    # native engine is faster than per-window beam dispatches; the beam
    # is for cohorts where host cores, not the chip, are the limit.
    device_beam: bool = False
    # gzip level for .base.gz/.piles.gz: the artifact contract is the
    # decompressed stream (all parity checks and downstream consumers
    # decompress), so the default trades disk for wall-clock; use 6 to
    # match the reference's zlib default byte-for-byte on disk
    gzip_level: int = 1
    # window-granular checkpoint/resume (non-guide path): after each
    # streamed window the output members are finalized and
    # <out>.cckpt.npz records stream position + coverage accumulators;
    # a rerun resumes at the last completed window (the reference's
    # restart granularity is a whole SGE job, SURVEY 5.3/5.4)
    checkpoint: bool = False
    # [site_lo, site_hi) genome-position bounds: the unit of multi-
    # process calling (parallel/distributed.run_caller_distributed) —
    # each process calls a contiguous span; part artifacts concatenate
    # byte-exactly (gzip members / headerless parts)
    site_range: tuple | None = None
    # False for distributed parts > 0 so artifact concatenation yields
    # the single-process byte stream
    write_header: bool = True
    # device mesh for the screen's phase-0/phase-1 programs: sites
    # shard over every device (the caller's in-core scale-out; the
    # reference's equivalent is one pecaller process per cohort via
    # qsub, call_directory.pl:52)
    mesh: object = None


def _chrom_type(name: str) -> int:
    tok = name.replace(":", "\0").replace("_", "\0").replace("-", "\0") \
              .replace(" ", "\0").split("\0")[0].lower()
    return {"chrx": CHRX, "chry": CHRY, "chrmt": CHRMT}.get(tok, AUTO)


def _discover_pileups(directory: str, ext: str):
    """readdir-order scan for files containing ``ext`` (pecaller.c:495-515).
    Sample name = prefix before the first '.', tab, or space."""
    names, files = [], []
    for entry in os.listdir(directory):
        if ext in entry:
            files.append(os.path.join(directory, entry))
            for sep in ".\t \n":
                entry = entry.split(sep)[0]
            names.append(entry)
    return names, files


def _parse_ped(path: str, sample_names):
    n = len(sample_names)
    dad = np.full(n, -1, dtype=np.int32)
    mom = np.full(n, -1, dtype=np.int32)
    sex = np.zeros(n, dtype=np.int32)
    name_to_i = {s: i for i, s in enumerate(sample_names)}
    with open(path) as f:
        for line in f:
            if len(line.strip()) <= 5:
                continue
            tok = line.split()
            if len(tok) < 5:
                continue
            fam, ind, d, mo, sx = tok[0], tok[1], tok[2], tok[3], tok[4]
            if ind not in name_to_i:
                continue
            i = name_to_i[ind]
            if d != "0" and d in name_to_i:
                dad[i] = name_to_i[d]
            if mo != "0" and mo in name_to_i:
                mom[i] = name_to_i[mo]
            sex[i] = int(sx)
    return dad, mom, sex


class _Stream:
    """Per-sample pileup stream with the reference's EOF accounting."""

    def __init__(self, path):
        pos, counts = read_pileup(path)
        # leading zero-position records are consumed and dropped
        # (pecaller.c:837-850)
        k = 0
        while k < len(pos) and pos[k] == 0:
            k += 1
        self.pos = pos[k:].astype(np.int64)
        self.counts = counts[k:]
        self.i = 0
        self.done = len(self.pos) == 0   # counted against running_files


class _ChunkedStream:
    """Streaming pileup reader: records delivered in position windows so
    whole-genome cohorts never materialize per-sample arrays in full."""

    _REC = np.dtype([("pos", "<u4"), ("counts", "<u2", (6,))])

    def __init__(self, path, chunk_bytes=1 << 24):
        import gzip as _gz
        self._f = _gz.open(path, "rb")
        self._chunk = chunk_bytes
        self._buf = np.zeros(0, dtype=self._REC)
        self._tail = b""
        self._eof = False
        self._first = True

    def _read_more(self):
        # decompress straight into a numpy buffer (readinto): bytes
        # objects come from glibc malloc, which this VM's pager faults
        # at ~40 MB/s; numpy buffers ride the hugepage allocator
        buf = np.empty(len(self._tail) + self._chunk, dtype=np.uint8)
        nt = len(self._tail)
        if nt:
            buf[:nt] = np.frombuffer(self._tail, dtype=np.uint8)
        got = self._f.readinto(memoryview(buf[nt:]))
        if not got:
            self._eof = True
            self._tail = b""
            return
        total = nt + got
        usable = total - (total % self._REC.itemsize)
        self._tail = buf[usable:total].tobytes()
        rec = buf[:usable].view(self._REC)
        if self._first and len(rec):
            # leading zero-position records dropped (pecaller.c:837-850)
            k = 0
            while k < len(rec) and rec["pos"][k] == 0:
                k += 1
            rec = rec[k:]
            if len(rec):
                self._first = False
        self._buf = np.concatenate([self._buf, rec]) \
            if len(self._buf) else rec.copy()

    def take_below(self, hi):
        """All records with pos < hi, consumed from the stream."""
        while not self._eof and (len(self._buf) == 0 or
                                 int(self._buf["pos"][-1]) < hi):
            self._read_more()
        cut = int(np.searchsorted(self._buf["pos"], hi))
        out_p = self._buf["pos"][:cut].astype(np.int64)
        out_c = self._buf["counts"][:cut].copy()
        self._buf = self._buf[cut:]
        return out_p, out_c

    @property
    def exhausted(self):
        return self._eof and len(self._buf) == 0


def _gz_member(data: bytes, level: int) -> bytes:
    """Deflate one standalone gzip member (zlib releases the GIL)."""
    import zlib
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


class _MemberGz:
    """Ordered multi-member gzip writer.

    Large blocks are deflated as independent gzip members by a shared
    thread pool (zlib drops the GIL, so on this 2-core host the deflate
    of window N overlaps the compute of window N+1 and uses both cores
    when the main thread is blocked on the device); one writer thread
    emits the compressed members strictly in submission order.  The
    artifact contract is the decompressed stream (concatenated gzip
    members decompress as one stream — the same property the
    window-granular checkpoint/resume relies on): ``member_end``
    returns a raw byte offset at a member boundary, and a resume
    truncates to it and appends fresh members."""

    CUT = 1 << 22              # coalesced literal bytes per member

    def __init__(self, path, level, pool, resume_offset=None,
                 max_queue: int = 8):
        import queue
        import threading
        if resume_offset is not None:
            self._raw = open(path, "r+b")
            self._raw.truncate(resume_offset)
            self._raw.seek(resume_offset)
        else:
            self._raw = open(path, "wb")
        self._level = level
        self._pool = pool
        self._parts = []
        self._psize = 0
        self._q = queue.Queue(maxsize=max_queue)
        self._exc = None
        self._ev = threading.Event
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if not hasattr(item, "result"):
                item.set()              # flush barrier
                continue
            try:
                self._raw.write(item.result())
            except Exception as e:     # surfaced on next write/close
                self._exc = e

    def _check(self):
        if self._exc is not None:
            raise self._exc

    def write(self, data: bytes):
        """Ordered literal bytes; coalesced into the next member."""
        self._check()
        self._parts.append(data)
        self._psize += len(data)
        if self._psize >= self.CUT:
            self._cut()

    def submit(self, fn):
        """Ordered lazy block: ``fn()`` produces the bytes; format and
        deflate both run in the pool.  Pending literal bytes become the
        member's prefix so the stream order is preserved."""
        self._check()
        prefix = b"".join(self._parts)
        self._parts, self._psize = [], 0
        lvl = self._level

        def job():
            return _gz_member(prefix + fn(), lvl)
        self._q.put(self._pool.submit(job))

    def _cut(self):
        if not self._parts:
            return
        data = b"".join(self._parts)
        self._parts, self._psize = [], 0
        self._q.put(self._pool.submit(_gz_member, data, self._level))

    def flush(self):
        """Every byte written so far reaches the underlying file."""
        self._cut()
        ev = self._ev()
        self._q.put(ev)
        ev.wait()
        self._check()

    def member_end(self) -> int:
        self.flush()
        self._raw.flush()
        return self._raw.tell()

    def close(self):
        self._cut()
        self._q.put(None)
        self._t.join()
        self._check()
        self._raw.close()


_TIMER = os.environ.get("PECALLER_CALLER_TIMING")


class _Phase:
    """Env-gated (PECALLER_CALLER_TIMING=1) phase wall-clock totals."""

    def __init__(self):
        import collections
        import time
        self.t = collections.defaultdict(float)
        self._time = time.time

    def __call__(self, name):
        import contextlib

        @contextlib.contextmanager
        def cm():
            t0 = self._time()
            yield
            self.t[name] += self._time() - t0
        return cm()

    def report(self):
        if _TIMER and self.t:
            tot = sum(self.t.values())
            rows = sorted(self.t.items(), key=lambda kv: -kv[1])
            print("caller phases: " + ", ".join(
                f"{k}={v:.2f}s" for k, v in rows) +
                f" (tracked {tot:.2f}s)", flush=True)


def run_caller(cfg: CallerConfig):
    sdx = read_sdx(cfg.sdx_path)
    base = cfg.sdx_path[:cfg.sdx_path.rfind(".")] \
        if ".sdx" in cfg.sdx_path else cfg.sdx_path
    import gzip as _gz
    with _gz.open(base + ".seq", "rb") as f:
        genome = np.frombuffer(f.read(sdx.genome_size), dtype=np.uint8)

    frag_pos = np.cumsum(sdx.stored_lens.astype(np.int64) + 15)
    chrom_types = np.array([_chrom_type(nm) for nm in sdx.names],
                           dtype=np.uint8)

    sample_names, files = _discover_pileups(cfg.directory, cfg.pileup_ext)
    indiv = len(sample_names)
    if indiv == 0:
        raise RuntimeError("no pileup files found")

    if cfg.use_ped:
        dad, mom, sex = _parse_ped(cfg.ped_path, sample_names)
    else:
        dad = np.full(indiv, -1, dtype=np.int32)
        mom = np.full(indiv, -1, dtype=np.int32)
        sex = np.zeros(indiv, dtype=np.int32)

    lib, model = load_pecall(indiv, cfg.haploid, cfg.theta, cfg.denovo_rate,
                             cfg.prob_to_call, cfg.use_ped, dad, mom, sex)

    screen = None
    if cfg.device_screen and not cfg.dump_mode:
        try:
            from .device_screen import CallerScreen
            screen = CallerScreen(indiv, cfg.haploid, mesh=cfg.mesh)
        except Exception:           # no usable jax backend: exact path
            screen = None

    beam = None
    if cfg.device_beam and not cfg.dump_mode and not cfg.use_ped \
            and screen is not None:
        try:
            from .device_beam import DeviceBeam
            beam = DeviceBeam(indiv, cfg.haploid, cfg.theta,
                              cfg.prob_to_call)
        except Exception:
            beam = None

    ck_path = cfg.out_base + ".cckpt.npz"
    resume_lo = 0
    ro = None
    if cfg.checkpoint and cfg.guide_path is None \
            and os.path.exists(ck_path):
        ck = np.load(ck_path)
        resume_lo = int(ck["next_lo"])
        ro = {k: int(ck[k + "_off"]) for k in ("base", "pile", "snp")}
    st = _Accum(indiv)
    if ro is not None:
        ck = np.load(ck_path)
        st.tot_bases = int(ck["tot_bases"])
        st.counts_hist = ck["counts_hist"]
        st.mean_sum = ck["mean_sum"]
        st.base_count = ck["base_count"]
        st.max_cov = ck["max_cov"]
    w = _SiteWriters(cfg, sample_names, resume_offsets=ro)
    ph = _Phase()
    ctx = dict(cfg=cfg, sdx=sdx, genome=genome, frag_pos=frag_pos,
               chrom_types=chrom_types, indiv=indiv, lib=lib, model=model,
               screen=screen, beam=beam, ph=ph)

    if cfg.guide_path is None:
        from concurrent.futures import ThreadPoolExecutor
        streams = [_ChunkedStream(p) for p in files]
        # ~23*indiv+43 bytes/window-position across all reusable
        # buffers: cap the resident set at ~2 GB for large cohorts
        window = min(cfg.window_positions,
                     max(1 << 20, (2 << 30) // (23 * indiv + 43)))
        lo = resume_lo
        # per-stream gz decompression releases the GIL: overlap it, and
        # double-buffer — the NEXT window's reads are submitted before
        # this window's compute so decompression hides behind it
        pool = ThreadPoolExecutor(max_workers=min(8, len(streams)))

        def _submit(bound):
            return [pool.submit(s.take_below, bound) for s in streams]

        site_hi = None
        if cfg.site_range is not None:
            # multi-process span: start at site_lo, stop at site_hi
            lo = max(lo, int(cfg.site_range[0]))
            site_hi = int(cfg.site_range[1])
        if lo:                          # resume: discard completed span
            for f in _submit(lo):
                f.result()
        futs = _submit(min(lo + window, site_hi)
                       if site_hi is not None else lo + window)
        # reusable window buffers (hugepage-backed: this VM faults
        # fresh 4 KiB pages at ~40 MB/s, so per-window allocation of
        # the multi-hundred-MB merge target would dominate); cached
        # across run_caller calls so repeated runs skip first-touch
        bufs = _window_bufs(window, indiv)
        mask_buf, rank_buf, pos_buf, data_buf, pres_buf = bufs.merge
        ctx["bufs"] = bufs
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        while site_hi is None or lo < site_hi:
            hi = lo + window
            if site_hi is not None:
                hi = min(hi, site_hi)
            with ph("read"):
                chunks = [f.result() for f in futs]
            exhausted = all(s.exhausted for s in streams)
            if not (exhausted and all(len(c[0]) == 0 for c in chunks)):
                nxt = hi + window
                if site_hi is not None:
                    nxt = min(nxt, site_hi)
                futs = _submit(nxt)
            if all(len(c[0]) == 0 for c in chunks):
                if exhausted:
                    break
                lo = hi
                continue
            with ph("merge"):
                # window-bitmap union + dense scatter, threaded in C
                # (native/screen.c merge_window)
                offs = np.zeros(indiv + 1, np.int64)
                offs[1:] = np.cumsum([len(p_) for p_, _ in chunks])
                cat_pos = np.concatenate(
                    [p_ for p_, _ in chunks]) if offs[-1] else \
                    np.zeros(0, np.int64)
                cat_cnt = np.concatenate(
                    [c_ for _, c_ in chunks]) if offs[-1] else \
                    np.zeros((0, 6), np.uint16)
                n_pos = lib.merge_window(
                    cat_pos.ctypes.data_as(i64p),
                    cat_cnt.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint16)),
                    offs.ctypes.data_as(i64p), indiv, lo, window,
                    cfg.nthreads, mask_buf.ctypes.data_as(u8p),
                    rank_buf.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)),
                    pos_buf.ctypes.data_as(i64p),
                    data_buf.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint16)),
                    pres_buf.ctypes.data_as(u8p))
                all_pos = pos_buf[:n_pos]
                data = data_buf[:n_pos]
                present = pres_buf[:n_pos]
            # non-guide quirk: chrY/MT are NOT forced haploid
            # (only the guide path does, pecaller.c:968-969)
            hap = np.full(len(all_pos), 1 if cfg.haploid else 0, np.uint8)
            _process_window(ctx, w, st, all_pos, data, present, hap,
                            count_absent=False)
            if cfg.checkpoint:
                with ph("ckpt"):
                    offs = w.sync_offsets()
                    tmp = ck_path + ".tmp"
                    with open(tmp, "wb") as f:
                        np.savez(f, next_lo=hi, base_off=offs["base"],
                                 pile_off=offs["pile"],
                                 snp_off=offs["snp"],
                                 tot_bases=st.tot_bases,
                                 counts_hist=st.counts_hist,
                                 mean_sum=st.mean_sum,
                                 base_count=st.base_count,
                                 max_cov=st.max_cov)
                    os.replace(tmp, ck_path)
            lo = hi
    else:
        sites_all = _parse_guide(cfg.guide_path, sdx, frag_pos)
        if len(sites_all) and (sites_all[1:] < sites_all[:-1]).any():
            # non-ascending bed: the streaming early-stop reduction
            # below needs monotone sites; fall back to the full-read
            # path (reference semantics preserved either way)
            _run_guide_legacy(ctx, w, st, files, sites_all)
        else:
            _run_guide_windowed(ctx, w, st, files, sites_all)

    w.close()
    if cfg.site_range is None:
        with ph("dist"):
            _write_dist(cfg, sample_names, st.tot_bases, st.counts_hist,
                        st.mean_done(), st.base_count, st.max_cov)
    else:
        # distributed part: persist raw accumulators; the merge step
        # reduces them and writes the final .dist
        np.savez(cfg.out_base + ".dstat.npz", tot_bases=st.tot_bases,
                 counts_hist=st.counts_hist, mean_sum=st.mean_sum,
                 base_count=st.base_count, max_cov=st.max_cov)
    if cfg.checkpoint and os.path.exists(ck_path):
        os.remove(ck_path)
    ph.report()
    return dict(n_sites=st.tot_bases, sample_names=sample_names,
                device_sites_phase0=screen.sites_phase0 if screen else 0,
                device_sites_phase1=screen.sites_phase1 if screen else 0)


class _Accum:
    """Coverage statistics accumulated across windows (.dist inputs)."""

    def __init__(self, indiv):
        self.tot_bases = 0
        self.counts_hist = np.zeros((indiv, MAX_DIST), dtype=np.int64)
        # int64 (coverage is integral): lets native/screen.c accumulate
        # all four directly in its fused stats pass
        self.mean_sum = np.zeros(indiv, dtype=np.int64)
        self.base_count = np.zeros(indiv, dtype=np.int64)
        self.max_cov = np.zeros(indiv, dtype=np.int64)

    def add(self, tot_cov, present, count_absent):
        n, indiv = tot_cov.shape
        self.tot_bases += n
        # absent samples land in bin 0, which _write_dist recomputes
        # from tot_bases anyway — so one flat unweighted bincount covers
        # every sample at once (the per-sample weighted-bincount loop
        # was a float64 path and a caller hot spot)
        cov = np.where(present, tot_cov, 0)
        self.mean_sum += cov.sum(axis=0)
        self.max_cov = np.maximum(self.max_cov,
                                  cov.max(axis=0, initial=0))
        capped = np.minimum(cov, MAX_DIST - 1)
        flat = capped + np.arange(indiv, dtype=np.int32) * MAX_DIST
        self.counts_hist += np.bincount(
            flat.ravel(), minlength=indiv * MAX_DIST).reshape(
            indiv, MAX_DIST)
        self.base_count += n if count_absent \
            else present.sum(axis=0, dtype=np.int64)

    def mean_done(self):
        return np.where(self.base_count > 0,
                        self.mean_sum / np.maximum(self.base_count, 1),
                        self.mean_sum)


class _WindowBufs:
    """Reusable per-window output buffers (hugepage-backed; this VM
    faults fresh pages at ~40 MB/s, so per-window np.zeros/np.ones of
    these would dominate the pipeline)."""

    def __init__(self, window, indiv):
        from ..utils.hugemem import hp_empty
        self.calls = hp_empty((window, indiv), np.int8)
        self.active = hp_empty((window, indiv), np.uint8)
        self.probs = hp_empty((window, indiv), np.float64)
        self.types = hp_empty(window, np.uint8)
        self.denovo = hp_empty(window, np.int32)
        self.acnt = hp_empty((window, 6), np.int32)
        self.codes = hp_empty(window, np.uint8)
        self.merge = (hp_empty(window, np.uint8),
                      hp_empty(window, np.int32),
                      hp_empty(window, np.int64),
                      hp_empty((window, indiv, 6), np.uint16),
                      hp_empty((window, indiv), np.uint8))


_BUF_CACHE: dict = {}


def _window_bufs(window, indiv):
    key = (window, indiv)
    if key not in _BUF_CACHE:
        _BUF_CACHE.clear()              # one live geometry at a time
        _BUF_CACHE[key] = _WindowBufs(window, indiv)
    return _BUF_CACHE[key]


def _process_window(ctx, w, st, all_pos, data, present, site_haploid,
                    count_absent):
    cfg, sdx = ctx["cfg"], ctx["sdx"]
    frag_pos = ctx["frag_pos"]
    indiv = ctx["indiv"]
    ph = ctx.get("ph") or _Phase()
    n_sites = len(all_pos)

    which = find_chrom_caller(frag_pos, sdx.n_contigs,
                              max((sdx.n_contigs - 1) // 2, 0), all_pos)
    which = np.clip(which, 0, sdx.n_contigs - 1)
    ctype = ctx["chrom_types"][which]
    fp_prev = np.concatenate([[0], frag_pos])
    contig_pos = 1 + all_pos - fp_prev[which]
    refc = ctx["genome"][np.clip(all_pos, 0, sdx.genome_size - 1)]
    ref_int = _GEN_LUT[refc]
    if (ref_int < 0).any():
        raise RuntimeError("illegal genome character at a called site")
    ref_int = ref_int.astype(np.int32)

    host = cfg.host_screen
    codes = out_calls = out_active = None
    if host:
        # fused host phase-0 screen + stats (native/screen.c): one
        # threaded pass over the window, zero device transfer
        from .device_screen import _phase0_tables, EASY, BAD, UNRES, HARD
        from .native import host_screen_stats
        bufs = ctx.get("bufs")
        if bufs is not None and n_sites <= len(bufs.types):
            codes = bufs.codes[:n_sites]
            out_calls = bufs.calls[:n_sites]
            out_active = bufs.active[:n_sites]
        with ph("screen"):
            presc = np.zeros(indiv, np.int64)
            ref_u8 = ref_int.astype(np.uint8)
            codes, out_calls, out_active = host_screen_stats(
                data, present, ref_u8, ctype, _phase0_tables(cfg.haploid),
                indiv, cfg.haploid, cfg.nthreads, st.counts_hist,
                st.mean_sum, st.max_cov, presc, codes, out_calls,
                out_active)
            st.tot_bases += n_sites
            st.base_count += n_sites if count_absent else presc
    else:
        with ph("stats"):
            # i32 is ample (6 * 65535 per site-sample) and halves the
            # memory traffic of the stats/easy passes on this host
            tot_cov = data.sum(axis=2, dtype=np.int32)  # (S, I) all 6
            st.add(tot_cov, present, count_absent)

    if cfg.dump_mode:
        from ..formats.sdx import find_chrom_dump
        dwhich = find_chrom_dump(frag_pos, sdx.n_contigs, all_pos)
        dfrag = [sdx.names[x] if 0 <= x < sdx.n_contigs else ""
                 for x in dwhich]
        dpos = 1 + all_pos - fp_prev[np.clip(dwhich, 0, sdx.n_contigs)]
        w.write_dump_window(dfrag, dpos, refc, data)
        return

    callable_m = ref_int < 6
    hap_want = 1 if cfg.haploid else 0
    screen = ctx.get("screen")
    if host:
        bufs = ctx.get("bufs")
        if bufs is not None and n_sites <= len(bufs.types):
            # no fills needed: with codes-based fast detection the
            # probs/types/denovo/acnt of a row are only ever read for
            # HARD rows, and every HARD row is written by the beam or
            # the native engine before the writer reads it
            out_probs = bufs.probs[:n_sites]
            out_types = bufs.types[:n_sites]
            out_denovo = bufs.denovo[:n_sites]
            out_acnt = bufs.acnt[:n_sites]
        else:
            out_probs = np.ones((n_sites, indiv), dtype=np.float64)
            out_types = np.zeros(n_sites, dtype=np.uint8)
            out_denovo = np.zeros(n_sites, dtype=np.int32)
            out_acnt = np.zeros((n_sites, 6), dtype=np.int32)

        # the screen classified under cfg.haploid; forced-haploid sites
        # (guide-path chrY/MT in a diploid run) must go to the exact
        # engine instead of trusting an EASY/UNRES verdict
        mm = site_haploid != hap_want
        if mm.any():
            codes[mm & ((codes == EASY) | (codes == UNRES))] = HARD
        cidx = np.nonzero(callable_m & (codes != EASY)
                          & (codes != BAD))[0]
        un = cidx[codes[cidx] == UNRES]
        if len(un):
            # every window's UNRES sites go to the device phase-1
            # screen: one dispatch+fetch round trip is 0.675 ms on an
            # H100 (PERF.md), small beside a window's host work, so no
            # size threshold (identical bytes either way — the screen
            # is conservative, native is exact)
            if screen is not None:
                with ph("phase1"):
                    c1 = screen.phase1(np.ascontiguousarray(data[un]),
                                       ref_u8[un], ctype[un])
                codes[un] = c1
                ne = un[c1 == EASY]
                if len(ne):
                    min_depth = 1 if cfg.haploid else 2
                    tot5 = data[ne, :, :5].sum(2, dtype=np.int32)
                    act = tot5 > min_depth
                    out_active[ne] = act.astype(np.uint8)
                    out_calls[ne] = np.where(
                        act, ref_int[ne, None].astype(np.int8),
                        np.int8(14))
                cidx = cidx[codes[cidx] == HARD]
            else:                       # no device: exact engine decides
                codes[un] = HARD
    else:
        out_calls = np.full((n_sites, indiv), 14, dtype=np.int8)
        out_probs = np.ones((n_sites, indiv), dtype=np.float64)
        out_types = np.zeros(n_sites, dtype=np.uint8)
        out_denovo = np.zeros(n_sites, dtype=np.int32)
        out_acnt = np.zeros((n_sites, 6), dtype=np.int32)
        out_active = np.zeros((n_sites, indiv), dtype=np.uint8)
        cidx = np.nonzero(callable_m)[0]

    if not host and screen is not None and len(cidx):
        from .device_screen import EASY, BAD, HARD
        all_callable = len(cidx) == n_sites
        with ph("screen"):
            codes = screen(data if all_callable else data[cidx],
                           ref_int[cidx].astype(np.uint8),
                           ctype[cidx].astype(np.uint8))
        # forced-haploid sites: same exact-engine routing as above
        mm = site_haploid[cidx] != hap_want
        if mm.any():
            codes[mm & (codes == EASY)] = HARD
        # EASY: every active sample is hom-ref beyond the 2.3 beam
        # threshold -> the exact beam keeps one config; posterior is
        # exactly 1.0, call = ref, site type REF (out_probs init 1.0,
        # out_types 0, out_acnt 0 already hold).
        with ph("easy"):
            easy_m = codes == EASY
            if easy_m.any():
                min_depth = 1 if cfg.haploid else 2
                em = np.zeros(n_sites, bool)
                em[cidx[easy_m]] = True
                # dense masked copies: nearly every site is easy, so
                # computing over the full window and np.copyto(where=)
                # beats two (|easy|, I) fancy-index gathers/scatters.
                # active uses depth WITHOUT the Ins column
                # (pecaller.c:1233-1236): reuse tot_cov from the stats
                # pass.
                act = (tot_cov - data[:, :, 5]) > min_depth
                m2 = em[:, None]
                np.copyto(out_active, act.astype(np.uint8), where=m2)
                np.copyto(out_calls,
                          np.where(act, ref_int[:, None].astype(np.int8),
                                   np.int8(14)), where=m2)
        # BAD: the integer bad-base gates fired -> all samples print
        # "N 1" with active=0; the initialized defaults already match.
        cidx = cidx[codes == 0]            # HARD -> beam/exact engine

    beam = ctx.get("beam")
    if beam is not None and len(cidx):
        # the device beam proposes each HARD site's surviving config
        # set; the f64 finisher reproduces the native bytes; flagged
        # sites (f32 boundary, beam overflow, EM continuation) fall
        # through to the native engine below
        hap_want = 1 if cfg.haploid else 0
        bm = site_haploid[cidx] == hap_want
        bsel = cidx[bm]
        rest = cidx[~bm]
        if len(bsel):
            from .device_beam import finish_f64
            with ph("beam"):
                n_cfg, cfgs, flags, _, _, hrank, hval = beam(
                    np.ascontiguousarray(data[bsel]),
                    np.ascontiguousarray(ref_int[bsel].astype(np.uint8)))
            ok = flags == 0
            if ok.any():
                with ph("beam_finish"):
                    # ctype matters: chrY sites are exempt from the
                    # <50%-of-samples-at-8x bad gate (pecaller.c:
                    # 1303-1304; ADVICE r4 high)
                    fc, fp, ty, ac_, act_ = finish_f64(
                        data[bsel[ok]], ref_int[bsel[ok]],
                        n_cfg[ok], cfgs[ok], hrank[ok], hval[ok],
                        indiv=indiv, haploid=cfg.haploid,
                        theta=cfg.theta, threshold=cfg.prob_to_call,
                        ctype=ctype[bsel[ok]].astype(np.uint8))
                sel2 = bsel[ok]
                out_calls[sel2] = fc
                out_probs[sel2] = fp
                out_types[sel2] = ty
                out_acnt[sel2] = ac_
                out_active[sel2] = act_
            cidx = np.sort(np.concatenate([bsel[~ok], rest]))
    ctx_native = ph("native")
    ctx_native.__enter__()
    for lo in range(0, len(cidx), cfg.chunk_sites):
        sel = cidx[lo:lo + cfg.chunk_sites]
        nb = len(sel)
        reads = np.ascontiguousarray(data[sel])
        ri = np.ascontiguousarray(ref_int[sel].astype(np.uint8))
        ch = np.ascontiguousarray(ctype[sel].astype(np.uint8))
        hp = np.ascontiguousarray(site_haploid[sel])
        calls = np.zeros((nb, indiv), dtype=np.int8)
        probs = np.zeros((nb, indiv), dtype=np.float64)
        types = np.zeros(nb, dtype=np.uint8)
        dn = np.zeros(nb, dtype=np.int32)
        ac = np.zeros((nb, 6), dtype=np.int32)
        act = np.zeros((nb, indiv), dtype=np.uint8)
        ctx["lib"].pecall_sites_batch(
            ctx["model"], ptr(reads, ctypes.c_uint16),
            ptr(ri, ctypes.c_uint8), ptr(ch, ctypes.c_uint8),
            ptr(hp, ctypes.c_uint8), nb, cfg.nthreads,
            ptr(calls, ctypes.c_int8), ptr(probs, ctypes.c_double),
            ptr(types, ctypes.c_uint8), ptr(dn, ctypes.c_int32),
            ptr(ac, ctypes.c_int32), ptr(act, ctypes.c_uint8))
        out_calls[sel] = calls
        out_probs[sel] = probs
        out_types[sel] = types
        out_denovo[sel] = dn
        out_acnt[sel] = ac
        out_active[sel] = act
    ctx_native.__exit__(None, None, None)

    with ph("write"):
        w.write_calls_window(sdx, which, contig_pos, refc, callable_m,
                             data, out_calls, out_probs, out_types,
                             out_denovo, out_acnt, out_active,
                             codes=codes if host else None)


class _SiteWriters:
    """Incremental .base.gz/.snp/.piles.gz writers (headers once)."""

    # fast rows formatted+deflated per ~256k-row pool task: bounds each
    # task's buffer at ~10 MB (this VM faults fresh pages at ~40 MB/s,
    # so giant one-shot buffers would dominate) and keeps both cores fed
    FMT_CHUNK = 1 << 18
    # runs shorter than this format inline instead of per-run pool tasks
    SUBMIT_MIN = 1 << 15

    def __init__(self, cfg, sample_names, resume_offsets=None):
        from concurrent.futures import ThreadPoolExecutor
        self.cfg = cfg
        self.indiv = len(sample_names)
        ro = resume_offsets or {}
        self._pool = ThreadPoolExecutor(max_workers=3)
        # ordered single-worker queue: the whole per-window write
        # (C run formatting, slow rows, enqueue-to-deflate) runs here
        # so the main thread moves on to the next window's merge/screen
        self._wq = ThreadPoolExecutor(max_workers=1)
        self._wq_last = None
        self.basef = _MemberGz(cfg.out_base + ".base.gz", cfg.gzip_level,
                               self._pool, ro.get("base"))
        self.pilef = _MemberGz(cfg.out_base + ".piles.gz", cfg.gzip_level,
                               self._pool, ro.get("pile"))
        if cfg.dump_mode:
            if not ro:
                open(cfg.out_base + ".snp", "w").close()
            self.snpf = None
        elif ro:
            self.snpf = open(cfg.out_base + ".snp", "r+b")
            self.snpf.truncate(ro["snp"])
            self.snpf.seek(ro["snp"])
        else:
            self.snpf = open(cfg.out_base + ".snp", "wb")
        if ro or not cfg.write_header:
            return      # headers already on disk / headerless part
        if self.snpf:
            self.snpf.write(b"Fragment\tPosition\tReference\tAlleles"
                            b"\tAllele_Counts\tType")
        self.basef.write(b"Fragment\tPosition\tReference")
        self.pilef.write(b"Fragment\tPosition\tReference")
        for nm in sample_names:
            if self.snpf:
                self.snpf.write(("\t%s\t" % nm).encode())
            self.basef.write(("\t%s\t" % nm).encode())
            self.pilef.write(("\t%s\t\t\t\t\t" % nm).encode())

    def sync_offsets(self):
        """Finalize the current gzip members; return raw byte offsets
        for a checkpoint record (checkpoint mode only)."""
        self._wq_drain()
        offs = {"base": self.basef.member_end(),
                "pile": self.pilef.member_end()}
        if self.snpf:
            self.snpf.flush()
            offs["snp"] = self.snpf.tell()
        else:
            offs["snp"] = 0
        return offs

    def write_calls_window(self, sdx, which, contig_pos, refc, callable_m,
                           data, calls, probs, types, denovo, acnt, active,
                           codes=None):
        idx = np.nonzero(callable_m)[0]
        if len(idx) == 0:
            return
        # rows whose per-sample fields are all "<call> 1"/"N 1" and that
        # emit no .snp/.piles row are bulk-formatted at C speed
        # (screen-resolved sites, plus any exact-engine REF site whose
        # posteriors are exactly 1.0 — identical bytes either way)
        if codes is not None:
            # screen codes decide all but the dispatched (HARD) rows,
            # so the dense (S, I) float64 posterior gather reduces to
            # the hard subset
            from .device_screen import EASY, BAD
            cs = codes[idx]
            fast = (cs == EASY) | (cs == BAD)
            hard = np.nonzero(~fast)[0]
            if len(hard):
                hs = idx[hard]
                fast[hard] = (types[hs] == 0) & \
                    (probs[hs] == 1.0).all(axis=1)
        else:
            fast = (types[idx] == 0) & (probs[idx] == 1.0).all(axis=1)
        wh = which[idx]
        change = np.empty(len(idx), dtype=bool)
        change[0] = True
        change[1:] = (fast[1:] != fast[:-1]) | (wh[1:] != wh[:-1])
        bounds = np.nonzero(change)[0].tolist()
        bounds.append(len(idx))
        # gather the window's callable rows once — copies that detach
        # everything the write needs from the reused window buffers, so
        # the actual formatting runs as an ordered background task
        # while the main thread merges the next window
        if len(idx) == len(callable_m):
            # all-callable window (the common case): contig_pos/refc
            # are fresh per-window arrays, only the reused buffers
            # need a straight memcpy (no 70 MB fancy gather)
            gpos = np.ascontiguousarray(contig_pos, dtype=np.int64)
            gref = refc
            gcalls = calls.copy()
            gact = active.copy()
        else:
            gpos = np.ascontiguousarray(contig_pos[idx], dtype=np.int64)
            gref = np.ascontiguousarray(refc[idx])
            gcalls = np.ascontiguousarray(calls[idx])
            gact = np.ascontiguousarray(active[idx])
        run_a, run_b, run_frag = [], [], []
        segs = []                       # (is_fast, a, b)
        slow_loc = []                   # slow rows' positions in idx
        for a, b in zip(bounds[:-1], bounds[1:]):
            if fast[a]:
                segs.append((True, a, b))
                run_a.append(a)
                run_b.append(b)
                run_frag.append(int(wh[a]))
            else:
                segs.append((False, a, b))
                slow_loc.append(np.arange(a, b))
        if slow_loc:
            sl = np.concatenate(slow_loc)
            sidx = idx[sl]
            slow = dict(which=which[sidx].astype(np.int32),
                        pos=np.ascontiguousarray(gpos[sl]),
                        refc=np.ascontiguousarray(gref[sl]),
                        data=np.ascontiguousarray(data[sidx]),
                        calls=np.ascontiguousarray(gcalls[sl]),
                        probs=np.ascontiguousarray(probs[sidx]),
                        types=np.ascontiguousarray(types[sidx]),
                        denovo=np.ascontiguousarray(denovo[sidx]),
                        acnt=np.ascontiguousarray(acnt[sidx]),
                        active=np.ascontiguousarray(gact[sl]))
        else:
            slow = None
        self._submit_window(sdx, segs, run_a, run_b, run_frag, gpos,
                            gref, gcalls, gact, slow)

    def _submit_window(self, sdx, segs, run_a, run_b, run_frag, gpos,
                       gref, gcalls, gact, slow):
        if self._wq_last is not None:
            # surface background write errors with backpressure (at
            # most one window's write may be in flight)
            self._wq_last.result()
        self._wq_last = self._wq.submit(
            self._write_window_task, sdx, segs, run_a, run_b, run_frag,
            gpos, gref, gcalls, gact, slow)

    def _write_window_task(self, sdx, segs, run_a, run_b, run_frag,
                           gpos, gref, gcalls, gact, slow):
        from .native import format_runs, format_slow, frag_table
        if run_a:
            buf, offs = format_runs(sdx, run_a, run_b, run_frag, gpos,
                                    gref, gcalls, gact, self.indiv, self)
        if slow is not None:
            cat, foff, maxfrag = frag_table(sdx, self)
            sbuf, soff, snp_bytes, pile_bytes = format_slow(
                cat, foff, maxfrag, slow, self.indiv, self.cfg.use_ped)
        k = 0
        sptr = 0
        for is_fast, a, b in segs:
            if is_fast:
                self.basef.write(buf[offs[k]:offs[k + 1]].tobytes())
                k += 1
            else:
                self.basef.write(
                    sbuf[soff[sptr]:soff[sptr + b - a]].tobytes())
                sptr += b - a
        # .snp/.piles rows only exist for slow rows and live in their
        # own streams, so one block write preserves site order
        if slow is not None:
            if self.snpf:
                self.snpf.write(snp_bytes)
            self.pilef.write(pile_bytes)

    def _wq_drain(self):
        if self._wq_last is not None:
            self._wq_last.result()
            self._wq_last = None

    def write_dump_window(self, frag_names, contig_pos, refc, data):
        min_depth_needed = 2
        tot = data.astype(np.int64).sum(axis=2)     # includes Ins (quirk)
        for s in range(len(contig_pos)):
            frag = frag_names[s]
            pos = int(contig_pos[s])
            ref = chr(refc[s])
            row = ["\n%s\t%d\t%c" % (frag, pos, ref)]
            prow = ["\n%s\t%d\t%c" % (frag, pos, ref)]
            for i in range(self.indiv):
                if tot[s, i] > min_depth_needed and ref != "N":
                    row.append("\tN\t0")
                else:
                    row.append("\tN\t1")
                for j in range(6):
                    prow.append("\t%d" % data[s, i, j])
            self.basef.write("".join(row).encode())
            self.pilef.write("".join(prow).encode())

    def close(self):
        self._wq_drain()
        self._wq.shutdown()
        self.basef.close()
        self.pilef.close()
        self._pool.shutdown()
        if self.snpf:
            self.snpf.close()


def _parse_guide(guide_path, sdx, frag_pos) -> np.ndarray:
    """Expand bed intervals into global site positions (bed order),
    honoring the reference's blank-line early terminator."""
    fp_prev = np.concatenate([[0], frag_pos])
    name_to_i = {nm: i for i, nm in enumerate(sdx.names)}
    sites = []
    with open(guide_path) as f:
        for line in f:
            if len(line.strip()) < 5 and sites:
                break
            tok = line.split()
            if len(tok) < 3:
                continue
            which = name_to_i[tok[0]]
            start = fp_prev[which] + int(tok[1]) - 1
            end = fp_prev[which] + int(tok[2]) - 1
            sites.append(np.arange(start, end + 1, dtype=np.int64))
    if not sites:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(sites)


def _guide_hap(ctx, all_pos):
    sdx, frag_pos = ctx["sdx"], ctx["frag_pos"]
    cfg = ctx["cfg"]
    which = find_chrom_caller(frag_pos, sdx.n_contigs,
                              max((sdx.n_contigs - 1) // 2, 0), all_pos)
    which = np.clip(which, 0, sdx.n_contigs - 1)
    ctype0 = ctx["chrom_types"][which]
    return np.where((ctype0 == CHRY) | (ctype0 == CHRMT), 1,
                    1 if cfg.haploid else 0).astype(np.uint8)


def _run_guide_windowed(ctx, w, st, files, sites_all):
    """Streamed guide path: sites process in
    count-bounded chunks against windowed pileup readers, so memory is
    bounded by the chunk size regardless of bed span — mirroring the
    reference's 50 MB sliding genome window (pecaller.c:1753-1789).

    Early stop: the reference stops once every pileup stream is
    exhausted (pecaller.c:952-1068).  For ascending sites that reduces
    to: process sites up to and including the FIRST site >= the
    maximum position any stream delivers (one more site is processed
    while the last stream dies on it); no sites when every stream is
    empty."""
    cfg, indiv = ctx["cfg"], ctx["indiv"]
    streams = [_ChunkedStream(p) for p in files]
    W = min(cfg.window_positions,
            max(1 << 18, (2 << 30) // (23 * indiv + 43)))
    k = 0
    lmax = -1
    while k < len(sites_all):
        chunk = sites_all[k:k + W]
        hi = int(chunk[-1]) + 1
        got = [s.take_below(hi) for s in streams]
        for p_, _c in got:
            if len(p_):
                lmax = max(lmax, int(p_[-1]))
        exhausted = all(s.exhausted for s in streams)
        if exhausted:
            if lmax < 0:
                break                   # all streams empty: no sites
            cut = int(np.searchsorted(chunk, lmax, side="left"))
            chunk = chunk[:min(cut + 1, len(chunk))]
            if len(chunk) == 0:
                break
        data = np.zeros((len(chunk), indiv, 6), dtype=np.uint16)
        present = np.zeros((len(chunk), indiv), dtype=bool)
        for i, (p_, c_) in enumerate(got):
            if len(p_) == 0:
                continue
            idx = np.searchsorted(chunk, p_)
            ok = idx < len(chunk)
            ok[ok] = chunk[idx[ok]] == p_[ok]
            data[idx[ok], i] = c_[ok]
            present[idx[ok], i] = True
        _process_window(ctx, w, st, chunk, data, present,
                        _guide_hap(ctx, chunk), count_absent=True)
        if exhausted:
            break
        k += W


def _run_guide_legacy(ctx, w, st, files, sites_all):
    """Full-read guide path for non-ascending beds (original design)."""
    cfg, indiv = ctx["cfg"], ctx["indiv"]
    streams = [_Stream(p) for p in files]
    all_pos, _ = _guide_sites(sites_all, streams)
    data = np.zeros((len(all_pos), indiv, 6), dtype=np.uint16)
    present = np.zeros((len(all_pos), indiv), dtype=bool)
    for i, sstream in enumerate(streams):
        if len(sstream.pos) == 0:
            continue
        idx = np.searchsorted(all_pos, sstream.pos)
        ok = idx < len(all_pos)
        ok[ok] = all_pos[idx[ok]] == sstream.pos[ok]
        data[idx[ok], i] = sstream.counts[ok]
        present[idx[ok], i] = True
    _process_window(ctx, w, st, all_pos, data, present,
                    _guide_hap(ctx, all_pos), count_absent=True)


def _guide_sites(sites, streams):
    """Per-site early-stop walk over pre-expanded guide sites: stops
    when every pileup stream is exhausted (pecaller.c:952-1068)."""
    if len(sites) == 0:
        return sites, 0
    # early stop: walk sites, tracking when each stream exhausts
    running = sum(1 for s in streams if not s.done)
    if running == 0:
        return sites[:1][:0], 0
    ptrs = [0] * len(streams)
    done = [s.done for s in streams]
    n_proc = 0
    for k, site in enumerate(sites):
        if running <= 0:
            break
        n_proc = k + 1
        for i, s in enumerate(streams):
            if done[i]:
                continue
            while ptrs[i] < len(s.pos) and s.pos[ptrs[i]] < site:
                ptrs[i] += 1
            if ptrs[i] >= len(s.pos):
                done[i] = True
                running -= 1
                continue
            if s.pos[ptrs[i]] == site:
                ptrs[i] += 1
                if ptrs[i] >= len(s.pos):
                    done[i] = True
                    running -= 1
    return sites[:n_proc], n_proc


def _write_dist(cfg, sample_names, tot_bases, counts_hist, mean, base_count,
                max_cov):
    indiv = len(sample_names)
    tot_8x = counts_hist[:, 8:].sum(axis=1)
    tot_1x = tot_8x + counts_hist[:, 1:8].sum(axis=1)
    counts_hist = counts_hist.copy()
    counts_hist[:, 0] = tot_bases - tot_1x
    median = np.zeros(indiv, dtype=np.int64)
    stop = tot_bases // 2
    for i in range(indiv):
        mc = counts_hist[i, 0]
        med = 0
        for j in range(1, MAX_DIST):
            if mc > stop:
                break
            med += 1
            mc += counts_hist[i, med]
        median[i] = med
    with open(cfg.out_base + ".dist", "w") as f:
        f.write("Category")
        for nm in sample_names:
            f.write("\t%s" % nm)
        f.write("\nTotal Number of bases in target")
        for _ in range(indiv):
            f.write("\t%d" % tot_bases)
        f.write("\nTotal Number of bases with at least 1x coverage")
        for i in range(indiv):
            f.write("\t%d" % tot_1x[i])
        f.write("\nTotal Number of bases with at least 8x coverage")
        for i in range(indiv):
            f.write("\t%d" % tot_8x[i])
        f.write("\nMean depth of coverage")
        for i in range(indiv):
            f.write("\t%g" % mean[i])
        f.write("\nMedian depth of coverage")
        for i in range(indiv):
            f.write("\t%d" % median[i])
        f.write("\nMaximum depth of coverage")
        for i in range(indiv):
            f.write("\t%d" % max_cov[i])
        f.write("\n\nDepth")
        for j in range(MAX_DIST - 1):
            f.write("\n%d" % j)
            for i in range(indiv):
                f.write("\t%d" % counts_hist[i, j])
        f.write("\n%d+" % (MAX_DIST - 1))
        for i in range(indiv):
            f.write("\t%d" % counts_hist[i, MAX_DIST - 1])
        f.write("\n")


