"""Device-backed mapping engine: the host seed/chain/decision scaffolding of
MapperEngine with the Smith-Waterman score + traceback stages and the
pileup accumulation moved onto the device (ops/sw.py kernels).

Scores are exact rationals x36 (int32); the C decision layer consumes
score/36.0, whose comparisons are tie-exact.  Differences vs the float64
oracle are confined to exact-tie resolution inside the DP (see ops/sw.py).
"""

from __future__ import annotations

import numpy as np

from .engine import MapperEngine, MAX_HITS
from ..ops import sw as dsw


def _pad_to(x: int, step: int) -> int:
    return ((x + step - 1) // step) * step


def _bucket_b(n: int, lo: int = 512) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class DeviceMapperEngine(MapperEngine):
    def __init__(self, *args, device_seeds: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        from ..utils import enable_compilation_cache
        enable_compilation_cache()
        import jax.numpy as jnp
        self._jnp = jnp
        self.dev_counts = jnp.zeros((self.sdx.genome_size, 6), jnp.uint16)
        self._shape_cache = {}
        self.n_fallback = 0
        self._seed_fn = None
        if self.sdx.genome_size >= 2**30:
            # device seed structures hold positions as int32; past 2^30
            # the POS_PAD sentinel ordering breaks — use exact host seeds
            device_seeds = False
        if device_seeds:
            from .device_seeds import (DeviceSeedIndex, build_seed_chain_fn,
                                       HIT_CAP)
            self._dindex = DeviceSeedIndex(self.index)
            self._seed_fns = {}
            self._seed_fn = True   # sentinel; per-bucket fns built lazily
            self._hit_cap = HIT_CAP

    def _seed_bucket_fn(self, s_needed: int):
        from .device_seeds import build_seed_chain_fn
        for b in (8, 12, 20):
            if s_needed <= b:
                break
        if b not in self._seed_fns:
            self._seed_fns[b] = build_seed_chain_fn(
                self._dindex, bisulfite=self.bisulfite, s_max=b)
        return self._seed_fns[b], b

    def _initial_map_dispatch(self, seqs, lens):
        from .seeds import segment_offsets
        B = seqs.shape[0]
        n_count = (seqs == ord("N")).sum(axis=1)
        skip = (n_count >= 1 + lens // 10).astype(np.int32)
        n_segs, offs = segment_offsets(lens)
        tc = n_segs - 1
        min_match0 = np.minimum(np.maximum(1, tc), 4)
        over4 = tc > 4
        min_match0[over4] = np.minimum((4 * tc[over4]) // 5, 4)

        fn, b = self._seed_bucket_fn(int(n_segs.max()))
        Bp = _bucket_b(B)
        if Bp != B or seqs.shape[1] != 304:
            seqs_p = np.zeros((Bp, 304), dtype=np.uint8)
            seqs_p[:B, :seqs.shape[1]] = seqs
        else:
            seqs_p = seqs
        pad = lambda a, fill=0: np.concatenate(
            [a, np.full((Bp - B,) + a.shape[1:], fill, a.dtype)]) \
            if Bp != B else a
        pending = fn.dispatch(
            seqs_p, pad(lens.astype(np.int32), 13),
            pad(offs[:, :b].astype(np.int32)),
            pad(n_segs.astype(np.int32), 1),
            pad(min_match0.astype(np.int32), 1),
            pad(skip, 1))
        return (fn, pending, seqs, lens, B)

    def _initial_map_resolve(self, handle):
        from .seeds import revcomp_batch
        fn, pending, seqs, lens, B = handle
        h16, o16, or16, tot16, fb = fn.fetch(pending)
        h16 = h16[:B]
        o16 = o16[:B]
        or16 = or16[:B]
        tot = tot16[:B].copy()
        fb = fb[:B]

        hits = np.zeros((B, MAX_HITS), dtype=np.uint32)
        hits_off = np.zeros((B, MAX_HITS), dtype=np.int32)
        orient = np.zeros((B, MAX_HITS), dtype=np.int8)
        hits[:, :self._hit_cap] = h16.astype(np.int64).astype(np.uint32)
        hits_off[:, :self._hit_cap] = o16
        orient[:, :self._hit_cap] = or16

        rev = revcomp_batch(seqs, lens)
        nfb = int(fb.sum())
        if nfb:
            self.n_fallback += nfb
            sel = np.nonzero(fb)[0]
            hh, ho, oo, tt, _ = MapperEngine._initial_map(
                self, np.ascontiguousarray(seqs[sel]), lens[sel])
            hits[sel] = hh
            hits_off[sel] = ho
            orient[sel] = oo
            tot[sel] = tt
        return hits, hits_off, orient, tot, rev

    def map_batch(self, seqs1, lens1, seqs2=None, lens2=None,
                  read_nos=None):
        # overlap the two ends' seed kernels: dispatch both before the
        # first fetch so the device works while the host waits
        if self.paired and self._seed_fn is not None and seqs2 is not None:
            lens1 = lens1.astype(np.int64)
            lens2 = lens2.astype(np.int64)
            h1 = self._initial_map_dispatch(seqs1, lens1)
            h2 = self._initial_map_dispatch(seqs2, lens2)
            self._pending_maps = [self._initial_map_resolve(h1),
                                  self._initial_map_resolve(h2)]
        else:
            self._pending_maps = None
        return super().map_batch(seqs1, lens1, seqs2, lens2,
                                 read_nos=read_nos)

    def _initial_map(self, seqs, lens):
        if getattr(self, "_pending_maps", None):
            return self._pending_maps.pop(0)
        if self._seed_fn is None:
            return MapperEngine._initial_map(self, seqs, lens)
        return self._initial_map_resolve(self._initial_map_dispatch(
            seqs, lens))

    # pad widths to coarse buckets so jit recompiles stay rare
    def _bucket(self, n, m):
        return (_pad_to(max(n, 8), 64), _pad_to(max(m, 8), 64))

    def _sw_scores(self, refs, blens, reads, rlens):
        H = refs.shape[0]
        if H == 0:
            return (np.zeros(0), np.zeros(0, np.int32),
                    np.zeros(0, np.int32))
        rl = int(rlens.max()) if len(rlens) else 1
        N, M = self._bucket(refs.shape[1], rl)
        Hp = _bucket_b(H)
        refs_p = np.zeros((Hp, N), dtype=np.uint8)
        refs_p[:H, :refs.shape[1]] = refs
        reads_p = np.ones((Hp, M), dtype=np.uint8)   # pad != ref pad (0)
        reads_p[:H, :min(M, reads.shape[1])] = reads[:, :M]
        blens_p = np.zeros(Hp, np.int32)
        blens_p[:H] = blens
        rlens_p = np.full(Hp, 1, np.int32)
        rlens_p[:H] = rlens
        packed = np.asarray(dsw.sw_align_device_packed(
            refs_p, blens_p, reads_p, rlens_p, bisulfite=self.bisulfite,
            n_rows=N))
        return (packed[0, :H].astype(np.float64) / 36.0,
                packed[1, :H].astype(np.int32),
                packed[2, :H].astype(np.int32))

    def _backtrack_end(self, seqs, lens, rev, orient, flat, best, use, end,
                       read_nos):
        jnp = self._jnp
        B = seqs.shape[0]
        m = np.zeros(B, dtype=np.uint32)
        winners = np.nonzero(use == 1)[0]
        if len(winners) == 0:
            return m
        flat_idx = np.full((B, MAX_HITS), -1, dtype=np.int64)
        flat_idx[flat["rid"], flat["hid"]] = np.arange(len(flat["rid"]))
        sel = flat_idx[winners, best[winners]]
        starts = flat["starts"][sel]
        blens = np.ascontiguousarray(flat["blens"][sel]).astype(np.int32)
        out_k = np.asarray(flat["out_k"][sel], dtype=np.int32)
        out_i = np.asarray(flat["out_i"][sel], dtype=np.int32)
        ors = orient[winners, best[winners]]
        oriented = np.where(ors[:, None] == 1, rev[winners], seqs[winners])
        rlens = lens[winners].astype(np.int32)
        width = int(blens.max()) if len(blens) else 1
        refs = self._gather_refs(starts, blens, width)
        m[winners] = (starts + out_i + 1).astype(np.uint32)

        rl = int(rlens.max()) if len(rlens) else 1
        N, M = self._bucket(width, rl)
        H = len(winners)
        Hp = _bucket_b(H)
        refs_p = np.zeros((Hp, N), dtype=np.uint8)
        refs_p[:H, :width] = refs
        reads_p = np.ones((Hp, M), dtype=np.uint8)
        reads_p[:H, :min(M, oriented.shape[1])] = oriented[:, :M]
        blens_p = np.zeros(Hp, np.int32); blens_p[:H] = blens
        rlens_p = np.full(Hp, 1, np.int32); rlens_p[:H] = rlens
        kp = np.zeros(Hp, np.int32); kp[:H] = out_k
        ip = np.zeros(Hp, np.int32); ip[:H] = out_i

        starts_p = np.zeros(Hp, np.int64)
        starts_p[:H] = starts
        # fused traceback + pileup scatter + insertion compaction: the
        # pileup delta stays on device; only a small (cap+1, 4) insertion
        # record table is fetched (padded rows walk zero steps)
        counts, rec = dsw.sw_traceback_scatter(
            refs_p, blens_p, reads_p, rlens_p, kp, ip,
            jnp.asarray(starts_p).astype(jnp.int32),
            bisulfite=self.bisulfite, n_rows=N,
            genome_size=self.sdx.genome_size)
        self.dev_counts = self.dev_counts + counts
        rec = np.asarray(rec)
        n_ins = int(rec[-1, 0])
        if n_ins > rec.shape[0] - 1:
            raise RuntimeError("insertion record cap exceeded; raise "
                               "ins_cap in sw_traceback_scatter")
        for b, evp, js, ln in rec[:n_ins]:
            if b < 0 or b >= H:
                continue
            w = winners[b]
            rn = int(read_nos[w]) if read_nos is not None else int(w)
            gpos = int(starts[b] + evp)
            sstr = oriented[b, js:js + ln].tobytes().decode()
            self.ins_records.append(((self._order_counter + rn, end),
                                     gpos, sstr))
        return m

    def final_pileup(self) -> np.ndarray:
        host = self.pileup.sum(axis=0, dtype=np.uint16)
        return (host + np.asarray(self.dev_counts)).astype(np.uint16)

    def reset_group(self) -> None:
        super().reset_group()
        self.dev_counts = self._jnp.zeros(
            (self.sdx.genome_size, 6), self._jnp.uint16)
