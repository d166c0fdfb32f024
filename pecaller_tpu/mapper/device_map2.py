"""Second-generation fused on-device mapping step.

One jit per batch, like device_pipeline.py, built to keep scatters,
sorts, top_k and byte-wise gathers out of the step (whether each of
these choices still pays on the GPU has not been measured):

Changes:
  1. Seed probing uses the 1-mismatch-closed inverted index
     (index/nbr.py): ONE rank lookup + one contiguous position gather
     per (read, orientation, segment) replaces 49 presence probes, the
     per-variant-key position gathers, and the 392-wide top_k merge.
     Per-segment lists arrive pre-merged ascending.
  2. All compactions are scatter-free: inclusive-cumsum gives each
     element its slot; a vectorized binary search over the cumsum gives
     each slot its element (searchsorted as unrolled gathers).
  3. Diagonal dedup is per-read pairwise (the anchor space is only
     2*S*SEG_CAP wide) instead of four global argsorts.
  4. Genome and reads travel as 2-bit-packed uint32 words with separate
     N/exotic masks; windows are gathered word-wise (11 gathers per
     slot instead of 160) and unpacked/aligned with vector ops.  Bases
     outside {A,C,G,T,N} can't be represented (the reference compares
     raw bytes, pemapper.c:2006-2048), so reads containing exotic chars
     — and reads whose candidate window touches an exotic genome char —
     fall back to the exact host engine.
  5. Both mate ends ride ONE device program as 2B "units" (end-major),
     sharing the SW kernel call, compactions, and the single flat-u32
     pileup scatter.
  6. Traceback is row-synchronous (ops/sw2.py): n_rows iterations total,
     emitting row-indexed events — no 273-step scalar walk.

Decision layer (decide_single/decide_pair) is carried over verbatim
from device_pipeline.py (pemapper.c:1313-1536 and :1084-1174 as exact
integer arithmetic).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ..native.build import ptr as _ptr

from ..index.nbr import NbrIndex, NBR_HI_BITS as NBR_HI_BITS_DEV
from ..ops import sw2
from ..ops.encode import IDEPTH
from .engine import (MapperEngine, MISALIGN_SLOP,
                     UNIQUE_MATE, UNIQUE_SLIP, UNIQUE_SINGLE, UNIQUE_MIS,
                     NON_MATE, NON_MIS, NON_NO, NEITHER_MAP)
from .seeds import segment_offsets, revcomp_batch
from .device_pipeline import (exact_score_threshold_amb, _pad_to,
                              _bucket_b)

PAD_SCORE = -36


def _mix32(x):
    """murmur3 finalizer on uint32 (jnp; multiplication wraps)."""
    import jax.numpy as jnp
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x
POS_PAD = np.int32(2 ** 30)
HIT_CAP = 16
INS_CAP = 2048
TIE_CAP = 2048          # walk-tie record rows per batch (overflow -> fb)
# pileup accumulator rows past genome end: the windowed pileup scatter
# writes (R_ROWS, 6) blocks per winner (contiguous-window scatter_add,
# ~1.6x the flat per-element scatter), and a window starting near the
# genome end overhangs by < R_ROWS <= 512 rows of EV_NONE zeros
SCATTER_PAD = 512


# --------------------------------------------------------------------------
# host-side packing helpers

_CODE_TAB = np.zeros(256, dtype=np.uint8)        # char -> xcode
for _c, _v in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3)):
    _CODE_TAB[_c[0]] = _v
_CODE_TAB[ord("N")] = sw2.XN
_EXOTIC = np.ones(256, dtype=bool)
for _c in b"ACGTN":
    _EXOTIC[_c] = False


def pack_genome(genome: np.ndarray):
    """ASCII genome -> (code words, N|exotic 2-bit mask words), both
    uint32 and padded with 16 guard words."""
    codes = _CODE_TAB[genome]
    n = (codes == sw2.XN) | (genome == ord("n"))
    exotic = _EXOTIC[genome] & ~(genome == ord("n"))
    gs = len(genome)
    PW = (gs + 15) // 16 + 16
    cw = np.zeros(PW, dtype=np.uint32)
    mw = np.zeros(PW, dtype=np.uint32)
    idx = np.arange(gs)
    np.bitwise_or.at(cw, idx >> 4,
                     (codes & 3).astype(np.uint32) << ((idx & 15) * 2))
    np.bitwise_or.at(mw, idx >> 4,
                     (n.astype(np.uint32)
                      | (exotic.astype(np.uint32) << 1)) << ((idx & 15) * 2))
    return cw, mw


class NbrDeviceIndex:
    """Device-resident arrays for an NbrIndex.

    Two rank-lookup modes:
      * "hash" (default when the NbrIndex carries a cuckoo table): 3
        gathers per probe — 2 tag probes + 1 value (see nbr.build_cuckoo)
      * "binsearch": the two-level hi_table + log-step search (~10
        gathers per probe); kept as the fallback when cuckoo placement
        fails
    """

    def __init__(self, nbr: NbrIndex):
        import jax.numpy as jnp
        self.n_keys = len(nbr.nkeys)
        if nbr.hash_tag is None and os.environ.get(
                "PECALLER_NO_CUCKOO") != "1":
            nbr.with_cuckoo()
        if nbr.hash_tag is not None and os.environ.get(
                "PECALLER_NO_CUCKOO") != "1":
            self.mode = "hash"
            self.tb = int(np.log2(len(nbr.hash_tag) // 2))
            self.positions = jnp.asarray(nbr.positions)
            self.args = (jnp.asarray(nbr.hash_tag),
                         jnp.asarray(nbr.hash_val), self.positions)
        else:
            self.mode = "binsearch"
            ht = np.asarray(nbr.hi_table)
            sub = np.diff(ht)
            self.max_subrange = int(sub.max()) if self.n_keys else 1
            self.n_steps = max(1, int(np.ceil(np.log2(
                max(self.max_subrange, 2)))) + 1)
            # arrays arrive pre-split in device layout (possibly mmap'ed)
            self.nkeys = jnp.asarray(nbr.nkeys)
            self.hi_table = jnp.asarray(ht)
            self.val_start = jnp.asarray(nbr.val_start)   # nn+1, ab<<31
            self.positions = jnp.asarray(nbr.positions)
            self.args = (self.nkeys, self.val_start, self.hi_table,
                         self.positions)


# --------------------------------------------------------------------------
# fused step builder

def build_fused_step2(dnbr: NbrDeviceIndex, *, paired: bool,
                      bisulfite: bool, min_dist: int, max_dist: int,
                      n_contigs: int, genome_size: int,
                      B: int, M: int, N: int, s_max: int,
                      seg_cap: int = 16, ins_cap: int = INS_CAP,
                      tie_cap: int = TIE_CAP,
                      h_factor: float = 1.5, jit: bool = True,
                      max_rlen: int | None = None,
                      genome_axis: str | None = None,
                      n_genome_shards: int = 1):
    """genome_axis: mesh axis name for genome-sharded (octile) mapping —
    the step then runs inside shard_map with per-shard index/genome
    arrays in LOCAL coordinates, two extra trailing args (g_base,
    owned_len), collectives for the chain ratchet and candidate
    ownership, an all_gather'ed global decide, and owner-local
    traceback/pileup (docs/SCALING.md design)."""
    import jax
    import jax.numpy as jnp

    U = 2 * B if paired else B              # end-major read units
    S = s_max
    CAP = HIT_CAP
    F = 2 * S * seg_cap                      # per-unit anchor space
    H_CAP = ((int(h_factor * U) + 255) // 256) * 256
    PW = (M + 15) // 16                      # packed read words
    NW = N // 16 + 2                         # packed window words
    # max usable DP rows: windows span at most max_rlen + 2*slop + 1
    # bases, so rows beyond that are dead weight in the SW/traceback
    # kernels and the pileup scatter (M is 16-padded; max_rlen is the
    # batch's true 8-bucketed max read length)
    R_ROWS = min(N, (max_rlen or M) + 2 * MISALIGN_SLOP + 1)
    n_steps = getattr(dnbr, "n_steps", 1)
    n_keys = dnbr.n_keys
    chrom_steps = max(3, int(np.ceil(np.log2(max(n_contigs, 2)))) + 3)
    SBIG = jnp.int32(2**31 - 1)
    NEGBIG = jnp.int32(-(1 << 30))
    L = max(M - IDEPTH + 1, 1)

    sw_align, sw_traceback = _sw_fns()

    # decide-tie hash: per-column powers of two independent odd
    # multipliers (uint32 wraparound), computed once per build
    pw_np = np.empty((2, N), np.uint32)
    for t, mlt in enumerate((2654435761, 2246822519)):
        p = 1
        for c in range(N):
            pw_np[t, c] = p
            p = (p * mlt) & 0xFFFFFFFF
    pw_a = jnp.asarray(pw_np[0])
    pw_b = jnp.asarray(pw_np[1])

    # ---- helpers ---------------------------------------------------------

    def unpack_codes(words, n_out):
        """(..., W) uint32 -> (..., n_out) uint8 2-bit fields."""
        sh = (jnp.arange(16, dtype=jnp.uint32) * 2)
        b = (words[..., :, None] >> sh) & 3
        return b.reshape(*words.shape[:-1],
                         words.shape[-1] * 16)[..., :n_out].astype(jnp.uint8)

    def vsearch_ge(csum, targets, steps):
        """Smallest idx with csum[idx] >= target (csum ascending,
        int32); targets beyond csum[-1] return len(csum)."""
        n = csum.shape[0]
        lo = jnp.zeros(targets.shape, jnp.int32)
        hi = jnp.full(targets.shape, n, jnp.int32)
        for _ in range(steps):
            mid = (lo + hi) >> 1
            v = csum[jnp.clip(mid, 0, n - 1)]
            pred = v < targets
            lo = jnp.where(pred, mid + 1, lo)
            hi = jnp.where(~pred, mid, hi)
        return lo

    def find_chrom(st_pad, pos):
        """Exact port of the reference probe-at-7 contig search
        (pemapper.c:2168-2186), log-bounded."""
        ns = st_pad.shape[0]
        first = jnp.zeros_like(pos)
        last = jnp.full_like(pos, n_contigs - 1)
        trie = jnp.full_like(pos, 7)
        result = jnp.full_like(pos, -1)
        done = jnp.zeros(pos.shape, bool)
        for _ in range(chrom_steps):
            eq = (first == last) & ~done
            result = jnp.where(eq, first, result)
            done = done | eq
            ci = jnp.clip(trie, 0, ns - 2)
            ok_t = (trie >= 0) & (trie <= ns - 2)
            v_try = jnp.where(ok_t, st_pad[ci], SBIG)
            v_try1 = jnp.where((trie >= -1) & (trie <= ns - 2),
                               st_pad[ci + 1], SBIG)
            hit = (~done) & (v_try <= pos) & (v_try1 >= pos)
            result = jnp.where(hit, trie, result)
            done = done | hit
            go_low = (~done) & (v_try > pos)
            go_high = (~done) & ~go_low
            last = jnp.where(go_low, trie - 1, last)
            first = jnp.where(go_high, trie + 1, first)
            trie = jnp.where(~done, (last + first) // 2, trie)
        return result

    def windows(st_pad, ist, spots, lens_u, c_shift=0):
        """Candidate locus -> clamped seq-coordinate window
        (engine._windows, pemapper.c:1047-1081).  c_shift: first contig
        of a genome shard — local seq coords subtract its accumulated
        +15/contig padding."""
        chrom = jnp.clip(find_chrom(st_pad, spots), 0, n_contigs - 1)
        extra = 15 * (chrom - c_shift)
        start = jnp.maximum(ist[chrom] + extra,
                            jnp.maximum(0, extra + spots - MISALIGN_SLOP))
        end = jnp.minimum(ist[chrom + 1] + extra,
                          extra + spots + lens_u + MISALIGN_SLOP)
        blen = 1 + end - start
        return start, blen

    def fetch_windows(gcode, gmask, start, blen):
        """Packed window fetch: word gathers + unpack + shift align.
        Returns (xcodes (n, N) uint8 with N-wildcards applied, exotic
        (n,) bool)."""
        w0 = (start >> 4).astype(jnp.int32)
        widx = w0[:, None] + jnp.arange(NW, dtype=jnp.int32)[None, :]
        gmax = gcode.shape[0] - 1
        cw = gcode[jnp.clip(widx, 0, gmax)]
        mw = gmask[jnp.clip(widx, 0, gmax)]
        ext = NW * 16
        codes = unpack_codes(cw, ext)
        m2 = (mw[..., :, None] >>
              (jnp.arange(16, dtype=jnp.uint32) * 2)) & 3
        m2 = m2.reshape(m2.shape[0], ext)
        sh = (start & 15).astype(jnp.int32)
        # compose the per-slot shift out of static slices
        width = ext
        for bit in (8, 4, 2, 1):
            nw_ = width - bit
            codes = jnp.where((sh[:, None] & bit) != 0,
                              codes[:, bit:bit + nw_], codes[:, :nw_])
            m2 = jnp.where((sh[:, None] & bit) != 0,
                           m2[:, bit:bit + nw_], m2[:, :nw_])
            width = nw_
        codes = codes[:, :N]
        m2 = m2[:, :N]
        inwin = jnp.arange(N)[None, :] < blen[:, None]
        xc = jnp.where((m2 & 1) == 1, jnp.uint8(sw2.XN), codes)
        xc = jnp.where(inwin, xc, jnp.uint8(0))
        exotic = (((m2 & 2) != 0) & inwin).any(axis=1)
        return xc, exotic

    def rolling_keys(kcodes, offsets):
        key_all = jnp.zeros(kcodes.shape[:-1] + (L,), jnp.uint32)
        for j in range(IDEPTH):
            key_all = (key_all << 2) + kcodes[..., j:j + L].astype(
                jnp.uint32)
        return jnp.take_along_axis(key_all,
                                   jnp.clip(offsets, 0, L - 1), axis=-1)

    # ---- seed + chain ----------------------------------------------------

    n_idx = len(dnbr.args)
    hash_mode = dnbr.mode == "hash"
    quarter_mode = dnbr.mode == "quarter"

    def make_keys2(xcode_f, xcode_r, offsets):
        """Probe keys on converted codes (convert_ct,
        pemapper.c:2292-2300) for both orientations: (U, 2, S) u32."""
        if bisulfite:
            conv = lambda x: jnp.where(x == 1, jnp.uint8(3), x & 3)  # noqa
        else:
            conv = lambda x: x & 3                                   # noqa
        kf = rolling_keys(conv(xcode_f), offsets)
        kr = rolling_keys(conv(xcode_r), offsets)
        return jnp.stack([kf, kr], axis=1)             # (U, 2, S)

    def seed_nbr(idx_args, xcode_f, xcode_r, offsets, n_segs,
                 min_match0, skip):
        """(U, ...) unit-major seed probing + chaining.  Semantics match
        device_seeds.seed_chain_core (itself pemapper.c:1539-1690 /
        :2188-2289) with the 49-key expansion replaced by the inverted
        index."""
        positions = idx_args[-1]
        keys2 = make_keys2(xcode_f, xcode_r, offsets)

        if hash_mode:
            # cuckoo rank lookup: 2 tag probes + 1 value gather
            tagt, valt = idx_args[0], idx_args[1]
            tb = dnbr.tb
            TT = jnp.int32(1 << tb)

            def mix1(x):
                x = x ^ (x >> 16)
                x = x * jnp.uint32(0x85EBCA6B)
                x = x ^ (x >> 13)
                x = x * jnp.uint32(0xC2B2AE35)
                return x ^ (x >> 16)

            def mix2(x):
                x = x ^ (x >> 17)
                x = x * jnp.uint32(0xED5AD4BB)
                x = x ^ (x >> 11)
                x = x * jnp.uint32(0xAC4C1B51)
                x = x ^ (x >> 15)
                x = x * jnp.uint32(0x31848BAB)
                return x ^ (x >> 14)

            m1 = mix1(keys2)
            m2 = mix2(keys2)
            h1 = (m1 & jnp.uint32((1 << tb) - 1)).astype(jnp.int32)
            h2 = TT + (m2 & jnp.uint32((1 << tb) - 1)).astype(jnp.int32)
            e1 = tagt[h1]
            e2 = tagt[h2]
            tfm = jnp.uint32((1 << 22) - 1)
            hit1 = ((e1 >> 31) != 0) & ((e1 & tfm) == (m1 >> tb))
            hit2 = ((e2 >> 31) != 0) & ((e2 & tfm) == (m2 >> tb))
            present = hit1 | hit2
            e = jnp.where(hit1, e1, e2)
            hsel = jnp.where(hit1, h1, h2)
            start = jnp.where(present, valt[hsel],
                              jnp.uint32(0)).astype(jnp.int32)
            cnt_sat = jnp.where(
                present, ((e >> 22) & jnp.uint32(0xFF)).astype(jnp.int32),
                0)
            abund = jnp.where(present, (e >> 30) & jnp.uint32(1),
                              jnp.uint32(0))
        else:
            # two-level binary-search rank lookup
            nkeys, val_start, hi_table = (idx_args[0], idx_args[1],
                                          idx_args[2])
            hi = (keys2 >> (32 - NBR_HI_BITS_DEV)).astype(jnp.int32)
            lo = hi_table[hi]
            hi_end = hi_table[hi + 1]
            for _ in range(n_steps):
                cont = lo < hi_end
                mid = (lo + hi_end) >> 1
                v = nkeys[jnp.clip(mid, 0, max(n_keys - 1, 0))]
                pred = v < keys2
                lo = jnp.where(cont & pred, mid + 1, lo)
                hi_end = jnp.where(cont & ~pred, mid, hi_end)
            idx = jnp.clip(lo, 0, max(n_keys - 1, 0))
            present = (nkeys[idx] == keys2) & (n_keys > 0)
            v0 = val_start[idx]
            v1 = val_start[idx + 1]
            mask31 = jnp.uint32((1 << 31) - 1)
            start = jnp.where(present, v0 & mask31, 0).astype(jnp.int32)
            cnt_exact = jnp.where(
                present, (v1 & mask31).astype(jnp.int32) - start, 0)
            cnt_sat = jnp.minimum(cnt_exact, 255)      # decisions only
            abund = jnp.where(present, v0 >> 31, 0)

        seg_valid = (jnp.arange(S)[None, :] < n_segs[:, None])
        seg_bad = (abund == 1) | ~seg_valid[:, None, :]
        seg_tot = jnp.where(seg_bad, 0, cnt_sat)       # (U, 2, S)
        seg_over = (seg_tot > seg_cap) & ~seg_bad

        # contiguous position gather (lists pre-merged ascending),
        # two-tier: most probes have cnt <= T1, so gather T1 for all
        # and spill the rare heavy probes through a small compaction
        # (a flat seg_cap-wide gather moves seg_cap/T1 times the words)
        take = jnp.minimum(seg_tot, seg_cap)
        pmax = max(positions.shape[0] - 1, 0)
        # expected positions/probe is ~1 + 48*genome_density (~1.05 for
        # E. coli): T1=2 covers the common case; heavier probes ride the
        # compacted spill tier
        T1 = min(2, seg_cap)
        g1 = start[..., None] + jnp.arange(T1, dtype=jnp.int32)
        gval1 = jnp.arange(T1) < take[..., None]
        pos = jnp.where(gval1, positions[jnp.clip(g1, 0, pmax)], POS_PAD)
        heavy_over = jnp.zeros(U, bool)
        if seg_cap > T1:
            T2 = seg_cap - T1
            NF = U * 2 * S
            HV = max(1024, NF // 64)
            heavy = (take > T1).reshape(-1)
            hc = jnp.cumsum(heavy.astype(jnp.int32))
            n_heavy = hc[-1]
            heavy_over = (hc.reshape(U, 2 * S) > HV).any(axis=1)
            steps_f = max(1, int(np.ceil(np.log2(NF + 1))))
            hsrc = jnp.clip(
                vsearch_ge(hc, jnp.arange(1, HV + 1, dtype=jnp.int32),
                           steps_f), 0, NF - 1)
            h_ok = jnp.arange(HV, dtype=jnp.int32) < n_heavy
            hstart = start.reshape(-1)[hsrc]
            htake = take.reshape(-1)[hsrc]
            g2 = hstart[:, None] + T1 + jnp.arange(T2, dtype=jnp.int32)
            hval = (h_ok[:, None] &
                    (T1 + jnp.arange(T2) < htake[:, None]))
            hpos = jnp.where(hval, positions[jnp.clip(g2, 0, pmax)],
                             POS_PAD)
            tail = jnp.full((NF + 1, T2), POS_PAD, jnp.int32).at[
                jnp.where(h_ok, hsrc, NF), :].set(hpos, mode="drop")
            pos = jnp.concatenate(
                [pos, tail[:NF].reshape(U, 2, S, T2)], axis=-1)
        return chain_dedup_select(pos, seg_tot, seg_over, heavy_over,
                                  offsets, n_segs, min_match0, skip)

    def chain_dedup_select(pos, seg_tot, seg_over, heavy_over, offsets,
                           n_segs, min_match0, skip, shard=None):
        """Shared seed tail: co-linear chaining + min_match ratchet +
        diagonal dedup + CAP selection (pemapper.c:2188-2289 semantics).

        ``pos`` (U, 2, S, seg_cap) int32 candidate positions, ascending
        per probe, POS_PAD-padded; ``seg_tot`` (U, 2, S) candidate counts
        (0 for poisoned/invalid segments); ``seg_over`` (U, 2, S) probes
        whose candidate set exceeded seg_cap; ``heavy_over`` (U,) units
        whose probing exceeded a batch-level budget.

        ``shard`` (genome-sharded mode): (g_base, owned_len) local
        scalars.  seg_tot must then already be the GLOBAL per-probe
        count (psum over the genome axis); the chain votes stay local
        (a candidate's chain mates all lie within its owner's covered
        span), the min_match ratchet maxes over the mesh so every shard
        ratchets on the globally best chain, and only OWNED candidates
        (window start inside this shard's interval) survive selection —
        the boundary-overlap copies are dropped by their non-owner."""
        seg_valid = (jnp.arange(S)[None, :] < n_segs[:, None])
        # --- chaining (exact port of seed_chain_core) -------------------
        max_off = max(2, IDEPTH - 4)
        diag = pos - offsets[:, None, :, None]
        anchor_valid = pos < POS_PAD
        T = jnp.ones(pos.shape, jnp.int32)
        seg_in_read = (jnp.arange(S)[None, :] <= (n_segs - 1)[:, None])
        for dd in range(1, S):
            a = diag[:, :, :S - dd, :]
            bseg = diag[:, :, dd:, :]
            near = jnp.abs(a[..., :, None] - bseg[..., None, :]) < max_off
            near = near & anchor_valid[:, :, dd:][..., None, :]
            found = near.any(-1) & seg_in_read[:, None, dd:, None]
            T = T.at[:, :, :S - dd, :].add(found.astype(jnp.int32))
        T = jnp.where(anchor_valid, T, 0)

        # min_match ratchet (pemapper.c:2251-2254 + min_spots wipe)
        max_depth = (n_segs - 1).astype(jnp.int32)
        min_spots = jnp.where(seg_valid[:, None, :], seg_tot,
                              jnp.int32(1 << 30)).min(-1)     # (U, 2)
        wipe = min_spots > 200
        Tmax = T.max(-1)
        if shard is not None:
            # the globally best chain may live on another shard: the
            # ratchet must see it or weaker local chains would survive
            # that the reference (global view) suppresses
            Tmax = jax.lax.pmax(Tmax, genome_axis)
        cur = min_match0.astype(jnp.int32)
        processed = jnp.zeros(pos.shape[:3], jnp.bool_)
        for o in range(2):
            o_ok = ~wipe[:, o] & (skip == 0)
            for li in range(S):
                active = o_ok & (li <= 1 + max_depth - cur)
                processed = processed.at[:, o, li].set(active)
                cur = jnp.maximum(cur,
                                  jnp.where(active, Tmax[:, o, li], 0))
        final_min = cur
        accepted = (processed[..., None] &
                    (T == final_min[:, None, None, None]) & anchor_valid)
        accepted = accepted & ~wipe[:, 1][:, None, None, None]
        if shard is not None:
            # keep only candidates whose window START this shard owns
            # (local index coords in [own_lo, own_hi)); shard 0 passes
            # own_lo = -2^30 so the reference's genome-start clamp
            # (diag < 0 -> spot 0) stays owned there
            own_lo_s, own_hi_s = shard
            owned = (diag >= own_lo_s) & (diag < own_hi_s)
            accepted = accepted & owned

        # --- per-unit diagonal dedup, enumeration order ------------------
        acc = accepted.reshape(U, F)
        dg = diag.reshape(U, F)
        posf = pos.reshape(U, F)
        # pairwise first-occurrence dedup, chunked over the q axis to
        # bound the (U, F, QC) intermediate
        QC = 64
        dup_parts = []
        for q0 in range(0, F, QC):
            q1 = q0 + QC
            tri = (jnp.arange(F)[:, None] <
                   jnp.arange(q0, q1)[None, :])      # p < q
            dup_parts.append(
                ((dg[:, :, None] == dg[:, None, q0:q1])
                 & acc[:, :, None] & tri[None]).any(axis=1))
        dup = jnp.concatenate(dup_parts, axis=1)
        keep = acc & ~dup
        n_keep = keep.sum(axis=1)

        rank = jnp.cumsum(keep, axis=1) - 1
        sel = keep[:, :, None] & (rank[:, :, None] ==
                                  jnp.arange(CAP)[None, None, :])
        orient_f = (jnp.arange(F, dtype=jnp.int32) //
                    (S * seg_cap))[None, :, None]
        # per-anchor segment offset: repeat/tile, no gather
        off_f = jnp.tile(jnp.repeat(offsets, seg_cap, axis=1), (1, 2))
        hits = jnp.sum(jnp.where(sel, posf[:, :, None], 0), axis=1)
        hits_off = jnp.sum(jnp.where(sel, off_f[:, :, None], 0), axis=1)
        orient = jnp.sum(jnp.where(sel, orient_f, 0), axis=1) \
            .astype(jnp.int8)

        tot = jnp.minimum(n_keep, CAP).astype(jnp.int32)
        n_keep_glob = n_keep if shard is None else \
            jax.lax.psum(n_keep, genome_axis)
        fallback = (seg_over.any((1, 2)) | heavy_over |
                    (n_keep_glob > CAP)) & (skip == 0)
        return hits, hits_off, orient, tot, fallback

    def bitonic_sort_last(x):
        """Ascending bitonic sort along the last axis (power-of-2 width,
        static permutations only — compiles to shuffles, no lax.sort)."""
        n = x.shape[-1]
        assert n & (n - 1) == 0
        lane = np.arange(n)
        k = 2
        while k <= n:
            j = k >> 1
            while j >= 1:
                xp = x[..., lane ^ j]
                is_lo = (lane & j) == 0
                asc = (lane & k) == 0
                take_min = jnp.asarray(is_lo == asc)
                x = jnp.where(take_min, jnp.minimum(x, xp),
                              jnp.maximum(x, xp))
                j >>= 1
            k <<= 1
        return x

    def seed_quarter(idx_args, xcode_f, xcode_r, offsets, n_segs,
                     min_match0, skip):
        """v2.5 seed probing via the quartered-key index (index/quarter):
        4 projection lookups per probe enumerate the exact Hamming<=1
        candidate set of pemapper's fill_mers (pemapper.c:1969-2003)
        without the nbr index's 49x storage blow-up.  See
        index/quarter.py for layout and the abundance-marker scheme."""
        from ..index.quarter import SUB_BITS, MARKER as Q_MARKER
        starts_t, cnt_t, epos, eqw = idx_args
        T1 = dnbr.t1
        T2E = dnbr.rcap - T1
        emax = max(epos.shape[0] - 1, 0)
        wmax = max(eqw.shape[0] - 1, 0)
        keys2 = make_keys2(xcode_f, xcode_r, offsets)

        # ---- per-quarter projection lookup (2 gathers each) ----------
        sh_q = jnp.asarray([(3 - q) * 8 for q in range(4)], jnp.uint32)
        k4 = keys2[..., None]                          # (U, 2, S, 1)
        qb_p = (k4 >> sh_q) & jnp.uint32(0xFF)         # (U, 2, S, 4)
        low_mask = (jnp.uint32(1) << sh_q) - jnp.uint32(1)
        # two sub-width shifts: (k >> 24) >> 8 is defined where k >> 32
        # is not
        sub = (((k4 >> sh_q) >> jnp.uint32(8)) << sh_q) | (k4 & low_mask)
        base = ((jnp.arange(4, dtype=jnp.int32) << SUB_BITS)
                | sub.astype(jnp.int32))               # (U, 2, S, 4)
        start = starts_t[base].astype(jnp.int32)
        cnt = cnt_t[base].astype(jnp.int32)            # saturated 255

        def ham_filter(pe_raw, qb_e, qb_probe, qsel, valid):
            """Base-level Hamming filter of the dropped-quarter byte +
            abundance-marker poisoning.  Returns (pos-or-PAD, poison)."""
            x = (qb_e ^ qb_probe) & jnp.uint32(0xFF)
            f = (x | (x >> jnp.uint32(1))) & jnp.uint32(0x55)
            nm = ((f & 1) + ((f >> jnp.uint32(2)) & 1)
                  + ((f >> jnp.uint32(4)) & 1)
                  + ((f >> jnp.uint32(6)) & 1)).astype(jnp.int32)
            is_mark = valid & (pe_raw >= Q_MARKER)
            ok = (nm == 1) | ((nm == 0) & (qsel == 0))
            cand = valid & ~is_mark & ok
            pos = jnp.where(cand, pe_raw, POS_PAD)
            poison = is_mark & (nm <= 1)
            return pos, poison

        # ---- inline tier: first T1 entries of every run --------------
        jt1 = jnp.arange(T1, dtype=jnp.int32)
        g1 = start[..., None] + jt1                # (U, 2, S, 4, T1)
        v1 = jt1 < cnt[..., None]
        pe1 = epos[jnp.clip(g1, 0, emax)]
        w0i = start >> 2
        w0 = eqw[jnp.clip(w0i, 0, wmax)]
        w1 = eqw[jnp.clip(w0i + 1, 0, wmax)]
        b1 = (start & 3)[..., None] + jt1              # byte 0..T1+2
        s0 = (jnp.clip(b1, 0, 3) * 8).astype(jnp.uint32)
        s1 = (jnp.clip(b1 - 4, 0, 3) * 8).astype(jnp.uint32)
        qb1 = jnp.where(b1 < 4, (w0[..., None] >> s0) & jnp.uint32(0xFF),
                        (w1[..., None] >> s1) & jnp.uint32(0xFF))
        qsel4 = jnp.arange(4, dtype=jnp.int32)[None, None, None, :, None]
        pos1, poison1 = ham_filter(pe1, qb1, qb_p[..., None], qsel4, v1)

        # ---- spill tier: compacted heavy lookups (cnt > T1) ----------
        heavy = (cnt > T1).reshape(-1)
        NF4 = U * 2 * S * 4
        # expected heavy fraction ~ P(run > T1) ~= 15% at 47 Mb density
        # and the per-batch fraction fluctuates (reads cluster), so the
        # budget needs real margin: a too-tight HV turns the tail of
        # every batch into heavy_over -> host-fallback storms (measured
        # 40x collapse at NF4//6)
        HV = int(os.environ.get("PECALLER_Q4_HV", "0")) \
            or max(2048, (NF4 // 4 + 255) & ~255)
        hc = jnp.cumsum(heavy.astype(jnp.int32))
        n_heavy = hc[-1]
        heavy_over = (hc.reshape(U, 2 * S * 4) > HV).any(axis=1)
        steps_f = max(1, int(np.ceil(np.log2(NF4 + 1))))
        hsrc = jnp.clip(
            vsearch_ge(hc, jnp.arange(1, HV + 1, dtype=jnp.int32),
                       steps_f), 0, NF4 - 1)
        h_ok = jnp.arange(HV, dtype=jnp.int32) < n_heavy
        hstart = start.reshape(-1)[hsrc]
        hcnt = cnt.reshape(-1)[hsrc]
        hqb_p = qb_p.reshape(-1)[hsrc]
        hqsel = (hsrc & 3).astype(jnp.int32)
        jt2 = jnp.arange(T2E, dtype=jnp.int32)
        v2_ = h_ok[:, None] & ((T1 + jt2) < hcnt[:, None])
        NW2 = (T1 % 4 + T2E + 3) // 4 + 1
        g2 = hstart[:, None] + T1 + jt2
        pe2 = epos[jnp.clip(g2, 0, emax)]
        w2i = (hstart + T1) >> 2
        ws = [eqw[jnp.clip(w2i + j, 0, wmax)] for j in range(NW2)]
        b2 = ((hstart + T1) & 3)[:, None] + jt2
        wsel = b2 >> 2
        bsh = ((b2 & 3) * 8).astype(jnp.uint32)
        qb2 = jnp.zeros(pe2.shape, jnp.uint32)
        for j, w in enumerate(ws):
            qb2 = jnp.where(wsel == j,
                            (w[:, None] >> bsh) & jnp.uint32(0xFF), qb2)
        pos2, poison2 = ham_filter(pe2, qb2, hqb_p[:, None],
                                   hqsel[:, None], v2_)
        tgt = jnp.where(h_ok, hsrc, NF4)
        tail = jnp.full((NF4 + 1, T2E), POS_PAD, jnp.int32).at[tgt].set(
            pos2, mode="drop")[:NF4].reshape(U, 2, S, 4, T2E)
        poison_sp = jnp.zeros(NF4 + 1, bool).at[tgt].set(
            poison2.any(axis=1), mode="drop")[:NF4].reshape(U, 2, S, 4)

        # runs longer than R_CAP can't be fully enumerated on device:
        # the unit falls back to the exact host engine unless the probe
        # is already poisoned (then its candidates are unused anyway)
        poison_q = poison1.any(-1) | poison_sp         # (U, 2, S, 4)
        poison_probe = poison_q.any(-1)                # (U, 2, S)
        seg_valid = (jnp.arange(S)[None, :] < n_segs[:, None])
        seg_in = seg_valid[:, None, :]
        enum_probe = (cnt > (T1 + T2E)).any(-1)        # (U, 2, S)
        enum_fb = (enum_probe & ~poison_probe & seg_in).any((1, 2))

        # ---- merge + ascending sort + compaction to seg_cap ----------
        allpos = jnp.concatenate([pos1, tail], axis=-1)
        W = 4 * (T1 + T2E)
        allpos = allpos.reshape(U, 2, S, W)
        live = seg_in & ~poison_probe
        allpos = jnp.where(live[..., None], allpos, POS_PAD)
        cnt_cand = (allpos < POS_PAD).sum(-1)          # (U, 2, S)
        Wp = 1 << (W - 1).bit_length()
        if Wp > W:
            allpos = jnp.pad(allpos, ((0, 0),) * 3 + ((0, Wp - W),),
                             constant_values=POS_PAD)
        pos = bitonic_sort_last(allpos)[..., :seg_cap]
        seg_over = cnt_cand > seg_cap
        return chain_dedup_select(pos, cnt_cand, seg_over,
                                  heavy_over | enum_fb, offsets, n_segs,
                                  min_match0, skip)

    def seed_octile(idx_args, xcode_f, xcode_r, offsets, n_segs,
                    min_match0, skip, gctx):
        """Octile (drop-one-of-8) seed probing — the mm10/hg38-scale
        path (index/quarter.py build_octile_index).  8 projection
        lookups of 28-bit subkeys through a content-proportional cuckoo
        rank table enumerate the exact fill_mers Hamming<=1 candidate
        set (pemapper.c:1969-2003); the dropped 2-base group's nibble
        is the Hamming filter.  Runs genome-sharded when genome_axis is
        set: positions are shard-local, ownership/ratchet collectives
        happen in chain_dedup_select."""
        from ..index.quarter import OCT_SUB_BITS, MARKER as Q_MARKER
        tagt, valt, epos, eqw = idx_args
        T1 = dnbr.t1
        T2E = dnbr.rcap - T1
        tb = dnbr.tb
        TT = jnp.int32(1 << tb)
        emax = max(epos.shape[0] - 1, 0)
        wmax = max(eqw.shape[0] - 1, 0)
        keys2 = make_keys2(xcode_f, xcode_r, offsets)

        # ---- 8 projections -> cuckoo rank lookup ---------------------
        sh_q = jnp.asarray([(7 - q) * 4 for q in range(8)], jnp.uint32)
        k8 = keys2[..., None]                          # (U, 2, S, 1)
        qn_p = (k8 >> sh_q) & jnp.uint32(0xF)          # (U, 2, S, 8)
        low_mask = (jnp.uint32(1) << sh_q) - jnp.uint32(1)
        sub = (((k8 >> sh_q) >> jnp.uint32(4)) << sh_q) | (k8 & low_mask)
        key31 = ((jnp.arange(8, dtype=jnp.uint32)
                  << jnp.uint32(OCT_SUB_BITS)) | sub)  # (U, 2, S, 8)

        def mix1(x):
            x = x ^ (x >> 16)
            x = x * jnp.uint32(0x85EBCA6B)
            x = x ^ (x >> 13)
            x = x * jnp.uint32(0xC2B2AE35)
            return x ^ (x >> 16)

        def mix2(x):
            x = x ^ (x >> 17)
            x = x * jnp.uint32(0xED5AD4BB)
            x = x ^ (x >> 11)
            x = x * jnp.uint32(0xAC4C1B51)
            x = x ^ (x >> 15)
            x = x * jnp.uint32(0x31848BAB)
            return x ^ (x >> 14)

        m1 = mix1(key31)
        m2 = mix2(key31)
        h1 = (m1 & jnp.uint32(TT - 1)).astype(jnp.int32)
        h2 = TT + (m2 & jnp.uint32(TT - 1)).astype(jnp.int32)
        e1 = tagt[h1]
        e2 = tagt[h2]
        tfm = jnp.uint32((1 << 22) - 1)
        hit1 = ((e1 >> 31) != 0) & ((e1 & tfm) == (m1 >> tb))
        hit2 = ((e2 >> 31) != 0) & ((e2 & tfm) == (m2 >> tb))
        slot = jnp.where(hit1, h1, h2)
        tag = jnp.where(hit1, e1, e2)
        found = hit1 | hit2
        start = jnp.where(found, valt[slot].astype(jnp.int32), 0)
        cnt = jnp.where(found,
                        ((tag >> 22) & jnp.uint32(0xFF)).astype(
                            jnp.int32), 0)             # (U, 2, S, 8)

        def ham_filter8(pe_raw, qn_e, qn_probe, qsel, valid):
            """2-base-group Hamming filter + marker poisoning."""
            x = (qn_e ^ qn_probe) & jnp.uint32(0xF)
            f = (x | (x >> jnp.uint32(1))) & jnp.uint32(0x5)
            nm = ((f & 1) + ((f >> jnp.uint32(2)) & 1)).astype(jnp.int32)
            is_mark = valid & (pe_raw >= Q_MARKER)
            ok = (nm == 1) | ((nm == 0) & (qsel == 0))
            cand = valid & ~is_mark & ok
            pos = jnp.where(cand, pe_raw, POS_PAD)
            poison = is_mark & (nm <= 1)
            return pos, poison

        # ---- inline tier ---------------------------------------------
        jt1 = jnp.arange(T1, dtype=jnp.int32)
        g1 = start[..., None] + jt1                # (U, 2, S, 8, T1)
        v1 = jt1 < cnt[..., None]
        pe1 = epos[jnp.clip(g1, 0, emax)]
        w0i = start >> 2
        w0 = eqw[jnp.clip(w0i, 0, wmax)]
        w1 = eqw[jnp.clip(w0i + 1, 0, wmax)]
        b1 = (start & 3)[..., None] + jt1
        s0 = (jnp.clip(b1, 0, 3) * 8).astype(jnp.uint32)
        s1 = (jnp.clip(b1 - 4, 0, 3) * 8).astype(jnp.uint32)
        qn1 = jnp.where(b1 < 4, (w0[..., None] >> s0) & jnp.uint32(0xFF),
                        (w1[..., None] >> s1) & jnp.uint32(0xFF))
        qsel8 = jnp.arange(8, dtype=jnp.int32)[None, None, None, :, None]
        pos1, poison1 = ham_filter8(pe1, qn1, qn_p[..., None], qsel8, v1)

        # ---- spill tier ----------------------------------------------
        heavy = (cnt > T1).reshape(-1)
        NF8 = U * 2 * S * 8
        HV = int(os.environ.get("PECALLER_Q8_HV", "0")) \
            or max(2048, (NF8 // 4 + 255) & ~255)
        hc = jnp.cumsum(heavy.astype(jnp.int32))
        n_heavy = hc[-1]
        heavy_over = (hc.reshape(U, 2 * S * 8) > HV).any(axis=1)
        steps_f = max(1, int(np.ceil(np.log2(NF8 + 1))))
        hsrc = jnp.clip(
            vsearch_ge(hc, jnp.arange(1, HV + 1, dtype=jnp.int32),
                       steps_f), 0, NF8 - 1)
        h_ok = jnp.arange(HV, dtype=jnp.int32) < n_heavy
        hstart = start.reshape(-1)[hsrc]
        hcnt = cnt.reshape(-1)[hsrc]
        hqn_p = qn_p.reshape(-1)[hsrc]
        hqsel = (hsrc & 7).astype(jnp.int32)
        jt2 = jnp.arange(T2E, dtype=jnp.int32)
        v2_ = h_ok[:, None] & ((T1 + jt2) < hcnt[:, None])
        NW2 = (T1 % 4 + T2E + 3) // 4 + 1
        g2 = hstart[:, None] + T1 + jt2
        pe2 = epos[jnp.clip(g2, 0, emax)]
        w2i = (hstart + T1) >> 2
        ws = [eqw[jnp.clip(w2i + j, 0, wmax)] for j in range(NW2)]
        b2 = ((hstart + T1) & 3)[:, None] + jt2
        wsel = b2 >> 2
        bsh = ((b2 & 3) * 8).astype(jnp.uint32)
        qn2 = jnp.zeros(pe2.shape, jnp.uint32)
        for j, w in enumerate(ws):
            qn2 = jnp.where(wsel == j,
                            (w[:, None] >> bsh) & jnp.uint32(0xFF), qn2)
        pos2, poison2 = ham_filter8(pe2, qn2, hqn_p[:, None],
                                    hqsel[:, None], v2_)
        tgt = jnp.where(h_ok, hsrc, NF8)
        tail = jnp.full((NF8 + 1, T2E), POS_PAD, jnp.int32).at[tgt].set(
            pos2, mode="drop")[:NF8].reshape(U, 2, S, 8, T2E)
        poison_sp = jnp.zeros(NF8 + 1, bool).at[tgt].set(
            poison2.any(axis=1), mode="drop")[:NF8].reshape(U, 2, S, 8)

        poison_q = poison1.any(-1) | poison_sp         # (U, 2, S, 8)
        poison_probe = poison_q.any(-1)                # (U, 2, S)
        seg_valid = (jnp.arange(S)[None, :] < n_segs[:, None])
        seg_in = seg_valid[:, None, :]
        enum_probe = (cnt > (T1 + T2E)).any(-1)
        enum_fb = (enum_probe & ~poison_probe & seg_in).any((1, 2))

        # ---- merge + sort + select -----------------------------------
        allpos = jnp.concatenate([pos1, tail], axis=-1)
        W = 8 * (T1 + T2E)
        allpos = allpos.reshape(U, 2, S, W)
        live = seg_in & ~poison_probe
        allpos = jnp.where(live[..., None], allpos, POS_PAD)
        cnt_cand = (allpos < POS_PAD).sum(-1)          # (U, 2, S)
        shard = None
        seg_tot = cnt_cand
        if genome_axis is not None:
            # global per-probe candidate count: owned anchors only
            # (overlap copies would double-count), summed over shards
            own_lo, own_hi = gctx[2], gctx[3]
            cnt_owned = ((allpos >= own_lo)
                         & (allpos < own_hi)).sum(-1)
            seg_tot = jax.lax.psum(cnt_owned, genome_axis)
            shard = (own_lo, own_hi)
        Wp = 1 << (W - 1).bit_length()
        if Wp > W:
            allpos = jnp.pad(allpos, ((0, 0),) * 3 + ((0, Wp - W),),
                             constant_values=POS_PAD)
        pos = bitonic_sort_last(allpos)[..., :seg_cap]
        seg_over = cnt_cand > seg_cap
        return chain_dedup_select(pos, seg_tot, seg_over,
                                  heavy_over | enum_fb, offsets, n_segs,
                                  min_match0, skip, shard=shard)

    octile_mode = dnbr.mode == "octile"
    seed_probe = seed_octile if octile_mode else (
        seed_quarter if quarter_mode else seed_nbr)

    # ---- decision layer (verbatim semantics from device_pipeline) -------

    def _top_tie(is_top, cnt, h):
        """True when >=2 candidates attain the exact top score with
        DIFFERENT DP inputs (hash inequality): the reference's strict
        f64 `>` best-replacement scan is rounding-noise-dependent
        there, so the unit is routed to the bit-exact host engine."""
        hmin = jnp.min(jnp.where(is_top, h, jnp.uint32(0xFFFFFFFF)),
                       axis=1)
        hmax = jnp.max(jnp.where(is_top, h, jnp.uint32(0)), axis=1)
        return (cnt >= 2) & (hmin != hmax)

    def decide_single(smax, valid, thr, h):
        elig = valid & (smax >= thr[:, None])
        top = jnp.max(jnp.where(elig, smax, NEGBIG), axis=1)
        is_top = elig & (smax == top[:, None])
        cnt = is_top.sum(1)
        bsm = jnp.argmax(is_top, axis=1).astype(jnp.int32)
        code = jnp.where(cnt == 0, NEITHER_MAP,
                         jnp.where(cnt == 1, UNIQUE_SINGLE, NON_NO))
        use = (cnt == 1).astype(jnp.int32)
        best = jnp.where(cnt == 1, bsm, 0)
        return code, best, use, _top_tie(is_top, cnt, h)

    def first_argmax(masked_bool):
        return jnp.argmax(masked_bool, axis=1).astype(jnp.int32)

    def decide_pair(e1, e2, thr1, thr2):
        smax1, pos1, v1 = e1["smax"], e1["pos"], e1["valid"]
        smax2, pos2, v2 = e2["smax"], e2["pos"], e2["valid"]
        or1, or2 = e1["orient"], e2["orient"]
        h1, h2 = e1["hash"], e2["hash"]
        K = smax1.shape[1]
        idx = jnp.arange(K, dtype=jnp.int32)[None, :]
        el1 = v1 & (smax1 >= thr1[:, None])
        el2 = v2 & (smax2 >= thr2[:, None])

        # uint32 modular |distance|: exact for any genome < 2^32-500
        # (genome-sharded global coords may exceed int31; a wrapped
        # "near" value would need true distance >= 2^32-max_dist, which
        # no genome reaches)
        du = (pos1.astype(jnp.uint32)[:, :, None]
              - pos2.astype(jnp.uint32)[:, None, :])
        dist = jnp.minimum(du, jnp.uint32(0) - du)
        pm = (el1[:, :, None] & el2[:, None, :] &
              (dist >= jnp.uint32(min_dist))
              & (dist <= jnp.uint32(max_dist)) &
              (or1[:, :, None] != or2[:, None, :]))
        ssum = smax1[:, :, None] + smax2[:, None, :]
        tot_best = jnp.max(jnp.where(pm, ssum, NEGBIG), axis=(1, 2))
        maxm = pm & (ssum == tot_best[:, None, None])
        perfect = maxm.sum((1, 2))
        flat = maxm.reshape(B, -1)
        first_lin = jnp.argmax(flat, axis=1).astype(jnp.int32)
        sm1 = first_lin // K
        sm2 = first_lin % K
        lin = jnp.arange(K * K, dtype=jnp.int32).reshape(K, K)
        share = (maxm & (lin[None] != first_lin[:, None, None]) &
                 ((jnp.arange(K)[None, :, None] == sm1[:, None, None]) |
                  (jnp.arange(K)[None, None, :] == sm2[:, None, None])))
        slip = 1 + share.sum((1, 2))

        s1m = jnp.where(v1, smax1, NEGBIG)
        max1 = s1m.max(1)
        best1 = first_argmax(v1 & (smax1 == max1[:, None]))
        m1_c = ((best1 != 0).astype(jnp.int32) +
                (v1 & (idx > best1[:, None]) &
                 (smax1 == max1[:, None])).sum(1))
        s2m = jnp.where(v2, smax2, NEGBIG)
        max2 = s2m.max(1)
        best2 = first_argmax(v2 & (smax2 == max2[:, None]))
        s2ref = jnp.take_along_axis(smax2, best1[:, None], axis=1)[:, 0]
        m2_c = ((best2 != 0).astype(jnp.int32) +
                (v2 & (idx > best2[:, None]) &
                 (smax2 >= s2ref[:, None])).sum(1))
        elig_b1 = max1 >= thr1
        elig_b2 = max2 >= thr2
        u1 = elig_b1 & (m1_c < 2)
        u2 = elig_b2 & (m2_c < 2)
        code_np = jnp.where(u1 & u2, UNIQUE_MIS,
                            jnp.where(u1 | u2, UNIQUE_SINGLE, NON_MIS))

        has_perf = perfect > 0
        use_both = (perfect == 1) | (slip == perfect)
        code = jnp.where(has_perf,
                         jnp.where(perfect == 1, UNIQUE_MATE,
                                   jnp.where(slip == perfect, UNIQUE_SLIP,
                                             NON_MATE)),
                         code_np)
        b1 = jnp.where(has_perf, sm1, best1)
        b2 = jnp.where(has_perf, sm2, best2)
        use1 = jnp.where(has_perf, use_both, u1).astype(jnp.int32)
        use2 = jnp.where(has_perf, use_both, u2).astype(jnp.int32)

        # decide-level tie flags: the no-perfect best1/best2 scans use
        # UNTHRESHOLDED strict `>` replacement (pemapper.c:1454-1468),
        # so an exact top tie across different DP inputs makes both the
        # class (m_c reset vs increment) and the chosen locus
        # rounding-dependent in the reference.  The perfect path is
        # immune: its comparisons carry a 0.001 band that exactly-int
        # ties always fall inside (min nonzero exact gap is 1/36).
        t_np1 = _top_tie(v1 & (smax1 == max1[:, None]),
                         (v1 & (smax1 == max1[:, None])).sum(1), h1)
        t_np2 = _top_tie(v2 & (smax2 == max2[:, None]),
                         (v2 & (smax2 == max2[:, None])).sum(1), h2)
        # a sub-threshold tied top never lands (u1/u2 stay 0 in every
        # rounding outcome), so only eligible tops are ambiguous
        tie_np = (~has_perf) & ((t_np1 & elig_b1) | (t_np2 & elig_b2))

        c_s1, b_s1, u_s1, t_s1 = decide_single(smax1, v1, thr1, h1)
        c_s2, b_s2, u_s2, t_s2 = decide_single(smax2, v2, thr2, h2)
        n1z = ~v1.any(1)
        n2z = ~v2.any(1)
        both = (~n1z) & (~n2z)
        only1 = (~n1z) & n2z
        only2 = n1z & (~n2z)
        code = jnp.where(both, code,
                         jnp.where(only1, c_s1,
                                   jnp.where(only2, c_s2, NEITHER_MAP)))
        best1 = jnp.where(both, b1, jnp.where(only1, b_s1, 0))
        best2 = jnp.where(both, b2, jnp.where(only2, b_s2, 0))
        use1 = jnp.where(both, use1, jnp.where(only1, u_s1, 0))
        use2 = jnp.where(both, use2, jnp.where(only2, u_s2, 0))
        tie_fb = jnp.where(both, tie_np,
                           jnp.where(only1, t_s1,
                                     jnp.where(only2, t_s2, False)))
        return code, best1, best2, use1, use2, tie_fb

    # ---- the fused step --------------------------------------------------

    def pairize(fb_u):
        """A fallback on either end routes the WHOLE pair to the host
        (mirrors device_pipeline: otherwise the device would emit pileup
        events for one end while the host remaps both)."""
        if paired:
            fbp = fb_u[:B] | fb_u[B:]
            return jnp.concatenate([fbp, fbp])
        return fb_u

    PW4 = (M + 7) // 8

    def pack4_dev(x):
        """(U, M) xcodes (0-4) -> (U, PW4) uint32, 4 bits per base —
        packed read rows make the per-slot row gathers 8x narrower."""
        pad = PW4 * 8 - M
        c = jnp.pad(x.astype(jnp.uint32), ((0, 0), (0, pad)))
        sh = (jnp.arange(8, dtype=jnp.uint32) * 4)[None, None, :]
        return (c.reshape(x.shape[0], PW4, 8) << sh).sum(
            axis=2, dtype=jnp.uint32)

    def unpack4(words, n_out):
        sh = (jnp.arange(8, dtype=jnp.uint32) * 4)
        b = (words[..., :, None] >> sh) & 15
        return b.reshape(*words.shape[:-1],
                         words.shape[-1] * 8)[..., :n_out].astype(jnp.uint8)

    def prep_reads_dev(seqs, lens):
        """Raw ASCII reads -> xcodes for both orientations + packed
        words + N-heavy skip + exotic flag, all on device (keeps this
        prep off the host loop's serial path)."""
        isC = seqs == ord("C")
        isG = seqs == ord("G")
        isT = seqs == ord("T")
        isA = seqs == ord("A")
        isn = seqs == ord("N")
        inlen = jnp.arange(M)[None, :] < lens[:, None]
        code = (isC * 1 + isG * 2 + isT * 3).astype(jnp.uint8)
        xf = jnp.where(isn & inlen, jnp.uint8(sw2.XN), code)
        exotic = ((~(isA | isC | isG | isT | isn)) & inlen &
                  (seqs != 0)).any(axis=1)
        n_count = (isn & inlen).sum(axis=1)
        skip = (n_count >= 1 + lens // 10).astype(jnp.int32)
        # reverse-complement: flip, complement, then roll the pad out
        # front via log-composed shifts (per-lane variable roll)
        flip = xf[:, ::-1]
        comp = jnp.where(flip == sw2.XN, jnp.uint8(sw2.XN),
                         jnp.uint8(3) - flip)
        sh_amt = (M - lens).astype(jnp.int32)
        xr = comp
        k = 1
        while k < M:
            rolled = jnp.roll(xr, -k, axis=1)
            xr = jnp.where((sh_amt[:, None] & k) != 0, rolled, xr)
            k *= 2
        xr = jnp.where(inlen, xr, jnp.uint8(0))
        return xf, xr, skip, exotic

    def step(dev_counts, *rest):
        """step(dev_counts, *dnbr.args, gcode, gmask, ist, st_pad,
        seqs_u, lens, offsets, n_segs, mm0, thr, fb_pad).

        All (U, ...) unit-major inputs (end-major: end1 rows then
        end2).  Returns (dev_counts, out (B+ins_cap+1+tie_cap+1, 6)
        int32: rows [:B] = [m1, m2, code, orb1, orb2, fb]; rows
        [B:B+ins_cap+1] = insertion records [unit, gpos, jstart, len,
        n_ins-tail-marker]; the rest = walk-tie records [unit, gstart,
        blen, orient, bt_k, bt_i, n-tail-marker] for host f64 window
        backtrack)."""
        idx_args = rest[:n_idx]
        if octile_mode:
            # gctx (5,) i32 per shard: [base_idx, base_seq, own_lo,
            # own_hi, c_lo] — local-coordinate context (see
            # parallel/mesh.py sharded_genome_step)
            (gcode, gmask, ist, st_pad, seqs_u, lens, offsets, n_segs,
             mm0, thr, fb_pad, gctx) = rest[n_idx:]
            c_shift = gctx[4]
        else:
            (gcode, gmask, ist, st_pad, seqs_u, lens, offsets, n_segs,
             mm0, thr, fb_pad) = rest[n_idx:]
            gctx = None
            c_shift = 0
        # bit 30 of thr marks a boundary-ambiguous threshold (see
        # exact_score_threshold_amb): units with a candidate score AT
        # the boundary are routed to the host (the C `>= good_score`
        # comparison there depends on f64 summation rounding)
        thr_amb = (thr & jnp.int32(1 << 30)) != 0
        thr = thr & jnp.int32((1 << 30) - 1)
        xf, xr, skip, exotic = prep_reads_dev(seqs_u, lens)
        x4f_w = pack4_dev(xf)
        x4r_w = pack4_dev(xr)

        if octile_mode:
            hits, hits_off, orient, tot, fb = seed_probe(
                idx_args, xf, xr, offsets, n_segs, mm0, skip, gctx)
        else:
            hits, hits_off, orient, tot, fb = seed_probe(
                idx_args, xf, xr, offsets, n_segs, mm0, skip)
        fb = pairize(fb | fb_pad | exotic)
        tot = jnp.where(fb, 0, tot)
        # units whose hits spill past H_CAP fall back (cap semantics)
        fb = pairize(fb | (jnp.cumsum(tot) > H_CAP))
        tot = jnp.where(fb, 0, tot)

        # --- scatter-free slot compaction (two-level) ----------------------
        idxc = jnp.arange(CAP, dtype=jnp.int32)[None, :]
        validh = idxc < tot[:, None]
        cu = jnp.cumsum(tot)                           # (U,) inclusive
        n_slots = cu[-1]
        cu_excl = cu - tot
        slot_tab = jnp.where(validh, cu_excl[:, None] + idxc, H_CAP)
        steps_u = max(1, int(np.ceil(np.log2(U + 1))))
        sarange = jnp.arange(H_CAP, dtype=jnp.int32)
        rid_s = jnp.clip(vsearch_ge(cu, sarange + 1, steps_u), 0, U - 1)
        slot_ok = sarange < n_slots
        rid_c = jnp.where(slot_ok, rid_s, 0)
        hid_s = jnp.where(slot_ok, sarange - cu_excl[rid_c], 0)

        spots_s = jnp.maximum(
            0, hits[rid_c, hid_s] - hits_off[rid_c, hid_s])
        lens_s = lens[rid_c].astype(jnp.int32)
        start_s, blen_s = windows(st_pad, ist, spots_s, lens_s,
                                  c_shift=c_shift)
        blen_m = jnp.where(slot_ok, blen_s, 0).astype(jnp.int32)
        refs_x, exo = fetch_windows(gcode, gmask, start_s, blen_m)
        ors_s = orient[rid_c, hid_s]
        # packed-word row gathers, then unpack (word-wise gathers touch
        # 8x fewer elements than byte-wise ones)
        rw = jnp.where(ors_s[:, None] == 1, x4r_w[rid_c], x4f_w[rid_c])
        reads_s = unpack4(rw, M)
        rlens_s = jnp.where(slot_ok, lens_s, 1)
        with jax.named_scope("sw_align"):
            score, bk, bi, tie_a = sw_align(refs_x, blen_m, reads_s,
                                            rlens_s, bisulfite, R_ROWS)

        score_pad = jnp.concatenate(
            [jnp.where(slot_ok, score, PAD_SCORE),
             jnp.full((1,), PAD_SCORE, jnp.int32)])
        smax = score_pad[slot_tab]                     # (U, CAP)
        spots_pad = jnp.concatenate([spots_s, jnp.zeros(1, jnp.int32)])
        pos_tab = spots_pad[slot_tab]

        # per-slot DP-input hash for decide-level tie disambiguation:
        # two slots with equal EXACT scores but different DP inputs
        # (window bases to blen, or orientation) have independent f64
        # rounding noise in the reference's strict `>` best-replacement
        # scans (pemapper.c:1101,1454-1468), so the C outcome is
        # ambiguous; identical inputs give bitwise-identical f64 scores
        # and the first candidate deterministically wins on both sides.
        # Hash equality stands in for input equality (32-bit avalanche
        # mix of two independent linear digests: false-equal odds
        # ~2^-32 per compared pair, and a collision only matters when
        # the C run would also have diverged).
        colm = jnp.arange(N, dtype=jnp.int32)[None, :] < blen_m[:, None]
        hv = jnp.where(colm, refs_x.astype(jnp.uint32) + 1,
                       jnp.uint32(0))
        ha = (hv * pw_a[None, :]).sum(axis=1, dtype=jnp.uint32)
        hb = (hv * pw_b[None, :]).sum(axis=1, dtype=jnp.uint32)
        hs = _mix32(ha ^ (blen_m.astype(jnp.uint32) * jnp.uint32(0x9E3779B9))
                    ^ (ors_s.astype(jnp.uint32) << 31))
        hs = hs ^ _mix32(hb + jnp.uint32(0x85EBCA6B))
        hash_pad = jnp.concatenate([jnp.where(slot_ok, hs, jnp.uint32(0)),
                                    jnp.zeros(1, jnp.uint32)])
        htab = hash_pad[slot_tab]                      # (U, CAP)

        # windows touching exotic genome chars -> host fallback
        exo_pad = jnp.concatenate([exo & slot_ok, jnp.zeros(1, bool)])
        fb = pairize(fb | (exo_pad[slot_tab] & validh).any(axis=1))
        tot = jnp.where(fb, 0, tot)
        smax = jnp.where(fb[:, None], PAD_SCORE, smax)

        # --- decide -------------------------------------------------------
        if genome_axis is not None:
            # genome-sharded: a unit's candidates are spread over the
            # genome axis.  Globalize the fallback verdict, gather every
            # shard's top list (global coords), and decide identically
            # on all shards; only the winner's OWNER shards traceback.
            my_g = jax.lax.axis_index(genome_axis).astype(jnp.int32)
            fb = jax.lax.pmax(fb.astype(jnp.int32), genome_axis) > 0
            tot = jnp.where(fb, 0, tot)
            smax = jnp.where(fb[:, None], PAD_SCORE, smax)
            validh_c = (jnp.arange(CAP, dtype=jnp.int32)[None, :]
                        < tot[:, None])
            # global index coords in uint32 (wraps only past 4.29 Gb)
            pos_glob = jnp.where(
                validh_c,
                pos_tab.astype(jnp.uint32) + gctx[0].astype(jnp.uint32),
                jnp.uint32(0))
            ag = lambda x: jax.lax.all_gather(    # noqa: E731
                x, genome_axis, axis=1, tiled=True)
            smax_d = ag(jnp.where(validh_c, smax, PAD_SCORE))
            pos_d = ag(pos_glob)
            orient_d = ag(jnp.where(validh_c, orient.astype(jnp.int8),
                                    jnp.int8(0)))
            valid_d = ag(validh_c)
            hash_d = ag(jnp.where(validh_c, htab, jnp.uint32(0)))
        else:
            my_g = None
            validh_c = (jnp.arange(CAP, dtype=jnp.int32)[None, :]
                        < tot[:, None])
            smax_d, pos_d, orient_d, valid_d = (smax, pos_tab, orient,
                                                validh_c)
            hash_d = htab
        if paired:
            e1 = dict(smax=smax_d[:B], pos=pos_d[:B], valid=valid_d[:B],
                      orient=orient_d[:B], hash=hash_d[:B])
            e2 = dict(smax=smax_d[B:], pos=pos_d[B:], valid=valid_d[B:],
                      orient=orient_d[B:], hash=hash_d[B:])
            code, b1, b2, u1, u2, tie_p = decide_pair(e1, e2, thr[:B],
                                                      thr[B:])
            best_u = jnp.concatenate([b1, b2])
            use_u = jnp.concatenate([u1, u2])
            code_out = code
            tie_dec = jnp.concatenate([tie_p, tie_p])
        else:
            code_out, b1, u1, tie_dec = decide_single(smax_d, valid_d,
                                                      thr, hash_d)
            best_u = b1
            use_u = u1

        # per-unit winner info (gather-only)
        if genome_axis is not None:
            own_u = (best_u // CAP) == my_g
            best_loc = jnp.where(own_u, best_u % CAP, 0)
            use_loc = jnp.where(own_u, use_u, 0)
        else:
            best_loc = best_u
            use_loc = use_u
        slot_b = jnp.take_along_axis(slot_tab, best_loc[:, None],
                                     axis=1)[:, 0]
        slot_b = jnp.clip(slot_b, 0, H_CAP - 1)
        # pre-walk tie routing: decide-level ambiguity, or an exact
        # argmax-cell tie in the winner's last DP column (rounding-
        # dependent bt cell => rounding-dependent .mfile position and
        # walk start).  Flagged units skip device traceback and are
        # re-mapped by the bit-exact f64 host engine in resolve().
        tie_al_u = (use_loc == 1) & tie_a[slot_b]
        # threshold-boundary hits: a candidate score exactly at (or one
        # notch under) a boundary-ambiguous eligibility threshold
        thr_hit = ((valid_d & ((smax_d == thr[:, None]) |
                               (smax_d == (thr - 1)[:, None]))
                    ).any(axis=1) & thr_amb)
        tie_pre = pairize(tie_dec | tie_al_u | thr_hit)
        if genome_axis is not None:
            tie_pre = jax.lax.pmax(tie_pre.astype(jnp.int32),
                                   genome_axis) > 0
        use_loc = jnp.where(tie_pre, 0, use_loc)
        m_u = jnp.where(use_loc == 1,
                        start_s[slot_b] + bi[slot_b] + 1, 0)
        if genome_axis is not None:
            # .mfile positions are global SEQ coords (+15/contig pads)
            m_u = jax.lax.psum(jnp.where(use_loc == 1, m_u + gctx[1], 0),
                               genome_axis)
        orb_u = jnp.take_along_axis(orient_d, best_u[:, None],
                                    axis=1)[:, 0].astype(jnp.int32)

        # --- winner compaction + traceback (owner-local when sharded) -----
        wmask = use_loc == 1
        wc = jnp.cumsum(wmask.astype(jnp.int32))
        n_win = wc[-1]
        wsrc = vsearch_ge(wc, jnp.arange(1, U + 1, dtype=jnp.int32),
                          steps_u)
        wsrc = jnp.clip(wsrc, 0, U - 1)
        w_ok = jnp.arange(U, dtype=jnp.int32) < n_win
        uw = jnp.where(w_ok, wsrc, 0)
        slot_w = slot_b[uw]
        start_w = start_s[slot_w]
        blen_w = jnp.where(w_ok, blen_s[slot_w], 0)
        k_w = jnp.where(w_ok, bk[slot_w], 0)
        i_w = jnp.where(w_ok, bi[slot_w], 0)
        orw = orb_u[uw]
        rww = jnp.where(orw[:, None] == 1, x4r_w[uw], x4f_w[uw])
        reads_w = unpack4(rww, M)
        rlens_w = jnp.where(w_ok, lens[uw].astype(jnp.int32), 1)
        refs_w, _ = fetch_windows(gcode, gmask, start_w, blen_w)

        with jax.named_scope("sw_traceback"):
            ev_kind, ins_j, ins_len, tie_w = sw_traceback(
                refs_w, blen_w, reads_w, rlens_w, k_w, i_w, bisulfite,
                R_ROWS)

        # walk-tie routing: lanes whose traceback crossed an exact-
        # equality decision get their device pileup/ins contributions
        # suppressed and a (unit, window, bt-cell) record emitted; the
        # host redoes JUST that window's f64 backtrack bit-exactly
        # (native sw_backtrack_batch) — the C f64 walk's path there is
        # rounding-noise-dependent (pemapper.c:1799-1831), while the
        # unit's class/locus/.mfile stay device-decided (walk ties
        # cannot change them).  Records past tie_cap demote their unit
        # to the full host-remap path (fb) so correctness never depends
        # on the cap.
        tied = w_ok & tie_w
        trank = jnp.cumsum(tied.astype(jnp.int32))       # inclusive
        t_over = tied & (trank > tie_cap)
        fb_over = jnp.zeros(U, bool).at[
            jnp.where(t_over, uw, U)].set(True, mode="drop")
        fb_over = pairize(fb_over)
        if genome_axis is not None:
            fb_over = jax.lax.pmax(fb_over.astype(jnp.int32),
                                   genome_axis) > 0
        # suppress: every tied lane, plus BOTH lanes of overflow units
        lane_keep = ~tied & ~fb_over[uw]

        # --- pileup scatter (flat u32) -------------------------------------
        # flat per-element scatter-add; the contiguous-window
        # scatter_add ((R_ROWS*6,) update block per winner) is the
        # alternative not yet tried on the GPU
        rowv = jnp.arange(R_ROWS, dtype=jnp.int32)[None, :]
        pos_abs = start_w[:, None] + rowv
        okev = (ev_kind != sw2.EV_NONE) & w_ok[:, None] & lane_keep[:, None]
        flat_idx = jnp.where(
            okev, pos_abs * 6 + ev_kind.astype(jnp.int32), 0).reshape(-1)
        # materialize indices/updates: fused into the scatter their
        # computation is recomputed inside the scatter loop
        flat_idx, upd = jax.lax.optimization_barrier(
            (flat_idx, okev.reshape(-1).astype(jnp.uint32)))
        dev_counts = dev_counts.at[flat_idx].add(upd, mode="drop")
        insm = (ins_j >= 0) & w_ok[:, None] & lane_keep[:, None]
        # insertion count column (rare): compact then scatter tiny
        fi = insm.reshape(-1)
        ci = jnp.cumsum(fi.astype(jnp.int32))
        n_ins = ci[-1]
        steps_i = max(1, int(np.ceil(np.log2(U * R_ROWS + 1))))
        isrc = vsearch_ge(ci, jnp.arange(1, ins_cap + 1, dtype=jnp.int32),
                          steps_i)
        isrc = jnp.clip(isrc, 0, U * R_ROWS - 1)
        i_ok = jnp.arange(ins_cap, dtype=jnp.int32) < n_ins
        iu = isrc // R_ROWS
        ir = isrc % R_ROWS
        ipos = start_w[iu] + ir
        if genome_axis is not None:
            # insertion records carry global SEQ coords; the local-row
            # pileup scatter below stays shard-local
            ipos_rec = ipos + gctx[1]
        else:
            ipos_rec = ipos
        dev_counts = dev_counts.at[
            jnp.where(i_ok, ipos * 6 + 5, 0)].add(
            i_ok.astype(jnp.uint32), mode="drop")
        zc = jnp.zeros(ins_cap + 1, jnp.int32)

        def _pad1(x, tail):
            return jnp.concatenate([x, jnp.full((1,), tail, jnp.int32)])

        rec = jnp.stack([
            _pad1(jnp.where(i_ok, uw[iu], -1), 0).at[ins_cap].set(n_ins),
            _pad1(jnp.where(i_ok, ipos_rec, -1), 0),
            _pad1(jnp.where(i_ok,
                            ins_j.reshape(-1)[isrc].astype(jnp.int32),
                            -1), 0),
            _pad1(jnp.where(i_ok,
                            ins_len.reshape(-1)[isrc].astype(jnp.int32),
                            0), 0),
            zc, zc], axis=1)

        # walk-tie record block: compacted (unit, global window start,
        # blen, orient, bt_k, bt_i) rows for the host f64 re-backtrack;
        # lanes of overflow-demoted units are excluded (their units go
        # through the full host remap instead)
        rsel = tied & ~fb_over[uw]
        crt = jnp.cumsum(rsel.astype(jnp.int32))
        n_trec = crt[-1]
        tsrc = vsearch_ge(crt, jnp.arange(1, tie_cap + 1, dtype=jnp.int32),
                          steps_u)
        tsrc = jnp.clip(tsrc, 0, U - 1)
        t_ok = jnp.arange(tie_cap, dtype=jnp.int32) < n_trec
        tstart = start_w[tsrc]
        if genome_axis is not None:
            tstart = tstart + gctx[1]
        trec = jnp.stack([
            _pad1(jnp.where(t_ok, uw[tsrc], -1), 0).at[tie_cap].set(
                n_trec),
            _pad1(jnp.where(t_ok, tstart, 0), 0),
            _pad1(jnp.where(t_ok, blen_w[tsrc], 0), 0),
            _pad1(jnp.where(t_ok, orw[tsrc], 0), 0),
            _pad1(jnp.where(t_ok, k_w[tsrc], 0), 0),
            _pad1(jnp.where(t_ok, i_w[tsrc], 0), 0)], axis=1)

        fb_all = fb | tie_pre | fb_over
        if paired:
            packed = jnp.stack(
                [m_u[:B], m_u[B:], code_out,
                 orb_u[:B], orb_u[B:],
                 (fb_all[:B] | fb_all[B:]).astype(jnp.int32)], axis=1)
        else:
            packed = jnp.stack(
                [m_u, jnp.zeros(B, jnp.int32), code_out, orb_u,
                 jnp.zeros(B, jnp.int32), fb_all.astype(jnp.int32)],
                axis=1)
        return dev_counts, jnp.concatenate([packed, rec, trec], axis=0)

    if jit:
        return jax.jit(step, donate_argnums=(0,))
    return step


def build_fused_multi(dnbr: NbrDeviceIndex, *, K: int, paired: bool,
                      bisulfite: bool, min_dist: int, max_dist: int,
                      n_contigs: int, genome_size: int,
                      B: int, M: int, N: int, s_max: int,
                      max_rlen: int | None = None):
    """K batches per device program via lax.scan over the SINGLE-batch
    step (identical per-batch semantics: every cap/fallback is evaluated
    at batch scope).  One dispatch + one fetch per K batches, for hosts
    where per-dispatch latency dominates."""
    import jax
    import jax.numpy as jnp

    raw = build_fused_step2(
        dnbr, paired=paired, bisulfite=bisulfite, min_dist=min_dist,
        max_dist=max_dist, n_contigs=n_contigs, genome_size=genome_size,
        B=B, M=M, N=N, s_max=s_max, jit=False,
        max_rlen=max_rlen)

    n_idx = len(dnbr.args)

    def multi(dev_counts, *rest):
        fixed = rest[:n_idx + 4]        # index arrays + genome/contigs
        xs_in = rest[n_idx + 4:]

        def body(dc, xs):
            dc, out = raw(dc, *fixed, *xs)
            return dc, out
        dev_counts, outs = jax.lax.scan(body, dev_counts, tuple(xs_in))
        return dev_counts, outs

    return jax.jit(multi, donate_argnums=(0,))


def _sw_fns():
    """SW align/traceback for the backend: the Hopper align kernel
    (ops/sw_cuda.py) on the GPU, the XLA scan (ops/sw2.py) elsewhere;
    the traceback is the XLA row-synchronous walk everywhere."""
    import jax
    if jax.default_backend() == "gpu":
        from ..ops.sw_cuda import sw_align_x_cuda
        return sw_align_x_cuda, sw2.sw_traceback_rows
    return sw2.sw_align_x, sw2.sw_traceback_rows


# --------------------------------------------------------------------------
# engine

class FusedMapperEngine2(MapperEngine):
    """Fused mapping engine v2 (inverted nbr index + scatter-free
    device pipeline).  Same public API as FusedMapperEngine."""

    def __init__(self, *args, nbr: NbrIndex | None = None, quarter=None,
                 mesh=None, group_k: int | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        from ..utils import enable_compilation_cache
        enable_compilation_cache()
        import jax
        import jax.numpy as jnp
        self._jnp = jnp
        if group_k is None:
            # the K-batch scan program's host staging (np.stack +
            # deferred group fetch) is serial work that the
            # depth-pipelined single-batch path overlaps with the device,
            # so grouping is opt-in, for hosts where per-dispatch latency
            # dominates
            group_k = int(os.environ.get("PECALLER_GROUP_K", "1"))
        self._group_k = max(1, group_k)
        self._staged = []
        gs = self.sdx.genome_size
        if gs >= 2**30:
            raise ValueError("fused device engine requires genome < 2^30 "
                             "bases; use the host engine")
        if quarter is None and nbr is None:
            # small genomes get the nbr index (fastest probe: 3-gather
            # cuckoo); genomes past its ~49x-blow-up cap get the
            # quartered-key index (v2.5, 4x storage)
            if os.environ.get("PECALLER_FORCE_Q4") == "1":
                from ..index.quarter import build_quarter_index
                quarter = build_quarter_index(self.index)
            else:
                from ..index.nbr import build_nbr_index
                try:
                    nbr = build_nbr_index(self.index)
                except ValueError:
                    from ..index.quarter import build_quarter_index
                    quarter = build_quarter_index(self.index)
        # mesh (>1 device): the reads axis shards over every device and
        # each shard accumulates its own pileup partial row (the
        # reference's qsub fan-out, map_directory_array.pl:101, becomes
        # one sharded program a user reaches via run_mapper)
        self._mesh = mesh
        self._n_sh = 1
        if mesh is not None:
            self._n_sh = int(np.prod(list(mesh.shape.values())))
        gs_p = gs + SCATTER_PAD
        if self._n_sh > 1:
            self.dev_counts = jnp.zeros((self._n_sh, gs_p * 6),
                                        jnp.uint32)
        else:
            self.dev_counts = jnp.zeros(gs_p * 6, jnp.uint32)
        if quarter is not None:
            from ..index.quarter import QuarterDeviceIndex
            self._dnbr = QuarterDeviceIndex(quarter)
        else:
            self._dnbr = NbrDeviceIndex(nbr)
        cw, mw = pack_genome(self.genome)
        self._gcode = jnp.asarray(cw)
        self._gmask = jnp.asarray(mw)
        ist = self._istarts.astype(np.int32)
        self._ist_dev = jnp.asarray(ist)
        n_pad = max(self.sdx.n_contigs + 1, 70) + 1
        st_pad = np.full(n_pad, 2**31 - 1, np.int32)
        st_pad[:len(ist)] = ist
        self._st_pad_dev = jnp.asarray(st_pad)
        self._fns = {}
        self.n_fallback = 0
        self.n_tiefix = 0       # walk-tie windows re-walked on host
        # mesh-path instrumentation: host shard-staging and result-fetch
        # walls, the host's part of the multi-card scaling efficiency
        self.mesh_timing = {"dispatch_s": 0.0, "fetch_s": 0.0,
                            "batches": 0}

    def _fn_for(self, B, M, N, s_max, mr=None):
        key = (B, M, N, s_max, mr)
        if key not in self._fns:
            if self._n_sh > 1:
                from ..parallel.mesh import sharded_fused_step2
                self._fns[key] = sharded_fused_step2(
                    self._mesh, self._dnbr, paired=self.paired,
                    bisulfite=self.bisulfite, min_dist=self.min_dist,
                    max_dist=self.max_dist, n_contigs=self.sdx.n_contigs,
                    genome_size=self.sdx.genome_size,
                    B=B, M=M, N=N, s_max=s_max, max_rlen=mr)[0]
            else:
                self._fns[key] = build_fused_step2(
                    self._dnbr, paired=self.paired,
                    bisulfite=self.bisulfite, min_dist=self.min_dist,
                    max_dist=self.max_dist, n_contigs=self.sdx.n_contigs,
                    genome_size=self.sdx.genome_size,
                    B=B, M=M, N=N, s_max=s_max, max_rlen=mr)
        return self._fns[key]

    def _mfn_for(self, K, B, M, N, s_max, mr=None):
        key = (K, B, M, N, s_max, mr)
        if key not in self._fns:
            self._fns[key] = build_fused_multi(
                self._dnbr, K=K, paired=self.paired,
                bisulfite=self.bisulfite, min_dist=self.min_dist,
                max_dist=self.max_dist, n_contigs=self.sdx.n_contigs,
                genome_size=self.sdx.genome_size,
                B=B, M=M, N=N, s_max=s_max, max_rlen=mr)
        return self._fns[key]

    def _dispatch_one(self, h):
        fn = self._fn_for(*h["key"])
        self.dev_counts, out = fn(
            self.dev_counts, *self._dnbr.args, self._gcode, self._gmask,
            self._ist_dev, self._st_pad_dev, *h["ins"])
        h["out"] = out
        del h["ins"]

    def _flush_staged(self):
        staged, self._staged = self._staged, []
        if not staged:
            return
        if len(staged) < self._group_k:
            # tail/partial group: single-batch dispatches (bounds the
            # compile set to one scan program per shape key)
            for h in staged:
                self._dispatch_one(h)
            return
        mfn = self._mfn_for(len(staged), *staged[0]["key"])
        xs = [np.stack([h["ins"][j] for h in staged])
              for j in range(len(staged[0]["ins"]))]
        self.dev_counts, outs = mfn(
            self.dev_counts, *self._dnbr.args, self._gcode, self._gmask,
            self._ist_dev, self._st_pad_dev, *xs)
        g = dict(outs=outs, host=None)
        for i, h in enumerate(staged):
            h["group"] = g
            h["gi"] = i
            del h["ins"]

    def _prep_end2(self, seqs, lens, B, M, s_max):
        """Light host prep: pad the raw reads + per-read scalars (all
        encoding/rev-comp/packing happens on device)."""
        n = seqs.shape[0]
        seqs_p = np.zeros((B, M), dtype=np.uint8)
        seqs_p[:n, :min(M, seqs.shape[1])] = seqs[:, :M]
        lens_p = np.full(B, 16, np.int32)
        lens_p[:n] = lens
        fb_pad = np.zeros(B, bool)
        fb_pad[n:] = True
        n_segs, offs = segment_offsets(lens_p.astype(np.int64))
        tc = n_segs - 1
        mm0 = np.minimum(np.maximum(1, tc), 4)
        over4 = tc > 4
        mm0[over4] = np.minimum((4 * tc[over4]) // 5, 4)
        thr = exact_score_threshold_amb(lens_p, self.min_align)
        return (seqs_p, lens_p, offs[:, :s_max].astype(np.int32),
                n_segs.astype(np.int32), mm0.astype(np.int32), thr,
                fb_pad)

    def _seg_bucket(self, s_needed):
        # probe-lane count (and with it the quartered path's gather
        # traffic) scales with s_max.  s_needed is the reference's true
        # segment count (segment_offsets): 100 bp reads have 7 segments
        # (the last at offset 84), so 6 covers reads up to 96 bp only
        for b in (6, 8, 12, 20):
            if s_needed <= b:
                return b
        return 20

    def map_batch_async(self, seqs1, lens1, seqs2=None, lens2=None,
                        read_nos=None):
        lens1 = np.asarray(lens1, np.int64)
        B = _bucket_b(seqs1.shape[0])
        maxlen = int(lens1.max()) if len(lens1) else 32
        if self.paired:
            lens2 = np.asarray(lens2, np.int64)
            maxlen = max(maxlen, int(lens2.max()) if len(lens2) else 32)
        M = _pad_to(max(maxlen, 32), 16)
        N = _pad_to(M + 2 * MISALIGN_SLOP + 1, 16)
        mr = _pad_to(max(maxlen, 32), 8)
        n_segs = int(segment_offsets(np.array([maxlen]))[0][0])
        s_max = self._seg_bucket(n_segs)
        fn = self._fn_for(B, M, N, s_max, mr)
        a1 = self._prep_end2(seqs1, lens1, B, M, s_max)
        if self.paired:
            a2 = self._prep_end2(seqs2, lens2, B, M, s_max)
            ins = [np.concatenate([x, y], axis=0)
                   for x, y in zip(a1, a2)]
        else:
            ins = list(a1)
        if self._n_sh > 1:
            from ..parallel.mesh import shard_units
            import time as _time
            t0 = _time.time()
            ins = [shard_units(x, self._n_sh, B, self.paired)
                   for x in ins]
            self.mesh_timing["dispatch_s"] += _time.time() - t0
            self.mesh_timing["batches"] += 1
        h = dict(seqs1=seqs1, lens1=lens1, seqs2=seqs2, lens2=lens2,
                 read_nos=read_nos, n=seqs1.shape[0], B=B,
                 key=(B, M, N, s_max, mr), ins=ins)
        if self._group_k > 1 and self._n_sh == 1:
            # stage; dispatch K batches as ONE scanned device program
            # (one dispatch + one fetch per K batches)
            if self._staged and self._staged[0]["key"] != h["key"]:
                self._flush_staged()
            self._staged.append(h)
            if len(self._staged) >= self._group_k:
                self._flush_staged()
            return h
        self.dev_counts, out = fn(
            self.dev_counts, *self._dnbr.args, self._gcode, self._gmask,
            self._ist_dev, self._st_pad_dev, *ins)
        h["out"] = out
        del h["ins"]
        return h

    def resolve(self, h):
        if "out" not in h and h.get("group") is None:
            self._flush_staged()        # h was still staged
        g = h.get("group")
        if g is not None:
            if g["host"] is None:       # one fetch per group
                g["host"] = np.asarray(g["outs"])
                g["outs"] = None
            out = g["host"][h["gi"]]
        elif self._n_sh > 1:
            import time as _time
            t0 = _time.time()
            out = np.asarray(h["out"])
            self.mesh_timing["fetch_s"] += _time.time() - t0
        else:
            out = np.asarray(h["out"])
        n = h["n"]
        B = h["B"]
        if out.ndim == 3:
            # sharded layout (n_sh, bl + ins_cap+1 + tie_cap+1, 6):
            # shard s holds pairs [s*bl, (s+1)*bl) with unit rows
            # [end1 bl | end2 bl]; normalize to the single-device
            # packed/rec/trec convention
            n_sh = out.shape[0]
            bl = B // n_sh
            packed = out[:, :bl, :].reshape(B, 6)
            parts = []
            tparts = []
            for sh in range(n_sh):
                rec_s = out[sh, bl:bl + INS_CAP + 1, :4]
                n_ins_s = int(rec_s[-1, 0])
                if n_ins_s > rec_s.shape[0] - 1:
                    raise RuntimeError(
                        "insertion record cap exceeded on shard "
                        f"{sh}; raise ins_cap in device_map2")
                r = rec_s[:n_ins_s].copy()
                tr_s = out[sh, bl + INS_CAP + 1:, :6]
                n_t_s = int(tr_s[-1, 0])
                tr = tr_s[:n_t_s].copy()
                if self.paired:
                    for arr in (r, tr):
                        end2 = arr[:, 0] >= bl
                        arr[:, 0] = np.where(
                            end2, B + sh * bl + (arr[:, 0] - bl),
                            sh * bl + arr[:, 0])
                else:
                    r[:, 0] = sh * bl + r[:, 0]
                    tr[:, 0] = sh * bl + tr[:, 0]
                parts.append(r)
                tparts.append(tr)
            rec = (np.concatenate(parts) if parts
                   else np.zeros((0, 4), out.dtype))
            n_ins = len(rec)
            trec = (np.concatenate(tparts) if tparts
                    else np.zeros((0, 6), out.dtype))
        else:
            packed = out[:B]
            rec = out[B:B + INS_CAP + 1, :4]
            n_ins = int(rec[-1, 0])
            if n_ins > rec.shape[0] - 1:
                raise RuntimeError("insertion record cap exceeded; raise "
                                   "ins_cap in device_map2")
            trec_a = out[B + INS_CAP + 1:, :6]
            trec = trec_a[:int(trec_a[-1, 0])]
        m1 = packed[:n, 0].astype(np.uint32)
        m2 = packed[:n, 1].astype(np.uint32)
        code = packed[:n, 2].astype(np.int32)
        orb1 = packed[:n, 3]
        orb2 = packed[:n, 4]
        fb = packed[:n, 5].astype(bool)
        read_nos = h["read_nos"]
        seqs1, lens1 = h["seqs1"], h["lens1"]
        seqs2, lens2 = h["seqs2"], h["lens2"]

        # reverse-complement ONLY the rows carrying reverse-strand
        # insertion records: a whole-batch revcomp here is host time
        # (fresh-page allocations) spent for a handful of strings
        rev_rows = {0: {}, 1: {}}
        rr = rec[:n_ins]
        if len(rr):
            # per-unit DESCENDING gpos: the reference walk attaches
            # insertion strings high-to-low (pemapper.c:1875-1905), and
            # the .indel writer preserves within-read append order
            g_u = rr[:, 1].astype(np.int64) & 0xFFFFFFFF
            rr = rr[np.lexsort((-g_u, rr[:, 0].astype(np.int64)))]
            unit_a = rr[:, 0].astype(np.int64)
            end_a = ((unit_a >= B) & self.paired).astype(np.int8)
            rid_a = unit_a - np.where(end_a == 1, B, 0)
            ok_a = (rid_a >= 0) & (rid_a < n)
            for end in (0, 1):
                seqs, lens, orb = (seqs1, lens1, orb1) if end == 0 \
                    else (seqs2, lens2, orb2)
                if seqs is None:
                    continue
                sel = ok_a & (end_a == end)
                rids = rid_a[sel]
                rids = rids[~fb[rids] & (orb[rids] == 1)]
                uniq = np.unique(rids)
                if len(uniq):
                    sub = revcomp_batch(
                        np.ascontiguousarray(seqs[uniq]), lens[uniq])
                    rev_rows[end] = {int(r): sub[k]
                                     for k, r in enumerate(uniq)}
        for unit, gpos, js, ln in rr:
            end = 1 if (self.paired and unit >= B) else 0
            rid = int(unit) - (B if end else 0)
            if rid < 0 or rid >= n or fb[rid]:
                continue
            if end == 0:
                seqs, orb = seqs1, orb1
            else:
                seqs, orb = seqs2, orb2
            src = rev_rows[end][rid] if orb[rid] == 1 else seqs[rid]
            sstr = src[js:js + ln].tobytes().decode()
            rn = int(read_nos[rid]) if read_nos is not None else int(rid)
            self.ins_records.append(
                ((self._order_counter + rn, end), int(gpos), sstr))

        # walk-tie records: the device suppressed these lanes' pileup/
        # ins contributions; redo JUST those windows' f64 DP+walk with
        # the native engine (bit-exact vs pemapper.c:1752-1965 — the
        # device detected an exact-equality decision on the path, where
        # the C f64 choice is rounding-dependent).  Class/locus/.mfile
        # stay device-decided: walk ties cannot change them, and the
        # device bt cell equals the C argmax cell (align ties are
        # routed to the full host remap instead).
        if len(trec):
            tr = trec
            unit_t = tr[:, 0].astype(np.int64)
            end_t = ((unit_t >= B) & self.paired).astype(np.int8)
            rid_t = unit_t - np.where(end_t == 1, B, 0)
            ok_t = (rid_t >= 0) & (rid_t < n)
            if not ok_t.all():
                tr, unit_t, end_t, rid_t = (x[ok_t] for x in
                                            (tr, unit_t, end_t, rid_t))
            self.n_tiefix += len(tr)
            starts = tr[:, 1].astype(np.int64) & 0xFFFFFFFF
            blens_t = np.ascontiguousarray(tr[:, 2].astype(np.int32))
            ors_t = tr[:, 3]
            ks_t = np.ascontiguousarray(tr[:, 4].astype(np.int32))
            is_t = np.ascontiguousarray(tr[:, 5].astype(np.int32))
            H = len(tr)
            W_r = seqs1.shape[1]
            if self.paired and seqs2 is not None:
                W_r = max(W_r, seqs2.shape[1])
            reads_t = np.zeros((H, W_r), np.uint8)
            rlens_t = np.zeros(H, np.int32)
            for end in (0, 1):
                seqs, lens = (seqs1, lens1) if end == 0 else (seqs2,
                                                              lens2)
                if seqs is None:
                    continue
                sel = np.nonzero(end_t == end)[0]
                if not len(sel):
                    continue
                rids = rid_t[sel]
                reads_t[sel, :seqs.shape[1]] = seqs[rids]
                rlens_t[sel] = lens[rids]
                bwd = sel[ors_t[sel] == 1]
                if len(bwd):
                    reads_t[bwd, :seqs.shape[1]] = revcomp_batch(
                        np.ascontiguousarray(seqs[rid_t[bwd]]),
                        lens[rid_t[bwd]])
            width = int(blens_t.max()) if H else 1
            refs_t = self._gather_refs(starts, blens_t, width)
            reads_t = np.ascontiguousarray(reads_t)
            ins_cap_t = H * 64 + 1024
            ins_buf = np.zeros((ins_cap_t, 4), dtype=np.int32)
            ins_count = np.zeros(1, dtype=np.int64)
            pos0 = np.ascontiguousarray(starts)
            self.lib.sw_backtrack_batch(
                _ptr(refs_t, ctypes.c_uint8), _ptr(blens_t, ctypes.c_int32),
                refs_t.shape[1], _ptr(reads_t, ctypes.c_uint8),
                _ptr(rlens_t, ctypes.c_int32), reads_t.shape[1], H,
                1 if self.bisulfite else 0, self.nthreads,
                _ptr(ks_t, ctypes.c_int32), _ptr(is_t, ctypes.c_int32),
                _ptr(pos0, ctypes.c_int64),
                self.pileup.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint16)),
                self.sdx.genome_size, _ptr(ins_buf, ctypes.c_int32),
                ins_cap_t, _ptr(ins_count, ctypes.c_int64))
            nrec = int(ins_count[0])
            if nrec:
                recs = ins_buf[:nrec]
                order = np.argsort(recs[:, 0], kind="stable")
                for ti, gpos, jstart, ilen in recs[order]:
                    rid = int(rid_t[ti])
                    end = int(end_t[ti])
                    s = reads_t[ti, jstart:jstart + ilen].tobytes()
                    rn = (int(read_nos[rid]) if read_nos is not None
                          else rid)
                    self.ins_records.append(
                        ((self._order_counter + rn, end),
                         int(np.uint32(gpos)), s.decode()))

        keep = ~fb
        self._accumulate_stats(
            code[keep], m1[keep], m2[keep], lens1[keep],
            lens2[keep] if self.paired else None)

        if fb.any():
            idx = np.nonzero(fb)[0]
            self.n_fallback += len(idx)
            nos = (read_nos[idx] if read_nos is not None
                   else idx.astype(np.int64))
            fm1, fm2, fcode = MapperEngine.map_batch(
                self, np.ascontiguousarray(seqs1[idx]), lens1[idx],
                np.ascontiguousarray(seqs2[idx]) if self.paired else None,
                lens2[idx] if self.paired else None, read_nos=nos)
            m1[idx] = fm1
            m2[idx] = fm2
            code[idx] = fcode
        return m1, m2, code

    def map_batch(self, seqs1, lens1, seqs2=None, lens2=None,
                  read_nos=None):
        return self.resolve(self.map_batch_async(
            seqs1, lens1, seqs2, lens2, read_nos=read_nos))

    def final_pileup(self) -> np.ndarray:
        self._flush_staged()
        host = self.pileup.sum(axis=0, dtype=np.uint16)
        dc = np.asarray(self.dev_counts)
        if dc.ndim == 2:                 # mesh: per-shard partial rows
            dc = dc.sum(axis=0, dtype=np.uint32)
        dev = (dc.reshape(-1, 6) & 0xFFFF).astype(np.uint16)
        return (host + dev[:self.sdx.genome_size]).astype(np.uint16)

    def reset_group(self) -> None:
        self._flush_staged()
        super().reset_group()
        gs_p = self.sdx.genome_size + SCATTER_PAD
        if self._n_sh > 1:
            self.dev_counts = self._jnp.zeros(
                (self._n_sh, gs_p * 6), self._jnp.uint32)
        else:
            self.dev_counts = self._jnp.zeros(gs_p * 6, self._jnp.uint32)
