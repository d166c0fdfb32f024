"""Device seed extraction + chaining: the mapper front half on device.

Device-first redesign of initial_map/fill_mers/find_matches — not a
translation: the reference's per-bucket pointer chasing becomes

  1. one gather per neighborhood key into a 2-bit-per-key presence table
     over the 4^16 key space (bit0 = key present, bit1 = abundant, i.e.
     the too_many_spots >= 100 gate, pemapper.c:1599-1615);
  2. a two-level rank table (high-22-bit prefix counts + short fixed-step
     lower_bound) replacing full searchsorted;
  3. fixed-cap padded gathers (8 positions/key, 64/segment, 16 hits/read)
     with per-read overflow flags that route rare repetitive reads to the
     exact host engine;
  4. vectorized co-linear chaining: pairwise |diag-diff| < 12 tests
     between segment lists and an exact emulation of the reference's
     min_match ratchet / dynamic loop bound / min_spots wipe
     (pemapper.c:2188-2289), with diagonal dedup in enumeration order.

Gathers are the expensive device operation here, so everything
derivable by arithmetic is:
the 48-variant 1-mismatch neighborhood (fill_mers' byte table becomes a
closed form over 2-bit fields), and the 16-mer keys (rolling static-
slice accumulation over host-precomputed 2-bit codes instead of
take_along_axis per base).

Reads flagged ``fallback`` re-run through the exact host path, so
end-to-end output matches the oracle except where a cap binds mid-read
(counted and reported by the engine).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.index_files import SeedIndex
from ..ops.encode import BASE_BITS, _RC, IDEPTH

S_MAX = 20              # max segments (reads <= 299bp)
KEY_CAP = 8             # positions gathered per neighborhood key
SEG_CAP = 64            # positions kept per segment
HIT_CAP = 16            # candidate loci per read (fast path)
TOO_MANY = 100
HI_BITS = 22
POS_PAD = np.int32(2 ** 30)     # padding sentinel (> any position)


class DeviceSeedIndex:
    """Device-resident companion structures for a SeedIndex."""

    def __init__(self, index: SeedIndex):
        keys = np.asarray(index.keys, dtype=np.int64)
        starts = np.asarray(index.starts, dtype=np.int64)
        counts = np.diff(starts)
        # 2 bits per key in uint32 words: bit0 present, bit1 abundant
        ptab = np.zeros(1 << 28, dtype=np.uint32)
        w = (keys >> 4).astype(np.int64)
        sh = ((keys & 15) << 1).astype(np.uint32)
        np.bitwise_or.at(ptab, w, np.uint32(1) << sh)
        ab = counts >= TOO_MANY
        if ab.any():
            np.bitwise_or.at(ptab, w[ab],
                             np.uint32(2) << sh[ab].astype(np.uint32))
        hi = (keys >> (32 - HI_BITS)).astype(np.int64)
        hi_table = np.searchsorted(hi, np.arange((1 << HI_BITS) + 1))
        self.n_keys = len(keys)
        self.density = len(keys) / float(2**32)
        self.ptab = jnp.asarray(ptab)
        self.keys = jnp.asarray(keys.astype(np.uint32))
        self.starts = jnp.asarray(starts.astype(np.int32))
        self.hi_table = jnp.asarray(hi_table.astype(np.int32))
        self.positions = jnp.asarray(
            np.asarray(index.positions, dtype=np.int64).astype(np.int32))
        self.max_subrange = int(np.diff(hi_table).max()) if len(keys) else 1

    def compact_cap(self, nflat: int) -> int:
        """Static capacity for batch-compacted present keys: the exact
        keys (1/49 of probes, nearly always present) plus 3x expected
        present 1-mismatch variants (~key-space density each)."""
        frac = 1.0 / 49.0 + 3.0 * (48.0 / 49.0) * self.density
        k = int(nflat * min(1.0, frac)) + 4096
        return (k + 1023) // 1024 * 1024


def host_bits_rev(seqs: np.ndarray, lens: np.ndarray,
                  bisulfite: bool = False):
    """Host-side prep for the device seed kernel: reverse-complement
    chars and 2-bit codes for both orientations (tiny numpy table
    lookups beat millions of device gathers)."""
    B, M = seqs.shape
    idx = lens[:, None].astype(np.int64) - 1 - np.arange(M)[None, :]
    rev = np.where(idx >= 0, _RC[seqs[
        np.arange(B)[:, None], np.clip(idx, 0, M - 1)]], 0).astype(np.uint8)
    conv_f, conv_r = seqs, rev
    if bisulfite:
        # uppercase-only C->T, matching convert_ct (pemapper.c:2292-2300)
        conv_f = np.where(seqs == ord("C"), np.uint8(ord("T")), seqs)
        conv_r = np.where(rev == ord("C"), np.uint8(ord("T")), rev)
    bits_f = BASE_BITS[conv_f].astype(np.uint8)
    bits_r = BASE_BITS[conv_r].astype(np.uint8)
    return rev, bits_f, bits_r


def _probe_pair(ptab, keys):
    """keys (…,) uint32 -> (present, abundant) via one gather."""
    w = ptab[(keys >> 4)]
    pair = (w >> ((keys & 15) << 1)) & 3
    return (pair & 1).astype(jnp.bool_), (pair >= 2)


def _rank_lookup(keys, starts, hi_table, n_keys, nbi, n_steps: int):
    """uint32 keys -> (start, count); absent keys get count 0."""
    hi = (nbi >> (32 - HI_BITS)).astype(jnp.int32)
    lo = hi_table[hi]
    hi_end = hi_table[hi + 1]
    for _ in range(n_steps):
        cont = lo < hi_end
        mid = (lo + hi_end) >> 1
        v = keys[jnp.clip(mid, 0, n_keys - 1)]
        pred = v < nbi
        lo = jnp.where(cont & pred, mid + 1, lo)
        hi_end = jnp.where(cont & ~pred, mid, hi_end)
    idx = jnp.clip(lo, 0, max(n_keys - 1, 0))
    present = keys[idx] == nbi
    start = jnp.where(present, starts[idx], 0)
    cnt = jnp.where(present, starts[idx + 1] - starts[idx], 0)
    return start, cnt


def _rolling_keys(bits, offsets):
    """bits (B, M) uint8 2-bit codes; offsets (B, S) -> (B, S) uint32.

    Accumulates all 16-mer keys with static slices (no gathers), then
    picks the segment offsets with one small gather."""
    B, M = bits.shape
    L = max(M - IDEPTH + 1, 1)
    key_all = jnp.zeros((B, L), jnp.uint32)
    for j in range(IDEPTH):
        key_all = (key_all << 2) + bits[:, j:j + L].astype(jnp.uint32)
    return jnp.take_along_axis(key_all, jnp.clip(offsets, 0, L - 1), axis=1)


def _neighborhood_dev(keys):
    """(B, 2, S) uint32 -> (B, 2, S, 49) uint32 keys in fill_mers order
    (pemapper.c:546-565): exact key, then per 2-bit field low->high the
    3 substitutions in ascending code order — a closed form replacing
    the reference's 256x12 byte table (no gathers)."""
    k = keys
    outs = [k[..., None]]
    for f in range(IDEPTH):
        cur = (k >> jnp.uint32(2 * f)) & jnp.uint32(3)
        base = k - (cur << jnp.uint32(2 * f))
        for j in range(3):
            c = jnp.uint32(j) + (jnp.uint32(j) >= cur).astype(jnp.uint32)
            outs.append((base + (c << jnp.uint32(2 * f)))[..., None])
    return jnp.concatenate(outs, axis=-1)


def seed_chain_core(ptab, ikeys, istarts, hi_table, positions,
                    bits_f, bits_r, offsets, n_segs, min_match0,
                    skip, *, s_max: int, n_steps: int, n_keys: int,
                    k_cap: int):
    """Traceable seed+chain core (inlined by build_seed_chain_fn's jit and
    by the fused map step in device_pipeline.py).

    Returns (hits, hits_off, orient, tot, fallback)."""
    S_MAX = s_max
    B = bits_f.shape[0]
    kf = _rolling_keys(bits_f, offsets)
    kr = _rolling_keys(bits_r, offsets)
    keys2 = jnp.stack([kf, kr], axis=1)            # (B, 2, S)
    nb = _neighborhood_dev(keys2)                  # (B, 2, S, 49)

    present, abundant = _probe_pair(ptab, nb)
    seg_valid = (jnp.arange(S_MAX)[None, :] < n_segs[:, None])
    seg_bad = abundant.any(-1) | ~seg_valid[:, None, :]

    # compact the present keys before the rank lookup + position
    # gather: only the exact keys plus a density-dependent fraction of
    # the 48 mismatch variants exist in the genome
    active = present & ~seg_bad[..., None]         # (B, 2, S, 49)
    flat_active = active.reshape(-1)
    K = k_cap
    slot = jnp.cumsum(flat_active.astype(jnp.int32)) - 1
    n_present = slot[-1] + 1
    compact_over = n_present > K                   # whole-batch fallback
    tgt = jnp.where(flat_active, jnp.minimum(slot, K - 1), K)
    comp_keys = jnp.zeros(K + 1, jnp.uint32).at[tgt].set(
        nb.reshape(-1), mode="drop")[:K]
    start_s, cnt_s = _rank_lookup(ikeys, istarts, hi_table, n_keys,
                                  comp_keys, n_steps)
    g_s = start_s[:, None] + jnp.arange(KEY_CAP)
    pmax = max(positions.shape[0] - 1, 0)
    gval_s = jnp.arange(KEY_CAP) < jnp.minimum(cnt_s,
                                               KEY_CAP)[:, None]
    pos_s = jnp.where(gval_s, positions[jnp.clip(g_s, 0, pmax)],
                      POS_PAD)                     # (K, 8)
    slot_c = jnp.clip(slot, 0, K - 1)
    cnt = jnp.where(flat_active, cnt_s[slot_c], 0).reshape(active.shape)
    seg_tot_true = cnt.sum(-1)                     # (B, 2, S)

    key_over = (cnt > KEY_CAP).any(-1)
    pos = jnp.where(flat_active[:, None], pos_s[slot_c], POS_PAD)
    pos = pos.reshape(*active.shape[:3], 49, KEY_CAP)
    pos = pos.reshape(*pos.shape[:3], 49 * KEY_CAP)
    # ascending smallest SEG_CAP via top_k on negated values (cheaper
    # than a full 392-wide sort)
    neg = jax.lax.top_k(-pos, SEG_CAP)[0]
    pos = -neg[..., ::-1]                          # (B,2,S,64) sorted
    seg_over = (seg_tot_true > SEG_CAP) | key_over

    # --- chaining: support counts per anchor -----------------------
    # one vectorized pass per segment-offset d: segment l vs l+d for
    # all l simultaneously (S-1 ops instead of S^2/2)
    max_off = max(2, IDEPTH - 4)
    diag = pos - offsets[:, None, :, None]          # int32 wrap, like C
    anchor_valid = pos < POS_PAD
    T = jnp.ones(pos.shape, jnp.int32)
    seg_in_read = (jnp.arange(S_MAX)[None, :] <= (n_segs - 1)[:, None])
    for dd in range(1, S_MAX):
        a = diag[:, :, :S_MAX - dd, :]              # anchors seg l
        bseg = diag[:, :, dd:, :]                   # partner seg l+dd
        near = jnp.abs(a[..., :, None] - bseg[..., None, :]) < max_off
        near = near & anchor_valid[:, :, dd:][..., None, :]
        found = near.any(-1) & seg_in_read[:, None, dd:, None]
        T = T.at[:, :, :S_MAX - dd, :].add(found.astype(jnp.int32))
    T = jnp.where(anchor_valid, T, 0)

    # --- min_match ratchet over (orient, loop) in order -------------
    max_depth = (n_segs - 1).astype(jnp.int32)
    min_spots = jnp.where(seg_valid[:, None, :], seg_tot_true,
                          jnp.int32(1 << 30)).min(-1)       # (B, 2)
    wipe = min_spots > 200
    Tmax = T.max(-1)                                        # (B, 2, S)
    cur = min_match0.astype(jnp.int32)
    processed = jnp.zeros((B, 2, S_MAX), jnp.bool_)
    for o in range(2):
        o_ok = ~wipe[:, o] & (skip == 0)
        for l in range(S_MAX):
            active = o_ok & (l <= 1 + max_depth - cur)
            processed = processed.at[:, o, l].set(active)
            cur = jnp.maximum(cur, jnp.where(active, Tmax[:, o, l], 0))
    final_min = cur
    accepted = (processed[..., None] &
                (T == final_min[:, None, None, None]) & anchor_valid)
    # a reverse-orientation min_spots wipe clears forward survivors
    # too (find_matches zeroes *tot_hits, pemapper.c:2204-2207)
    accepted = accepted & ~wipe[:, 1][:, None, None, None]

    # --- dedup by diagonal, keep enumeration order ------------------
    # compact the accepted anchors batch-wise first (typically ~1 per
    # read), then dedup/select with GLOBAL stable sorts over A_CAP
    # elements — per-read 1024-wide row sorts cost ~20x more
    flat_acc = accepted.reshape(-1)
    NA = flat_acc.shape[0]
    per = 2 * S_MAX * SEG_CAP
    A_CAP = 4 * B
    aslot = jnp.cumsum(flat_acc.astype(jnp.int32)) - 1
    atgt = jnp.where(flat_acc, jnp.minimum(aslot, A_CAP - 1), A_CAP)
    a_idx = jnp.zeros(A_CAP + 1, jnp.int32).at[atgt].set(
        jnp.arange(NA, dtype=jnp.int32), mode="drop")[:A_CAP]
    n_anch = jnp.minimum(flat_acc.sum(), A_CAP)
    a_valid = jnp.arange(A_CAP, dtype=jnp.int32) < n_anch
    # reads whose anchors spill past A_CAP (rid-major compaction)
    a_over = jnp.cumsum(accepted.reshape(B, -1).sum(1)) > A_CAP

    a_rid = a_idx // per
    rem = a_idx % per
    a_or = (rem // (S_MAX * SEG_CAP)).astype(jnp.int8)
    a_seg = (rem // SEG_CAP) % S_MAX
    a_diag = diag.reshape(-1)[a_idx]
    a_pos = pos.reshape(-1)[a_idx]
    a_off = offsets[a_rid, a_seg]

    BIGK = jnp.int32(2 ** 30)
    # sort by (rid, diag), stable => enumeration order within groups
    p1 = jnp.argsort(jnp.where(a_valid, a_diag, BIGK), stable=True)
    p2 = jnp.argsort(jnp.where(a_valid[p1], a_rid[p1], BIGK), stable=True)
    perm = p1[p2]
    s_rid = a_rid[perm]
    s_diag = a_diag[perm]
    s_valid = a_valid[perm]
    firstg = jnp.concatenate(
        [jnp.ones(1, bool),
         (s_rid[1:] != s_rid[:-1]) | (s_diag[1:] != s_diag[:-1])])
    keep = firstg & s_valid

    # kept anchors in per-read enumeration order, ranked within read
    k_ord = jnp.where(keep, rem[perm], BIGK)
    k_rid = jnp.where(keep, s_rid, BIGK)
    q1 = jnp.argsort(k_ord, stable=True)
    q2 = jnp.argsort(k_rid[q1], stable=True)
    qperm = q1[q2]
    rk = k_rid[qperm]
    permk = perm[qperm]
    idxa = jnp.arange(A_CAP, dtype=jnp.int32)
    newg = jnp.concatenate([jnp.ones(1, bool), rk[1:] != rk[:-1]])
    gstart = jax.lax.cummax(jnp.where(newg, idxa, 0))
    rank = idxa - gstart
    validk = rk < BIGK
    in_cap = validk & (rank < HIT_CAP)
    trg_r = jnp.where(in_cap, rk, B)
    trg_h = jnp.where(in_cap, rank, 0)
    hits = jnp.zeros((B, HIT_CAP), jnp.int32).at[trg_r, trg_h].set(
        a_pos[permk], mode="drop")
    hits_off = jnp.zeros((B, HIT_CAP), jnp.int32).at[trg_r, trg_h].set(
        a_off[permk], mode="drop")
    orient = jnp.zeros((B, HIT_CAP), jnp.int8).at[trg_r, trg_h].set(
        a_or[permk], mode="drop")
    n_keep = jnp.zeros(B, jnp.int32).at[
        jnp.where(keep, s_rid, B)].add(1, mode="drop")
    tot = jnp.minimum(n_keep, HIT_CAP)
    fallback = (seg_over.any((1, 2)) | (n_keep > HIT_CAP) |
                compact_over | a_over) & (skip == 0)
    return hits, hits_off, orient, tot, fallback


def build_seed_chain_fn(dindex: DeviceSeedIndex, bisulfite: bool = False,
                        s_max: int = 8):
    """s_max: static segment-count bucket (8 covers reads <= 127 bp)."""
    n_steps = max(1, int(np.ceil(np.log2(max(dindex.max_subrange, 2)))) + 1)
    n_keys = dindex.n_keys

    # index arrays are jit ARGUMENTS, not closure constants: closed-over
    # device arrays get inlined into the serialized HLO (1 GB table =>
    # oversized remote-compile requests)
    @jax.jit
    def seed_chain_impl(ptab, ikeys, istarts, hi_table,
                        positions, bits_f, bits_r, offsets, n_segs,
                        min_match0, skip):
        nflat = bits_f.shape[0] * 2 * s_max * 49
        hits, hits_off, orient, tot, fallback = seed_chain_core(
            ptab, ikeys, istarts, hi_table, positions, bits_f, bits_r,
            offsets, n_segs, min_match0, skip, s_max=s_max,
            n_steps=n_steps, n_keys=n_keys,
            k_cap=dindex.compact_cap(nflat))
        # pack all outputs into one int32 matrix: a single device->host
        # fetch per call
        packed = jnp.concatenate(
            [hits, hits_off.astype(jnp.int32), orient.astype(jnp.int32),
             tot[:, None], fallback.astype(jnp.int32)[:, None]], axis=1)
        return packed

    def dispatch(seqs, lens, offsets, n_segs, min_match0, skip):
        _, bits_f, bits_r = host_bits_rev(seqs, lens, bisulfite=bisulfite)
        return seed_chain_impl(
            dindex.ptab, dindex.keys, dindex.starts,
            dindex.hi_table, dindex.positions, bits_f, bits_r, offsets,
            n_segs, min_match0, skip)

    def fetch(pending):
        packed = np.asarray(pending)
        h = HIT_CAP
        return (packed[:, :h], packed[:, h:2 * h],
                packed[:, 2 * h:3 * h].astype(np.int8),
                packed[:, 3 * h], packed[:, 3 * h + 1].astype(bool))

    def seed_chain(seqs, lens, offsets, n_segs, min_match0, skip):
        return fetch(dispatch(seqs, lens, offsets, n_segs, min_match0,
                              skip))

    seed_chain.dispatch = dispatch
    seed_chain.fetch = fetch
    return seed_chain
