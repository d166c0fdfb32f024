"""Fully-fused on-device mapping step: seeds -> chain -> candidate
windows -> SW scoring -> mate/single decision -> winner traceback ->
pileup scatter, all inside ONE jit program per batch.

Motivation: the split device engine (device_engine.py) makes ~6
device<->host round trips per batch (seed fetch x2, SW fetch x2,
traceback fetch x2) plus host-side numpy glue between stages.  Here the
host transfers only the read batch in and fetches one small packed
result out; the pileup accumulator never leaves device memory.

The decision layer (reference find_mate_pairs, pemapper.c:1313-1536, and
the single-end scan :1084-1174) is re-derived as vectorized integer
arithmetic: SW scores are exact rationals x36 (ops/sw.py), so the
reference's floating-point epsilons collapse to exact integer tests —
  inc > 0.001   <=>  sum_int >  best_int   (min nonzero |delta| = 1/36)
  |d| < 0.0001  <=>  equality
and the sequential hysteresis scans become closed-form reductions (see
_decide_single / _decide_pair).  The `>= good_score` eligibility gates
are precomputed on host as exact integer thresholds (smallest k with
k/36.0 >= len*min_align in float64), so device comparisons reproduce the
reference's double comparisons bit-for-bit.

Reads the device seed kernel flags as fallbacks (repeat-heavy reads,
cap overflows) are re-mapped on the host exact engine, preserving
byte-parity end to end.
"""

from __future__ import annotations

import functools

import numpy as np

from ..formats.sdx import SdxInfo
from ..formats.index_files import SeedIndex
from ..ops import sw as dsw
from .engine import (MapperEngine, MAX_HITS, MISALIGN_SLOP,
                     UNIQUE_MATE, UNIQUE_SLIP, UNIQUE_SINGLE, UNIQUE_MIS,
                     NON_MATE, NON_MIS, NON_NO, NEITHER_MAP)
from .device_seeds import (DeviceSeedIndex, seed_chain_core, HIT_CAP,
                           host_bits_rev)
from .seeds import segment_offsets, revcomp_batch

PAD_SCORE = -36          # -1.0 x36: the reference's dvector padding
INS_CAP = 2048


def _pad_to(x: int, step: int) -> int:
    return ((x + step - 1) // step) * step


def _bucket_b(n: int, lo: int = 512) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def exact_score_threshold(lens: np.ndarray, min_align: float) -> np.ndarray:
    """Smallest int k such that (k/36.0 as float64) >= len*min_align.

    Device eligibility tests `score_int >= thr` then agree exactly with
    the reference's `smax >= good_score` double comparisons
    (pemapper.c:1086,1371-1377)."""
    good = lens.astype(np.float64) * float(min_align) * 1.0
    k = np.ceil(good * 36.0).astype(np.int64)
    k = np.where(k.astype(np.float64) / 36.0 < good, k + 1, k)
    k = np.where((k - 1).astype(np.float64) / 36.0 >= good, k - 1, k)
    return k.astype(np.int32)


THR_AMB_BIT = 1 << 30


def exact_score_threshold_amb(lens: np.ndarray,
                              min_align: float) -> np.ndarray:
    """exact_score_threshold with bit 30 set when the threshold is
    BOUNDARY-AMBIGUOUS: good_score lands within summation noise
    (<1e-9 here vs a <4e-11 bound for <=300 bp sums) of an exact k/36
    rational — e.g. min_align 0.9 with len a multiple of 5, where
    32.4*len is an integer.  A candidate whose exact score EQUALS such
    a threshold passes `score >= good_score` or not depending on the
    C f64 sum's rounding (the sum mixes inexact -1/3 and 1/36
    increments), so the v2 device step routes those units to the
    bit-exact host engine.  Exactly-representable sums (pure
    match+open paths) are deterministic in C but equal our priority
    choice, so over-flagging them is harmless."""
    thr = exact_score_threshold(lens, min_align).astype(np.int64)
    good = lens.astype(np.float64) * float(min_align) * 1.0
    k_near = np.rint(good * 36.0).astype(np.int64)
    amb = np.abs(k_near.astype(np.float64) / 36.0 - good) < 1e-9
    # the ambiguous int score k_near is thr itself or thr-1 (ceil may
    # have moved one up); the step flags scores equal to EITHER when
    # the bit is set — the extra level is a deterministic reject on
    # both sides, so over-flagging it is merely a rare host remap
    return (thr | np.where(amb, THR_AMB_BIT, 0)).astype(np.int32)


def build_fused_step(dindex: DeviceSeedIndex, *, paired: bool,
                     bisulfite: bool, min_dist: int, max_dist: int,
                     n_contigs: int, genome_size: int,
                     B: int, M: int, N: int, s_max: int,
                     ins_cap: int = INS_CAP):
    """Build the jitted fused map step for one (B, M, N, s_max) bucket."""
    import jax
    import jax.numpy as jnp

    n_steps = max(1, int(np.ceil(np.log2(max(dindex.max_subrange, 2)))) + 1)
    n_keys = dindex.n_keys
    k_cap = dindex.compact_cap(B * 2 * s_max * 49)
    CAP = HIT_CAP
    H_CAP = 2 * B
    SBIG = jnp.int32(2**31 - 1)
    NEGBIG = jnp.int32(-(1 << 30))

    def find_chrom(st_pad, pos):
        """Device port of formats/sdx.find_chrom_mapper (the reference's
        probe-at-7 recursion, pemapper.c:2168-2186)."""
        ns = st_pad.shape[0]
        first = jnp.zeros_like(pos)
        last = jnp.full_like(pos, n_contigs - 1)
        trie = jnp.full_like(pos, 7)
        result = jnp.full_like(pos, -1)
        done = jnp.zeros(pos.shape, bool)

        def body(_, s):
            first, last, trie, result, done = s
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
            return first, last, trie, result, done

        s = jax.lax.fori_loop(0, 80, body,
                              (first, last, trie, result, done))
        return s[3]

    def windows(st_pad, ist, spots, lens_b):
        """Candidate locus -> clamped seq-coordinate ref window
        (engine._windows semantics, pemapper.c:1047-1081)."""
        chrom = jnp.clip(find_chrom(st_pad, spots), 0, n_contigs - 1)
        extra = 15 * chrom
        start = jnp.maximum(ist[chrom] + extra,
                            jnp.maximum(0, extra + spots - MISALIGN_SLOP))
        end = jnp.minimum(ist[chrom + 1] + extra,
                          extra + spots + lens_b + MISALIGN_SLOP)
        blen = 1 + end - start
        return start, blen

    def compact_and_score(genome, st_pad, ist, seqs, rev, lens,
                          hits, hits_off, orient, tot):
        """Compact valid hits across the batch, SW-score them on device.

        Returns per-slot arrays + the (B, CAP) int32 score matrix padded
        with PAD_SCORE (the reference pads its dvectors with -1.0)."""
        idx = jnp.arange(CAP, dtype=jnp.int32)[None, :]
        valid = idx < tot[:, None]
        flat_valid = valid.reshape(-1)
        slot = jnp.cumsum(flat_valid.astype(jnp.int32)) - 1
        tgt = jnp.where(flat_valid, jnp.minimum(slot, H_CAP - 1), H_CAP)
        rid_flat = (jnp.arange(B * CAP, dtype=jnp.int32) // CAP)
        hid_flat = (jnp.arange(B * CAP, dtype=jnp.int32) % CAP)
        n_slots = jnp.minimum(flat_valid.sum(), H_CAP)
        rid_s = jnp.zeros(H_CAP + 1, jnp.int32).at[tgt].set(
            rid_flat, mode="drop")[:H_CAP]
        hid_s = jnp.zeros(H_CAP + 1, jnp.int32).at[tgt].set(
            hid_flat, mode="drop")[:H_CAP]
        slot_ok = jnp.arange(H_CAP, dtype=jnp.int32) < n_slots

        spots_s = jnp.maximum(
            0, hits[rid_s, hid_s].astype(jnp.int32) - hits_off[rid_s, hid_s])
        lens_s = lens[rid_s].astype(jnp.int32)
        start_s, blen_s = windows(st_pad, ist, spots_s, lens_s)
        blen_m = jnp.where(slot_ok, blen_s, 0).astype(jnp.int32)
        gidx = start_s[:, None] + jnp.arange(N, dtype=jnp.int32)[None, :]
        refs = jnp.where(jnp.arange(N)[None, :] < blen_m[:, None],
                         genome[jnp.clip(gidx, 0, genome_size - 1)],
                         jnp.uint8(0))
        ors_s = orient[rid_s, hid_s]
        reads_s = jnp.where(ors_s[:, None] == 1, rev[rid_s], seqs[rid_s])
        reads_s = reads_s[:, :M]
        rlens_m = jnp.where(slot_ok, lens_s, 1).astype(jnp.int32)

        score, bk, bi = dsw.sw_align_device(refs, blen_m, reads_s,
                                            rlens_m, bisulfite, N)

        # (B, CAP) lookup table: hit -> slot; sentinel H_CAP for absent
        rid_store = jnp.where(slot_ok, rid_s, B)
        slot_tab = jnp.full((B, CAP), H_CAP, jnp.int32).at[
            rid_store, hid_s].set(jnp.arange(H_CAP, dtype=jnp.int32),
                                  mode="drop")
        score_pad = jnp.concatenate(
            [score, jnp.full((1,), PAD_SCORE, jnp.int32)])
        smax = score_pad[slot_tab]
        spots_pad = jnp.concatenate([spots_s, jnp.zeros(1, jnp.int32)])
        pos_tab = spots_pad[slot_tab]
        return dict(slot_tab=slot_tab, smax=smax, pos=pos_tab,
                    start_s=start_s, blen_s=blen_m, bk=bk, bi=bi,
                    overflow=flat_valid.sum() > H_CAP)

    def decide_single(smax, tot, thr):
        """Vectorized single_scan (pemapper.c:1084-1174 / native/mate.c).
        Returns (code, best, use)."""
        idx = jnp.arange(CAP, dtype=jnp.int32)[None, :]
        innh = idx < tot[:, None]
        elig = innh & (smax >= thr[:, None])
        top = jnp.max(jnp.where(elig, smax, NEGBIG), axis=1)
        is_top = elig & (smax == top[:, None])
        cnt = is_top.sum(1)
        bsm = jnp.argmax(is_top, axis=1).astype(jnp.int32)
        code = jnp.where(cnt == 0, NEITHER_MAP,
                         jnp.where(cnt == 1, UNIQUE_SINGLE, NON_NO))
        use = (cnt == 1).astype(jnp.int32)
        best = jnp.where(cnt == 1, bsm, 0)
        return code, best, use

    def first_argmax(masked_bool):
        return jnp.argmax(masked_bool, axis=1).astype(jnp.int32)

    def decide_pair(e1, e2, thr1, thr2):
        """Vectorized find_mate_pairs selection (pemapper.c:1313-1536).

        The sequential hysteresis collapses exactly (integer scores):
          perfect   = #{pairs with sum == max over perfect candidates}
          (sm1,sm2) = first such pair in w1-major order
          slip      = 1 + #{later max pairs sharing sm1 or sm2}
        The no-perfect fallback reproduces m1_c/m2_c tie counting incl.
        the reference's smax2[best1] quirk (pemapper.c:1468)."""
        smax1, pos1, tot1 = e1["smax"], e1["pos"], e1["tot"]
        smax2, pos2, tot2 = e2["smax"], e2["pos"], e2["tot"]
        or1, or2 = e1["orient"], e2["orient"]
        idx = jnp.arange(CAP, dtype=jnp.int32)[None, :]
        v1 = idx < tot1[:, None]
        v2 = idx < tot2[:, None]
        el1 = v1 & (smax1 >= thr1[:, None])
        el2 = v2 & (smax2 >= thr2[:, None])

        dist = jnp.abs(pos1[:, :, None].astype(jnp.int64) -
                       pos2[:, None, :].astype(jnp.int64))
        pm = (el1[:, :, None] & el2[:, None, :] &
              (dist >= min_dist) & (dist <= max_dist) &
              (or1[:, :, None] != or2[:, None, :]))
        ssum = smax1[:, :, None] + smax2[:, None, :]
        tot_best = jnp.max(jnp.where(pm, ssum, NEGBIG), axis=(1, 2))
        maxm = pm & (ssum == tot_best[:, None, None])
        perfect = maxm.sum((1, 2))
        flat = maxm.reshape(B, -1)
        first_lin = jnp.argmax(flat, axis=1).astype(jnp.int32)
        sm1 = first_lin // CAP
        sm2 = first_lin % CAP
        lin = jnp.arange(CAP * CAP, dtype=jnp.int32).reshape(CAP, CAP)
        share = (maxm & (lin[None] != first_lin[:, None, None]) &
                 ((jnp.arange(CAP)[None, :, None] == sm1[:, None, None]) |
                  (jnp.arange(CAP)[None, None, :] == sm2[:, None, None])))
        slip = 1 + share.sum((1, 2))

        # no-perfect fallback: best single ends with tie counts
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

        # dispatch on which ends have hits (native/mate.c
        # decide_pair_batch)
        c_s1, b_s1, u_s1 = decide_single(smax1, tot1, thr1)
        c_s2, b_s2, u_s2 = decide_single(smax2, tot2, thr2)
        n1z = tot1 == 0
        n2z = tot2 == 0
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
        return code, best1, best2, use1, use2

    def backtrack(dev_counts, genome, seqs, rev, lens, info, orient,
                  best, use):
        """Winner traceback + pileup scatter-add + insertion compaction.
        Returns (dev_counts, m (B,), rec (ins_cap+1, 4))."""
        wmask = use == 1
        wslot = jnp.cumsum(wmask.astype(jnp.int32)) - 1
        n_win = wmask.sum()
        tgt = jnp.where(wmask, wslot, B)
        rid_w = jnp.zeros(B + 1, jnp.int32).at[tgt].set(
            jnp.arange(B, dtype=jnp.int32), mode="drop")[:B]
        valid_w = jnp.arange(B, dtype=jnp.int32) < n_win
        ridc = jnp.where(valid_w, rid_w, 0)
        hsel = info["slot_tab"][ridc, best[ridc]]
        hsel = jnp.clip(hsel, 0, H_CAP - 1)
        start_w = info["start_s"][hsel]
        blen_w = jnp.where(valid_w, info["blen_s"][hsel], 0)
        # invalid slots must not walk: bt_i = 0 kills the traceback loop
        k_w = jnp.where(valid_w, info["bk"][hsel], 0)
        i_w = jnp.where(valid_w, info["bi"][hsel], 0)
        ors_w = orient[ridc, best[ridc]]
        reads_w = jnp.where(ors_w[:, None] == 1, rev[ridc],
                            seqs[ridc])[:, :M]
        rlens_w = jnp.where(valid_w, lens[ridc].astype(jnp.int32), 1)
        gidx = start_w[:, None] + jnp.arange(N, dtype=jnp.int32)[None, :]
        refs_w = jnp.where(jnp.arange(N)[None, :] < blen_w[:, None],
                           genome[jnp.clip(gidx, 0, genome_size - 1)],
                           jnp.uint8(0))
        ev_pos, ev_kind, ins_j, ins_len = dsw.sw_traceback_device(
            refs_w, blen_w, reads_w, rlens_w, k_w, i_w,
            bisulfite=bisulfite, n_rows=N)
        ev_abs = jnp.where(ev_pos >= 0, ev_pos + start_w[:, None], -1)
        flat_pos = ev_abs.reshape(-1)
        flat_kind = ev_kind.reshape(-1)
        ok = (flat_pos >= 0) & (flat_kind != dsw.EV_NONE)
        p = jnp.where(ok, flat_pos, 0)
        kk = jnp.where(ok, flat_kind.astype(jnp.int32), 0)
        dev_counts = dev_counts.at[p, kk].add(ok.astype(jnp.uint16),
                                              mode="drop")
        iok = (flat_pos >= 0) & (ins_j >= 0).reshape(-1)
        ip = jnp.where(iok, flat_pos, 0)
        dev_counts = dev_counts.at[ip, 5].add(iok.astype(jnp.uint16),
                                              mode="drop")
        # compact insertion records: [read, gpos, jstart, len]
        T = ev_pos.shape[1]
        vrec = (ins_j >= 0).reshape(-1)
        order = jnp.argsort(~vrec, stable=True)[:ins_cap]
        bb = order // T
        tt = order % T
        sel = vrec[order]
        rec = jnp.stack([
            jnp.where(sel, ridc[bb], -1),
            jnp.where(sel, ev_abs[bb, tt], -1),
            jnp.where(sel, ins_j[bb, tt].astype(jnp.int32), -1),
            jnp.where(sel, ins_len[bb, tt].astype(jnp.int32), 0)], axis=1)
        rec = jnp.concatenate(
            [rec, jnp.stack([vrec.sum().astype(jnp.int32), 0, 0, 0])[None]],
            axis=0)
        m_w = jnp.where(valid_w, start_w + i_w + 1, 0)
        m = jnp.zeros(B, jnp.int32).at[
            jnp.where(valid_w, ridc, B)].set(m_w, mode="drop")
        return dev_counts, m, rec

    def seed_end(ptab, ikeys, kstarts, hi_table, positions,
                 bits_f, bits_r, offs, nsegs, mm0, skip):
        return seed_chain_core(
            ptab, ikeys, kstarts, hi_table, positions, bits_f, bits_r,
            offs, nsegs, mm0, skip, s_max=s_max, n_steps=n_steps,
            n_keys=n_keys, k_cap=k_cap)

    def hit_overflow(tot):
        """Reads whose hits spill past H_CAP in rid-major compaction."""
        csum = jnp.cumsum(tot.astype(jnp.int32))
        return csum > H_CAP

    if paired:
        @functools.partial(jax.jit, donate_argnums=(0,))
        def step(dev_counts, ptab, ikeys, kstarts, hi_table,
                 positions, genome, ist, st_pad,
                 seqs1, rev1, bits1f, bits1r, lens1, offs1, nsegs1, mm01,
                 skip1, thr1,
                 seqs2, rev2, bits2f, bits2r, lens2, offs2, nsegs2, mm02,
                 skip2, thr2):
            h1, ho1, or1, tot1, fb1 = seed_end(
                ptab, ikeys, kstarts, hi_table, positions,
                bits1f, bits1r, offs1, nsegs1, mm01, skip1)
            h2, ho2, or2, tot2, fb2 = seed_end(
                ptab, ikeys, kstarts, hi_table, positions,
                bits2f, bits2r, offs2, nsegs2, mm02, skip2)
            fb = (fb1 | fb2 | hit_overflow(tot1) | hit_overflow(tot2))
            tot1 = jnp.where(fb, 0, tot1)
            tot2 = jnp.where(fb, 0, tot2)
            i1 = compact_and_score(genome, st_pad, ist, seqs1, rev1,
                                   lens1, h1, ho1, or1, tot1)
            i2 = compact_and_score(genome, st_pad, ist, seqs2, rev2,
                                   lens2, h2, ho2, or2, tot2)
            e1 = dict(smax=i1["smax"], pos=i1["pos"], tot=tot1, orient=or1)
            e2 = dict(smax=i2["smax"], pos=i2["pos"], tot=tot2, orient=or2)
            code, b1, b2, u1, u2 = decide_pair(e1, e2, thr1, thr2)
            dev_counts, m1, rec1 = backtrack(
                dev_counts, genome, seqs1, rev1, lens1, i1, or1, b1, u1)
            dev_counts, m2, rec2 = backtrack(
                dev_counts, genome, seqs2, rev2, lens2, i2, or2, b2, u2)
            orb1 = jnp.take_along_axis(or1, b1[:, None], 1)[:, 0]
            orb2 = jnp.take_along_axis(or2, b2[:, None], 1)[:, 0]
            packed = jnp.stack(
                [m1, m2, code, orb1.astype(jnp.int32),
                 orb2.astype(jnp.int32), fb.astype(jnp.int32)], axis=1)
            return dev_counts, packed, rec1, rec2
    else:
        @functools.partial(jax.jit, donate_argnums=(0,))
        def step(dev_counts, ptab, ikeys, kstarts, hi_table,
                 positions, genome, ist, st_pad,
                 seqs1, rev1, bits1f, bits1r, lens1, offs1, nsegs1, mm01,
                 skip1, thr1):
            h1, ho1, or1, tot1, fb1 = seed_end(
                ptab, ikeys, kstarts, hi_table, positions,
                bits1f, bits1r, offs1, nsegs1, mm01, skip1)
            fb = fb1 | hit_overflow(tot1)
            tot1 = jnp.where(fb, 0, tot1)
            i1 = compact_and_score(genome, st_pad, ist, seqs1, rev1,
                                   lens1, h1, ho1, or1, tot1)
            code, b1, u1 = decide_single(i1["smax"], tot1, thr1)
            dev_counts, m1, rec1 = backtrack(
                dev_counts, genome, seqs1, rev1, lens1, i1, or1, b1, u1)
            orb1 = jnp.take_along_axis(or1, b1[:, None], 1)[:, 0]
            packed = jnp.stack(
                [m1, jnp.zeros(B, jnp.int32), code,
                 orb1.astype(jnp.int32), jnp.zeros(B, jnp.int32),
                 fb.astype(jnp.int32)], axis=1)
            return dev_counts, packed, rec1, rec1

    return step


class FusedMapperEngine(MapperEngine):
    """Mapping engine whose whole per-batch pipeline is one device call.

    Host responsibilities per batch: pad/prepare the read arrays, launch
    the fused step, and (after an optional pipelining delay) fetch the
    (B, 6) packed result + two small insertion-record tables.  Reads the
    device flags as fallbacks re-run through the exact host engine
    (MapperEngine), preserving output parity."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from ..utils import enable_compilation_cache
        enable_compilation_cache()
        import jax.numpy as jnp
        self._jnp = jnp
        gs = self.sdx.genome_size
        if gs >= 2**30:
            raise ValueError("fused device engine requires genome < 2^30 "
                             "bases (int32 device coordinates); use "
                             "DeviceMapperEngine / host engine")
        self.dev_counts = jnp.zeros((gs, 6), jnp.uint16)
        self._dindex = DeviceSeedIndex(self.index)
        self.genome_dev = jnp.asarray(self.genome)
        ist = self._istarts.astype(np.int32)
        self._ist_dev = jnp.asarray(ist)
        n_pad = max(self.sdx.n_contigs + 1, 70) + 1
        st_pad = np.full(n_pad, 2**31 - 1, np.int32)
        st_pad[:len(ist)] = ist
        self._st_pad_dev = jnp.asarray(st_pad)
        self._fns = {}
        self.n_fallback = 0

    def _fn_for(self, B, M, N, s_max):
        key = (B, M, N, s_max)
        if key not in self._fns:
            self._fns[key] = build_fused_step(
                self._dindex, paired=self.paired, bisulfite=self.bisulfite,
                min_dist=self.min_dist, max_dist=self.max_dist,
                n_contigs=self.sdx.n_contigs,
                genome_size=self.sdx.genome_size,
                B=B, M=M, N=N, s_max=s_max)
        return self._fns[key]

    def _prep_end(self, seqs, lens, B, M, s_max):
        Bp = B
        n = seqs.shape[0]
        seqs_p = np.zeros((Bp, M), dtype=np.uint8)
        seqs_p[:n, :min(M, seqs.shape[1])] = seqs[:, :M]
        lens_p = np.full(Bp, 16, np.int32)
        lens_p[:n] = lens
        rev, bits_f, bits_r = host_bits_rev(seqs_p, lens_p,
                                            bisulfite=self.bisulfite)
        n_count = (seqs == ord("N")).sum(axis=1)
        skip = np.ones(Bp, np.int32)
        skip[:n] = (n_count >= 1 + lens // 10).astype(np.int32)
        n_segs, offs = segment_offsets(lens_p.astype(np.int64))
        tc = n_segs - 1
        mm0 = np.minimum(np.maximum(1, tc), 4)
        over4 = tc > 4
        mm0[over4] = np.minimum((4 * tc[over4]) // 5, 4)
        thr = exact_score_threshold(lens_p, self.min_align)
        return (seqs_p, rev, bits_f, bits_r, lens_p,
                offs[:, :s_max].astype(np.int32),
                n_segs.astype(np.int32), mm0.astype(np.int32), skip, thr)

    def _seg_bucket(self, s_needed):
        for b in (8, 12, 20):
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
        N = _pad_to(M + 2 * MISALIGN_SLOP + 1, 32)
        n_segs = int(segment_offsets(np.array([maxlen]))[0][0])
        s_max = self._seg_bucket(n_segs)
        fn = self._fn_for(B, M, N, s_max)
        a1 = self._prep_end(seqs1, lens1, B, M, s_max)
        args = (self.dev_counts, self._dindex.ptab,
                self._dindex.keys, self._dindex.starts,
                self._dindex.hi_table, self._dindex.positions,
                self.genome_dev, self._ist_dev, self._st_pad_dev) + a1
        if self.paired:
            a2 = self._prep_end(seqs2, lens2, B, M, s_max)
            args = args + a2
        self.dev_counts, packed, rec1, rec2 = fn(*args)
        return dict(packed=packed, rec1=rec1, rec2=rec2,
                    seqs1=seqs1, lens1=lens1, seqs2=seqs2, lens2=lens2,
                    read_nos=read_nos, n=seqs1.shape[0])

    def resolve(self, h):
        packed = np.asarray(h["packed"])
        n = h["n"]
        m1 = packed[:n, 0].astype(np.uint32)
        m2 = packed[:n, 1].astype(np.uint32)
        code = packed[:n, 2].astype(np.int32)
        orb1 = packed[:n, 3]
        orb2 = packed[:n, 4]
        fb = packed[:n, 5].astype(bool)
        read_nos = h["read_nos"]
        seqs1, lens1 = h["seqs1"], h["lens1"]
        seqs2, lens2 = h["seqs2"], h["lens2"]

        # insertion records (device winners)
        rev1 = rev2 = None
        for end, rec_d, seqs, lens, orb in ((0, h["rec1"], seqs1, lens1,
                                             orb1),
                                            (1, h["rec2"], seqs2, lens2,
                                             orb2)):
            if end == 1 and not self.paired:
                break
            rec = np.asarray(rec_d)
            n_ins = int(rec[-1, 0])
            if n_ins > rec.shape[0] - 1:
                raise RuntimeError("insertion record cap exceeded; raise "
                                   "ins_cap in device_pipeline")
            if n_ins == 0:
                continue
            rev = revcomp_batch(seqs, lens)
            for rid, gpos, js, ln in rec[:n_ins]:
                if rid < 0 or rid >= n or fb[rid]:
                    continue
                src = rev[rid] if orb[rid] == 1 else seqs[rid]
                sstr = src[js:js + ln].tobytes().decode()
                rn = int(read_nos[rid]) if read_nos is not None else int(rid)
                self.ins_records.append(
                    ((self._order_counter + rn, end), int(gpos), sstr))

        # stats for device-handled reads
        keep = ~fb
        self._accumulate_stats(
            code[keep], m1[keep], m2[keep], lens1[keep],
            lens2[keep] if self.paired else None)

        # fallback reads: exact host re-map (stats/pileup/ins included)
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
        host = self.pileup.sum(axis=0, dtype=np.uint16)
        return (host + np.asarray(self.dev_counts)).astype(np.uint16)

    def reset_group(self) -> None:
        super().reset_group()
        self.dev_counts = self._jnp.zeros(
            (self.sdx.genome_size, 6), self._jnp.uint16)
