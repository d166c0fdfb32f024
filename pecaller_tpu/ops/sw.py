"""Device Smith-Waterman: batched affine-gap glocal DP in XLA.

Production counterpart of the float64 oracle in native/swexact.c.  Scores
are exact rationals scaled by 36 (match +36, mismatch -12, open 72,
extend 1) so the DP is integer-exact in int32 — no FP tie noise.  The
horizontal (read-gap) plane's within-row recursion is solved by the
cummax transform  z[j] = max(z[j-1], S0[j-1] - open + j*ext)  which is
exact over the integers, turning the row update into pure vector ops:
one lax.scan step per reference row.

The traceback variant re-runs the DP for winner alignments emitting
packed per-cell decision bits, then a bounded fori_loop walks the path
on device and emits pileup/insertion events.

Reference recurrences: pemapper.c:1694-1748 (score), :1752-1965 (walk).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MATCH, MISMATCH, OPEN, EXT = 36, -12, 72, 1
NEG = jnp.int32(-(1 << 30))

# event kinds emitted by the walk
EV_NONE = 5          # no event this step
EV_DEL = 4           # kinds 0..3 = base A,C,G,T counted


def _bump_row(rb, read_chars, bisulfite: bool):
    """(B,) ref chars x (B, M) read chars -> (B, M) int32 bump."""
    rb = rb[:, None]
    m = (rb == read_chars) | (rb == ord("N")) | (read_chars == ord("N")) \
        | (rb == ord("n")) | (read_chars == ord("n"))
    if bisulfite:
        m = m | (((rb == ord("C")) | (rb == ord("c"))) &
                 ((read_chars == ord("T")) | (read_chars == ord("t"))))
    return jnp.where(m, jnp.int32(MATCH), jnp.int32(MISMATCH))


def _row0(B, W):
    j = jnp.arange(W, dtype=jnp.int32)
    b = -(OPEN + (j - 1) * EXT)
    s0 = jnp.where(j == 0, 0, b)[None, :].repeat(B, 0)
    s1 = s0
    s2 = jnp.where(j == 0, -OPEN, b)[None, :].repeat(B, 0)
    return s0, s1, s2


def _step_core(s0, s1, s2, bump):
    """One DP row from the previous row's planes. bump: (B, W-1)."""
    B, W = s0.shape
    prev3 = jnp.maximum(jnp.maximum(s0, s1), s2)
    c0 = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), prev3[:, :-1] + bump], axis=1)
    c1 = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32),
         jnp.maximum(s0[:, 1:] - OPEN, s1[:, 1:] - EXT)], axis=1)
    j = jnp.arange(W, dtype=jnp.int32)[None, :]
    a = jnp.concatenate(
        [jnp.full((B, 1), -OPEN, jnp.int32),
         c0[:, :-1] - OPEN + j[:, 1:]], axis=1)
    z = jax.lax.cummax(a, axis=1)
    c2 = z - j
    return c0, c1, c2


@functools.partial(jax.jit, static_argnames=("bisulfite", "n_rows"))
def sw_align_device(refs, blens, reads, rlens, bisulfite: bool = False,
                    n_rows: int | None = None):
    """Batched glocal SW scores.

    refs: (B, N) uint8 window chars; blens: (B,) int32 valid rows.
    reads: (B, M) uint8; rlens: (B,) int32.
    Returns (score int32 x36, maxk int32, maxi int32).

    The scan iterates over a transposed (N, B) ref so each step consumes
    a contiguous xs row (no per-row dynamic slices), and the per-row
    last-read-column extraction is a one-hot masked max (a lane
    reduction) rather than a per-element gather.
    """
    B, N = refs.shape
    M = reads.shape[1]
    W = M + 1
    n_rows = N if n_rows is None else n_rows
    s0, s1, s2 = _row0(B, W)
    read_chars = reads.astype(jnp.int32)
    colmask = (jnp.arange(W, dtype=jnp.int32)[None, :] ==
               rlens.astype(jnp.int32)[:, None])

    def at_col(x):
        return jnp.max(jnp.where(colmask, x, NEG), axis=1)

    best0 = at_col(s0)
    carry0 = (s0, s1, s2, best0, jnp.zeros(B, jnp.int32),
              jnp.zeros(B, jnp.int32))
    refs_t = refs[:, :n_rows].T.astype(jnp.int32)     # (n_rows, B)

    def step(carry, xs):
        s0, s1, s2, best, bk, bi = carry
        rb, i = xs
        bump = _bump_row(rb, read_chars, bisulfite)
        c0, c1, c2 = _step_core(s0, s1, s2, bump)
        active = (i <= blens)
        for k, v in ((0, at_col(c0)), (1, at_col(c1)), (2, at_col(c2))):
            upd = active & (v > best)
            best = jnp.where(upd, v, best)
            bk = jnp.where(upd, k, bk)
            bi = jnp.where(upd, i, bi)
        s0 = jnp.where(active[:, None], c0, s0)
        s1 = jnp.where(active[:, None], c1, s1)
        s2 = jnp.where(active[:, None], c2, s2)
        return (s0, s1, s2, best, bk, bi), None

    (s0, s1, s2, best, bk, bi), _ = jax.lax.scan(
        step, carry0,
        (refs_t, jnp.arange(1, n_rows + 1, dtype=jnp.int32)))
    return best, bk, bi


@functools.partial(jax.jit, static_argnames=("bisulfite", "n_rows"))
def sw_traceback_device(refs, blens, reads, rlens, bt_k, bt_i,
                        bisulfite: bool = False, n_rows: int | None = None):
    """Recompute DP emitting decision bits, then walk the path on device.

    The walk at state (i, j, k) needs three different cells' bits: a0 of
    (i-1, j-1), b1 of (i-1, j), b2 of (i, j-1).  During the forward scan
    we pre-shift those into ONE combined byte stored at (i, j), so each
    walk step performs a single gather; read-base event kinds are
    resolved after the walk with one vectorized take_along_axis instead
    of a per-step gather.

    Returns (ev_pos (B, T) int32 ref-window row of each consuming step or
    -1, ev_kind (B, T) int8, ins_j (B, T) int16 read-slice start for
    insertion attachments or -1, ins_len (B, T) int16).
    """
    B, N = refs.shape
    M = reads.shape[1]
    W = M + 1
    n_rows = N if n_rows is None else n_rows
    s0, s1, s2 = _row0(B, W)
    read_chars = reads.astype(jnp.int32)

    def parts_of(c0, c1, c2):
        a0 = jnp.where(c1 > c0, 1, 0).astype(jnp.uint8)
        m = jnp.maximum(c0, c1)
        a0 = jnp.where(c2 > m, 2, a0).astype(jnp.uint8)
        b1 = (c1 - EXT > c0 - OPEN).astype(jnp.uint8)
        b2 = (c2 - EXT > c0 - OPEN).astype(jnp.uint8)
        return a0, b1, b2

    def shift_r(x):
        return jnp.concatenate(
            [jnp.zeros((B, 1), x.dtype), x[:, :-1]], axis=1)

    refs_t = refs[:, :n_rows].T.astype(jnp.int32)

    def step(carry, xs):
        s0, s1, s2 = carry
        rb, i = xs
        bump = _bump_row(rb, read_chars, bisulfite)
        c0, c1, c2 = _step_core(s0, s1, s2, bump)
        active = (i <= blens)[:, None]
        n0 = jnp.where(active, c0, s0)
        n1 = jnp.where(active, c1, s1)
        n2 = jnp.where(active, c2, s2)
        a0p, b1p, _ = parts_of(s0, s1, s2)      # cells of row i-1
        _, _, b2n = parts_of(n0, n1, n2)        # cells of row i
        comb = shift_r(a0p) | (b1p << 2) | (shift_r(b2n) << 3)
        return (n0, n1, n2), comb

    (_, _, _), rows = jax.lax.scan(
        step, (s0, s1, s2),
        (refs_t, jnp.arange(1, n_rows + 1, dtype=jnp.int32)))
    tbc = jnp.concatenate(
        [jnp.zeros((1, B, W), jnp.uint8), rows], axis=0)   # (nn+1, B, W)
    tbc = jnp.transpose(tbc, (1, 0, 2))                    # (B, nn+1, W)

    T = n_rows + M + 2
    rec_i = jnp.full((B, T), -1, jnp.int16)
    # rec_dj: >=0 diag step (read col j1), -2 deletion, -1 no event
    rec_dj = jnp.full((B, T), -1, jnp.int16)
    ins_j = jnp.full((B, T), -1, jnp.int16)
    ins_len = jnp.zeros((B, T), jnp.int16)

    arange_b = jnp.arange(B)

    def walk(t, st):
        ii, jj, kk, ilen, rec_i, rec_dj, ins_j, ins_len = st
        aliveb = (ii > 0) & (jj > 0)
        i1 = jnp.maximum(ii - 1, 0)
        j1 = jnp.maximum(jj - 1, 0)
        bits = tbc[arange_b, ii, jj]
        a0 = (bits & 3).astype(jnp.int32)
        b1 = ((bits >> 2) & 1).astype(jnp.int32)
        b2 = ((bits >> 3) & 1).astype(jnp.int32)
        # step targets per current plane
        ni = jnp.where(kk == 2, ii, i1)
        nj = jnp.where(kk == 1, jj, j1)
        nk = jnp.where(kk == 0, a0,
                       jnp.where(kk == 2, jnp.where(b2 == 1, 2, 0),
                                 jnp.where(b1 == 1, 1, 0)))
        consume_ref = aliveb & (kk != 2)
        diag = aliveb & (kk == 0)
        rec_i = rec_i.at[:, t].set(
            jnp.where(consume_ref, i1, -1).astype(jnp.int16))
        rec_dj = rec_dj.at[:, t].set(
            jnp.where(diag, j1,
                      jnp.where(consume_ref, -2, -1)).astype(jnp.int16))
        # insertion attachment: pending run ends at a consuming step
        attach = consume_ref & (ilen > 0)
        ins_j = ins_j.at[:, t].set(
            jnp.where(attach, jj.astype(jnp.int16), -1))
        ins_len = ins_len.at[:, t].set(
            jnp.where(attach, ilen.astype(jnp.int16), 0))
        ilen = jnp.where(aliveb,
                         jnp.where(kk == 2, ilen + 1, 0), ilen)
        ii = jnp.where(aliveb, ni, ii)
        jj = jnp.where(aliveb, nj, jj)
        kk = jnp.where(aliveb, nk, kk)
        return (ii, jj, kk, ilen, rec_i, rec_dj, ins_j, ins_len)

    st = (bt_i.astype(jnp.int32), rlens.astype(jnp.int32),
          bt_k.astype(jnp.int32), jnp.zeros(B, jnp.int32),
          rec_i, rec_dj, ins_j, ins_len)
    st = jax.lax.fori_loop(0, T - 1, walk, st)
    ii, jj, kk, ilen, rec_i, rec_dj, ins_j, ins_len = st
    # final attachment when the walk exits with a pending run and i >= 1
    fin = (ilen > 0) & (ii >= 1)
    rec_i = rec_i.at[:, T - 1].set(
        jnp.where(fin, ii - 1, -1).astype(jnp.int16))
    ins_j = ins_j.at[:, T - 1].set(
        jnp.where(fin, jj.astype(jnp.int16), -1))
    ins_len = ins_len.at[:, T - 1].set(
        jnp.where(fin, ilen.astype(jnp.int16), 0))

    # resolve event kinds in one vectorized pass
    base_map = jnp.full(256, -1, jnp.int8)
    base_map = base_map.at[ord("A")].set(0).at[ord("C")].set(1) \
                       .at[ord("G")].set(2).at[ord("T")].set(3)
    rbj = jnp.take_along_axis(
        reads, jnp.clip(rec_dj, 0, M - 1).astype(jnp.int32), axis=1)
    kind = base_map[rbj].astype(jnp.int32)
    ev_kind = jnp.where(rec_dj >= 0,
                        jnp.where(kind >= 0, kind, EV_NONE),
                        jnp.where(rec_dj == -2, EV_DEL, EV_NONE))
    return (rec_i.astype(jnp.int32), ev_kind.astype(jnp.int8),
            ins_j, ins_len)


@functools.partial(jax.jit, static_argnames=("genome_size",))
def pileup_scatter(ev_pos_abs, ev_kind, ins_mask, genome_size: int):
    """Accumulate walk events into a (genome_size, 6) uint16 pileup
    (wrapping adds, matching the reference's unsigned short counters).

    ev_pos_abs: (E,) absolute seq positions (or -1), ev_kind (E,) int8,
    ins_mask (E,) bool marking insertion attachments (column 5).
    """
    counts = jnp.zeros((genome_size, 6), jnp.uint16)
    valid = (ev_pos_abs >= 0) & (ev_kind != EV_NONE)
    pos = jnp.where(valid, ev_pos_abs, 0)
    kind = jnp.where(valid, ev_kind.astype(jnp.int32), 0)
    counts = counts.at[pos, kind].add(
        valid.astype(jnp.uint16), mode="drop")
    ivalid = (ev_pos_abs >= 0) & ins_mask
    ipos = jnp.where(ivalid, ev_pos_abs, 0)
    counts = counts.at[ipos, 5].add(ivalid.astype(jnp.uint16), mode="drop")
    return counts


@functools.partial(jax.jit, static_argnames=("bisulfite", "n_rows"))
def sw_align_device_packed(refs, blens, reads, rlens,
                           bisulfite: bool = False,
                           n_rows: int | None = None):
    """sw_align_device with outputs stacked into one (3, B) int32 array —
    a single device->host fetch for latency-bound hosts."""
    s, k, i = sw_align_device(refs, blens, reads, rlens,
                              bisulfite=bisulfite, n_rows=n_rows)
    return jnp.stack([s, k, i])


@functools.partial(jax.jit, static_argnames=("bisulfite", "n_rows",
                                             "genome_size", "ins_cap"))
def sw_traceback_scatter(refs, blens, reads, rlens, bt_k, bt_i, pos0,
                         bisulfite: bool = False, n_rows: int | None = None,
                         genome_size: int = 0, ins_cap: int = 2048):
    """Traceback + pileup scatter + insertion-event compaction, fused so
    the host fetches only a small (ins_cap+1, 4) int32 record table.

    Returns (counts (genome_size, 6) uint16 — stays on device,
             ins_packed (ins_cap+1, 4) int32: rows [b, ev_pos, jstart,
             len]; row ins_cap holds [n_ins_total, 0, 0, 0]).
    """
    ev_pos, ev_kind, ins_j, ins_len = sw_traceback_device(
        refs, blens, reads, rlens, bt_k, bt_i, bisulfite=bisulfite,
        n_rows=n_rows)
    ev_pos_abs = jnp.where(ev_pos >= 0, ev_pos + pos0[:, None], -1)
    counts = pileup_scatter(ev_pos_abs.reshape(-1), ev_kind.reshape(-1),
                            (ins_j >= 0).reshape(-1),
                            genome_size=genome_size)
    B, T = ev_pos.shape
    valid = (ins_j >= 0).reshape(-1)
    order = jnp.argsort(~valid, stable=True)[:ins_cap]
    bb = (order // T).astype(jnp.int32)
    tt = order % T
    sel_valid = valid[order]
    rec = jnp.stack([
        jnp.where(sel_valid, bb, -1),
        jnp.where(sel_valid, ev_pos[bb, tt], -1),
        jnp.where(sel_valid, ins_j[bb, tt].astype(jnp.int32), -1),
        jnp.where(sel_valid, ins_len[bb, tt].astype(jnp.int32), 0)],
        axis=1)
    total = valid.sum().astype(jnp.int32)
    rec = jnp.concatenate(
        [rec, jnp.stack([total, 0, 0, 0])[None, :]], axis=0)
    return counts, rec
