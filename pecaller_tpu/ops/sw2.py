"""Code-based Smith-Waterman + row-synchronous traceback (XLA).

Second-generation device SW path.  Differences from ops/sw.py:

* Bases travel as 3-state "xcodes" (0-3 = A/C/G/T, 4 = N wildcard)
  instead of ASCII chars, so genome and reads can be 2-bit packed for
  transfer and gathered as uint32 words (16x fewer gathered elements
  than byte-wise window gathers).  Reads or windows containing
  chars outside {A,C,G,T,N} are routed to the exact host engine by the
  caller (the reference compares raw bytes, pemapper.c:2006-2048, so
  exotic IUPAC letters can't be represented in 3 states).

* The traceback walk is ROW-SYNCHRONOUS: the backtrack path consumes
  exactly one reference row per iteration (a diagonal or vertical step),
  with any horizontal (insertion) run resolved in closed form inside the
  iteration via a prefix-max over the decision-bit row.  n_rows
  iterations bound the whole walk — no per-step scalar loop (the
  round-1 step walk of ops/sw.py), and events land ROW-INDEXED
  (slot r holds the event of ref window row r), which is what the
  pileup scatter wants.

Walk-state recurrence derivation (from sw.sw_traceback_device, itself
the vector port of pemapper.c:1752-1965): a step at state (i, j, k)
with decision bits a0/b1/b2 of cell (i, j) does
  k=0: consume ref row i-1 as read base j-1 (diagonal), ->(i-1,j-1,a0)
  k=1: consume ref row i-1 as a deletion,               ->(i-1,j,b1?1:0)
  k=2: consume read base j-1 (insertion run, ilen++),   ->(i,j-1,b2?2:0)
guarded by alive = (i > 0) & (j > 0); a consuming step (k<2) with
pending ilen attaches an insertion (ins_j = current j, len = ilen); a
walk that dies mid-run attaches (ins_j = 0, len) at row i-1 post-loop.
Consequences used here: a k=2 run stays inside one row and always ends
in a k=0 step (or walk death), and ilen is zero at every row entry, so
each row processes [optional k2-run] + one consuming step — one row per
iteration, runs resolved in closed form.

Scores are exact rationals x36 as in ops/sw.py; recurrences mirror
pemapper.c:1694-1748 (DP) and :1752-1965 (walk).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .sw import MATCH, MISMATCH, OPEN, EXT, _row0, _step_core

NEG = jnp.int32(-(1 << 30))
XN = 4                   # xcode of the N wildcard
EV_DEL = 4
EV_NONE = 5


def match_mask(ref_x, read_x, bisulfite: bool):
    """Reference bonus-matrix semantics on xcodes (pemapper.c:2006-2048):
    equal bases match, N matches everything, bisulfite adds ref C ~ read
    T."""
    m = (ref_x == read_x) | (ref_x == XN) | (read_x == XN)
    if bisulfite:
        m = m | ((ref_x == 1) & (read_x == 3))
    return m


def _bump_row_x(rb, read_x, bisulfite: bool):
    m = match_mask(rb[:, None], read_x, bisulfite)
    return jnp.where(m, jnp.int32(MATCH), jnp.int32(MISMATCH))


@functools.partial(jax.jit, static_argnames=("bisulfite", "n_rows"))
def sw_align_x(refs_x, blens, reads_x, rlens, bisulfite: bool = False,
               n_rows: int | None = None):
    """Batched glocal SW on xcodes.  Same contract as sw.sw_align_device:
    returns (score x36, plane k, ref row i) of the argmax cell in the
    last read column, plus a per-lane `tie` flag.

    `tie` is True when >=2 last-column cells attain the FINAL best
    score (pemapper.c:1716-1742 scans with strict `>` f64 comparisons;
    two mathematically-equal cells reached by different summation
    orders carry different rounding noise, so which of them the C scan
    lands on is rounding-dependent — flagged lanes are re-run through
    the bit-exact f64 host engine).  Ties with sub-final running bests
    are irrelevant: a later strict improvement erases them in every
    rounding outcome, so the count resets on improvement."""
    B, N = refs_x.shape
    M = reads_x.shape[1]
    W = M + 1
    n_rows = N if n_rows is None else n_rows
    s0, s1, s2 = _row0(B, W)
    read_x = reads_x.astype(jnp.int32)
    colmask = (jnp.arange(W, dtype=jnp.int32)[None, :] ==
               rlens.astype(jnp.int32)[:, None])

    def at_col(x):
        return jnp.max(jnp.where(colmask, x, NEG), axis=1)

    best0 = at_col(s0)
    carry0 = (s0, s1, s2, best0, jnp.zeros(B, jnp.int32),
              jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.int32))
    refs_t = refs_x[:, :n_rows].T.astype(jnp.int32)

    def step(carry, xs):
        s0, s1, s2, best, bk, bi, n_at = carry
        rb, i = xs
        bump = _bump_row_x(rb, read_x, bisulfite)
        c0, c1, c2 = _step_core(s0, s1, s2, bump)
        active = (i <= blens)
        for k, v in ((0, at_col(c0)), (1, at_col(c1)), (2, at_col(c2))):
            upd = active & (v > best)
            n_at = jnp.where(upd, 1,
                             jnp.where(active & (v == best), n_at + 1,
                                       n_at))
            best = jnp.where(upd, v, best)
            bk = jnp.where(upd, k, bk)
            bi = jnp.where(upd, i, bi)
        s0 = jnp.where(active[:, None], c0, s0)
        s1 = jnp.where(active[:, None], c1, s1)
        s2 = jnp.where(active[:, None], c2, s2)
        return (s0, s1, s2, best, bk, bi, n_at), None

    (s0, s1, s2, best, bk, bi, n_at), _ = jax.lax.scan(
        step, carry0,
        (refs_t, jnp.arange(1, n_rows + 1, dtype=jnp.int32)))
    return best, bk, bi, n_at >= 2


def _parts_of(c0, c1, c2):
    a0 = jnp.where(c1 > c0, 1, 0).astype(jnp.uint8)
    m = jnp.maximum(c0, c1)
    a0 = jnp.where(c2 > m, 2, a0).astype(jnp.uint8)
    b1 = (c1 - EXT > c0 - OPEN).astype(jnp.uint8)
    b2 = (c2 - EXT > c0 - OPEN).astype(jnp.uint8)
    return a0, b1, b2


def _tie_parts_of(c0, c1, c2):
    """Exact-equality companions of _parts_of: at cells where any of the
    walk's strict `>` comparisons (pemapper.c:1799-1831) sees two
    mathematically-equal quantities, the C f64 outcome is
    rounding-order-dependent; a walk crossing such a cell is flagged."""
    t0 = ((c1 == c0) | (c2 == jnp.maximum(c0, c1))).astype(jnp.uint8)
    t1 = (c1 - EXT == c0 - OPEN).astype(jnp.uint8)
    t2 = (c2 - EXT == c0 - OPEN).astype(jnp.uint8)
    return t0, t1, t2


@functools.partial(jax.jit, static_argnames=("bisulfite", "n_rows"))
def sw_traceback_rows(refs_x, blens, reads_x, rlens, bt_k, bt_i,
                      bisulfite: bool = False, n_rows: int | None = None):
    """Row-synchronous traceback on xcodes.

    Returns, all shaped (B, n_rows) and indexed by ref window row r:
      ev_kind  int8: 0-3 read base code consumed at row r via a diagonal
               step, EV_DEL for a vertical step, EV_NONE otherwise
      ins_j    int16: read-column start of an insertion run attached at
               row r (-1 if none; matches sw.sw_traceback_device ins_j)
      ins_len  int16: its length
    plus `tie` (B,) bool: True when any decision the walk actually took
    compared two exactly-equal quantities (the C f64 walk's choice at
    that point is rounding-noise-dependent — see _tie_parts_of).
    """
    B, N = refs_x.shape
    M = reads_x.shape[1]
    W = M + 1
    n_rows = N if n_rows is None else n_rows
    s0, s1, s2 = _row0(B, W)
    read_x32 = reads_x.astype(jnp.int32)
    refs_t = refs_x[:, :n_rows].T.astype(jnp.int32)

    def shift_r(x):
        return jnp.concatenate(
            [jnp.zeros((B, 1), x.dtype), x[:, :-1]], axis=1)

    def step(carry, xs):
        s0, s1, s2 = carry
        rb, i = xs
        bump = _bump_row_x(rb, read_x32, bisulfite)
        c0, c1, c2 = _step_core(s0, s1, s2, bump)
        active = (i <= blens)[:, None]
        n0 = jnp.where(active, c0, s0)
        n1 = jnp.where(active, c1, s1)
        n2 = jnp.where(active, c2, s2)
        a0p, b1p, _ = _parts_of(s0, s1, s2)      # row i-1 cells
        _, _, b2n = _parts_of(n0, n1, n2)        # row i cells
        t0p, t1p, _ = _tie_parts_of(s0, s1, s2)
        _, _, t2n = _tie_parts_of(n0, n1, n2)
        comb = (shift_r(a0p) | (b1p << 2) | (shift_r(b2n) << 3)
                | (shift_r(t0p) << 4) | (t1p << 5) | (shift_r(t2n) << 6))
        return (n0, n1, n2), comb

    (_, _, _), rows = jax.lax.scan(
        step, (s0, s1, s2),
        (refs_t, jnp.arange(1, n_rows + 1, dtype=jnp.int32)))
    # rows[i-1] = combined bits of DP row i (bits of row 0 are all 0)
    tbc = jnp.concatenate(
        [jnp.zeros((1, B, W), jnp.uint8), rows], axis=0)   # (nn+1, B, W)

    ev_kind = jnp.full((B, n_rows), EV_NONE, jnp.int8)
    ins_j = jnp.full((B, n_rows), -1, jnp.int16)
    ins_len = jnp.zeros((B, n_rows), jnp.int16)

    colv = jnp.arange(W, dtype=jnp.int32)[None, :]        # (1, W)
    kind_of = jnp.where(reads_x == XN, jnp.int8(EV_NONE),
                        reads_x.astype(jnp.int8))          # (B, M)
    kind_pad = jnp.concatenate(
        [kind_of, jnp.full((B, 1), EV_NONE, jnp.int8)], axis=1)

    def row_iter(t, st):
        i = n_rows - t                                     # rows high->low
        jj, kk, alive, tie, ev_kind, ins_j, ins_len = st
        # a lane is at row i exactly when it started at bt_i >= i and
        # is still alive (one row consumed per iteration once started)
        act = alive & (bt_i.astype(jnp.int32) >= i)
        rowb = jax.lax.dynamic_index_in_dim(tbc, i, 0, False)  # (B, W)
        a0 = (rowb & 3).astype(jnp.int32)
        b1 = ((rowb >> 2) & 1).astype(jnp.int32)
        b2 = ((rowb >> 3) & 1).astype(jnp.int32)
        t0 = ((rowb >> 4) & 1).astype(jnp.int32)
        t1 = ((rowb >> 5) & 1).astype(jnp.int32)
        t2 = ((rowb >> 6) & 1).astype(jnp.int32)

        # k2-run resolution: run columns jj..jc where jc = largest
        # col <= jj with b2(i, col) == 0; jc <= 1 means the run reaches
        # column 0 and the walk dies mid-run (pending-run attachment)
        stopc = jnp.where(b2 == 0, colv, -1)               # (B, W)
        pm = jax.lax.cummax(stopc, axis=1)
        oh_j = colv == jj[:, None]
        jc = jnp.max(jnp.where(oh_j, pm, -1), axis=1)      # (B,)

        is2 = act & (kk == 2)
        is1 = act & (kk == 1)
        run_dead = is2 & (jc <= 1)
        run_len = jnp.where(is2, jnp.where(run_dead, jj, jj - jc + 1), 0)
        # column of this row's consuming step (k0 after a run lands at
        # jc-1; entry k0/k1 consume at jj directly)
        cstep_j = jnp.where(is2, jc - 1, jj)
        cstep_j_c = jnp.clip(cstep_j, 0, W - 1)
        oh_c = colv == cstep_j_c[:, None]

        def at_c(x):
            return jnp.max(jnp.where(oh_c, x, NEG), axis=1)

        a0_c = at_c(a0)
        b1_c = at_c(b1)
        consume = act & ~run_dead                          # one ref row
        diag = consume & ~is1

        # events of ref row i-1 -> slot i-1
        kind_row = jnp.take_along_axis(
            kind_pad, jnp.clip(cstep_j_c - 1, 0, M)[:, None],
            axis=1)[:, 0]
        ev = jnp.where(diag, kind_row,
                       jnp.where(is1, jnp.int8(EV_DEL), jnp.int8(EV_NONE)))
        ev_kind = jax.lax.dynamic_update_index_in_dim(
            ev_kind, jnp.where(act & ~run_dead, ev, ev_kind[:, i - 1]),
            i - 1, 1)
        # insertion attachment: consuming diag step with a pending run,
        # or mid-run death (reference post-loop attach, ins_j = 0)
        attach = (diag & (run_len > 0)) | run_dead
        ins_col = jnp.where(run_dead, jnp.int32(0), cstep_j)
        ins_j = jax.lax.dynamic_update_index_in_dim(
            ins_j,
            jnp.where(attach, ins_col.astype(jnp.int16), ins_j[:, i - 1]),
            i - 1, 1)
        ins_len = jax.lax.dynamic_update_index_in_dim(
            ins_len,
            jnp.where(attach, run_len.astype(jnp.int16),
                      ins_len[:, i - 1]),
            i - 1, 1)

        # next state: k0/post-run -> (i-1, cstep_j-1, a0); k1 ->
        # (i-1, jj, b1 ? 1 : 0); mid-run death freezes the lane
        nk = jnp.where(is1, jnp.where(b1_c == 1, 1, 0), a0_c)
        nj = jnp.where(is1, jj, cstep_j - 1)
        nalive = consume & (nj > 0) & (i - 1 > 0)
        # tie accounting: a0/b1 ties only matter when the walk survives
        # the step (they pick the NEXT k; the current row's event is
        # decision-independent); b2 ties matter at every run column the
        # walk actually visited, cols [max(jc,1), jj]
        pmT = jax.lax.cummax(jnp.where(t2 == 1, colv, -1), axis=1)
        t2max = jnp.max(jnp.where(oh_j, pmT, -1), axis=1)
        tie_run = is2 & (t2max >= jnp.maximum(jc, 1))
        tie_new = ((diag & (at_c(t0) == 1) & nalive)
                   | (is1 & (at_c(t1) == 1) & nalive)
                   | tie_run)
        tie = tie | tie_new
        jj = jnp.where(act, nj, jj)
        kk = jnp.where(act, nk, kk)
        alive = jnp.where(act, nalive, alive)
        return jj, kk, alive, tie, ev_kind, ins_j, ins_len

    st = (rlens.astype(jnp.int32), bt_k.astype(jnp.int32),
          (bt_i > 0) & (rlens > 0), jnp.zeros(B, bool),
          ev_kind, ins_j, ins_len)
    st = jax.lax.fori_loop(0, n_rows, row_iter, st)
    _, _, _, tie, ev_kind, ins_j, ins_len = st
    return ev_kind, ins_j, ins_len, tie
