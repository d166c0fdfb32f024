"""Device caller screen: the production fast path of `run_caller`.

The reference caller (pecaller.c:1149-1749) runs an exact float64
joint-configuration beam per site.  On real cohorts the overwhelming
majority of sites are *provably boring*: either the bad-base gates fire
(pecaller.c:1261-1304 — pure integer logic), or every active sample is
homozygous-reference by such a margin that the beam never keeps a second
configuration, in which case every output value is fully determined
(call = ref genotype, posterior = exactly 1.0, site type = REF, no .snp
row).  This module classifies sites on-device so only the residual
"interesting" sites reach the exact native float64 engine
(native/pecall.c) — the screen is *conservative*, never mis-claiming a
site, so byte parity with the C reference is preserved by construction.

Why the margin criterion is exact
---------------------------------
With the pass-1 alpha prior, `fill_config_probs` (pecaller.c:2511-2788)
expands an alternate genotype j for sample s only when
``like_s[dom] - like_s[j] < thres (=2.3)`` (the allocation check
``templ + thres > best_post`` with the all-ref config's prior == 0 and
all priors <= 0; the secondary check ``templ + 0.01 > best_like`` is
strictly tighter).  If every active sample's margin over *every*
alternate genotype exceeds 2.3, the beam holds exactly one configuration
through all passes, its normalized posterior is exactly 1.0 (float64
1.0/1.0), every final call equals the initial call, and the EM loop
terminates after pass 1 (`calls_changed == 0`).  The screen therefore
requires ``margin > 2.3 + BAND`` where BAND conservatively covers the
float32 likelihood-evaluation error (see below), and additionally routes
any site whose depth could push the f32 lgamma error past BAND/2 to the
exact engine.

The pass-1 likelihood is evaluated in the same algebra as
``fill_sample_like`` (pecaller.c:2448-2507) minus the per-sample
multinomial coefficient (constant across genotypes, cancels in margins):

    like'[j] = A1[scale,ref,j]
             + sum_ii lgamma(TA[scale,ref,j,ii] + reads[ii])
             - lgamma(TOTA[scale,ref,j] + tot + reads[5])

where TA = ceil(scale * d_mean) is precomputed on the host with the
*identical float64 operation sequence* as the C code (so ceil boundary
cases match bit-for-bit), and A1 folds the read-independent factln terms.
`factln(n) == lgamma(n+1)`: the C factbl uses the NR gammln / exact
products whose difference from true lgamma (<1e-9) is inside BAND.
"""

from __future__ import annotations

import functools

import numpy as np

from .device_model import fill_alpha_prior_np

NO_ALLELES = 6
MAX_GEN = 14

# site codes (UNRES is phase-0-internal: "phase 1 must decide")
HARD, EASY, BAD, UNRES = 0, 1, 2, 3

# conservative slack over the exact 2.3 beam threshold: covers f32
# summation error (<=14 terms of magnitude <= ~7e4 at the depth gate ->
# <0.15) plus lgamma-vs-NR-gammln approximation error (<1e-6 rel).
BAND = 1.0
# route any sample whose lgamma arguments could exceed ~8.8e3 (f32 abs
# error ~0.01/term, sum ~0.15) to the exact engine instead.
DEPTH_GATE = 8192

_SCALES = np.arange(10, 101, dtype=np.int64)        # pass-1 scale domain


def _factln_table(n: int) -> np.ndarray:
    """math.lgamma(k+1) for k in [0, n): within 1e-9 of the C factbl."""
    import math
    return np.array([math.lgamma(k + 1.0) for k in range(n)])


@functools.lru_cache(maxsize=4)
def _tables(haploid: bool):
    """Pass-1 alpha tables over (scale 10..100, ref 0..3, genotype).

    TA replicates pecaller.c:2466-2470 in identical float64 ops:
    d_mean = alpha/rowsum (f64 divide), ta = ceil(scale * d_mean),
    clamped >= 1.
    """
    max_gen = NO_ALLELES if haploid else MAX_GEN
    n_sc = len(_SCALES)
    ta = np.zeros((n_sc, 4, max_gen, NO_ALLELES), dtype=np.int32)
    for ref in range(4):
        alpha = fill_alpha_prior_np(300, 150, ref)[:max_gen].astype(
            np.float64)
        d_mean = alpha / alpha.sum(axis=1, keepdims=True)
        for k, sc in enumerate(_SCALES):
            t = np.ceil(float(sc) * d_mean)
            ta[k, ref] = np.maximum(t, 1.0).astype(np.int32)
    tota = ta.sum(axis=3, dtype=np.int32)
    fact = _factln_table(int(tota.max()) + 1)
    a1 = (fact[tota - 1] - fact[ta - 1].sum(axis=3)).astype(np.float32)
    return ta, tota, a1


# --- phase-0: exact-f64 pass/fail tables for simple count patterns -------
#
# The overwhelming majority of samples at real sites carry a SIMPLE
# pattern: every read is the reference base except at most CMAX reads of
# ONE alternate kind, no Ins reads.  For such a pattern the pass-1
# margin is a pure function of (ref, alt kind, depth, alt count), so it
# is precomputed HOST-SIDE IN FLOAT64 with the identical algebra — no
# f32 error band needed, just P0_EPS for the lgamma-vs-NR-gammln
# difference (<1e-9).  The device then resolves those samples with one
# byte gather, and only sites with a non-simple sample reach the f32
# lgamma screen (phase 1).

TMAX = 512      # phase-0 depth ceiling (deeper sites -> phase 1)
CMAX = 3        # phase-0 alt-read ceiling
P0_EPS = 1e-6


@functools.lru_cache(maxsize=4)
def _phase0_tables(haploid: bool):
    """uint8 pass tables, flat-indexed ((ref*5 + alt)*(TMAX+1) + tot)
    *(CMAX+1) + c: bit 0 = beam margin > 2.3 + eps (single-config
    survival), bit 1 = ungated-argmax margin > eps (the indiv >= 4 EM
    condition)."""
    from scipy.special import gammaln
    max_gen = NO_ALLELES if haploid else MAX_GEN
    ta, tota, _ = _tables(haploid)          # (91, 4, G, 6) int32
    t_ax = np.arange(TMAX + 1)
    sc_idx = np.clip(np.minimum(t_ax, 100), 10, 100) - 10     # (T,)
    g_ax = np.arange(max_gen)

    out = np.zeros((4, 5, TMAX + 1, CMAX + 1), np.uint8)
    for ref in range(4):
        ta_r = ta[sc_idx, ref].astype(np.float64)     # (T, G, 6)
        tota_r = tota[sc_idx, ref].astype(np.float64)  # (T, G)
        # a1 in f64 (read-independent factln terms); like uses the C
        # convention factln(x-1) = lgamma(x) throughout
        a1 = (gammaln(tota_r) - gammaln(ta_r).sum(-1))
        base = gammaln(ta_r).sum(-1)                   # all-zero reads
        for alt in range(5):
            for c in range(CMAX + 1):
                rr = np.maximum(t_ax - c, 0)           # ref reads
                like = (a1 + base
                        - gammaln(ta_r[:, :, ref])
                        + gammaln(ta_r[:, :, ref] + rr[:, None])
                        - gammaln(tota_r + t_ax[:, None]))
                if alt != ref and c > 0:
                    like = (like - gammaln(ta_r[:, :, alt])
                            + gammaln(ta_r[:, :, alt] + c))
                is_ref = g_ax == ref
                # beam gating: Del genotypes need >= 3 Del reads, Ins
                # genotypes >= 3 Ins reads (pecaller.c:2621-2625);
                # phase-0 patterns have Ins = 0 and Del = c iff alt == 4
                blocked = np.zeros(max_gen, bool)
                dead_del = not (alt == 4 and c >= 3)
                blocked[4] = dead_del
                blocked[5] = True
                if max_gen > 12:        # diploid het indel genotypes
                    blocked[12] = dead_del
                    blocked[13] = True
                like_ref = np.where(is_ref, like, -np.inf).max(-1)
                like_beam = np.where(is_ref | blocked, -np.inf,
                                     like).max(-1)
                like_any = np.where(is_ref, -np.inf, like).max(-1)
                pb = (like_ref - like_beam) > (2.3 + P0_EPS)
                pa = (like_ref - like_any) > P0_EPS
                valid = t_ax >= c
                out[ref, alt, :, c] = np.where(
                    valid, pb.astype(np.uint8) | (pa.astype(np.uint8)
                                                  << 1), 0)
    return out.reshape(-1)


def _phase0_chunk(reads, ref_int, ctype, *, haploid: bool, indiv: int,
                  ptab):
    """Cheap integer screen: resolves BAD sites, ref>=4 sites (HARD),
    and EASY sites whose every active sample has a simple pattern.
    Returns codes with UNRES for sites phase 1 must decide."""
    import jax.numpy as jnp

    ptab = jnp.asarray(ptab)
    min_depth = 1 if haploid else 2
    r = reads.astype(jnp.int32)                     # (S, I, 6)
    tot = r[..., :5].sum(-1)                        # (S, I)
    active = tot > min_depth

    sum_tot = tot.sum(-1, dtype=jnp.int32)
    cnt8 = (tot >= 8).sum(-1)
    CHRY = 2
    bad = (sum_tot < 8 * indiv) | ((2 * cnt8 < indiv) & (ctype != CHRY))

    ref_raw = ref_int.astype(jnp.int32)[:, None]    # (S, 1)
    ref_b = jnp.minimum(ref_raw, 3)
    rref = jnp.take_along_axis(
        r, jnp.broadcast_to(ref_b[:, :, None],
                            (r.shape[0], r.shape[1], 1)), axis=2)[..., 0]
    nonref = tot - rref
    masked = jnp.where(jnp.arange(5)[None, None, :] == ref_b[..., None],
                       -1, r[..., :5])
    c = masked.max(-1)
    altk = masked.argmax(-1).astype(jnp.int32)
    simple = (nonref == jnp.maximum(c, 0)) & (r[..., 5] == 0) \
        & (tot <= TMAX) & (c <= CMAX)
    c0 = jnp.clip(c, 0, CMAX)
    flat = (((ref_b * 5 + altk) * (TMAX + 1)
             + jnp.minimum(tot, TMAX)) * (CMAX + 1) + c0)
    bits = ptab[flat]
    pass_beam = (bits & 1) == 1
    if indiv >= 4:
        pass_beam = pass_beam & (((bits >> 1) & 1) == 1)
    samp_easy = (~active) | (simple & pass_beam)
    easy = samp_easy.all(-1)

    codes = jnp.where(bad, jnp.uint8(BAD),
                      jnp.where(easy, jnp.uint8(EASY),
                                jnp.uint8(UNRES)))
    codes = jnp.where(ref_raw[:, 0] >= 4, jnp.uint8(HARD), codes)
    return codes


def pass1_margins(reads, ref_int, *, haploid: bool, ta, tota, a1):
    """Pass-1 likelihood margins in f32 (pure jax), (S, I) each:
    ``margin`` = ref genotype over the best beam-eligible alternate,
    ``margin_any`` = ref over the best alternate ungated (the indiv >= 4
    EM-continuation test).  reads (S, I, 6), ref_int (S,)."""
    import jax.numpy as jnp
    from jax import lax

    max_gen = NO_ALLELES if haploid else MAX_GEN
    r = reads.astype(jnp.int32)                     # (S, I, 6)
    tot = r[..., :5].sum(-1)                        # (S, I) excl. Ins
    sc_idx = jnp.clip(jnp.minimum(tot, 100), 10, 100) - 10       # (S, I)
    n_sc, _, G, _ = ta.shape
    # tables only cover ref in {A,C,G,T}; ambiguity-code references
    # (ref_int >= 4, e.g. IUPAC 'D'/'H' genome chars that land < 6 in
    # GEN_TO_INT) are forced HARD by the caller of this function
    ref_b = jnp.minimum(ref_int.astype(jnp.int32)[:, None], 3)   # (S, 1)
    # flat (scale*4+ref) row index + single-axis takes
    flat = sc_idx * 4 + ref_b                       # (S, I)
    ta_d = jnp.asarray(ta.reshape(n_sc * 4, G, 6))
    tota_d = jnp.asarray(tota.reshape(n_sc * 4, G))
    a1_d = jnp.asarray(a1.reshape(n_sc * 4, G))
    ta_si = jnp.take(ta_d, flat, axis=0)            # (S, I, G, 6)
    tota_si = jnp.take(tota_d, flat, axis=0)        # (S, I, G)
    a1_si = jnp.take(a1_d, flat, axis=0)            # (S, I, G)

    # factln(n) = lgamma(n+1): C sums factln(ta+r-1) = lgamma(ta+r)
    # and subtracts factln(tot_tot-1) = lgamma(tota+tot+r5)
    # (pecaller.c:2448-2507)
    args = (ta_si + r[:, :, None, :]).astype(jnp.float32)
    tail = (tota_si + (tot + r[..., 5])[..., None]).astype(jnp.float32)
    like = a1_si + lax.lgamma(args).sum(-1) - lax.lgamma(tail)  # (S,I,G)

    g = jnp.arange(max_gen)
    is_ref = g[None, None, :] == ref_b[..., None]
    like_ref = jnp.where(is_ref, like, -jnp.inf).max(-1)
    # fill_config_probs never expands indel genotypes without >=3
    # supporting reads (pecaller.c:2621-2625: templ -= 1e10 for j in
    # {4,12} when reads[Del]<3, {5,13} when reads[Ins]<3), so they are
    # excluded from the beam-survival margin.
    is_del_g = (g == 4) | (g == 12)
    is_ins_g = (g == 5) | (g == 13)
    blocked = ((is_del_g[None, None, :] & (r[..., 4:5] < 3)) |
               (is_ins_g[None, None, :] & (r[..., 5:6] < 3)))
    like_alt = jnp.where(is_ref | blocked, -jnp.inf, like).max(-1)
    like_any = jnp.where(is_ref, -jnp.inf, like).max(-1)
    return like_ref - like_alt, like_ref - like_any


def pass1_margins_np(reads, ref_int, *, haploid: bool):
    """float64 NumPy evaluation of pass1_margins' algebra (the plain
    reference its f32 error is measured against)."""
    from scipy.special import gammaln

    max_gen = NO_ALLELES if haploid else MAX_GEN
    ta, tota, _ = _tables(haploid)
    fact = _factln_table(int(tota.max()) + 1)
    a1 = fact[tota - 1] - fact[ta - 1].sum(axis=3)        # float64
    r = np.asarray(reads).astype(np.int64)
    tot = r[..., :5].sum(-1)
    sc_idx = np.clip(np.minimum(tot, 100), 10, 100) - 10
    ref_b = np.minimum(np.asarray(ref_int).astype(np.int64), 3)[:, None]
    ta_si = ta[sc_idx, ref_b]                             # (S, I, G, 6)
    like = (a1[sc_idx, ref_b]
            + gammaln(ta_si + r[:, :, None, :]).sum(-1)
            - gammaln(tota[sc_idx, ref_b] + (tot + r[..., 5])[..., None]))
    g = np.arange(max_gen)
    is_ref = g[None, None, :] == ref_b[..., None]
    like_ref = np.where(is_ref, like, -np.inf).max(-1)
    blocked = ((((g == 4) | (g == 12))[None, None, :] & (r[..., 4:5] < 3))
               | (((g == 5) | (g == 13))[None, None, :]
                  & (r[..., 5:6] < 3)))
    like_alt = np.where(is_ref | blocked, -np.inf, like).max(-1)
    like_any = np.where(is_ref, -np.inf, like).max(-1)
    return like_ref - like_alt, like_ref - like_any


def _screen_chunk(reads, ref_int, ctype, *, haploid: bool,
                  ta, tota, a1):
    """codes (S,) uint8 for one (S, I, 6) uint16 chunk.  Pure jax."""
    import jax.numpy as jnp

    min_depth = 1 if haploid else 2
    indiv = reads.shape[1]

    r = reads.astype(jnp.int32)                     # (S, I, 6)
    tot = r[..., :5].sum(-1)                        # (S, I) excl. Ins
    active = tot > min_depth
    ref_raw = ref_int.astype(jnp.int32)[:, None]    # (S, 1)

    # ---- bad-base gates (pecaller.c:1261-1304), exact integer logic ----
    sum_tot = tot.sum(-1, dtype=jnp.int32)          # (S,) < 2**31 safe
    cnt8 = (tot >= 8).sum(-1)                       # (S,)
    CHRY = 2
    bad = (sum_tot < 8 * indiv) | ((2 * cnt8 < indiv) & (ctype != CHRY))

    # ---- pass-1 likelihood margins (f32) ----
    margin, margin_any = pass1_margins(reads, ref_int, haploid=haploid,
                                       ta=ta, tota=tota, a1=a1)
    samp_easy = margin > jnp.float32(2.3 + BAND)
    if indiv >= 4:
        # with >=4 samples the EM loop continues whenever any sample's
        # pass-1 argmax (over ALL genotypes, ungated:
        # pecaller.c:2484-2486) differs from the final call, so EASY
        # additionally requires the ungated argmax to be the ref
        # genotype by more than the f32 error band.
        samp_easy &= margin_any > jnp.float32(BAND)

    samp_easy = (~active) | samp_easy
    depth_ok = ((tot + r[..., 5]) <= DEPTH_GATE).all(-1)
    easy = samp_easy.all(-1) & depth_ok

    codes = jnp.where(bad, jnp.uint8(BAD),
                      jnp.where(easy, jnp.uint8(EASY), jnp.uint8(HARD)))
    # non-ACGT reference: the screened likelihoods used a clamped ref
    # row and the EASY/BAD shortcuts assume call==ref semantics — route
    # unconditionally to the exact native engine
    codes = jnp.where(ref_raw[:, 0] >= 4, jnp.uint8(HARD), codes)
    return codes


@functools.lru_cache(maxsize=8)
def _screen_programs(indiv: int, haploid: bool, mesh):
    """The jitted phase-1 and phase-0 programs, one pair per process and
    configuration, so repeated run_caller calls do not retrace them."""
    import jax
    ta, tota, a1 = _tables(haploid)
    f1 = functools.partial(
        _screen_chunk, haploid=haploid, ta=ta, tota=tota, a1=a1)
    f0 = functools.partial(
        _phase0_chunk, haploid=haploid, indiv=indiv,
        ptab=_phase0_tables(haploid))
    if mesh is None:
        return jax.jit(f1), jax.jit(f0)
    # sites shard over every mesh device (the screen is embarrassingly
    # parallel per site); chunk buckets are powers of two >= 2^10 so
    # they divide any 2^k-device mesh
    from ..parallel.mesh import shard_map
    from jax.sharding import PartitionSpec as P
    axes = tuple(mesh.axis_names)

    def wrap(f):
        return jax.jit(shard_map(
            f, mesh=mesh, in_specs=(P(axes, None, None), P(axes), P(axes)),
            out_specs=P(axes), check_vma=False))
    return wrap(f1), wrap(f0)


class CallerScreen:
    """Chunked, jitted site screen.  Call with host numpy arrays.

    Chunks are large (up to 2**18 sites, scaled down with cohort size to
    bound the (S, I, 14, 6) f32 working set) so the per-dispatch
    latency amortizes; short inputs pad up to power-of-two buckets
    so only a handful of shapes ever compile.
    """

    MIN_CHUNK = 1 << 10

    def __init__(self, indiv: int, haploid: bool, chunk: int | None = None,
                 mesh=None):
        from ..utils import enable_compilation_cache
        enable_compilation_cache()
        self.indiv = indiv
        self.haploid = haploid
        # sites each device program classified (phase 0 / phase 1)
        self.sites_phase0 = 0
        self.sites_phase1 = 0
        if chunk is None or chunk <= 8192:
            # ~ (1<<21) site*samples per dispatch, pow2, within [2^13,2^18]
            c = (1 << 21) // max(indiv, 1)
            c = 1 << (c.bit_length() - 1)
            chunk = max(1 << 13, min(1 << 18, c))
        self.chunk = chunk
        self._fn, self._fn0 = _screen_programs(indiv, haploid, mesh)

    def _bucket(self, m: int) -> int:
        b = self.MIN_CHUNK
        while b < m:
            b <<= 1
        return min(b, self.chunk)

    def _dispatch(self, fn, reads, ref_int, ctype, lo, hi):
        m = hi - lo
        ck = self._bucket(m)
        if m < ck:                        # pad the tail into its bucket
            rd = np.zeros((ck, self.indiv, 6), dtype=np.uint16)
            rd[:m] = reads[lo:hi]
            ri = np.zeros(ck, dtype=np.uint8)
            ri[:m] = ref_int[lo:hi]
            ct = np.zeros(ck, dtype=np.uint8)
            ct[:m] = ctype[lo:hi]
            return fn(rd, ri, ct)
        return fn(np.ascontiguousarray(reads[lo:hi]),
                  np.ascontiguousarray(ref_int[lo:hi]),
                  np.ascontiguousarray(ctype[lo:hi]))

    # pipeline depth bound: at most MAX_PEND chunks in flight so
    # device-resident input buffers stay O(1) in the window size while
    # dispatch/fetch still overlap
    MAX_PEND = 3

    def __call__(self, reads: np.ndarray, ref_int: np.ndarray,
                 ctype: np.ndarray) -> np.ndarray:
        """reads (S,I,6) u16, ref_int (S,) 0..3, ctype (S,) -> codes.

        Two passes: the integer/table phase-0 program resolves simple
        sites (one byte gather per sample, exact-f64 tables); only
        UNRES sites reach the f32 lgamma screen (phase 1).  Chunks are
        dispatched async (jax dispatch does not block) and fetched
        afterwards, so device compute overlaps host slicing/fetches."""
        n = len(ref_int)
        self.sites_phase0 += n
        out = np.empty(n, dtype=np.uint8)
        pend = []
        lo = 0
        while lo < n:
            if len(pend) >= self.MAX_PEND:
                plo, phi, pcodes = pend.pop(0)
                out[plo:phi] = np.asarray(pcodes)[:phi - plo]
            hi = min(lo + self.chunk, n)
            pend.append((lo, hi, self._dispatch(self._fn0, reads,
                                                ref_int, ctype, lo, hi)))
            lo = hi
        for lo, hi, codes in pend:
            out[lo:hi] = np.asarray(codes)[:hi - lo]

        un = np.flatnonzero(out == UNRES)
        if len(un):
            out[un] = self.phase1(reads[un], ref_int[un], ctype[un])
        return out

    def phase1(self, reads: np.ndarray, ref_int: np.ndarray,
               ctype: np.ndarray) -> np.ndarray:
        """The f32 lgamma screen alone, for sites phase 0 (device or
        the host native phase-0 in native/screen.c) left UNRES.
        Returns EASY/BAD/HARD codes."""
        n = len(ref_int)
        self.sites_phase1 += n
        out = np.empty(n, dtype=np.uint8)
        rd1 = np.ascontiguousarray(reads)
        ri1 = np.ascontiguousarray(ref_int)
        ct1 = np.ascontiguousarray(ctype)
        pend = []
        lo = 0
        while lo < n:
            if len(pend) >= self.MAX_PEND:
                plo, phi, pcodes = pend.pop(0)
                out[plo:phi] = np.asarray(pcodes)[:phi - plo]
            hi = min(lo + self.chunk, n)
            pend.append((lo, hi, self._dispatch(
                self._fn, rd1, ri1, ct1, lo, hi)))
            lo = hi
        for lo, hi, codes in pend:
            out[lo:hi] = np.asarray(codes)[:hi - lo]
        return out
