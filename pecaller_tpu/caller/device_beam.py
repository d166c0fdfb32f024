"""Device joint-configuration beam — the caller's hard kernel
(pecaller.c fill_config_probs/clean_config_probs, :2511-2788 and
:2248-2344) redesigned as a vectorized-over-sites device program.

Division of labor (byte parity preserved by construction):

  * The DEVICE BEAM (f32, this module's ``_beam_chunk``) runs the exact
    pass-1 search semantics vectorized over sites: per-sample
    likelihoods, confidence ordering, config expansion x genotypes with
    the indel-support gates, dedup of configs identical outside the
    current sample, the 2.3 log-unit prune, and the forced-homozygote
    reinjection.  Its product is the per-site SURVIVING CONFIG SET (a
    (C_CAP, indiv) genotype matrix in sorted order) — pure structure,
    no floats that reach an artifact.
  * The F64 FINISHER (``finish_f64``) recomputes likes/priors/posts for
    that set host-side with the identical float64 operation sequence as
    the C engine (NR gammln tables, sequential summation order,
    config-order softmax), then types the site — so printed posteriors
    are bit-identical to the native engine whenever the config set is
    right.
  * FLAGS route every case where f32 cannot prove the set to the exact
    native engine: decisions within an error band of the 2.3/0.01
    survival thresholds, near-ties in sample ordering or the top
    config, beam-width overflow, the exp(-40) softmax cutoff, and (for
    indiv >= 4) any site where the EM loop would run a second pass
    (calls_changed, pecaller.c:1505-1509).  Pedigree mode and
    mixed-haploid sites always use the native engine.

The beam search collapses to set semantics because every sequential
running-best gate in fill_config_probs is implied by the final prune:
a candidate with post >= final_best - 2.3 always passed the running
``templ + thres > best_post`` and post-keep gates (prior <= 0,
running best <= final best), so the surviving set equals
{candidates: post >= final_best - 2.3} capped to MAX_CONFIGS in
(post desc, allocation order) — which is exactly what the vectorized
prune computes.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from .device_screen import _tables
from .device_model import fill_alpha_prior_np

NO_ALLELES = 6
MAX_GEN = 14
THRES = 2.3
BAND = 0.05          # f32 slack around every beam threshold
ORDER_BAND = 1e-3    # f32 slack for sample-confidence ordering ties

# flag bits
F_BOUNDARY = 1       # a survival decision within BAND of a threshold
F_OVERFLOW = 2       # beam width exceeded C_CAP
F_ORDER = 4          # sample-order near-tie
F_EM = 8             # indiv >= 4 and the EM would run another pass
F_EXP = 16           # a post within BAND of the exp(-40) cutoff
F_REF = 32           # non-ACGT reference
F_TIE = 64           # near-tied genotype likes within one sample
F_DEEP = 128         # depth past the f32 lgamma error gate


def _get_het(i, ref):
    ha = [0, 0, 0, 1, 1, 2]
    hb = [1, 2, 3, 2, 3, 3]
    if i < NO_ALLELES:
        return i, i
    if i < 12:
        return ha[i - 6], hb[i - 6]
    if i == 12:
        return ref, 4
    return ref, 5


def allele_counts_tab(haploid: bool) -> np.ndarray:
    """(4, MAX_GEN+1, 6) int32: per-(ref, genotype) allele contributions
    (native/pecall.c model init; row MAX_GEN = NCALL = zero)."""
    t = np.zeros((4, MAX_GEN + 1, NO_ALLELES), np.int32)
    for r in range(4):
        for g in range(MAX_GEN):
            a, b = _get_het(g, r)
            t[r, g, a] += 1
            if not haploid:
                t[r, g, b] += 1
    return t


_DIP_ORDER = np.array([
    [0, 7, 6, 8, 12, 13, 1, 2, 3, 4, 5, 9, 10, 11],
    [1, 10, 6, 9, 12, 13, 0, 2, 3, 4, 5, 7, 8, 11],
    [2, 7, 9, 11, 12, 13, 0, 1, 3, 4, 5, 6, 8, 10],
    [3, 10, 8, 11, 12, 13, 1, 0, 2, 4, 5, 6, 7, 9]], np.int32)
_HAP_ORDER = np.array([
    [0, 2, 1, 3, 4, 5], [1, 3, 0, 2, 4, 5],
    [2, 0, 1, 3, 4, 5], [3, 1, 0, 2, 4, 5]], np.int32)


@functools.lru_cache(maxsize=8)
def fill_hardy_weinberg_np(n: int):
    """Exact replication of fill_hardy_weinberg (pecaller.c:2791-2866 /
    native/pecall.c:103-141) in python-float (= C double) arithmetic.
    Returns (2n+1, n+1) float64 log-probabilities."""
    asize = 2 * n
    marg = [[0.0] * (n + 1) for _ in range(asize + 1)]
    for i in range(1, asize + 1):
        Na = 2 * n - i
        Nb = i
        p = float(i) / float(Na + Nb)
        expect = int(math.ceil(i * (1.0 - p)))
        if i % 2 == 0:
            start = expect - 1 if expect % 2 == 1 else expect
        else:
            start = expect if expect % 2 == 1 else expect - 1
        marg[i][start] = 1.0
        s = 1.0
        nbb = (Nb - start) // 2
        naa = (Na - start) // 2
        nab = start + 2
        while naa > 0 and nbb > 0:
            marg[i][nab] = (marg[i][nab - 2] * 4.0 *
                            (float(naa) * float(nbb)) /
                            (float(nab) * (nab - 1.0)))
            s += marg[i][nab]
            nab += 2
            naa -= 1
            nbb -= 1
        nbb = (Nb - start) // 2
        naa = (Na - start) // 2
        nab = start - 2
        while nab >= 0:
            marg[i][nab] = (marg[i][nab + 2] *
                            ((nab + 2.0) * (nab + 1.0)) /
                            (4.0 * ((naa + 1.0) * (nbb + 1.0))))
            s += marg[i][nab]
            nab -= 2
            naa += 1
            nbb += 1
        for j in range(n + 1):
            marg[i][j] /= s
    out = np.full((asize + 1, n + 1), -5000.0)
    for i in range(asize + 1):
        for j in range(n + 1):
            if marg[i][j] > 1e-50:
                out[i][j] = math.log(marg[i][j])
    return out


@functools.lru_cache(maxsize=8)
def hw_flat(indiv: int):
    """Flattened ln_HW for n = 1..indiv + per-n offsets.
    Index: off[n] + minor * (n + 1) + hets."""
    parts, off = [], np.zeros(indiv + 2, np.int64)
    for n in range(1, indiv + 1):
        t = fill_hardy_weinberg_np(n)
        off[n + 1] = off[n] + t.size
        parts.append(t.reshape(-1))
    if not parts:
        return np.zeros(1), off
    return np.concatenate(parts), off


# --- exact NR gammln / factln (native/pecall.c:62-90) --------------------

_COF = (76.18009173, -86.50532033, 24.01409822, -1.231739516,
        0.120858003e-2, -0.536382e-5)


def _gammln_scalar(xx: float) -> float:
    x = xx - 1.0
    tmp = x + 5.5
    tmp -= (x + 0.5) * math.log(tmp)
    ser = 1.0
    for c in _COF:
        x += 1.0
        ser += c / x
    return -tmp + math.log(2.50662827465 * ser)


@functools.lru_cache(maxsize=1)
def factln_tbl():
    t = np.zeros(10001)
    x = 1.0
    for n in range(2, 41):
        x *= float(n)
        t[n] = math.log(x)
    for n in range(41, 10001):
        t[n] = _gammln_scalar(n + 1.0)
    return t


_gammln_u = np.frompyfunc(_gammln_scalar, 1, 1)


def factln_np(n: np.ndarray) -> np.ndarray:
    """Vectorized m_factln: table below 10001, NR gammln above."""
    t = factln_tbl()
    n = np.asarray(n)
    out = t[np.minimum(n, 10000)]
    big = n > 10000
    if big.any():
        out = out.copy()
        out[big] = _gammln_u(n[big] + 1.0).astype(np.float64)
    return out


# --- the device beam -----------------------------------------------------

def _beam_chunk(reads, ref_int, *, haploid, indiv, c_cap, ta, tota, a1,
                ac_tab, gorder, hw_t, hw_off, ln_theta, threshold):
    """One jitted chunk: (S, I, 6) u16 + (S,) ref -> (n_cfg, cfgs,
    flags, call32, p32).  See module doc."""
    import jax.numpy as jnp
    from jax import lax

    G = NO_ALLELES if haploid else MAX_GEN
    NCALL = G
    min_depth = 1 if haploid else 2
    S = reads.shape[0]
    I = indiv
    C = c_cap

    r = reads.astype(jnp.int32)
    tot = r[..., :5].sum(-1)                        # (S, I)
    active = tot > min_depth
    ref_raw = ref_int.astype(jnp.int32)
    ref_b = jnp.minimum(ref_raw, 3)

    # pass-1 likelihoods sans multinomial coef (cancels in every
    # comparison; the f64 finisher restores it)
    sc_idx = jnp.clip(jnp.minimum(tot, 100), 10, 100) - 10
    n_sc = ta.shape[0]
    flat = sc_idx * 4 + ref_b[:, None]              # (S, I)
    ta_d = jnp.asarray(ta.reshape(n_sc * 4, G, 6))
    tota_d = jnp.asarray(tota.reshape(n_sc * 4, G))
    a1_d = jnp.asarray(a1.reshape(n_sc * 4, G))
    args = (jnp.take(ta_d, flat, axis=0)
            + r[:, :, None, :]).astype(jnp.float32)
    tail = (jnp.take(tota_d, flat, axis=0)
            + (tot + r[..., 5])[..., None]).astype(jnp.float32)
    like = (jnp.take(a1_d, flat, axis=0)
            + lax.lgamma(args).sum(-1) - lax.lgamma(tail))  # (S, I, G)

    # confidence order (fill_sample_like tail): initial_p = margin of
    # the argmax over its closest competitor; stable sort desc
    best_g = jnp.argmax(like, axis=-1)
    like_best = jnp.take_along_axis(like, best_g[..., None], -1)[..., 0]
    margin = jnp.where(
        jnp.arange(G)[None, None, :] == best_g[..., None], jnp.inf,
        like_best[..., None] - like).min(-1)
    initial_p = jnp.where(active, margin, jnp.float32(0.0))
    order = jnp.argsort(-initial_p, axis=-1, stable=True)   # (S, I)
    # order near-ties between samples with distinct read vectors (equal
    # vectors give bit-identical f64 margins, so stable order matches)
    same_reads = (r[:, :, None, :] == r[:, None, :, :]).all(-1)
    diff_p = jnp.abs(initial_p[:, :, None] - initial_p[:, None, :])
    pair_bad = (diff_p < ORDER_BAND) & ~same_reads \
        & ~jnp.eye(I, dtype=bool)[None]
    gap_flag = pair_bad.any((1, 2))

    flags = jnp.where(gap_flag, jnp.int32(F_ORDER), 0)
    flags = flags | jnp.where(ref_raw >= 4, jnp.int32(F_REF), 0)
    # the screen routes tot+Ins > DEPTH_GATE sites HARD because f32
    # lgamma error there exceeds the fixed BAND — those sites are just
    # as unsafe for the f32 beam, so route them to the native engine
    # (ADVICE r4)
    from .device_screen import DEPTH_GATE
    flags = flags | jnp.where(
        ((tot + r[..., 5]) > DEPTH_GATE).any(-1), jnp.int32(F_DEEP), 0)

    ac_d = jnp.asarray(ac_tab)                      # (4, G+1, 6)
    gorder_d = jnp.asarray(gorder)                  # (4, G)
    hw_d = jnp.asarray(hw_t.astype(np.float32))
    hw_off_d = jnp.asarray(hw_off)
    like_pad = jnp.concatenate(
        [like, jnp.zeros((S, I, 1), like.dtype)], axis=-1)  # NCALL=0

    # beam state: configs (S, C, I) int8 (sorted), n_cfg, plus each
    # config's fresh-sum origin — the C engine builds config likes
    # INCREMENTALLY (old.like - like[j_old] + like[j]) from either the
    # initial all-dom config or a reinjected homozygote, and float64
    # addition is not associative, so the exact finisher must replay
    # the same sequence: hrank = rank at which the config's ancestor
    # was fresh-summed (-1 = initial), hval = that ancestor's genotype
    calls = jnp.broadcast_to(
        jnp.where(active, ref_b[:, None], NCALL)[:, None, :],
        (S, C, I)).astype(jnp.int8)
    n_cfg = jnp.ones(S, jnp.int32)
    # int16: cohorts past 127 samples would wrap an int8 rank (ADVICE r4)
    hrank = jnp.full((S, C), -1, jnp.int16)
    hval = jnp.broadcast_to(ref_b[:, None], (S, C)).astype(jnp.int8)

    lp_flat = like_pad.reshape(S * I * (G + 1))
    lp_base = (jnp.arange(S)[:, None, None] * I
               + jnp.arange(I)[None, None, :]) * (G + 1)

    def cfg_like_of(calls_m):
        """Sum of active samples' like at each config's calls:
        fill_config_like (native/pecall.c:363-371)."""
        lk = lp_flat[lp_base + calls_m.astype(jnp.int32)]   # (S, C, I)
        return jnp.where(active[:, None, :], lk, 0.0).sum(-1)

    def prior_of(ac, hets):
        """theta + exact-HW prior from integer allele counts."""
        na = (ac > 0).sum(-1)
        pr = jnp.where(na > 1, (na - 1).astype(jnp.float32) *
                       jnp.float32(ln_theta), 0.0)
        if not haploid:
            major_k = jnp.argmax(ac, axis=-1)
            major = jnp.take_along_axis(ac, major_k[..., None],
                                        -1)[..., 0]
            tot_ac = ac.sum(-1)
            minor = tot_ac - major
            swap = minor > major
            mj = jnp.where(swap, minor, major)
            mn = jnp.where(swap, major, minor)
            h = jnp.minimum(mn, hets)
            tot_n = (mn + mj) // 2
            odd = (mn - h) % 2 == 1
            mn = jnp.where(odd, mn + 1, mn)
            idx = (hw_off_d[jnp.clip(tot_n, 0, len(hw_off) - 2)]
                   + mn * (tot_n + 1) + h)
            hwv = hw_d[jnp.clip(idx, 0, hw_d.shape[0] - 1)]
            pr = pr + jnp.where(na > 1, hwv, 0.0)
        return pr

    boundary = jnp.zeros(S, bool)
    overflow = jnp.zeros(S, bool)

    for rank in range(I):
        s_idx = order[:, rank]                      # (S,)
        act_s = jnp.take_along_axis(active, s_idx[:, None], 1)[:, 0]
        like_s = jnp.take_along_axis(
            like_pad, s_idx[:, None, None], 1)[:, 0, :]      # (S, G+1)
        reads_s = jnp.take_along_axis(r, s_idx[:, None, None],
                                      1)[:, 0, :]            # (S, 6)
        valid_c = jnp.arange(C)[None, :] < n_cfg[:, None]

        # dedup: config i skipped if an earlier ii matches outside s
        dim_is_s = jnp.arange(I)[None, None, None, :] == \
            s_idx[:, None, None, None]
        eq = (calls[:, :, None, :] == calls[:, None, :, :]) | dim_is_s
        eq_all = eq.all(-1) & valid_c[:, :, None] & valid_c[:, None, :]
        tri = jnp.arange(C)[None, :, None] > jnp.arange(C)[None, None, :]
        dup = (eq_all & tri).any(-1)                # (S, C)
        kept = valid_c & ~dup

        # candidate posts over genotype_order
        old_call = jnp.take_along_axis(
            calls.astype(jnp.int32), s_idx[:, None, None], 2)[:, :, 0]
        cfg_like_full = cfg_like_of(calls)          # (S, C) all active
        base_like = cfg_like_full - jnp.take_along_axis(
            like_s, old_call, 1) * act_s[:, None].astype(jnp.float32)
        jv = gorder_d[ref_b]                        # (S, G) genotype vals
        like_j = jnp.take_along_axis(like_s, jv, 1)  # (S, G)
        templ = base_like[:, :, None] + like_j[:, None, :]   # (S, C, G)
        is_del_g = (jv == 4) | (jv == 12)
        is_ins_g = (jv == 5) | (jv == 13)
        gate = (jnp.where(is_del_g & (reads_s[:, 4:5] < 3), -1e10, 0.0)
                + jnp.where(is_ins_g & (reads_s[:, 5:6] < 3), -1e10,
                            0.0))                    # (S, G)
        templ = templ + gate[:, None, :]

        # candidate integer metadata
        not_s = jnp.arange(I)[None, :] != s_idx[:, None]     # (S, I)
        act_not_s = active & not_s
        ac_rows = ac_d[ref_b[:, None, None],
                       calls.astype(jnp.int32)]      # (S, C, I, 6)
        base_ac = jnp.where(act_not_s[:, None, :, None], ac_rows,
                            0).sum(2)                # (S, C, 6)
        base_hets = (act_not_s[:, None, :] & (calls >= NO_ALLELES)
                     & (calls < NCALL)).sum(-1)      # (S, C)
        ac_j = ac_d[ref_b[:, None], jv]              # (S, G, 6)
        cand_ac = base_ac[:, :, None, :] + ac_j[:, None, :, :]
        cand_hets = base_hets[:, :, None] + (jv >= NO_ALLELES)[:, None, :]
        cand_prior = prior_of(cand_ac, cand_hets)   # (S, C, G)
        post = templ + cand_prior
        cand_ok = kept[:, :, None] & jnp.broadcast_to(
            act_s[:, None, None], post.shape)

        best = jnp.max(jnp.where(cand_ok, post, -jnp.inf), (1, 2))
        surv = cand_ok & (post >= best[:, None, None] - THRES)
        boundary = boundary | (cand_ok & (
            jnp.abs(post - (best[:, None, None] - THRES)) < BAND)
        ).any((1, 2))

        # sort survivors by (post desc, enum asc), take C
        post_f = jnp.where(surv, post, -jnp.inf).reshape(S, C * G)
        sort_ix = jnp.argsort(-post_f, axis=1, stable=True)[:, :C]
        n_new = surv.sum((1, 2))
        overflow = overflow | (n_new > C)
        ci = sort_ix // G
        ji = sort_ix % G
        new_calls = jnp.take_along_axis(calls, ci[:, :, None], 1)
        new_hrank = jnp.take_along_axis(hrank, ci, 1)
        new_hval = jnp.take_along_axis(hval, ci, 1)
        jval = jnp.take_along_axis(jv, ji, 1).astype(jnp.int8)
        sel_slot = (jnp.arange(I)[None, None, :] ==
                    s_idx[:, None, None])
        new_calls = jnp.where(sel_slot, jval[:, :, None], new_calls)
        new_n = jnp.minimum(n_new, C)

        # inactive sample: no expansion, calls[s] = NCALL everywhere
        calls_na = jnp.where(sel_slot, jnp.int8(NCALL), calls)
        calls = jnp.where(act_s[:, None, None], new_calls, calls_na)
        hrank = jnp.where(act_s[:, None], new_hrank, hrank)
        hval = jnp.where(act_s[:, None], new_hval, hval)
        n_cfg = jnp.where(act_s, new_n, n_cfg)

        # hom reinjection (clean_config_probs tail)
        valid_c = jnp.arange(C)[None, :] < n_cfg[:, None]
        ac_all = jnp.where(
            (active[:, None, :] & (calls < NCALL))[..., None],
            ac_d[ref_b[:, None, None], calls.astype(jnp.int32)],
            0).sum(2)                               # (S, C, 6)
        na_all = (ac_all > 0).sum(-1)
        has_hom = ((na_all == 1) & valid_c).any(1)
        top_ac = ac_all[:, 0, :]
        best_hom = jnp.argmax(top_ac, -1)
        best_hom = jnp.where(best_hom > 3, ref_b, best_hom) \
            .astype(jnp.int8)
        hom_calls = jnp.where(active, best_hom[:, None],
                              jnp.int8(NCALL))      # (S, I)
        hom_like = jnp.where(
            active, jnp.take_along_axis(
                like_pad, hom_calls[:, :, None].astype(jnp.int32),
                2)[..., 0], 0.0).sum(-1)
        hom_post = hom_like                          # prior forced 0
        inject = act_s & ~has_hom
        slot = jnp.minimum(n_cfg, C - 1)
        overflow = overflow | (inject & (n_cfg >= C))
        inj_slot = (inject[:, None] &
                    (jnp.arange(C)[None, :] == slot[:, None]))
        calls = jnp.where(inj_slot[:, :, None], hom_calls[:, None, :],
                          calls)
        hrank = jnp.where(inj_slot, jnp.int16(rank), hrank)
        hval = jnp.where(inj_slot, best_hom[:, None], hval)
        n_cfg = jnp.where(inject, jnp.minimum(n_cfg + 1, C), n_cfg)
        # stable resort including the injected config (enum = last)
        valid_c = jnp.arange(C)[None, :] < n_cfg[:, None]
        hets_all = (active[:, None, :] & (calls >= NO_ALLELES)
                    & (calls < NCALL)).sum(-1)
        ac_all = jnp.where(
            (active[:, None, :] & (calls < NCALL))[..., None],
            ac_d[ref_b[:, None, None], calls.astype(jnp.int32)],
            0).sum(2)
        pr_all = prior_of(ac_all, hets_all)
        pr_all = jnp.where(
            inject[:, None] & (jnp.arange(C)[None, :] == slot[:, None]),
            0.0, pr_all)
        lk_all = cfg_like_of(calls)
        post_all = jnp.where(valid_c, lk_all + pr_all, -jnp.inf)
        res_ix = jnp.argsort(-post_all, axis=1, stable=True)
        calls = jnp.take_along_axis(calls, res_ix[:, :, None], 1)
        hrank = jnp.take_along_axis(hrank, res_ix, 1)
        hval = jnp.take_along_axis(hval, res_ix, 1)
        spost = jnp.sort(jnp.where(valid_c, post_all, -jnp.inf),
                         axis=1)
        boundary = boundary | ((n_cfg > 1) &
                               (jnp.abs(spost[:, -1] - spost[:, -2])
                                < BAND))

    # final posts + f32 posteriors (diagnostics + EM-continuation flag)
    valid_c = jnp.arange(C)[None, :] < n_cfg[:, None]
    hets_all = (active[:, None, :] & (calls >= NO_ALLELES)
                & (calls < NCALL)).sum(-1)
    ac_all = jnp.where(
        (active[:, None, :] & (calls < NCALL))[..., None],
        ac_d[ref_b[:, None, None], calls.astype(jnp.int32)], 0).sum(2)
    pr_all = prior_of(ac_all, hets_all)
    lk_all = cfg_like_of(calls)
    post_all = jnp.where(valid_c, lk_all + pr_all, -jnp.inf)
    mx = post_all.max(1)
    d = post_all - mx[:, None]
    expd = jnp.where(d > -40.0, jnp.exp(d), 0.0)
    flags = flags | jnp.where(
        (valid_c & (jnp.abs(d + 40.0) < BAND)).any(1),
        jnp.int32(F_EXP), 0)
    p_cfg = expd / expd.sum(1, keepdims=True)
    onehot = calls[:, :, :, None].astype(jnp.int32) == \
        jnp.arange(G + 1)[None, None, None, :]
    post_prob = (onehot * p_cfg[:, :, None, None]).sum(1)  # (S, I, G+1)
    final_call = jnp.argmax(post_prob[..., :G], -1)
    final_p = jnp.take_along_axis(post_prob,
                                  final_call[..., None], -1)[..., 0]
    final_call = jnp.where(active, final_call, NCALL)
    final_p = jnp.where(active, final_p, 1.0)

    if indiv >= 4:
        # fill_sample_like overwrites initial_call with the per-sample
        # UNGATED ML genotype each pass (native/pecall.c:478-481), so
        # the EM-continuation test compares against that argmax — plus
        # a band for near-tied argmaxes and near-threshold posteriors
        init_call = jnp.where(active, best_g, NCALL)
        changed = (active & ((final_call != init_call) |
                             (final_p < threshold - 0.01))).any(-1)
        near = (active & (jnp.abs(final_p - threshold) < 0.01)).any(-1)
        near_arg = (active & (initial_p < ORDER_BAND)).any(-1)
        flags = flags | jnp.where(changed | near | near_arg,
                                  jnp.int32(F_EM), 0)

    # a genotype near-tied (in f32, e.g. exactly symmetric counts whose
    # f64 likes differ only by summation-order ulps) with a SURVIVING
    # call could swap into/out of the f64 set on a tie-break the beam
    # cannot see — flag any site where a survivor's call has a tied
    # partner genotype within its sample
    lk_call = lp_flat[lp_base + calls.astype(jnp.int32)]    # (S, C, I)
    d_t = jnp.abs(like[:, None, :, :] - lk_call[..., None])  # (S,C,I,G)
    # the danger zone is f32-indistinguishable pairs: bitwise-equal f32
    # likes may be f64-distinct (summation-order ulps) and flip a
    # tie-break the finisher cannot replay; pairs separated by more
    # than the f32 evaluation error follow f64's order
    tie_band = 4e-7 * jnp.abs(lk_call[..., None]) + 1e-5
    n_near = (d_t <= tie_band).sum(-1)
    tied = ((n_near > 1) & valid_c[:, :, None] & active[:, None, :]
            & (calls < NCALL)).any((1, 2))
    flags = flags | jnp.where(tied, jnp.int32(F_TIE), 0)

    flags = flags | jnp.where(boundary, jnp.int32(F_BOUNDARY), 0)
    flags = flags | jnp.where(overflow, jnp.int32(F_OVERFLOW), 0)
    return (n_cfg, calls, flags.astype(jnp.int32),
            final_call.astype(jnp.int8), final_p.astype(jnp.float32),
            hrank, hval)


class DeviceBeam:
    """Chunked, jitted beam.  Call with host numpy arrays; returns
    (n_cfg, cfgs, flags, call32, p32) as numpy."""

    def __init__(self, indiv: int, haploid: bool, theta: float,
                 threshold: float, c_cap: int = 64, chunk: int = 1024):
        import jax
        from ..utils import enable_compilation_cache
        enable_compilation_cache()
        self.indiv = indiv
        self.haploid = haploid
        self.c_cap = c_cap
        self.chunk = chunk
        ta, tota, a1 = _tables(haploid)
        hw_t, hw_off = (hw_flat(indiv) if not haploid
                        else (np.zeros(1), np.zeros(indiv + 2, np.int64)))
        self._fn = jax.jit(functools.partial(
            _beam_chunk, haploid=haploid, indiv=indiv, c_cap=c_cap,
            ta=ta, tota=tota, a1=a1.astype(np.float32),
            ac_tab=allele_counts_tab(haploid),
            gorder=_HAP_ORDER if haploid else _DIP_ORDER,
            hw_t=hw_t, hw_off=hw_off,
            ln_theta=math.log(theta), threshold=threshold))

    def __call__(self, reads: np.ndarray, ref_int: np.ndarray):
        n = len(ref_int)
        C = self.c_cap
        G = NO_ALLELES if self.haploid else MAX_GEN
        n_cfg = np.zeros(n, np.int32)
        cfgs = np.zeros((n, C, self.indiv), np.int8)
        flags = np.zeros(n, np.int32)
        call32 = np.zeros((n, self.indiv), np.int8)
        p32 = np.zeros((n, self.indiv), np.float32)
        hrank = np.zeros((n, C), np.int16)
        hval = np.zeros((n, C), np.int8)
        pend = []
        lo = 0
        while lo < n:
            hi = min(lo + self.chunk, n)
            m = hi - lo
            if m < self.chunk:
                rd = np.zeros((self.chunk, self.indiv, 6), np.uint16)
                rd[:m] = reads[lo:hi]
                ri = np.zeros(self.chunk, np.uint8)
                ri[:m] = ref_int[lo:hi]
            else:
                rd = np.ascontiguousarray(reads[lo:hi])
                ri = np.ascontiguousarray(ref_int[lo:hi])
            pend.append((lo, hi, self._fn(rd, ri)))
            lo = hi
        for lo, hi, res in pend:
            m = hi - lo
            n_cfg[lo:hi] = np.asarray(res[0])[:m]
            cfgs[lo:hi] = np.asarray(res[1])[:m]
            flags[lo:hi] = np.asarray(res[2])[:m]
            call32[lo:hi] = np.asarray(res[3])[:m]
            p32[lo:hi] = np.asarray(res[4])[:m]
            hrank[lo:hi] = np.asarray(res[5])[:m]
            hval[lo:hi] = np.asarray(res[6])[:m]
        return n_cfg, cfgs, flags, call32, p32, hrank, hval


# --- the exact float64 finisher ------------------------------------------

T_REF, T_SNP, T_DEL, T_INS, T_LOW, T_MULTI, T_MESS = range(7)


def finish_f64(reads, ref_int, n_cfg, cfgs, hrank, hval, *, indiv,
               haploid, theta, threshold, ctype=None):
    """Given the beam's config sets, recompute every output with the
    native engine's float64 operation sequence (call_one_site,
    native/pecall.c:783-1070, itself pecaller.c:1149-1749): identical
    factln tables, sequential sums, config-order softmax, site typing.
    Returns (calls, probs, types, acnt, active) matching
    pecall_sites_batch's per-site outputs (no-pedigree mode)."""
    S = len(ref_int)
    I = indiv
    G = NO_ALLELES if haploid else MAX_GEN
    NCALL = G
    min_depth = 1 if haploid else 2
    C = cfgs.shape[1]
    r = reads.astype(np.int64)                       # (S, I, 6)
    ref = np.minimum(ref_int.astype(np.int64), 3)
    tot = r[..., :5].sum(-1)                         # (S, I)
    active = tot > min_depth

    # bad-base gates (call_one_site, native/pecall.c:820-834): in
    # production the screen resolves these, but the finisher stays
    # self-contained — a bad site zeroes every sample
    avg = np.zeros(S)
    for i in range(I):
        avg = avg + tot[:, i]
    avg = avg / float(I)
    cnt8 = (tot >= 8).sum(1)
    CHRY = 2
    ct = np.zeros(S, np.int64) if ctype is None \
        else ctype.astype(np.int64)
    bad = (avg < 8) | ((cnt8 < 0.5 * I) & (ct != CHRY))
    active = active & ~bad[:, None]

    # per-sample multinomial coefficient, C op order
    coef = factln_np(tot)
    for ii in range(6):
        coef = coef - factln_np(r[..., ii])

    dm_all = np.stack([
        fill_alpha_prior_np(300, 150, rr)[:G].astype(np.float64)
        for rr in range(4)])
    dm_all = dm_all / dm_all.sum(axis=2, keepdims=True)   # (4, G, 6)
    t100 = np.minimum(tot, 100)
    scale = t100 * 1.0
    scale = np.where(scale < 10, 10.0, scale)
    scale = np.where(scale > 1000, 1000.0, scale)

    like = np.zeros((S, I, G + 1))
    dm = dm_all[ref]                                 # (S, G, 6)
    for j in range(G):
        lj = np.zeros((S, I))
        cj = coef.copy()
        tot_a = np.zeros((S, I), np.int64)
        tot_tot = np.zeros((S, I), np.int64)
        for ii in range(6):
            ta = np.ceil(scale * dm[:, None, j, ii]).astype(np.int64)
            ta = np.maximum(ta, 1)
            tot_a = tot_a + ta
            tot_tot = tot_tot + ta + r[..., ii]
            cj = cj - factln_np(ta - 1)
            lj = lj + factln_np(ta + r[..., ii] - 1)
        cj = cj + factln_np(tot_a - 1)
        lj = lj + cj
        lj = lj - factln_np(tot_tot - 1)
        like[:, :, j] = lj

    ac_tab = allele_counts_tab(haploid)              # (4, G..+1, 6)
    valid_c = np.arange(C)[None, :] < n_cfg[:, None]
    cf = np.where(valid_c[:, :, None], cfgs, NCALL).astype(np.int64)

    # sample confidence order (fill_sample_like tail) in exact f64: on
    # unflagged sites the f32 device order provably matches
    like_g = like[:, :, :G]
    best_g = np.argmax(like_g, -1)
    lbest = np.take_along_axis(like_g, best_g[..., None], -1)[..., 0]
    marg = np.where(np.arange(G)[None, None, :] == best_g[..., None],
                    np.inf, lbest[..., None] - like_g).min(-1)
    initial_p = np.where(active, marg, 0.0)
    order = np.argsort(-initial_p, axis=1, kind="stable")

    # replay the C engine's INCREMENTAL like construction: fresh sum at
    # the config's origin (initial all-dom or reinjected hom), then
    # (like - like[s_r][origin]) + like[s_r][call] per later rank
    bval = np.minimum(hval.astype(np.int64), G)      # (S, C)
    srange = np.arange(S)
    like_cfg = np.zeros((S, C))
    for i in range(I):
        li = like[srange[:, None], i, bval]
        like_cfg = like_cfg + np.where(active[:, i, None], li, 0.0)
    for rk in range(I):
        s_r = order[:, rk]
        act_r = active[srange, s_r]
        applies = act_r[:, None] & (rk > hrank)
        lt_old = like[srange[:, None], s_r[:, None], bval]
        c_r = np.take_along_axis(cf, s_r[:, None, None], 2)[:, :, 0]
        lt_new = like[srange[:, None], s_r[:, None], np.minimum(c_r, G)]
        like_cfg = np.where(applies, (like_cfg - lt_old) + lt_new,
                            like_cfg)

    ac = np.zeros((S, C, 6), np.int64)
    hets = np.zeros((S, C), np.int64)
    for i in range(I):
        m = active[:, i, None, None]
        ac += np.where(m, ac_tab[ref[:, None], np.minimum(cf[:, :, i],
                                                          MAX_GEN)], 0)
        hets += (active[:, i, None] & (cf[:, :, i] >= NO_ALLELES)
                 & (cf[:, :, i] < NCALL))
    na = (ac > 0).sum(-1)
    prior = np.where(na > 1, (na - 1) * math.log(theta), 0.0)
    if not haploid:
        major_k = np.argmax(ac, -1)
        major = np.take_along_axis(ac, major_k[..., None], -1)[..., 0]
        minor = ac.sum(-1) - major
        swap = minor > major
        mj = np.where(swap, minor, major)
        mn = np.where(swap, major, minor)
        h = np.minimum(mn, hets)
        tot_n = (mn + mj) // 2
        mn = np.where((mn - h) % 2 == 1, mn + 1, mn)
        hwv = np.zeros((S, C))
        need = (na > 1) & valid_c
        for n_ in np.unique(tot_n[need]):
            t = fill_hardy_weinberg_np(int(n_))
            sel = need & (tot_n == n_)
            hwv[sel] = t[mn[sel], h[sel]]
        prior = prior + np.where(need, hwv, 0.0)
    # beam-injected pure-hom configs carry prior == 0 naturally (one
    # allele -> no theta/HW term), matching clean_config_probs

    post = np.where(valid_c, prior + like_cfg, -np.inf)
    # stable re-sort by f64 post desc (device order = allocation order
    # breaks exact ties, reproducing sort_cfgs)
    res = np.argsort(-post, axis=1, kind="stable")
    post = np.take_along_axis(post, res, 1)
    cf = np.take_along_axis(cf, res[:, :, None], 1)
    valid_c = np.take_along_axis(valid_c, res, 1)

    mx = post[:, 0].copy()
    d = post - mx[:, None]
    p = np.zeros_like(d)
    vm = valid_c & (d > -40)
    p[vm] = _exp_u(d[vm]).astype(np.float64)
    tot_post = np.zeros(S)
    for c in range(C):
        tot_post = tot_post + np.where(valid_c[:, c], p[:, c], 0.0)
    p = p / tot_post[:, None]

    post_prob = np.zeros((S, I, G + 1))
    for i in range(I):
        for c in range(C):
            g = np.minimum(cf[:, c, i], G)
            np.add.at(post_prob[:, i, :], (np.arange(S), g),
                      np.where(valid_c[:, c] & active[:, i],
                               p[:, c], 0.0))
    final_call = np.argmax(post_prob[:, :, :G], -1)
    final_p = np.take_along_axis(post_prob, final_call[..., None],
                                 -1)[..., 0]
    # the artifact N code is always 14 (INT_TO_GEN), even in haploid
    # mode where the internal NCALL slot is 6
    final_call = np.where(active, final_call, 14).astype(np.int8)
    final_p = np.where(active, final_p, 1.0)

    # --- site typing (native/pecall.c:997-1050) ---
    low_base = 0.4 * avg
    low_base = np.where(low_base < 8, 8.0, low_base)
    this_ac = np.zeros((S, 6), np.int64)
    on_t = np.zeros(S, np.int64)
    off_t = np.zeros(S, np.int64)
    not_low = np.zeros(S, np.int64)
    for i in range(I):
        counted = active[:, i] & (final_p[:, i] >= threshold)
        fc = np.where(counted, final_call[:, i], MAX_GEN).astype(np.int64)
        contrib = ac_tab[ref, np.minimum(fc, MAX_GEN)]      # (S, 6)
        for k in range(6):
            hit = counted & (ref < 4) & (contrib[:, k] > 0)
            this_ac[:, k] += np.where(hit, contrib[:, k], 0)
            on_t += np.where(hit, r[:, i, k], 0)
            off_hit = counted & ~hit & \
                ((k != ref) | (fc != NO_ALLELES - 1))
            off_t += np.where(off_hit, r[:, i, k], 0)
        not_low += (counted & (tot[:, i] > low_base)
                    & (final_call[:, i] != ref))
    na_s = (this_ac > 0).sum(-1)
    isdel = this_ac[:, 4] > 0
    isins = this_ac[:, 5] > 0
    issnp_base = np.zeros(S, np.int64)
    for k in range(4):
        issnp_base |= (this_ac[:, k] > 0) & (k != ref)
    types = np.where(issnp_base, T_SNP, T_REF)
    ref_ac = np.take_along_axis(this_ac, ref[:, None], 1)[:, 0]
    multi = (na_s > 1) | ((na_s > 0) & (ref_ac < 1))
    with np.errstate(invalid="ignore", divide="ignore"):
        mess = multi & (off_t / np.maximum(on_t + off_t, 1) > 0.15)
    t2 = np.where(na_s > 2, T_MULTI,
                  np.where(not_low > 0,
                           np.where(isdel, T_DEL,
                                    np.where(isins, T_INS, T_SNP)),
                           T_LOW))
    types = np.where(multi, np.where(mess, T_MESS, t2), types)
    return (final_call, final_p, types.astype(np.uint8),
            this_ac.astype(np.int32), active.astype(np.uint8))


_exp_u = np.frompyfunc(math.exp, 1, 1)
