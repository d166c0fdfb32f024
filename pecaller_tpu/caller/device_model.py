"""Device genotype-likelihood kernels — the caller's hot inner loop
vectorized over (sites, samples, genotypes).

This is the production path for site-throughput benchmarks: a float32
lgamma-based Dirichlet-multinomial, numerically equivalent to the exact
native engine (pecall.c fill_sample_like, mirroring pecaller.c:2448-2507)
up to rounding — the byte-parity pipeline keeps using the native engine.

Sites batch on the mesh's data axis (see parallel/mesh.py); the tensors
are (S, I, 14, 6), reduced over the allele axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NO_ALLELES = 6
MAX_GEN = 14


def _get_het_alleles(i, ref):
    pairs = {6: (0, 1), 7: (0, 2), 8: (0, 3), 9: (1, 2), 10: (1, 3),
             11: (2, 3), 12: (ref, 4), 13: (ref, 5)}
    return (i, i) if i < 6 else pairs[i]


def fill_alpha_prior_np(hom: int, het: int, ref: int) -> np.ndarray:
    """Numpy port of the reference's per-ref alpha prior
    (pecaller.c:3043-3139)."""
    a = np.zeros((MAX_GEN, NO_ALLELES), dtype=np.int64)
    hom_err = max(1, hom // 300)
    err = max(1, (2 * het) // 300)
    for i in range(4):
        a[i] = hom_err
        a[i, i] = hom
    a[4, :4] = err
    a[4, ref] = hom // 5
    a[4, 4] = (4 * hom) // 5
    a[4, 5] = err
    a[5, :4] = err
    a[5, ref] = hom
    a[5, 4] = err
    a[5, 5] = (4 * hom) // 5
    for j in range(6, 12):
        x, y = _get_het_alleles(j, ref)
        if x == ref or y == ref:
            r, o = (x, y) if x == ref else (y, x)
            a[j] = err
            a[j, r] = (51 * het) // 50
            a[j, o] = (49 * het) // 50
            a[j, 4] = max(1, het // 20)
            a[j, 5] = err
        else:
            a[j] = err
            a[j, x] = het
            a[j, y] = het
    a[12] = err
    a[12, 4] = (4 * het) // 5
    a[12, ref] = (6 * het) // 5
    a[12, 5] = err
    a[13] = err
    a[13, 5] = (2 * het) // 5
    a[13, ref] = (8 * het) // 5
    return a


_ALPHA_MEAN = np.stack([
    fill_alpha_prior_np(300, 150, r) /
    fill_alpha_prior_np(300, 150, r).sum(axis=1, keepdims=True)
    for r in range(4)])      # (4, 14, 6)


@functools.partial(jax.jit, static_argnames=("norm",))
def site_likelihoods(reads, ref_int, norm: float = 1.0):
    """(S, I, 6) uint16 counts + (S,) ref -> (S, I, 14) f32 log-likes.

    Mirrors fill_sample_like with the pass-1 flat alpha prior: the
    Dirichlet-multinomial log pmf with per-sample concentration
    scale = clip(min(tot,100)*norm, 10, 1000), alpha = ceil(scale*mean).
    """
    reads = reads.astype(jnp.float32)                 # (S, I, 6)
    tot = reads[..., :5].sum(-1)                      # (S, I)
    scale = jnp.clip(jnp.minimum(tot, 100.0) * norm, 10.0, 1000.0)
    mean = jnp.asarray(_ALPHA_MEAN, jnp.float32)[ref_int]   # (S, 14, 6)
    alpha = jnp.maximum(
        jnp.ceil(scale[:, :, None, None] * mean[:, None, :, :]), 1.0)
    r = reads[:, :, None, :]                          # (S, I, 1, 6)
    lg = jax.lax.lgamma
    a_tot = alpha.sum(-1)
    t_tot = (alpha + r).sum(-1)
    like = (lg(alpha + r).sum(-1) - lg(alpha).sum(-1)
            + lg(a_tot) - lg(t_tot)
            + lg(tot[:, :, None] + 1.0) - lg(r + 1.0).sum(-1))
    return like


@jax.jit
def site_posteriors_flat(reads, ref_int, ln_theta):
    """Fast per-sample genotype posteriors under an independent-sample
    approximation: likelihood + theta prior per non-ref allele, softmax
    over genotypes.  Used for throughput benchmarking and screening;
    the exact joint-configuration search refines flagged sites.
    """
    like = site_likelihoods(reads, ref_int)
    ref = ref_int[:, None, None]
    g = jnp.arange(MAX_GEN)[None, None, :]
    is_ref_hom = g == ref
    prior = jnp.where(is_ref_hom, 0.0, ln_theta).astype(jnp.float32)
    post = like + prior
    post = post - post.max(-1, keepdims=True)
    p = jnp.exp(post)
    p = p / p.sum(-1, keepdims=True)
    return p
