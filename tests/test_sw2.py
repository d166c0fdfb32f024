"""sw2 (code-based SW + row-sync traceback) equivalence vs the round-1
char-based kernels."""

import numpy as np
import jax.numpy as jnp
import pytest

from pecaller_tpu.ops import sw as swc
from pecaller_tpu.ops import sw2

CODE = np.zeros(256, np.uint8)
for i, c in enumerate(b"ACGT"):
    CODE[c] = i
CODE[ord("N")] = sw2.XN


def _mk(rng, B, N, M, lo, hi):
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = bases[rng.integers(0, 4, (B, M))]
    rlens = rng.integers(lo, hi, B).astype(np.int32)
    refs = np.zeros((B, N), np.uint8)
    blens = np.zeros(B, np.int32)
    for b in range(B):
        L = rlens[b]
        r = list(reads[b, :L])
        for _ in range(rng.integers(0, 5)):
            p = rng.integers(0, len(r))
            r[p] = bases[rng.integers(0, 4)]
        for _ in range(rng.integers(0, 3)):
            p = rng.integers(1, len(r))
            if rng.random() < 0.5:
                r.insert(p, bases[rng.integers(0, 4)])
            else:
                del r[p]
        pre = rng.integers(0, 11)
        win = np.concatenate([bases[rng.integers(0, 4, pre)],
                              np.array(r, np.uint8),
                              bases[rng.integers(0, 4, rng.integers(0, 11))]])
        blens[b] = min(len(win), N)
        refs[b, :blens[b]] = win[:blens[b]]
    reads = np.where(rng.random((B, M)) < 0.01, ord("N"), reads)
    refs = np.where(rng.random((B, N)) < 0.005, ord("N"), refs)
    return (refs.astype(np.uint8), blens, reads.astype(np.uint8), rlens)


@pytest.mark.parametrize("bis", [False, True])
def test_sw2_matches_sw_chars(bis):
    rng = np.random.default_rng(11)
    refs, blens, reads, rlens = _mk(rng, 128, 96, 80, 30, 73)
    s1, k1, i1 = swc.sw_align_device(
        jnp.asarray(refs), jnp.asarray(blens), jnp.asarray(reads),
        jnp.asarray(rlens), bisulfite=bis, n_rows=96)
    s2, k2, i2, _tie2 = sw2.sw_align_x(
        jnp.asarray(CODE[refs]), jnp.asarray(blens),
        jnp.asarray(CODE[reads]), jnp.asarray(rlens),
        bisulfite=bis, n_rows=96)
    assert np.array_equal(np.asarray(s1), np.asarray(s2))
    assert np.array_equal(np.asarray(k1), np.asarray(k2))
    assert np.array_equal(np.asarray(i1), np.asarray(i2))

    ev_pos, ev_kind, ins_j, ins_len = [np.asarray(x) for x in
                                       swc.sw_traceback_device(
        jnp.asarray(refs), jnp.asarray(blens), jnp.asarray(reads),
        jnp.asarray(rlens), k1, i1, bisulfite=bis, n_rows=96)]
    ek, ij, il, _tw = [np.asarray(x) for x in sw2.sw_traceback_rows(
        jnp.asarray(CODE[refs]), jnp.asarray(blens),
        jnp.asarray(CODE[reads]), jnp.asarray(rlens), k2, i2,
        bisulfite=bis, n_rows=96)]
    B = refs.shape[0]
    for b in range(B):
        old = {int(ev_pos[b, t]): int(ev_kind[b, t])
               for t in range(ev_pos.shape[1])
               if ev_pos[b, t] >= 0 and ev_kind[b, t] != swc.EV_NONE}
        new = {r: int(k) for r, k in enumerate(ek[b]) if k != sw2.EV_NONE}
        assert old == new, b
        oldins = sorted((int(ev_pos[b, t]), int(ins_j[b, t]),
                         int(ins_len[b, t]))
                        for t in range(ev_pos.shape[1]) if ins_j[b, t] >= 0)
        newins = sorted((r, int(ij[b, r]), int(il[b, r]))
                        for r in range(ek.shape[1]) if ij[b, r] >= 0)
        assert oldins == newins, b
