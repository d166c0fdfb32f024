"""The GPU SW align path: which scorer the fused step picks, the CUDA
wrapper's batch padding and output contract (checked on the CPU through
the wrapper's XLA stand-in), and the kernel itself on a card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pecaller_tpu.ops import sw2, sw_cuda
from pecaller_tpu.mapper import device_map2

from test_sw2 import CODE, _mk


def test_sw_fns_cpu_picks_xla_scan():
    assert jax.default_backend() == "cpu"
    assert device_map2._sw_fns() == (sw2.sw_align_x, sw2.sw_traceback_rows)


def test_sw_fns_gpu_picks_cuda_kernel(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    align, tb = device_map2._sw_fns()
    assert align is sw_cuda.sw_align_x_cuda
    assert tb is sw2.sw_traceback_rows


def _inputs(B, seed=21):
    rng = np.random.default_rng(seed + B)
    refs, blens, reads, rlens = _mk(rng, B, 64, 48, 17, 41)
    return (jnp.asarray(CODE[refs]), jnp.asarray(blens),
            jnp.asarray(CODE[reads]), jnp.asarray(rlens))


@pytest.mark.parametrize("B", [1, 8, 13, 37])
@pytest.mark.parametrize("bis", [False, True])
def test_align_padded_matches_sw2(B, bis):
    """align_padded pads B up to the block multiple with zero-row lanes,
    hands the kernel uint8/int32 inputs, and unpacks (4, BP) int32 into
    sw2.sw_align_x's outputs for the first B lanes."""
    seen = []

    def call(refs, blens, reads, rlens, bisulfite, n_rows):
        seen.append((refs.shape, refs.dtype, reads.dtype, blens.dtype,
                     rlens.dtype, np.asarray(blens[B:]).tolist()))
        return sw_cuda.xla_align(refs, blens, reads, rlens, bisulfite,
                                 n_rows)

    args = _inputs(B)
    got = sw_cuda.align_padded(call, *args, bisulfite=bis, n_rows=64)
    want = sw2.sw_align_x(*args, bisulfite=bis, n_rows=64)
    (shape, rdt, qdt, bdt, ldt, pad_blens), = seen
    assert shape[0] % sw_cuda.BLOCK == 0 and shape[0] - B < sw_cuda.BLOCK
    assert (rdt, qdt, bdt, ldt) == (jnp.uint8, jnp.uint8, jnp.int32,
                                    jnp.int32)
    assert pad_blens == [0] * (shape[0] - B)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B,) and g.dtype == w.dtype
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_align_padded_rejects_rows_past_window():
    args = _inputs(8)
    with pytest.raises(ValueError):
        sw_cuda.align_padded(sw_cuda.xla_align, *args, n_rows=65)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,bis", [(112, 144, False), (112, 144, True),
                                     (160, 208, False), (304, 352, True)])
def test_cuda_kernel_equals_sw2_on_card(gpu, M, N, bis):
    import chip_smoke
    r = chip_smoke.kernel_check(sw_cuda.sw_align_x_cuda, B=1000, M=M, N=N,
                                bisulfite=bis, reps=1)
    assert r["equal"]


def test_kernel_check_rehearsal():
    """chip_smoke's phase-2 comparison, with the wrapper's XLA stand-in in
    the kernel's place."""
    import chip_smoke
    align = jax.jit(functools.partial(sw_cuda.align_padded,
                                      sw_cuda.xla_align),
                    static_argnames=("bisulfite", "n_rows"))
    r = chip_smoke.kernel_check(align, B=37, M=48, N=64, bisulfite=True,
                                reps=1)
    assert r["equal"] and r["B"] == 37
