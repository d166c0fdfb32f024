"""chip_smoke.py's parity phases rehearsed on the CPU at a tiny size,
its refusal to run without a GPU, and the compile-cache location."""

import json
import os
import subprocess
import sys

import pytest

from util import REPO

import bench
import chip_smoke


@pytest.mark.parametrize("env_dir", [True, False])
def test_compilation_cache_dir(tmp_path, env_dir):
    """$JAX_COMPILATION_CACHE_DIR is used as given; otherwise the cache
    is <checkout>/.jax_cache (fresh interpreter: JAX reads the variable
    at import)."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import sys, jax; sys.path.insert(0, sys.argv[1]); "
            "from pecaller_tpu.utils import enable_compilation_cache; "
            "d = enable_compilation_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code, REPO], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    assert out == [want, want]
    assert os.path.isdir(want)


def test_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("smoke"))
    d = bench._prepare_data(os.path.join(root, "bact"), genome_len=60000,
                            n_reads=600, write_idx=False)
    return root, d


def test_smoke_map_parity_rehearsal(tiny_data):
    """Phase 3 at a tiny size: the fused device step against the host
    oracle, then the 2-way reads-sharded step against 1 device."""
    root, d = tiny_data
    clock = chip_smoke.CompileClock()
    host, dev = chip_smoke.map_parity(
        d, "g.sdx", os.path.join(root, "out"),
        [("host", False, None), ("device", True, 1)], nthreads=2,
        clock=clock)
    assert host["reads"] == dev["reads"] == 1200
    assert dev["compile_s"] > 0 and dev["n_fallback"] >= 0
    assert dev["cold_compile_s"] >= dev["compile_s"] - 1e-3
    step, = dev["fused_step"]
    assert step["temp_size"] > 0 and step["argument_size"] > 0
    one, two = chip_smoke.map_parity(
        d, "g.sdx", os.path.join(root, "out2"),
        [("one", True, 1), ("two", True, 2)], nthreads=2, clock=clock)
    assert two["dispatch_ms_per_batch"] >= 0
    json.dumps([host, dev, one, two])


def test_smoke_artifact_mismatch_is_reported():
    a = {".summary.txt": b"abc", ".pileup": b"x"}
    chip_smoke.assert_equal_artifacts(a, dict(a), "same")
    with pytest.raises(AssertionError, match="first difference at byte 1"):
        chip_smoke.assert_equal_artifacts(
            a, {".summary.txt": b"axc", ".pileup": b"x"}, "diff")


def test_smoke_caller_parity_rehearsal(tiny_data):
    root, d = tiny_data
    cb = bench._prepare_caller_data(d)
    runs = chip_smoke.caller_parity(cb, os.path.join(root, "call"), 2)
    by = {r["run"]: r for r in runs}
    assert by["device_phase0"]["device_sites_phase0"] == by["native"][
        "sites"]
    assert by["native"]["device_sites_phase0"] == 0
    # the default config sends every window's UNRES sites to phase 1
    assert by["default"]["device_sites_phase1"] > 0


def test_smoke_margin_check_rehearsal():
    r = chip_smoke.margin_check(n_min=2000)
    assert r["unres_sites"] >= 2000
    assert r["max_abs_err"] < r["limit"]
