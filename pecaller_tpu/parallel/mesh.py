"""Mesh scale-out: sharded mapping / calling steps.

The reference's only scale-out mechanism is one process per directory via
SGE qsub (map_directory_array.pl:101); here the equivalents are proper
device-mesh programs:

* mapping: reads are the data axis — each shard runs the SW batch on its
  reads and produces a partial pileup; partials are combined with
  psum_scatter over the ``genome`` axis so the final pileup lands sharded
  over space (a reduce-scatter).
* calling: sites are embarrassingly parallel — shard the site batch and
  run the per-site model locally, no collectives needed beyond the final
  gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..ops import sw as dsw


def make_mesh(n_reads_shards: int, n_genome_shards: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_reads_shards * n_genome_shards
    import numpy as np
    dev = np.asarray(devices[:n]).reshape(n_reads_shards, n_genome_shards)
    return Mesh(dev, axis_names=("reads", "genome"))


def sharded_map_step(mesh: Mesh, genome_size: int, bisulfite: bool = False):
    """Build a jitted mapping compute step over the mesh.

    Step signature: (refs (B,N) u8, blens (B,), reads (B,M) u8,
    rlens (B,)) -> (scores x36 (B,), bk, bi, pileup (genome_size, 6) u16
    sharded over the genome axis).
    """
    n_total = mesh.shape["reads"] * mesh.shape["genome"]
    gs_pad = ((genome_size + n_total - 1) // n_total) * n_total
    axes = ("reads", "genome")

    def local_step(refs, blens, reads, rlens):
        score, bk, bi = dsw.sw_align_device(refs, blens, reads, rlens,
                                            bisulfite=bisulfite)
        ev_pos, ev_kind, ins_j, _ = dsw.sw_traceback_device(
            refs, blens, reads, rlens, bk, bi, bisulfite=bisulfite)
        counts = dsw.pileup_scatter(ev_pos.reshape(-1),
                                    ev_kind.reshape(-1),
                                    (ins_j >= 0).reshape(-1),
                                    genome_size=gs_pad)
        # reduce partial pileups across every shard; land genome-sharded
        counts = jax.lax.psum_scatter(
            counts.reshape(n_total, gs_pad // n_total, 6),
            axes, scatter_dimension=0, tiled=False)
        return score, bk, bi, counts

    step = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(axes, None), P(axes), P(axes, None), P(axes)),
        out_specs=(P(axes), P(axes), P(axes), P(axes, None)),
        check_vma=False)
    return jax.jit(step)


def shard_units(arr, n_shards: int, B: int, paired: bool):
    """Split a (U, ...) end-major batch into (n_shards, U_local, ...)
    keeping both ends of each pair on the same shard (decide_pair needs
    them together).  For paired input U = 2B rows [end1 | end2]."""
    import numpy as np
    if not paired:
        return np.ascontiguousarray(
            arr.reshape(n_shards, B // n_shards, *arr.shape[1:]))
    bl = B // n_shards
    a = arr.reshape(2, n_shards, bl, *arr.shape[1:])
    return np.ascontiguousarray(
        a.transpose(1, 0, *range(2, a.ndim)).reshape(
            n_shards, 2 * bl, *arr.shape[1:]))


def sharded_fused_step2(mesh: Mesh, dnbr, *, paired: bool,
                        bisulfite: bool, min_dist: int, max_dist: int,
                        n_contigs: int, genome_size: int,
                        B: int, M: int, N: int, s_max: int,
                        max_rlen: int | None = None):
    """The full v2 fused mapping step sharded over every mesh device.

    Reads are the data axis (the reference's per-directory SGE fan-out,
    map_directory_array.pl:101, becomes one mesh program): each shard
    runs the complete seed→chain→SW→decide→traceback pipeline on its
    B/n_shards pairs and accumulates into its own pileup partial row of
    a (n_shards, genome_size*6) tensor; the per-run reduction over
    shards happens once at pileup download (a psum every batch would
    move the pileup between cards for a once-per-run artifact).

    Returns (step, n_shards).  Step signature matches the single-chip
    fused step except every per-batch array carries a leading
    (n_shards,) axis (see ``shard_units``) and dev_counts is
    (n_shards, (genome_size + SCATTER_PAD) * 6) uint32, donated.
    """
    from ..mapper.device_map2 import build_fused_step2

    axes = ("reads", "genome")
    n_shards = mesh.shape["reads"] * mesh.shape["genome"]
    if B % n_shards:
        raise ValueError(f"B={B} must divide by n_shards={n_shards}")
    raw = build_fused_step2(
        dnbr, paired=paired, bisulfite=bisulfite, min_dist=min_dist,
        max_dist=max_dist, n_contigs=n_contigs, genome_size=genome_size,
        B=B // n_shards, M=M, N=N, s_max=s_max, jit=False,
        max_rlen=max_rlen)
    n_idx = len(dnbr.args)

    def local(dev_counts, *rest):
        fixed = rest[:n_idx + 4]        # index arrays + genome/contigs
        per_b = rest[n_idx + 4:]
        dc, out = raw(dev_counts[0], *fixed,
                      *[x[0] for x in per_b])
        return dc[None], out[None]

    rep1 = P(None)
    batch_specs = (P(axes, None, None), P(axes, None),
                   P(axes, None, None), P(axes, None), P(axes, None),
                   P(axes, None), P(axes, None))
    step = shard_map(
        local, mesh=mesh,
        in_specs=(P(axes, None),                      # dev_counts
                  *([rep1] * (n_idx + 4)),            # index + genome
                  *batch_specs),
        out_specs=(P(axes, None), P(axes, None, None)),
        check_vma=False)
    return jax.jit(step, donate_argnums=(0,)), n_shards


def sharded_call_step(mesh: Mesh, indiv: int):
    """Sharded per-site genotype-likelihood step (sites = data axis).

    Computes the Dirichlet-multinomial likelihood tensor over
    (sites, genotypes) for the flat-alpha pass — the caller's hot inner
    loop — with sites sharded across the full mesh.
    """
    from ..caller.device_model import site_likelihoods

    def local_step(reads, ref_int):
        return site_likelihoods(reads, ref_int)

    step = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(("reads", "genome"), None, None),
                  P(("reads", "genome"))),
        out_specs=P(("reads", "genome"), None, None),
        check_vma=False)
    return jax.jit(step)
