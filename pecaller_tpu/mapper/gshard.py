"""Genome-sharded octile mapping engine (docs/SCALING.md): mm10/hg38-scale
device seeding over a mesh ``genome`` axis.

Each shard holds an octile index + genome slice in LOCAL coordinates
(index/shard.py); one shard_map program runs the full fused pipeline
per shard with the cross-shard collectives living exactly where the
reference's global data structures used to be consulted
(pemapper.c:2129-2165 index, :497-522 genome, :2188-2289 chaining):

  * chain min-match ratchet / per-probe candidate totals: pmax / psum
  * candidate ownership by window start; overlap duplicates dropped
  * decide over the all_gather'ed per-shard top lists (global coords)
  * winner traceback + pileup scatter stay OWNER-LOCAL; the pileup
    lives genome-sharded until artifact download

Reads are replicated over the genome axis (a batch is ~4 MB; the index
is the heavy operand).  The public engine API (map_batch_async /
resolve / final_pileup) matches FusedMapperEngine2.
"""

from __future__ import annotations

import numpy as np

from ..formats.index_files import SeedIndex
from ..formats.sdx import SdxInfo
from ..index.quarter import OctileDeviceIndex
from ..index.shard import ShardPlan, plan_shards, build_octile_shards
from .engine import MapperEngine
from .device_map2 import (FusedMapperEngine2, build_fused_step2,
                          pack_genome)


class _OctShardSet:
    """dnbr-compatible descriptor whose args are the (G, ...) stacked,
    genome-sharded device arrays."""

    mode = "octile"

    def __init__(self, devs, args):
        self.t1 = devs[0].t1
        self.rcap = devs[0].rcap
        self.tb = devs[0].tb
        self.n_keys = 0
        self.args = args


def sharded_genome_step(mesh, dnbr, *, paired, bisulfite, min_dist,
                        max_dist, n_contigs, B, M, N, s_max,
                        max_rlen=None):
    """shard_map the octile fused step over mesh axis 'genome'."""
    import jax
    from ..parallel.mesh import shard_map
    from jax.sharding import PartitionSpec as P

    raw = build_fused_step2(
        dnbr, paired=paired, bisulfite=bisulfite, min_dist=min_dist,
        max_dist=max_dist, n_contigs=n_contigs, genome_size=0,
        B=B, M=M, N=N, s_max=s_max, jit=False, max_rlen=max_rlen,
        genome_axis="genome")
    n_idx = len(dnbr.args)

    def local(dev_counts, *rest):
        fixed = rest[:n_idx + 4]        # index + genome/contig arrays
        per_b = rest[n_idx + 4:-1]
        gctx = rest[-1]
        dc, out = raw(dev_counts[0], *[x[0] for x in fixed], *per_b,
                      gctx[0])
        return dc[None], out[None]

    g2 = P("genome", None)
    g3 = P("genome", None, None)
    batch_specs = (P(None, None), P(None), P(None, None), P(None),
                   P(None), P(None), P(None))
    step = shard_map(
        local, mesh=mesh,
        in_specs=(g2, *([g2] * (n_idx + 4)), *batch_specs, g2),
        out_specs=(g2, g3),
        check_vma=False)
    return jax.jit(step, donate_argnums=(0,))


class OctileShardedEngine(FusedMapperEngine2):
    """FusedMapperEngine2 API over genome-sharded octile shards."""

    def __init__(self, sdx: SdxInfo, genome: np.ndarray,
                 index: SeedIndex, mesh, plan: ShardPlan | None = None,
                 shards=None, **kwargs):
        MapperEngine.__init__(self, sdx, genome, index, **kwargs)
        from ..utils import enable_compilation_cache
        enable_compilation_cache()
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        self._jnp = jnp
        self._mesh = mesh
        self._n_sh = 1                  # reads axis unsharded here
        self._group_k = 1
        self._staged = []
        self._fns = {}
        self.n_fallback = 0
        self.n_tiefix = 0
        self.mesh_timing = {"dispatch_s": 0.0, "fetch_s": 0.0,
                            "batches": 0}
        G = mesh.shape["genome"]
        if plan is None:
            plan = plan_shards(sdx, G)
        if shards is None:
            shards = build_octile_shards(index, plan)
        if len(shards) != G:
            raise ValueError("shard count != mesh genome axis size")
        self._plan = plan
        emax = max(len(np.asarray(s.pos)) for s in shards)
        devs = [OctileDeviceIndex(s, pad_entries=emax) for s in shards]

        def put(x):
            return jax.device_put(
                x, NamedSharding(mesh, P("genome",
                                         *([None] * (x.ndim - 1)))))

        idx_stacked = [put(np.stack([np.asarray(d.args[k])
                                     for d in devs]))
                       for k in range(4)]
        self._dnbr = _OctShardSet(devs, tuple(idx_stacked))

        # per-shard genome slices (seq coords), equal padded length
        # (+SCATTER_PAD: the windowed pileup scatter may overhang past
        # a shard's covered span with EV_NONE zero rows)
        from .device_map2 import SCATTER_PAD
        cs_max = int(plan.cover_seq.max()) + SCATTER_PAD
        cs_max = ((cs_max + 31) // 32) * 32
        gcodes, gmasks = [], []
        for g in range(G):
            b = int(plan.bases_seq[g])
            sl = np.zeros(cs_max, np.uint8)
            src = genome[b:b + cs_max]
            sl[:len(src)] = src
            sl[len(src):] = ord("N")
            cw, mw = pack_genome(sl)
            gcodes.append(cw)
            gmasks.append(mw)
        self._gcode = put(np.stack(gcodes))
        self._gmask = put(np.stack(gmasks))
        self._local_seq = cs_max

        ist = sdx.istarts.astype(np.int64)
        n_pad = max(sdx.n_contigs + 1, 70) + 1
        ists, stps = [], []
        for g in range(G):
            b = int(plan.bases_idx[g])
            il = np.clip(ist - b, -(2 ** 31) + 1, 2 ** 31 - 1)
            ists.append(il.astype(np.int32))
            stp = np.full(n_pad, 2 ** 31 - 1, np.int64)
            stp[:len(ist)] = ist - b
            stps.append(np.clip(stp, -(2 ** 31) + 1,
                                2 ** 31 - 1).astype(np.int32))
        self._ist_dev = put(np.stack(ists))
        self._st_pad_dev = put(np.stack(stps))
        self._gctx_dev = put(plan.gctx())
        self.dev_counts = jax.device_put(
            jnp.zeros((G, cs_max * 6), jnp.uint32),
            NamedSharding(mesh, P("genome", None)))

    def _fn_for(self, B, M, N, s_max, mr=None):
        key = (B, M, N, s_max, mr)
        if key not in self._fns:
            step = sharded_genome_step(
                self._mesh, self._dnbr, paired=self.paired,
                bisulfite=self.bisulfite, min_dist=self.min_dist,
                max_dist=self.max_dist, n_contigs=self.sdx.n_contigs,
                B=B, M=M, N=N, s_max=s_max, max_rlen=mr)
            gctx = self._gctx_dev

            def fn(dev_counts, *args):
                return step(dev_counts, *args, gctx)
            self._fns[key] = fn
        return self._fns[key]

    def resolve(self, h):
        # normalize the (G, B + ins_cap+1 + tie_cap+1, 6) output to the
        # single-device convention: packed rows are replicated (m_u was
        # psum'd over the genome axis), insertion/walk-tie records are
        # per-shard with global positions — merge each block under one
        # tail marker at the single-device fixed offsets
        if "out" in h and not isinstance(h["out"], np.ndarray):
            from .device_map2 import INS_CAP, TIE_CAP
            out = np.asarray(h["out"])
            G = out.shape[0]
            B = h["B"]
            packed = out[0, :B]
            recs, trecs = [], []
            for g in range(G):
                rec_g = out[g, B:B + INS_CAP + 1]
                n_ins_g = int(rec_g[-1, 0])
                if n_ins_g > rec_g.shape[0] - 1:
                    raise RuntimeError("insertion record cap exceeded "
                                       f"on genome shard {g}")
                recs.append(rec_g[:n_ins_g])
                tr_g = out[g, B + INS_CAP + 1:]
                trecs.append(tr_g[:int(tr_g[-1, 0])])
            rec = np.concatenate(recs) if recs else \
                np.zeros((0, 6), out.dtype)
            trec = np.concatenate(trecs) if trecs else \
                np.zeros((0, 6), out.dtype)
            if len(rec) > INS_CAP:
                raise RuntimeError("merged insertion records exceed "
                                   "ins_cap; raise INS_CAP")
            if len(trec) > TIE_CAP:
                raise RuntimeError("merged walk-tie records exceed "
                                   "tie_cap; raise TIE_CAP")
            blk_i = np.zeros((INS_CAP + 1, 6), out.dtype)
            blk_i[:len(rec)] = rec
            blk_i[-1, 0] = len(rec)
            blk_t = np.zeros((TIE_CAP + 1, 6), out.dtype)
            blk_t[:len(trec)] = trec
            blk_t[-1, 0] = len(trec)
            h["out"] = np.concatenate([packed, blk_i, blk_t], axis=0)
        return super().resolve(h)

    def final_pileup(self) -> np.ndarray:
        host = self.pileup.sum(axis=0, dtype=np.uint16)
        dc = np.asarray(self.dev_counts)        # (G, cs_max*6)
        gs = self.sdx.genome_size
        dev = np.zeros((gs, 6), np.uint32)
        for g in range(self._plan.n_shards):
            b = int(self._plan.bases_seq[g])
            span = min(self._local_seq, gs - b)
            dev[b:b + span] += dc[g].reshape(-1, 6)[:span]
        dev = (dev & 0xFFFF).astype(np.uint16)
        return (host + dev).astype(np.uint16)

    def reset_group(self) -> None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        MapperEngine.reset_group(self)
        self.dev_counts = jax.device_put(
            self._jnp.zeros((self._plan.n_shards, self._local_seq * 6),
                            self._jnp.uint32),
            NamedSharding(self._mesh, P("genome", None)))
