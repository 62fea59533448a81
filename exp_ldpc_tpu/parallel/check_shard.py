"""Check-partition (model-parallel) sharded BP decoding.

For codes whose spacetime Tanner graph is too large for one chip's HBM — or
to cut per-decode latency — the CHECK dimension is partitioned over the mesh
``MODEL_AXIS`` (SURVEY.md §2.4 row 2; BASELINE.json scaling config 3).  The
reference has no model parallelism at all (its only strategy is a CPU
process pool over shots, ``/root/reference/python/qldpc/misc/p_sweep.py:18-29``).

Sharding layout (contiguous check blocks, padded to equal size):

  * each device owns ``C_loc = ceil(C / D)`` check rows and ALL messages on
    edges incident to those checks, stored check-major ``(C_loc, Dc, S)``;
  * variables are conceptually replicated: the per-variable posterior is
    reconstituted every iteration by summing each shard's partial
    variable-totals with ONE ``psum`` over ``MODEL_AXIS`` — the only
    communication in the decode loop ((V, S) f32 per iteration);
  * the check-node update, the local variable-major segment sum, and the
    ``v2c = posterior[chk_vars] - c2v`` route-back are all local.

Shots can shard over ``DATA_AXIS`` at the same time: syndromes enter as a
(C_pad, S) array sharded P(model, data).

The math matches :func:`exp_ldpc_tpu.decoders.bp._bp_core` with the gather
formulation up to f32 summation order (partial sums + psum tree).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from scipy import sparse

from ..decoders.bp import _BIG, _check_update_cm, priors_to_llr
from .mesh import DATA_AXIS, MODEL_AXIS

__all__ = ["ShardedTanner", "ShardedBPDecoder"]


@dataclass(frozen=True, eq=False)
class ShardedTanner:
    """Static per-shard index arrays for check-partitioned BP.

    All arrays carry a leading shard axis D (sharded P(model) at dispatch):
      chk_vars   (D, C_loc, Dc) int32 — global variable id per local slot
      chk_mask   (D, C_loc, Dc) bool
      vm_local   (D, V, Dv) int32 — per shard, for each variable, indices of
                 its LOCALLY-incident edges into the flattened local
                 check-major array (pad = C_loc*Dc, a one-past-end zero row)
    """

    num_checks: int
    num_vars: int
    num_shards: int
    checks_per_shard: int
    chk_vars: np.ndarray
    chk_mask: np.ndarray
    vm_local: np.ndarray

    @classmethod
    def from_check_matrix(cls, H, num_shards: int) -> "ShardedTanner":
        H = sparse.csr_matrix(H)
        H = H.copy()
        H.data = H.data % 2
        H.eliminate_zeros()
        H.sort_indices()
        C, V = H.shape
        D = int(num_shards)
        C_loc = -(-C // D)
        Dc = int(max((H.indptr[i + 1] - H.indptr[i] for i in range(C)), default=1))
        Dv = int(H.getnnz(axis=0).max(initial=1))

        chk_vars = np.zeros((D, C_loc, Dc), dtype=np.int32)
        chk_mask = np.zeros((D, C_loc, Dc), dtype=bool)
        vm_local = np.full((D, V, Dv), C_loc * Dc, dtype=np.int32)
        vm_fill = np.zeros((D, V), dtype=np.int64)
        for c in range(C):
            d, cl = divmod(c, C_loc)
            row = H.indices[H.indptr[c]:H.indptr[c + 1]]
            for i, v in enumerate(row):
                chk_vars[d, cl, i] = v
                chk_mask[d, cl, i] = True
                vm_local[d, v, vm_fill[d, v]] = cl * Dc + i
                vm_fill[d, v] += 1

        return cls(
            num_checks=C,
            num_vars=V,
            num_shards=D,
            checks_per_shard=C_loc,
            chk_vars=chk_vars,
            chk_mask=chk_mask,
            vm_local=vm_local,
        )

    @property
    def max_check_degree(self) -> int:
        return self.chk_vars.shape[2]


def _shard_step(v2c, c2v_to_totals, synd_sign, prior_llr, chk_vars, mask3,
                method, alpha):
    """One sharded flooding iteration on this device's check block."""
    c2v = _check_update_cm(v2c, synd_sign, method, alpha)
    partial_tot = c2v_to_totals(c2v)  # (V, S) local partial sums
    totals = jax.lax.psum(partial_tot, MODEL_AXIS)
    posterior = prior_llr[:, None] + totals  # (V, S), replicated over model
    v2c_new = jnp.where(mask3, posterior[chk_vars] - c2v, _BIG)
    return v2c_new, posterior


@dataclass(eq=False)
class ShardedBPDecoder:
    """Batched BP with checks sharded over MODEL_AXIS and shots over DATA_AXIS.

    ``decode_batch`` accepts (S, C) uint8 syndromes on the host and returns
    (S, V) hard decisions, (S, V) posteriors, (S,) convergence flags —
    the same contract as :class:`exp_ldpc_tpu.decoders.bp.BPDecoder`.
    """

    tanner: ShardedTanner
    prior_llr: np.ndarray
    mesh: Mesh
    method: str = "ps"
    max_iter: int = 0
    ms_scaling_factor: float = 0.0
    early_stop: bool = True

    def __post_init__(self):
        method = {"ps": "ps", "psl": "ps", "ms": "ms", "msl": "ms"}.get(self.method)
        if method is None:
            raise ValueError(f"unknown bp method {self.method!r}")
        self.method = method
        if self.max_iter <= 0:
            self.max_iter = self.tanner.num_vars
        if self.mesh.shape[MODEL_AXIS] != self.tanner.num_shards:
            raise ValueError(
                f"tanner built for {self.tanner.num_shards} shards but mesh "
                f"model axis is {self.mesh.shape[MODEL_AXIS]}"
            )
        self._decode = self._build()

    @classmethod
    def from_check_matrix(cls, H, mesh: Mesh, *,
                          error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None,
                          max_iter: int = 0, bp_method: str = "ps",
                          ms_scaling_factor: float = 0.0,
                          early_stop: bool = True, **_ignored):
        tanner = ShardedTanner.from_check_matrix(H, mesh.shape[MODEL_AXIS])
        if channel_probs is not None:
            prior = np.asarray(channel_probs, dtype=np.float64)
        elif error_rate is not None:
            prior = np.full(tanner.num_vars, error_rate, dtype=np.float64)
        else:
            raise ValueError("must supply error_rate or channel_probs")
        return cls(tanner=tanner, prior_llr=priors_to_llr(prior), mesh=mesh,
                   method=bp_method, max_iter=max_iter,
                   ms_scaling_factor=float(ms_scaling_factor),
                   early_stop=early_stop)

    def _build(self):
        t = self.tanner
        C_loc, Dc = t.checks_per_shard, t.max_check_degree
        V = t.num_vars
        method, max_iter = self.method, self.max_iter
        early_stop = self.early_stop
        ms_sf = jnp.float32(self.ms_scaling_factor)
        adaptive = float(self.ms_scaling_factor) == 0.0
        prior = jnp.asarray(self.prior_llr)

        def per_device(synd_loc, chk_vars, chk_mask, vm_local):
            # shard_map passes size-1 leading shard axes; drop them
            chk_vars = chk_vars[0]
            chk_mask = chk_mask[0]
            vm_local = vm_local[0]
            mask3 = chk_mask[:, :, None]
            S = synd_loc.shape[1]
            synd_sign = 1.0 - 2.0 * synd_loc.astype(jnp.float32)

            def c2v_to_totals(c2v):
                flat = jnp.concatenate(
                    [c2v.reshape(C_loc * Dc, S), jnp.zeros((1, S), jnp.float32)],
                    axis=0)
                return jnp.sum(flat[vm_local], axis=1)  # (V, S)

            def local_syndrome_ok(hard):
                bits = jnp.where(mask3, hard[chk_vars], 0).astype(jnp.int32)
                par = jnp.sum(bits, axis=1) % 2  # (C_loc, S)
                bad = jnp.sum(jnp.abs(par - synd_loc.astype(jnp.int32)), axis=0)
                return jax.lax.psum(bad, MODEL_AXIS) == 0  # (S,) replicated

            edge_prior = jnp.where(mask3[:, :, 0], prior[chk_vars], _BIG)
            v2c0 = jnp.broadcast_to(edge_prior[:, :, None], (C_loc, Dc, S))

            def step(it, v2c):
                alpha = jnp.where(
                    adaptive, 1.0 - 2.0 ** (-(it + 1).astype(jnp.float32)), ms_sf)
                return _shard_step(v2c, c2v_to_totals, synd_sign, prior,
                                   chk_vars, mask3, method, alpha)

            if not early_stop:
                def fbody(it, carry):
                    v2c, _post = carry
                    return step(it, v2c)

                post0 = jnp.broadcast_to(prior[:, None], (V, S))
                _v2c, posterior = jax.lax.fori_loop(
                    0, max_iter, fbody, (v2c0, post0))
                hard = (posterior <= 0).astype(jnp.uint8)
                conv = local_syndrome_ok(hard)
                return hard, posterior, conv

            hard0 = jnp.zeros((V, S), dtype=jnp.uint8)
            post0 = jnp.broadcast_to(prior[:, None], (V, S))
            conv0 = jnp.zeros((S,), dtype=bool)

            def cond(state):
                it, _v2c, _hard, _post, conv = state
                return (it < max_iter) & ~jnp.all(conv)

            def body(state):
                it, v2c, hard, post, conv = state
                v2c_new, posterior = step(it, v2c)
                hard_new = (posterior <= 0).astype(jnp.uint8)
                ok = local_syndrome_ok(hard_new)
                hard = jnp.where(conv[None, :], hard, hard_new)
                post = jnp.where(conv[None, :], post, posterior)
                conv = conv | ok
                return (it + 1, v2c_new, hard, post, conv)

            state = (jnp.int32(0), v2c0, hard0, post0, conv0)
            _, _, hard, post, conv = jax.lax.while_loop(cond, body, state)
            return hard, post, conv

        mapped = jax.shard_map(
            per_device,
            mesh=self.mesh,
            in_specs=(P(MODEL_AXIS, DATA_AXIS), P(MODEL_AXIS), P(MODEL_AXIS),
                      P(MODEL_AXIS)),
            out_specs=(P(None, DATA_AXIS), P(None, DATA_AXIS), P(DATA_AXIS)),
            check_vma=False,
        )
        jitted = jax.jit(mapped)
        chk_vars = jnp.asarray(t.chk_vars)
        chk_mask = jnp.asarray(t.chk_mask)
        vm_local = jnp.asarray(t.vm_local)

        def decode(synd_pad):
            return jitted(synd_pad, chk_vars, chk_mask, vm_local)

        return decode

    def decode_batch(self, syndromes: np.ndarray):
        t = self.tanner
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        S, C = syndromes.shape
        n_data = self.mesh.shape[DATA_AXIS]
        S_pad = -(-S // n_data) * n_data
        C_pad = t.num_shards * t.checks_per_shard
        synd = np.zeros((C_pad, S_pad), dtype=np.uint8)
        synd[:C, :S] = syndromes.T
        hard, post, conv = self._decode(jnp.asarray(synd))
        return (np.asarray(hard).T[:S], np.asarray(post).T[:S],
                np.asarray(conv)[:S])
