"""Rounds-axis (sequence-parallel) sharded spacetime BP with 1-D halo
exchange.

SURVEY.md §2.4 identifies the spacetime ROUND axis as the reference's
long-sequence analog: the multi-round check matrix grows block-diagonally
with rounds (reference ``spacetime_code.py:52-70``) and adjacent round
blocks couple ONLY through degree-2 measurement-error columns.  That is a
textbook 1-D halo pattern, so instead of the generic check-partition psum
(``parallel/check_shard.py``, a full (V, S) all-reduce per iteration) the
round blocks shard over the mesh ``MODEL_AXIS`` and each flooding iteration
exchanges exactly TWO boundary message rows of shape (r, S_local) with the
neighbor devices via ``lax.ppermute`` — nearest-neighbor traffic,
independent of the number of rounds.

The math is the fixed-iteration structured kernel
(:func:`exp_ldpc_tpu.decoders.spacetime_bp._stbp_core` with
``early_stop=False``, matmul formulation, f32 messages), identical up to
f32 rounding (XLA reassociates the batched routing einsum differently for
different local block counts; measured ~1e-6 posterior deltas after 12
iterations, hard decisions identical off the knife-edge): each device runs
the base-code one-hot matmul routing on its local round blocks; the halo rows
are the ``v2c`` message of the last local measurement variable (consumed by
the next device's first check block) and the ``c2v`` message of the first
local check block (consumed by the previous device's last measurement
variable).  Shots shard over ``DATA_AXIS`` at the same time.

Round blocks pad to a multiple of the mesh axis; padded blocks carry zero
syndromes and +BIG priors, and padded measurement rows are pinned to the
neutral +BIG each iteration, so no padding garbage reaches a real message.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..decoders.bp import _BIG, _build_dense_ops, _check_update_cm, priors_to_llr
from ..decoders.tanner import TannerELL
from .mesh import DATA_AXIS, MODEL_AXIS

__all__ = ["RoundsShardedSpacetimeBP"]


def _stbp_rounds_sharded(
    tanner: TannerELL,
    num_rounds: int,
    mesh: Mesh,
    method: str,
    max_iter: int,
    ms_scaling_factor: float,
):
    """Build the jitted sharded decode: (synd, data_llr, meas_llr, valid_m)
    -> (posterior_d (B_pad, n, S), posterior_m (B_pad, r, S), conv (S,)).

    Shapes: synd (B_pad, r, S) zero-padded; data_llr (B_pad, n) with +BIG on
    pad blocks; meas_llr (B_pad, r) with +BIG on invalid measurement rows;
    valid_m (B_pad, 1, 1) f32 0/1 mask (row b holds measurement variable
    m_b, valid iff b < num_rounds)."""
    r, n, Dc = tanner.num_checks, tanner.num_vars, tanner.max_check_degree
    M, G, Hd, mask = _build_dense_ops(tanner)
    Mj, Gj, Hdj = jnp.asarray(M), jnp.asarray(G), jnp.asarray(Hd)
    mask4 = jnp.asarray(mask)[None, :, :, None]  # (1, r, Dc, 1)
    D = mesh.shape[MODEL_AXIS]
    fwd = [(i, i + 1) for i in range(D - 1)]  # d -> d+1 (no wraparound)
    bwd = [(i + 1, i) for i in range(D - 1)]  # d -> d-1
    adaptive = ms_scaling_factor == 0.0
    msf = jnp.float32(ms_scaling_factor)

    def local_decode(synd, data_llr, meas_llr, valid_m):
        """Per-device body: K local round blocks, S local shots."""
        K = synd.shape[0]
        S = synd.shape[2]
        didx = jax.lax.axis_index(MODEL_AXIS)
        synd_sign = 1.0 - 2.0 * synd.astype(jnp.float32)

        chk_vars = np.asarray(tanner.chk_vars)
        edge_prior = data_llr[:, chk_vars]  # (K, r, Dc)
        edge_prior = jnp.where(jnp.asarray(tanner.chk_mask)[None], edge_prior, _BIG)
        v2c_data0 = jnp.broadcast_to(edge_prior[..., None], (K, r, Dc, S))
        m0 = jnp.where(valid_m > 0, meas_llr[..., None], _BIG)
        v2c_mlo0 = jnp.broadcast_to(m0, (K, r, S))
        v2c_mhi0 = v2c_mlo0

        def fbody(it, carry):
            (v2c_data, v2c_mlo, v2c_mhi), _posts = carry
            alpha = jnp.where(
                adaptive, 1.0 - 2.0 ** (-(it + 1).astype(jnp.float32)), msf
            )
            # halo 1: previous device's last measurement row feeds the first
            # local check block's "previous-round" slot
            prev_mhi = jax.lax.ppermute(v2c_mhi[-1], MODEL_AXIS, fwd)  # (r, S)
            prev_mhi = jnp.where(didx == 0, _BIG, prev_mhi)  # global block 0
            slot_prev = jnp.concatenate([prev_mhi[None], v2c_mhi[:-1]], axis=0)
            slot_next = v2c_mlo  # measurement row j is block j's lo edge
            v2c_ext = jnp.concatenate(
                [v2c_data, slot_prev[:, :, None, :], slot_next[:, :, None, :]],
                axis=2,
            )  # (K, r, Dc+2, S)
            c2v_ext = _check_update_cm(
                v2c_ext.reshape(K * r, Dc + 2, S),
                synd_sign.reshape(K * r, S),
                method,
                alpha,
            ).reshape(K, r, Dc + 2, S)
            c2v_data = c2v_ext[:, :, :Dc, :]

            # data-variable update: base-code matmul routing per local
            # block.  HIGHEST: these dots carry LLRs, which TF32 would
            # otherwise round
            flat = c2v_data.reshape(K, r * Dc, S)
            totals = jnp.einsum(
                "vk,bks->bvs", Mj, flat, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            posterior_d = data_llr[:, :, None] + totals  # (K, n, S)
            back = jnp.einsum(
                "kv,bvs->bks", Gj, posterior_d, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            v2c_data_new = jnp.where(
                mask4, back.reshape(K, r, Dc, S) - c2v_data, _BIG
            )

            # halo 2: next device's first check block's "previous-round" c2v
            # feeds the last local measurement variable
            next_c2v = jax.lax.ppermute(c2v_ext[0, :, Dc, :], MODEL_AXIS, bwd)
            c2m_lo = c2v_ext[:, :, Dc + 1, :]  # (K, r, S) from block j
            c2m_hi = jnp.concatenate(
                [c2v_ext[1:, :, Dc, :], next_c2v[None]], axis=0
            )  # from block j+1
            posterior_m = jnp.where(
                valid_m > 0, meas_llr[:, :, None] + c2m_lo + c2m_hi, _BIG
            )
            v2c_mlo_new = jnp.where(valid_m > 0, posterior_m - c2m_lo, _BIG)
            v2c_mhi_new = jnp.where(valid_m > 0, posterior_m - c2m_hi, _BIG)
            return (
                (v2c_data_new, v2c_mlo_new, v2c_mhi_new),
                (posterior_d, posterior_m),
            )

        pd0 = jnp.broadcast_to(data_llr[:, :, None], (K, n, S))
        pm0 = jnp.broadcast_to(m0, (K, r, S))
        # the loop body is data-axis-varying (syndromes shard over shots);
        # mark the prior-derived initial carries to match
        carry0 = jax.lax.pcast(
            ((v2c_data0, v2c_mlo0, v2c_mhi0), (pd0, pm0)),
            (DATA_AXIS,), to="varying",
        )
        _msgs, (posterior_d, posterior_m) = jax.lax.fori_loop(
            0, max_iter, fbody, carry0
        )

        # spacetime parity of the hard decision vs the syndrome (local
        # blocks; one boolean all-reduce at the end)
        hard_d = (posterior_d <= 0).astype(jnp.float32)
        hard_m = (posterior_m <= 0).astype(jnp.int32)
        counts = jnp.einsum(
            "cv,bvs->bcs", Hdj, hard_d, preferred_element_type=jnp.float32
        )
        data_par = (counts - 2.0 * jnp.floor(counts * 0.5) > 0.5).astype(jnp.int32)
        prev_m = jax.lax.ppermute(hard_m[-1], MODEL_AXIS, fwd)
        prev_m = jnp.where(didx == 0, 0, prev_m)
        m_prev = jnp.concatenate([prev_m[None], hard_m[:-1]], axis=0)
        par = (data_par + m_prev + hard_m) % 2
        bad = jnp.sum(
            jnp.abs(par - synd.astype(jnp.int32)).astype(jnp.float32), axis=(0, 1)
        )
        bad = jax.lax.psum(bad, MODEL_AXIS)  # (S,) replicated over model
        conv = bad == 0
        return posterior_d, posterior_m, conv

    shard = partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(MODEL_AXIS, None, DATA_AXIS),
            P(MODEL_AXIS, None),
            P(MODEL_AXIS, None),
            P(MODEL_AXIS, None, None),
        ),
        out_specs=(
            P(MODEL_AXIS, None, DATA_AXIS),
            P(MODEL_AXIS, None, DATA_AXIS),
            P(DATA_AXIS),
        ),
    )
    return jax.jit(shard(local_decode))


@dataclass
class RoundsShardedSpacetimeBP:
    """Fixed-iteration spacetime BP with round blocks sharded over
    ``MODEL_AXIS`` and shots over ``DATA_AXIS``.

    Same inputs/outputs as :class:`~exp_ldpc_tpu.decoders.spacetime_bp.
    SpacetimeBPDecoder` with ``early_stop=False``: ``decode_batch`` takes
    (S, (R+1)·r) syndromes in SpacetimeCode row order and returns
    (hard (S, Vst), posterior (S, Vst), converged (S,), iters (S,))."""

    tanner: TannerELL
    num_rounds: int
    prior_llr: np.ndarray  # (B*n + R*r,) spacetime column order
    mesh: Mesh
    method: str = "ms"
    max_iter: int = 32
    ms_scaling_factor: float = 0.0

    def __post_init__(self):
        method = {"ps": "ps", "psl": "ps", "ms": "ms", "msl": "ms"}.get(self.method)
        if method is None:
            raise ValueError(f"unknown bp method {self.method!r}")
        object.__setattr__(self, "method", method)
        D = self.mesh.shape[MODEL_AXIS]
        B = self.num_rounds + 1
        self._B_pad = ((B + D - 1) // D) * D
        self._fn = _stbp_rounds_sharded(
            self.tanner, self.num_rounds, self.mesh, self.method,
            self.max_iter, float(self.ms_scaling_factor),
        )

    @classmethod
    def from_check_matrix(
        cls,
        H,
        num_rounds: int,
        mesh: Mesh,
        *,
        error_rate: Optional[float] = None,
        channel_probs: Optional[np.ndarray] = None,
        max_iter: int = 32,
        bp_method: str = "ms",
        ms_scaling_factor: float = 0.0,
        **_ignored,
    ) -> "RoundsShardedSpacetimeBP":
        tanner = TannerELL.from_check_matrix(H)
        B = num_rounds + 1
        Vst = B * tanner.num_vars + num_rounds * tanner.num_checks
        if channel_probs is not None:
            prior = np.asarray(channel_probs, dtype=np.float64)
            if prior.shape[0] != Vst:
                raise ValueError(f"channel_probs must have {Vst} entries")
        elif error_rate is not None:
            prior = np.full(Vst, error_rate, dtype=np.float64)
        else:
            raise ValueError("must supply error_rate or channel_probs")
        return cls(
            tanner=tanner,
            num_rounds=num_rounds,
            prior_llr=priors_to_llr(prior),
            mesh=mesh,
            method=bp_method,
            max_iter=max_iter,
            ms_scaling_factor=float(ms_scaling_factor),
        )

    def decode_batch(self, syndromes: np.ndarray):
        r, n = self.tanner.num_checks, self.tanner.num_vars
        R, B, Bp = self.num_rounds, self.num_rounds + 1, self._B_pad
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        S = syndromes.shape[0]
        d_shots = self.mesh.shape[DATA_AXIS]
        if S % d_shots != 0:
            raise ValueError(f"shot count {S} not divisible by data axis {d_shots}")

        synd = np.zeros((Bp, r, S), np.uint8)
        synd[:B] = syndromes.T.reshape(B, r, S)
        data_llr = np.full((Bp, n), _BIG, np.float32)
        data_llr[:B] = self.prior_llr[: B * n].reshape(B, n)
        meas_llr = np.full((Bp, r), _BIG, np.float32)
        meas_llr[:R] = self.prior_llr[B * n :].reshape(R, r)
        valid_m = np.zeros((Bp, 1, 1), np.float32)
        valid_m[:R] = 1.0

        put = lambda x, spec: jax.device_put(x, NamedSharding(self.mesh, spec))
        pd, pm, conv = self._fn(
            put(synd, P(MODEL_AXIS, None, DATA_AXIS)),
            put(data_llr, P(MODEL_AXIS, None)),
            put(meas_llr, P(MODEL_AXIS, None)),
            put(valid_m, P(MODEL_AXIS, None, None)),
        )
        pd = np.asarray(pd)[:B].reshape(B * n, S)
        pm = np.asarray(pm)[:R].reshape(R * r, S)
        posterior = np.concatenate([pd, pm], axis=0)
        hard = (posterior <= 0).astype(np.uint8)
        iters = np.full((S,), self.max_iter, np.int32)
        return hard.T, posterior.T, np.asarray(conv), iters
