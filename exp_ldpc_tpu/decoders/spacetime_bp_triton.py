"""Fixed-iteration structured spacetime BP as one Pallas-Triton kernel.

The GPU form of :func:`~exp_ldpc_tpu.decoders.spacetime_bp._stbp_core` with
``early_stop=False`` and f32 messages: the same flooding math, in one
launch for all iterations instead of several XLA launches per iteration
(XLA does not fuse across ``fori_loop`` iterations, so the XLA core streams
the (B, r, Dc+2, S) message tensor through device memory every pass).

One program per block of ``sb`` shots runs every iteration.  Per round
block b it loads the check-major v2c plane (r_pad, D, sb) and the two
measurement-edge slots, does the check update in registers, routes c2v to
the variables through the base code's static gather table (``vm_from_cm``)
via a per-program scratch in global memory, and routes the posteriors back
to the edges through ``chk_vars``.  The degree-2 measurement variables are
updated in closed form after all round blocks.  Each program touches only
its own shot columns, so blocks need no order.  Hard decisions and
convergence are computed by XLA from the returned posteriors.

Tile shapes are powers of two (r_pad, D, n_pad); :func:`fits_stbp_triton`
keeps the kernel to base codes whose tiles fit the registers of a block,
the regime it was measured in (HGP-225; ``PERF.md``).  ``interpret=True``
runs it on the CPU, for tests only.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["fits_stbp_triton", "stbp_triton_fixed"]

_BIG = 1e30
_PHI_LO, _PHI_HI = 1e-7, 30.0  # decoders/bp.py's phi clamp
# shots per program and warps per program: the fastest of (16, 4), (32, 4)
# and (16, 8) on an H100 at HGP-225 x 4 rounds (PERF.md)
SHOT_BLOCK = 16
NUM_WARPS = 8
# largest check-major tile (r_pad * D) and variable tile (n_pad) measured
_MAX_EDGE_TILE = 1024
_MAX_VAR_TILE = 512


def _p2(x):
    return 1 << max(0, int(x - 1).bit_length())


def fits_stbp_triton(tanner) -> bool:
    """True when the base code's padded tiles are within the measured
    regime (larger tiles spill a block's registers)."""
    return (_p2(tanner.num_checks) * _p2(tanner.max_check_degree) <= _MAX_EDGE_TILE
            and _p2(tanner.num_vars) <= _MAX_VAR_TILE)


def _tables(tanner):
    r, n, Dc = tanner.num_checks, tanner.num_vars, tanner.max_check_degree
    r_pad, n_pad, D = _p2(r), _p2(n), _p2(Dc)
    chk_vars = np.asarray(tanner.chk_vars)
    chk_mask = np.asarray(tanner.chk_mask)
    cv = np.zeros((r_pad, D), np.int32)
    cm = np.zeros((r_pad, D), np.int32)
    cv[:r, :Dc] = np.where(chk_mask, chk_vars, 0)
    cm[:r, :Dc] = chk_mask
    # var-major slots -> (check, slot) of the same edge
    vm = np.asarray(tanner.vm_from_cm)  # (n, Dv) flat c*Dc+i, pad = r*Dc
    Dv = vm.shape[1]
    vchk = np.zeros((n_pad, Dv), np.int32)
    vslot = np.zeros((n_pad, Dv), np.int32)
    vval = np.zeros((n_pad, Dv), np.int32)
    real = vm < r * Dc
    vchk[:n] = np.where(real, vm // Dc, 0)
    vslot[:n] = np.where(real, vm % Dc, 0)
    vval[:n] = real
    return dict(r_pad=r_pad, n_pad=n_pad, D=D, Dv=Dv, cv=cv, cm=cm,
                vchk=vchk, vslot=vslot, vval=vval)


def _phi(x):
    x = jnp.clip(x, _PHI_LO, _PHI_HI)
    return -jnp.log(jnp.tanh(x * 0.5))


def _kernel(cv_ref, cm_ref, vchk_ref, vslot_ref, vval_ref, dllr_ref, mllr_ref,
            synd_ref, v2c_ref, vlo_ref, vhi_ref, c2v_ref, clo_ref, chi_ref,
            postd_ref, postm_ref, *, B, R, r_pad, n_pad, D, Dv, sb, method,
            max_iter, msf, barrier):
    s0 = pl.program_id(0) * sb
    cols = pl.ds(s0, sb)
    sidx = s0 + jax.lax.broadcasted_iota(jnp.int32, (sb,), 0)
    sync = plgpu.debug_barrier if barrier else (lambda: None)
    cv = cv_ref[...]
    cmask = cm_ref[...] > 0  # (r_pad, D)

    # init: edge priors (BIG on padded slots), measurement priors
    def init_b(b, carry):
        dl = plgpu.load(dllr_ref.at[b, cv])  # (r_pad, D)
        e = jnp.where(cmask, dl, _BIG)
        v2c_ref[b, :, :, cols] = jnp.broadcast_to(e[:, :, None], (r_pad, D, sb))
        return carry

    jax.lax.fori_loop(0, B, init_b, None)

    def init_m(m, carry):
        ml = mllr_ref[m, :]
        v = jnp.broadcast_to(ml[:, None], (r_pad, sb))
        vlo_ref[m, :, cols] = v
        vhi_ref[m, :, cols] = v
        return carry

    jax.lax.fori_loop(0, R, init_m, None)
    sync()

    def iteration(it, carry):
        if msf == 0.0:
            alpha = 1.0 - jnp.exp2(-(it + 1).astype(jnp.float32))
        else:
            alpha = jnp.float32(msf)

        def block(b, carry):
            v = v2c_ref[b, :, :, cols]  # (r_pad, D, sb)
            prev = jnp.where(b > 0, vhi_ref[jnp.maximum(b - 1, 0), :, cols], _BIG)
            nxt = jnp.where(b < R, vlo_ref[jnp.minimum(b, R - 1), :, cols], _BIG)
            ss = 1.0 - 2.0 * synd_ref[b, :, cols].astype(jnp.float32)  # (r_pad, sb)
            neg = (jnp.sum((v < 0).astype(jnp.int32), axis=1)
                   + (prev < 0).astype(jnp.int32) + (nxt < 0).astype(jnp.int32))
            tsign = jnp.where(neg % 2 == 1, -1.0, 1.0) * ss
            sgn = jnp.where(v < 0, -1.0, 1.0)
            sgp = jnp.where(prev < 0, -1.0, 1.0)
            sgx = jnp.where(nxt < 0, -1.0, 1.0)
            mag, magp, magx = jnp.abs(v), jnp.abs(prev), jnp.abs(nxt)
            if method == "ps":
                ph, php, phx = _phi(mag), _phi(magp), _phi(magx)
                tot = jnp.sum(ph, axis=1) + php + phx
                out = (tsign[:, None, :] * sgn) * _phi(tot[:, None, :] - ph)
                outp = (tsign * sgp) * _phi(tot - php)
                outx = (tsign * sgx) * _phi(tot - phx)
            else:
                m1 = jnp.minimum(jnp.min(mag, axis=1), jnp.minimum(magp, magx))
                cnt = (jnp.sum((mag == m1[:, None, :]).astype(jnp.int32), axis=1)
                       + (magp == m1).astype(jnp.int32) + (magx == m1).astype(jnp.int32))
                gt = jnp.minimum(
                    jnp.min(jnp.where(mag > m1[:, None, :], mag, _BIG), axis=1),
                    jnp.minimum(jnp.where(magp > m1, magp, _BIG),
                                jnp.where(magx > m1, magx, _BIG)))
                m2 = jnp.where(cnt >= 2, m1, gt)
                ext = jnp.where(mag == m1[:, None, :], m2[:, None, :], m1[:, None, :])
                out = (tsign[:, None, :] * sgn) * ext * alpha
                outp = (tsign * sgp) * jnp.where(magp == m1, m2, m1) * alpha
                outx = (tsign * sgx) * jnp.where(magx == m1, m2, m1) * alpha
            c2v_ref[:, :, cols] = out
            chi_ref[b, :, cols] = outp  # from check (b, c) to m_{b-1}
            clo_ref[b, :, cols] = outx  # from check (b, c) to m_b
            sync()
            tot_v = jnp.zeros((n_pad, sb), jnp.float32)
            for j in range(Dv):
                g = plgpu.load(c2v_ref.at[vchk_ref[:, j][:, None],
                                          vslot_ref[:, j][:, None], sidx[None, :]])
                tot_v = tot_v + jnp.where(vval_ref[:, j][:, None] > 0, g, 0.0)
            post = dllr_ref[b, :][:, None] + tot_v
            postd_ref[b, :, cols] = post
            sync()
            back = plgpu.load(postd_ref.at[b, cv[:, :, None], sidx[None, None, :]])
            v2c_ref[b, :, :, cols] = jnp.where(cmask[:, :, None], back - out, _BIG)
            sync()
            return carry

        jax.lax.fori_loop(0, B, block, None)

        def meas(m, carry):
            lo = clo_ref[m, :, cols]
            hi = chi_ref[m + 1, :, cols]
            pm = mllr_ref[m, :][:, None] + lo + hi
            postm_ref[m, :, cols] = pm
            vlo_ref[m, :, cols] = pm - lo
            vhi_ref[m, :, cols] = pm - hi
            return carry

        jax.lax.fori_loop(0, R, meas, None)
        sync()
        return carry

    jax.lax.fori_loop(0, max_iter, iteration, None)


@partial(jax.jit, static_argnames=("tanner", "num_rounds", "method", "max_iter",
                                   "msf", "interpret"))
def stbp_triton_fixed(tanner, num_rounds, prior_llr_st, syndromes, method,
                      max_iter, msf, interpret=False):
    """Same contract as ``_stbp_core(..., early_stop=False)``: syndromes
    (B*r, S) -> (hard (Vst, S) uint8, posterior (Vst, S), conv (S,), iters).
    ``method`` is "ms" or "ps"; ``msf`` a static min-sum scaling factor (0
    selects the adaptive schedule).  S need not be a multiple of the shot
    block."""
    sb = SHOT_BLOCK
    t = _tables(tanner)
    r, n = tanner.num_checks, tanner.num_vars
    R, B = num_rounds, num_rounds + 1
    r_pad, n_pad, D, Dv = t["r_pad"], t["n_pad"], t["D"], t["Dv"]
    S = syndromes.shape[1]
    S_pad = -(-S // sb) * sb
    Rm = max(R, 1)
    dllr = jnp.zeros((B, n_pad), jnp.float32).at[:, :n].set(
        prior_llr_st[: B * n].reshape(B, n))
    mllr = jnp.full((Rm, r_pad), _BIG, jnp.float32)
    if R:
        mllr = mllr.at[:, :r].set(prior_llr_st[B * n:].reshape(R, r))
    synd = jnp.zeros((B, r_pad, S_pad), jnp.uint8).at[:, :r, :S].set(
        syndromes.reshape(B, r, S))
    f32 = jnp.float32
    out_shape = (
        jax.ShapeDtypeStruct((B, r_pad, D, S_pad), f32),   # v2c
        jax.ShapeDtypeStruct((Rm, r_pad, S_pad), f32),     # v2c to m (lo)
        jax.ShapeDtypeStruct((Rm, r_pad, S_pad), f32),     # v2c to m (hi)
        jax.ShapeDtypeStruct((r_pad, D, S_pad), f32),      # c2v scratch
        jax.ShapeDtypeStruct((B, r_pad, S_pad), f32),      # c2m lo
        jax.ShapeDtypeStruct((B + 1, r_pad, S_pad), f32),  # c2m hi
        jax.ShapeDtypeStruct((B, n_pad, S_pad), f32),      # data posterior
        jax.ShapeDtypeStruct((Rm, r_pad, S_pad), f32),     # meas posterior
    )
    kern = partial(_kernel, B=B, R=R, r_pad=r_pad, n_pad=n_pad, D=D, Dv=Dv,
                   sb=sb, method=method, max_iter=max_iter, msf=float(msf),
                   barrier=not interpret)
    outs = pl.pallas_call(
        kern, out_shape=out_shape, grid=(S_pad // sb,),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret, name="stbp_triton",
    )(jnp.asarray(t["cv"]), jnp.asarray(t["cm"]), jnp.asarray(t["vchk"]),
      jnp.asarray(t["vslot"]), jnp.asarray(t["vval"]), dllr, mllr, synd)
    pd = outs[6][:, :n, :S]
    pm = outs[7][:R, :r, :S]
    posterior = jnp.concatenate([pd.reshape(B * n, S), pm.reshape(R * r, S)], 0)
    hard = (posterior <= 0).astype(jnp.uint8)
    hd = (pd <= 0).astype(jnp.int32)
    hm = (pm <= 0).astype(jnp.int32)
    chk_vars = np.asarray(tanner.chk_vars)
    bits = jnp.where(jnp.asarray(tanner.chk_mask)[None, :, :, None], hd[:, chk_vars], 0)
    par = jnp.sum(bits, axis=2)
    z = jnp.zeros((1, r, S), jnp.int32)
    par = (par + jnp.concatenate([z, hm], 0) + jnp.concatenate([hm, z], 0)) % 2
    conv = jnp.all(par == syndromes.reshape(B, r, S).astype(jnp.int32), axis=(0, 1))
    return hard, posterior, conv, jnp.full((S,), max_iter, jnp.int32)
