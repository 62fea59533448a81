"""Fully-fused on-device Monte-Carlo pipeline, sharded over a mesh.

One jitted SPMD program per sweep point: per device shard — sample the
storage circuit, build differenced spacetime syndromes, run batched BP,
apply the final-round correction, test the logicals — then ``psum`` the
failure count over the data axis.  This is the device-native replacement for
the reference's fork-a-Pool-of-CPU-workers outer loop
(``/root/reference/python/qldpc/misc/p_sweep.py:17-29``): the only
host<->device traffic per point is one PRNG key in and two scalars out.

Shots whose BP did not converge can optionally be returned for host-side
OSD post-processing (the BP+OSD statistical contract — OSD touches only the
few BP failures, SURVEY.md §7).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scipy import sparse

from ..circuits.ir import ParsedCircuit, parse_circuit
from ..circuits.storage_sim import build_storage_simulation
from ..core import QuantumCode
from ..decoders.bp import _bp_core, dense_ops_device, priors_to_llr, resolve_use_matmul
from ..decoders.select import bp_backend
from ..decoders.spacetime_bp import _stbp_core
from ..decoders.spacetime_bp_triton import fits_stbp_triton, stbp_triton_fixed
from ..decoders.spacetime import SpacetimeCode
from ..decoders.tanner import TannerELL
from ..sampler.device import build_record_sampler
from ..utils.compile_cache import enable_compilation_cache
from .mesh import DATA_AXIS

__all__ = ["StorageDecodePipeline"]


@dataclass(eq=False)
class StorageDecodePipeline:
    """End-to-end sample+decode step for a storage experiment.

    Parameters mirror ``run_simulation`` (``misc/_experiment.py:154-210``)
    restricted to the device-resident bposd path (plain BP on the spacetime
    matrix; OSD fallback data is returned to the host).
    """

    code: QuantumCode
    rounds: int
    noise_model: object  # NoiseRewriter
    data_prior: float
    meas_prior: float
    shots_per_device: int
    max_iter: int = 40
    bp_method: str = "ps"
    ms_scaling_factor: float = 0.0
    mesh: Optional[Mesh] = None
    # fixed-iteration flooding by default: identical statistics at relevant
    # iteration budgets, much cheaper XLA compile than the early-stop
    # while_loop (which pays a per-iteration syndrome check)
    early_stop: bool = False
    # "bfloat16" halves the message bytes of the bandwidth-bound spacetime
    # check update, statistically LER-neutral for min-sum
    msg_dtype: str = "float32"
    # > 0: the device step additionally ships (up to cap per device) the
    # syndromes+readouts of BP-unconverged shots to the host, where a full
    # BP+OSD decode replaces their plain-BP correction (the reference bposd
    # statistical contract: OSD touches exactly the BP failures,
    # ``misc/_experiment.py:62-83``).  Use :meth:`run_bposd`.
    osd_fallback_cap: int = 0
    osd_options: Optional[dict] = None
    # X-basis memory experiment: prepare/read |+>, decode the X-check
    # history with checks.x / logicals.x (reference surface
    # ``storage_sim.py:110-118``; its drivers hardcode Z)
    use_x_logicals: bool = False
    # decode contract, mirroring the reference's three bposd modes
    # (``misc/_experiment.py:12-126``), each fully fused on device:
    #   "bposd"             — BP on the whole spacetime matrix
    #   "bposd_single_shot" — per-round (H|I) BP inside a lax.scan with the
    #                         accumulated-correction recurrence, then a
    #                         clean final-round BP (the reference runs this
    #                         loop on the HOST with one device round-trip
    #                         per round)
    #   "bposd_hybrid"      — spacetime BP + final-round BP
    # In every mode, shots with ANY unconverged BP stage are shipped to the
    # host where the matching BP+OSD driver redecodes them (the OSD-only-
    # on-BP-failures contract).
    mode: str = "bposd"
    # > 0: TWO-TIER adaptive decode for mode "bposd" (VERDICT r4 item 2).
    # Stage 1 runs every shot at tier1_iters; the (few) unconverged shots
    # are compacted to a fixed-size block of tier2_cap and redecoded from
    # scratch at max_iter.  At campaign p-values most shots converge in
    # well under max_iter iterations, so this converts the fixed-iteration
    # benchmark discipline into real campaign throughput while keeping
    # every shape static (two compiled programs per sweep, not a dynamic
    # loop).  A redecode-from-scratch at max_iter reproduces exactly what
    # a per-shot-frozen early-stop decode would have produced for those
    # shots (same deterministic trajectory), so the statistics match the
    # reference's early-exit ldpc semantics (``misc/_experiment.py:213``)
    # up to tier2_cap overflow — overflow shots keep their stage-1 result
    # and are reported unconverged (-> OSD under run_bposd, exactly like
    # any other BP failure).
    tier1_iters: int = 0
    tier2_cap: Optional[int] = None

    def __post_init__(self):
        devices = self.mesh.devices.flat if self.mesh is not None else None
        backend = bp_backend(devices)
        enable_compilation_cache()
        code = self.code
        sim = build_storage_simulation(
            self.rounds, self.noise_model, code,
            use_x_logicals=self.use_x_logicals)
        self.storage_sim = sim
        self.parsed = parse_circuit(sim.circuit)
        self.x_count = code.checks.x.shape[0]
        self.z_count = code.checks.z.shape[0]
        self.num_data = code.num_qubits
        checks_sector = code.checks.x if self.use_x_logicals else code.checks.z
        self._sector_logicals = (
            code.logicals.x if self.use_x_logicals else code.logicals.z)

        self.spacetime = SpacetimeCode(checks_sector, self.rounds)
        # structured spacetime BP (decoders/spacetime_bp.py): per-round
        # batched routing on the BASE code's Tanner graph — (rounds+1)x fewer
        # FLOPs than generic BP on the stacked spacetime matrix
        self.tanner = TannerELL.from_check_matrix(checks_sector)
        # the spacetime-BP stage runs the Triton kernel where the platform
        # decision picks it and the stage is fixed-iteration f32 on a base
        # code the kernel fits; else the XLA core
        self._kernel = (backend == "triton" and not self.early_stop
                        and self.msg_dtype == "float32"
                        and fits_stbp_triton(self.tanner))
        prior = np.zeros(self.spacetime.spacetime_check_matrix.shape[1])
        prior[: self.spacetime._datablock_size] = self.data_prior
        prior[self.spacetime._datablock_size:] = self.meas_prior
        self.prior_llr = priors_to_llr(prior)

        # 0/1 operands of the parity products below (syndromes, corrections,
        # logical flips): 0/1 times 0/1 summed in f32 is exact even where the
        # GPU runs f32 dots in TF32, so they take the default precision
        self._Hz = jnp.asarray(checks_sector.toarray(), dtype=jnp.float32)  # (r, n)
        self._Lz = jnp.asarray(self._sector_logicals, dtype=jnp.float32)  # (k, n)

        # dense one-hot BP operands as runtime args: multi-MB HLO constants
        # slow compiles down and are baked into every executable
        if resolve_use_matmul(self.tanner, "auto"):
            self._dense_ops = dense_ops_device(self.tanner)
        else:
            self._dense_ops = None

        if self.mode not in ("bposd", "bposd_single_shot", "bposd_hybrid"):
            raise ValueError(f"unknown pipeline mode {self.mode!r}")
        self.tanner_ss = None
        self._dense_ss = None
        if self.mode == "bposd_single_shot":
            # per-round decode matrix (H|I): measurement-error columns as an
            # identity block (reference ``spacetime_code.py:10-37``)
            r_sector = checks_sector.shape[0]
            H_ss = sparse.hstack(
                [checks_sector,
                 sparse.identity(r_sector, dtype=np.uint8, format="csr")]
            ).tocsr()
            self.tanner_ss = TannerELL.from_check_matrix(H_ss)
            if resolve_use_matmul(self.tanner_ss, "auto"):
                self._dense_ss = dense_ops_device(self.tanner_ss)

        # runtime-rebindable parameters: noise probabilities + BP priors.
        # One compile serves a whole p sweep (see rebind_noise)
        self._noise_args = jnp.asarray(self.parsed.noise_args())
        self._prior = self._prior_tree()

        if self.tier1_iters > 0:
            if self.mode != "bposd":
                raise ValueError("tier1_iters applies to mode='bposd' only")
            if self.early_stop:
                raise ValueError("tier1_iters requires early_stop=False "
                                 "(two fixed-shape passes)")
            if self.tier2_cap is None:
                self.tier2_cap = max(128, self.shots_per_device // 4)
            self.tier2_cap = min(self.tier2_cap, self.shots_per_device)

        self._osd = None
        if self.osd_fallback_cap > 0:
            if self.osd_fallback_cap > self.shots_per_device:
                raise ValueError("osd_fallback_cap exceeds shots_per_device")
            self._osd = self._build_osd_corrector()

        self._step = self._build()

    def _prior_tree(self):
        """The runtime prior arguments for the current mode (a pytree)."""
        if self.mode == "bposd":
            return (jnp.asarray(self.prior_llr),)
        final = priors_to_llr(np.full(self.num_data, self.data_prior))
        if self.mode == "bposd_hybrid":
            return (jnp.asarray(self.prior_llr), jnp.asarray(final))
        r_sector = self.tanner_ss.num_vars - self.num_data
        ss = priors_to_llr(np.concatenate([
            np.full(self.num_data, self.data_prior),
            np.full(r_sector, self.meas_prior),
        ]))
        return (jnp.asarray(ss), jnp.asarray(final))

    def _dense_tree(self):
        if self.mode == "bposd_single_shot":
            return (self._dense_ss, self._dense_ops)
        return (self._dense_ops, self._dense_ops)

    def _build_osd_corrector(self):
        from ..decoders.drivers import (
            BPOSDCorrect,
            BPOSDCorrectSingleShot,
            BPOSDHybridCorrect,
        )

        opts = dict(self.osd_options or {})
        opts.setdefault("max_iter", self.max_iter)
        opts.setdefault("bp_method", self.bp_method)
        opts.setdefault("ms_scaling_factor", self.ms_scaling_factor)
        cls = {
            "bposd": BPOSDCorrect,
            "bposd_single_shot": BPOSDCorrectSingleShot,
            "bposd_hybrid": BPOSDHybridCorrect,
        }[self.mode]
        return cls(self.code, self.rounds, opts,
                   (self.data_prior, self.meas_prior),
                   basis="x" if self.use_x_logicals else "z")

    def _device_step(self, key, dense_ops, noise_args, prior_llr):
        """Single-shard step: key -> (failures, shots, bp_unconverged)."""
        S = self.shots_per_device
        sample = build_record_sampler(self.parsed, S, parametric=True)
        record = sample(key, noise_args).astype(jnp.float32)  # (S, M)
        return self._decode_records(record, dense_ops, prior_llr)

    def _decode_records(self, record, dense_ops, prior_llr):
        """Shared decode path: (S, M) record -> (failures, shots, unconv)."""
        S = record.shape[0]
        rounds = self.rounds
        r = self.x_count if self.use_x_logicals else self.z_count
        mpr = self.x_count + self.z_count
        # per-round memory-basis syndromes + final syndrome from transversal
        # readout (record layout per round: [x_checks..., z_checks...])
        blk = 0 if self.use_x_logicals else self.x_count
        readout = record[:, mpr * rounds : mpr * rounds + self.num_data]
        if rounds > 0:
            per_round = record[:, : mpr * rounds].reshape(S, rounds, mpr)
            history = per_round[:, :, blk : blk + r]  # (S, rounds, r)
        else:
            history = jnp.zeros((S, 0, r), dtype=jnp.float32)
        n = self.num_data
        msf = jnp.float32(self.ms_scaling_factor)

        if self.mode == "bposd_single_shot":
            # the reference runs this recurrence on the HOST with one
            # device round-trip and two numpy matmuls per round
            # (``misc/_experiment.py:43-60``); here the whole rounds loop is
            # a lax.scan inside the one fused program
            prior_ss, prior_final = prior_llr
            dense_ss, dense_final = dense_ops
            HzT = self._Hz.T  # (n, r)

            def body(carry, hist_t):
                acc, bad = carry
                corr = jnp.mod(acc @ HzT, 2.0)
                s_t = jnp.mod(corr + hist_t, 2.0).astype(jnp.uint8)
                hard_t, _p, conv_t, _i = _bp_core(
                    self.tanner_ss, prior_ss, s_t.T, self.bp_method,
                    self.max_iter, msf, self.early_stop, "auto", dense_ss)
                acc = jnp.mod(acc + hard_t.T[:, :n].astype(jnp.float32), 2.0)
                return (acc, bad | ~conv_t), None

            init = (jnp.zeros((S, n), jnp.float32), jnp.zeros((S,), bool))
            (acc, bad), _ = jax.lax.scan(body, init, history.transpose(1, 0, 2))
            readout2 = jnp.mod(readout + acc, 2.0)
            synd_f = jnp.mod(readout2 @ HzT, 2.0).astype(jnp.uint8)
            hard_f, _p, conv_f, _i = _bp_core(
                self.tanner, prior_final, synd_f.T, self.bp_method,
                self.max_iter, msf, self.early_stop, "auto", dense_final)
            ship = bad | ~conv_f
            correction = jnp.mod(hard_f.T.astype(jnp.float32) + acc, 2.0)
        else:
            # spacetime-BP stage (modes "bposd" and "bposd_hybrid")
            prior_main = prior_llr[0]
            method = {"ps": "ps", "psl": "ps", "ms": "ms", "msl": "ms"}[self.bp_method]
            dense_main = dense_ops[0]
            final = jnp.mod(readout @ self._Hz.T, 2.0)  # (S, r)
            synd = jnp.concatenate([history, final[:, None, :]], axis=1)
            synd = jnp.concatenate(
                [synd[:, :1], jnp.mod(synd[:, 1:] + synd[:, :-1], 2.0)], axis=1
            )
            synd = synd.reshape(S, (rounds + 1) * r).astype(jnp.uint8)

            def run_stbp(s_in, n_iter):
                """(S', Bst*r) syndromes -> (hard (S', Vst), conv (S',))."""
                if self._kernel:
                    h, _p, c, _i = stbp_triton_fixed(
                        self.tanner, rounds, prior_main, s_in.T, method,
                        n_iter, float(self.ms_scaling_factor))
                    return h.T, c
                h, _p, c, _i = _stbp_core(
                    self.tanner, rounds, prior_main, s_in.T,
                    self.bp_method, n_iter, msf, self.early_stop,
                    "auto", dense_main, self.msg_dtype)
                return h.T, c

            hard, conv = run_stbp(synd, self.max_iter if self.tier1_iters <= 0
                                  else self.tier1_iters)
            if self.tier1_iters > 0:
                # stage 2: compact the unconverged shots to a fixed-size
                # block and redecode from scratch at the full budget
                cap2 = self.tier2_cap
                order2 = jnp.argsort(conv.astype(jnp.int32),
                                     stable=True)[:cap2]
                hard2, conv2 = run_stbp(synd[order2], self.max_iter)
                take = ~conv[order2]
                hard = hard.at[order2].set(
                    jnp.where(take[:, None], hard2, hard[order2]))
                conv = conv.at[order2].set(conv[order2] | conv2)
            # mod-2 sum of the per-round data blocks
            data_blocks = hard[:, : (rounds + 1) * n].reshape(S, rounds + 1, n)
            bp_corr = jnp.mod(jnp.sum(data_blocks, axis=1), 2).astype(jnp.float32)
            if self.mode == "bposd":
                correction = bp_corr
                ship = ~conv
            else:
                # hybrid: clean final-round BP on top of the plain spacetime
                # BP (``misc/_experiment.py:115-126``); only the final
                # round's BP carries the OSD fallback in the reference
                prior_final = prior_llr[1]
                dense_final = dense_ops[1]
                readout2 = jnp.mod(readout + bp_corr, 2.0)
                synd_f = jnp.mod(readout2 @ self._Hz.T, 2.0).astype(jnp.uint8)
                hard_f, _p, conv_f, _i = _bp_core(
                    self.tanner, prior_final, synd_f.T, self.bp_method,
                    self.max_iter, msf, self.early_stop, "auto", dense_final)
                correction = jnp.mod(hard_f.T.astype(jnp.float32) + bp_corr, 2.0)
                ship = ~conv_f

        corrected = jnp.mod(readout + correction, 2.0)
        flips = jnp.mod(corrected @ self._Lz.T, 2.0)  # (S, k)
        failed = jnp.any(flips > 0.5, axis=1)
        unconv = jnp.sum(ship.astype(jnp.int32))
        if self.osd_fallback_cap <= 0:
            return (jnp.sum(failed.astype(jnp.int32)), jnp.int32(S), unconv)
        # count device-BP failures among the shots we keep; compact the
        # shipped shots to the front and send their raw history+readout to
        # the host, where the matching BP+OSD driver redecodes them
        cap = self.osd_fallback_cap
        f_conv = jnp.sum((failed & ~ship).astype(jnp.int32))
        order = jnp.argsort((~ship).astype(jnp.int32), stable=True)[:cap]
        return (
            f_conv,
            jnp.int32(S),
            unconv,
            history[order],
            readout[order],
            ship[order],
        )

    def _build(self):
        """Jit the step; sets ``self._jitted`` and ``self._step_args`` (key
        -> the jitted function's arguments) and returns key -> outputs."""
        dense = self._dense_tree()
        fallback = self.osd_fallback_cap > 0
        if self.mesh is None:
            self._jitted = jax.jit(self._device_step)
            self._step_args = lambda key: (
                key, dense, self._noise_args, self._prior)
        else:
            mesh = self.mesh

            def sharded(keys, dense_ops, noise_args, prior_llr):
                out = self._device_step(keys[0], dense_ops, noise_args, prior_llr)
                f = jax.lax.psum(out[0], DATA_AXIS)
                s = jax.lax.psum(out[1], DATA_AXIS)
                u = jax.lax.psum(out[2], DATA_AXIS)
                return (f, s, u) + out[3:]

            # check_vma=False: the BP while_loop carry starts from unvarying
            # constants (priors) and becomes data-varying inside the loop,
            # which the varying-manual-axes checker rejects; the computation
            # is still correctly per-shard SPMD.
            out_specs = ((P(), P(), P()) + (P(DATA_AXIS),) * 3) if fallback else P()
            mapped = jax.shard_map(
                sharded,
                mesh=mesh,
                in_specs=(P(DATA_AXIS), P(), P(), P()),
                out_specs=out_specs,
                check_vma=False,
            )  # dense/prior pytrees ride the unsharded P() specs
            self._jitted = jax.jit(mapped)
            n_data = mesh.shape[DATA_AXIS]
            self._step_args = lambda key: (
                jax.random.split(key, n_data), dense, self._noise_args,
                self._prior)

        def run(key):
            out = self._jitted(*self._step_args(key))
            return tuple(int(x) for x in out[:3]) + tuple(out[3:])

        return run

    def memory_analysis(self):
        """``compiled.memory_analysis()`` of the jitted sample+decode step
        (lowers and compiles it again; the compile caches make that cheap
        after the first run)."""
        args = self._step_args(jax.random.PRNGKey(0))
        return self._jitted.lower(*args).compile().memory_analysis()

    def run(self, key):
        """key -> (logical_failures, total_shots, bp_unconverged_shots).

        With ``osd_fallback_cap`` set this is :meth:`run_bposd` (failures
        include the host-side OSD decode of the BP-unconverged shots)."""
        if self.osd_fallback_cap > 0:
            return self.run_bposd(key)
        return self._step(key)

    def run_bposd(self, key):
        """Device BP + host BP+OSD redecode of the BP failures: key ->
        (logical_failures, total_shots, osd_decoded_shots).  Matches the
        reference decode contract of the selected ``mode`` statistically:
        every shot's correction is device BP where BP converged, else the
        matching host BP+OSD driver on the shot's raw history+readout."""
        if self._osd is None:
            raise ValueError("construct the pipeline with osd_fallback_cap > 0")
        f_conv, shots, unconv, hist, readout, valid = self._step(key)
        n_shards = 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]
        if unconv > self.osd_fallback_cap * n_shards:
            raise RuntimeError(
                f"{unconv} BP-unconverged shots exceed osd_fallback_cap="
                f"{self.osd_fallback_cap} per device; raise the cap")
        valid = np.asarray(valid)
        if not valid.any():
            return f_conv, shots, 0
        hist = np.asarray(hist)[valid].astype(np.int64)
        readout = np.asarray(readout)[valid].astype(np.int64)
        corr = self._osd.readout_correction_batch(hist, readout)
        corrected = (readout + np.asarray(corr, dtype=np.int64)) % 2
        flips = (corrected @ np.asarray(self._Lz, dtype=np.int64).T) % 2
        f_osd = int(np.any(flips != 0, axis=1).sum())
        return f_conv + f_osd, shots, int(valid.sum())

    def rebind_noise(self, noise_model, data_prior: float, meas_prior: float):
        """Re-bind the pipeline to a new noise model / priors WITHOUT
        recompiling: only probability VALUES may change — the rewritten
        circuit must have the same structure (same channels in the same
        places), which holds across the p grid of a sweep."""
        sim = build_storage_simulation(
            self.rounds, noise_model, self.code,
            use_x_logicals=self.use_x_logicals)
        parsed = parse_circuit(sim.circuit)
        if parsed.structure_signature() != self.parsed.structure_signature():
            raise ValueError(
                "rebind_noise: circuit structure changed; build a new pipeline")
        self._noise_args = jnp.asarray(parsed.noise_args())
        prior = np.zeros(self.spacetime.spacetime_check_matrix.shape[1])
        prior[: self.spacetime._datablock_size] = data_prior
        prior[self.spacetime._datablock_size:] = meas_prior
        self.data_prior, self.meas_prior = data_prior, meas_prior
        self.prior_llr = priors_to_llr(prior)
        self._prior = self._prior_tree()
        self.noise_model = noise_model
        self.storage_sim = sim
        if self._osd is not None:
            # the host corrector's BP program is cached by structure; only
            # its prior vector changes here
            self._osd = self._build_osd_corrector()
        return self

    def run_host_sampled(self, seed: int, shots: Optional[int] = None):
        """Same decode program, records from the CPU oracle sampler.

        Cross-validates the device Pauli-frame sampler end-to-end: decoder
        and every downstream step are IDENTICAL to :meth:`run`, so any
        statistical disagreement isolates to the samplers."""
        from ..sampler.reference import FrameSampler

        S = shots if shots is not None else self.shots_per_device
        fs = FrameSampler(self.storage_sim.circuit, seed=seed)
        record = jnp.asarray(fs.sample(S), dtype=jnp.float32)
        out = jax.jit(self._decode_records)(record, self._dense_tree(), self._prior)
        return int(out[0]), int(out[1]), int(out[2])
