"""JAX Pauli-frame sampler for the device.

Device-native replacement for Stim's batch sampler (consumed by the reference at
``/root/reference/python/qldpc/misc/_experiment.py:193-197``), sharing exact
semantics with the CPU oracle in :mod:`exp_ldpc_tpu.sampler.reference` (see
that module's docstring for the frame algebra).

Design for the hardware/XLA:
  * the shot axis is the vector axis: frames are (Q, S) uint8 bit planes, and
    every gate/noise layer is SCATTER-FREE — a full-plane masked XOR with
    gathered partners/draws (static row maps; a scatter serializes updates
    to one row) — so the whole circuit jits into one fused program;
  * the structural REPEAT block from :class:`ParsedCircuit` lowers to
    ``lax.scan`` — compile time is independent of the round count and XLA
    double-buffers the measurement-record writes (``spacetime_code``'s rounds
    axis, SURVEY.md §5 long-context note);
  * noise channels draw from ``jax.random`` with per-op fold_in keys, so the
    sampler is deterministic given (key, circuit);
  * detector/observable evaluation is a single (S, M) x (M, D) matmul on the
    record, done in f32 (0/1 operands: exact) and reduced mod 2.

The record layout matches the reference contract (rounds of
[x_checks..., z_checks...] then data readout, ``storage_sim.py:187-196``).
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..circuits.ir import ParsedCircuit, parse_circuit

__all__ = ["DeviceSampler", "build_record_sampler"]


@lru_cache(maxsize=4096)
def _row_maps(Q: int, t_bytes: bytes, n: int):
    """Static (trace-time) helpers for scatter-free frame updates.

    Returns (mask (Q,1) bool, inv (Q,) int32): mask marks target rows; inv
    maps a target row to its position in the compact target list (0
    elsewhere), so a compact (n, S) per-site draw expands to the full plane
    with ONE gather — a scatter serializes updates to one row
    (docs/DESIGN.md §2), so every frame update here is gather + masked XOR.
    """
    t = np.frombuffer(t_bytes, dtype=np.int64).astype(np.int64)
    mask = np.zeros((Q, 1), dtype=bool)
    mask[t, 0] = True
    inv = np.zeros(Q, dtype=np.int32)
    inv[t] = np.arange(n, dtype=np.int32) % max(n, 1)
    return mask, inv


def _expand(mask, inv, compact):
    """Compact (n, S) rows -> full (Q, S) plane: gather + mask (no scatter)."""
    return jnp.where(mask, compact[inv], jnp.uint8(0))


def _apply_op(op_name, arg, targets, fx, fz, key):
    """Apply one compiled op to frame planes (Q, S); returns (fx, fz, record_or_None).

    ``arg`` may be a Python float OR a traced scalar (parametric noise —
    probability values re-bound at runtime, structure fixed at trace time;
    callers pass ``None`` for arg-less ops, which is a static property).
    Entirely SCATTER-FREE: target metadata is static, so every plane update
    is a full-plane ``where`` with gathered compact draws/partners.
    """
    Q, S = fx.shape
    t = np.asarray(targets, dtype=np.int64)
    rec = None

    def maps(idx, n):
        return _row_maps(Q, np.ascontiguousarray(idx, dtype=np.int64).tobytes(), n)

    if op_name in ("RZ", "RX", "MZ", "MX", "MRZ", "MRX"):
        rnd = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5, (t.size, S)).astype(jnp.uint8)
        mask, inv = maps(t, t.size)
        rnd_full = _expand(mask, inv, rnd)
    if op_name == "RZ":
        fx = jnp.where(mask, jnp.uint8(0), fx)
        fz = jnp.where(mask, rnd_full, fz)
    elif op_name == "RX":
        fz = jnp.where(mask, jnp.uint8(0), fz)
        fx = jnp.where(mask, rnd_full, fx)
    elif op_name in ("MZ", "MRZ", "MX", "MRX"):
        plane = fx if op_name in ("MZ", "MRZ") else fz
        out = plane[t]  # gather only
        if arg is not None:
            flips = jax.random.bernoulli(jax.random.fold_in(key, 2), arg, (t.size, S))
            out = out ^ flips.astype(jnp.uint8)
        rec = out
        if op_name == "MRZ":
            fx = jnp.where(mask, jnp.uint8(0), fx)
        elif op_name == "MRX":
            fz = jnp.where(mask, jnp.uint8(0), fz)
        if op_name in ("MZ", "MRZ"):
            fz = jnp.where(mask, rnd_full, fz)
        else:
            fx = jnp.where(mask, rnd_full, fx)
    elif op_name == "CX":
        ctrl, tgt = t[0::2], t[1::2]
        # fx[tgt] ^= fx[ctrl]: gather the partner plane through a full-length
        # source map (identity off-target), mask, XOR
        mask_t, _ = maps(tgt, tgt.size)
        src_x = np.arange(Q, dtype=np.int32)
        src_x[tgt] = ctrl
        fx = fx ^ jnp.where(mask_t, fx[src_x], jnp.uint8(0))
        mask_c, _ = maps(ctrl, ctrl.size)
        src_z = np.arange(Q, dtype=np.int32)
        src_z[ctrl] = tgt
        fz = fz ^ jnp.where(mask_c, fz[src_z], jnp.uint8(0))
    elif op_name == "CZ":
        a, b = t[0::2], t[1::2]
        mask_ab, _ = maps(np.concatenate([a, b]), a.size + b.size)
        src = np.arange(Q, dtype=np.int32)
        src[a] = b
        src[b] = a
        fz = fz ^ jnp.where(mask_ab, fx[src], jnp.uint8(0))
    elif op_name == "DEPOLARIZE1":
        kk = jax.random.fold_in(key, 3)
        e = jax.random.bernoulli(kk, arg, (t.size, S)).astype(jnp.uint8)
        k = jax.random.randint(jax.random.fold_in(kk, 1), (t.size, S), 1, 4, dtype=jnp.uint8)
        mask, inv = maps(t, t.size)
        ex = _expand(mask, inv, e & (k & 1))
        ez = _expand(mask, inv, e & ((k >> 1) & 1))
        fx = fx ^ ex
        fz = fz ^ ez
    elif op_name == "DEPOLARIZE2":
        a, b = t[0::2], t[1::2]
        kk = jax.random.fold_in(key, 4)
        e = jax.random.bernoulli(kk, arg, (a.size, S)).astype(jnp.uint8)
        k = jax.random.randint(jax.random.fold_in(kk, 1), (a.size, S), 1, 16, dtype=jnp.uint8)
        # both members of pair i read draw i: inv maps a_i -> i AND b_i -> i
        mask_a, inv_a = maps(a, a.size)
        mask_b, inv_b = maps(b, b.size)
        fx = fx ^ _expand(mask_a, inv_a, e & (k & 1)) \
                ^ _expand(mask_b, inv_b, e & ((k >> 2) & 1))
        fz = fz ^ _expand(mask_a, inv_a, e & ((k >> 1) & 1)) \
                ^ _expand(mask_b, inv_b, e & ((k >> 3) & 1))
    elif op_name == "X_ERROR":
        e = jax.random.bernoulli(jax.random.fold_in(key, 5), arg, (t.size, S)).astype(jnp.uint8)
        mask, inv = maps(t, t.size)
        fx = fx ^ _expand(mask, inv, e)
    elif op_name == "Z_ERROR":
        e = jax.random.bernoulli(jax.random.fold_in(key, 6), arg, (t.size, S)).astype(jnp.uint8)
        mask, inv = maps(t, t.size)
        fz = fz ^ _expand(mask, inv, e)
    elif op_name == "Y_ERROR":
        e = jax.random.bernoulli(jax.random.fold_in(key, 7), arg, (t.size, S)).astype(jnp.uint8)
        mask, inv = maps(t, t.size)
        ef = _expand(mask, inv, e)
        fx = fx ^ ef
        fz = fz ^ ef
    elif op_name == "PAULI_CHANNEL_1":
        # one of X/Y/Z with DISJOINT probabilities; ``arg`` is the (px, py,
        # pz) triple of (possibly traced) scalars.  One uniform draw per
        # site selects the region — X flips fx, Z flips fz, Y flips both.
        px, py, pz = arg
        u = jax.random.uniform(jax.random.fold_in(key, 8), (t.size, S))
        mask, inv = maps(t, t.size)
        ex = (u < px + py).astype(jnp.uint8)
        ez = ((u >= px) & (u < px + py + pz)).astype(jnp.uint8)
        fx = fx ^ _expand(mask, inv, ex)
        fz = fz ^ _expand(mask, inv, ez)
    elif op_name == "PAULI_CHANNEL_2":
        # one of the 15 two-qubit Paulis; Stim parameter order IX..ZZ means
        # parameter k (1-based) is the pair with code 4*A + B = k.  The
        # region index is a 15-threshold comparison sum (no searchsorted —
        # keeps everything a dense VPU op over the (pairs, S) plane).
        a, b = t[0::2], t[1::2]
        cum = jnp.cumsum(jnp.stack(arg))
        u = jax.random.uniform(jax.random.fold_in(key, 9), (a.size, S))
        region = 1 + jnp.sum(
            u[None, :, :] >= cum[:, None, None], axis=0).astype(jnp.int32)
        pa, pb = region // 4, region % 4
        hit = region <= 15
        mask_a, inv_a = maps(a, a.size)
        mask_b, inv_b = maps(b, b.size)
        exa = (hit & ((pa == 1) | (pa == 2))).astype(jnp.uint8)
        eza = (hit & ((pa == 2) | (pa == 3))).astype(jnp.uint8)
        exb = (hit & ((pb == 1) | (pb == 2))).astype(jnp.uint8)
        ezb = (hit & ((pb == 2) | (pb == 3))).astype(jnp.uint8)
        fx = fx ^ _expand(mask_a, inv_a, exa) ^ _expand(mask_b, inv_b, exb)
        fz = fz ^ _expand(mask_a, inv_a, eza) ^ _expand(mask_b, inv_b, ezb)
    else:  # pragma: no cover
        raise ValueError(f"unsupported op {op_name}")
    return fx, fz, rec


def _apply_correlated(op, arg, fx, fz, chain, key):
    """CORRELATED_ERROR / ELSE_CORRELATED_ERROR (stim chain semantics).

    ``chain`` is the per-shot (1, S) uint8 plane marking shots where some
    earlier member of the current chain already fired.  One Bernoulli draw
    per shot gates the whole Pauli product; an ELSE additionally requires
    the chain not to have fired.  Scatter-free like every other channel:
    the fired row broadcasts to the product's X/Z target rows via the same
    static mask/inv maps.
    """
    Q, S = fx.shape
    draw = jax.random.bernoulli(jax.random.fold_in(key, 10), arg, (1, S)).astype(jnp.uint8)
    if op.name == "ELSE_CORRELATED_ERROR":
        fired = draw & (1 - chain)
        chain = chain | fired
    else:  # CORRELATED_ERROR starts a fresh chain
        fired = draw
        chain = fired
    paulis = np.asarray(op.paulis)
    t = np.asarray(op.targets, dtype=np.int64)
    for plane, sel in ((0, (paulis == 1) | (paulis == 2)),
                       (1, (paulis == 2) | (paulis == 3))):
        tq = t[sel]
        if tq.size == 0:
            continue
        mask, inv = _row_maps(Q, np.ascontiguousarray(tq).tobytes(), tq.size)
        flip = _expand(mask, np.zeros(Q, dtype=np.int32), fired)
        if plane == 0:
            fx = fx ^ flip
        else:
            fz = fz ^ flip
    return fx, fz, chain


def _run_block(ops, fx, fz, record, key, rec_base, args):
    """Apply a compiled op block; record writes land at rec_base + op.meas_offset.

    ``args``: per-op probability values aligned with the arg-carrying ops of
    this block (traced scalars for the parametric sampler, floats otherwise).
    """
    ai = 0
    chain = jnp.zeros((1, fx.shape[1]), dtype=jnp.uint8)
    for i, op in enumerate(ops):
        op_key = jax.random.fold_in(key, i)
        n = op.num_noise_args
        if n == 0:
            arg = None
        elif op.args is not None:  # multi-parameter channel: tuple of scalars
            arg = tuple(args[ai + j] for j in range(n))
            ai += n
        else:
            arg = args[ai]
            ai += 1
        if op.name in ("CORRELATED_ERROR", "ELSE_CORRELATED_ERROR"):
            fx, fz, chain = _apply_correlated(op, arg, fx, fz, chain, op_key)
            continue
        fx, fz, rec = _apply_op(op.name, arg, op.targets, fx, fz, op_key)
        if rec is not None:
            record = jax.lax.dynamic_update_slice(
                record, rec, (rec_base + op.meas_offset, jnp.int32(0))
            )
    return fx, fz, record


def build_record_sampler(circuit: ParsedCircuit, shots: int, parametric: bool = False):
    """Pure sampling function for a fixed circuit STRUCTURE.

    ``parametric=False``: ``key -> (shots, M) uint8 record`` with noise
    probabilities baked in.  ``parametric=True``: ``(key, noise_args) ->
    record`` where ``noise_args`` is the runtime vector from
    :meth:`ParsedCircuit.noise_args` — one compile serves every error rate
    of a sweep (structure equality checked via ``structure_signature``).

    Unjitted so it composes under jit / shard_map (the distributed pipeline
    traces it per device shard)."""
    c = circuit
    S = int(shots)
    Q = c.num_qubits
    M = c.num_measurements

    def _block_args(ops, vec, base):
        k = sum(op.num_noise_args for op in ops)
        return [vec[base + j] for j in range(k)], base + k

    def sample_impl(key, vec):
        pro_args, off = _block_args(c.prologue, vec, 0)
        body_args, off = _block_args(c.body, vec, off)
        epi_args, _ = _block_args(c.epilogue, vec, off)

        fx = jnp.zeros((Q, S), dtype=jnp.uint8)
        fz = jnp.zeros((Q, S), dtype=jnp.uint8)
        record = jnp.zeros((M, S), dtype=jnp.uint8)

        k_pro, k_body, k_epi = jax.random.split(key, 3)
        fx, fz, record = _run_block(c.prologue, fx, fz, record, k_pro, 0, pro_args)

        if c.repeat_count > 0 and c.body:
            def body_fn(carry, it):
                fx, fz, record = carry
                kb = jax.random.fold_in(k_body, it)
                base = c.prologue_measurements + it * c.body_measurements
                fx, fz, record = _run_block(c.body, fx, fz, record, kb, base, body_args)
                return (fx, fz, record), None

            (fx, fz, record), _ = jax.lax.scan(
                body_fn, (fx, fz, record), jnp.arange(c.repeat_count)
            )

        epi_base = c.prologue_measurements + c.repeat_count * c.body_measurements
        fx, fz, record = _run_block(c.epilogue, fx, fz, record, k_epi, epi_base, epi_args)
        return record.T  # (S, M)

    if parametric:
        return sample_impl
    baked = c.noise_args()
    return lambda key: sample_impl(key, baked)


# compiled parametric samplers shared across same-structure circuits (a p
# sweep reuses ONE executable; probability values are runtime arguments)
_sampler_cache: dict = {}


class DeviceSampler:
    """jit-compiled batch sampler for a fixed circuit and shot count.

    Same-structure circuits (e.g. one storage experiment across a noise
    sweep) share the compiled executable via ``structure_signature``."""

    def __init__(self, circuit, shots: int):
        if not isinstance(circuit, ParsedCircuit):
            circuit = parse_circuit(circuit)
        self.circuit = circuit
        self.shots = int(shots)
        c = circuit
        self._det = jnp.asarray(c.detector_matrix().toarray().T, dtype=jnp.float32)
        self._obs = jnp.asarray(c.observable_matrix().toarray().T, dtype=jnp.float32)
        key = (c.structure_signature(), self.shots)
        if key not in _sampler_cache:
            _sampler_cache[key] = jax.jit(
                build_record_sampler(c, self.shots, parametric=True))
        self._sample_parametric = _sampler_cache[key]
        self._noise_args = jnp.asarray(c.noise_args())

    def sample(self, key) -> jnp.ndarray:
        """uint8 (shots, num_measurements) measurement record."""
        return self._sample_parametric(key, self._noise_args)

    def sample_detectors(self, key, append_observables: bool = False) -> jnp.ndarray:
        record = self.sample(key).astype(jnp.float32)
        # 0/1 x 0/1 parity products: exact in TF32, default precision
        det = jnp.mod(record @ self._det, 2.0).astype(jnp.uint8)
        if append_observables:
            obs = jnp.mod(record @ self._obs, 2.0).astype(jnp.uint8)
            det = jnp.concatenate([det, obs], axis=1)
        return det
