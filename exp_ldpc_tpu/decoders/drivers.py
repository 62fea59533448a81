"""Decode-mode drivers and the end-to-end Monte-Carlo simulation.

Behavioral parity with ``/root/reference/python/qldpc/misc/_experiment.py``
(the four decode modes and ``run_simulation``), re-designed batch-first: the
reference decodes shot-by-shot in a Python loop (``:199-209``); here the
sampler produces the whole record batch on device, syndromes for ALL shots
decode in one BP call, and the logical-failure reduction is vectorized.

Priors follow the reference exactly: data columns get ``data_prior``,
measurement-error columns ``meas_prior`` (``:33-35,74-76,106-108``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..circuits.storage_sim import build_storage_simulation
from ..core import QuantumCode
from .bp import BPDecoder
from .bposd import BPOSDDecoder
from .dem import detector_error_model
from .spacetime import DetectorSpacetimeCode, SpacetimeCode, SpacetimeCodeSingleShot

__all__ = [
    "BPOSDCorrect",
    "BPOSDCorrectSingleShot",
    "BPOSDHybridCorrect",
    "BPDetectorCorrect",
    "RelayBPCorrect",
    "SSFCorrect",
    "SlidingWindowCorrect",
    "run_simulation",
    "add_bposd_args",
    "unpack_bposd_args",
    "load_code",
]


def _spacetime_prior(spacetime, data_prior: float, meas_prior: float) -> np.ndarray:
    prior = np.zeros(spacetime.spacetime_check_matrix.shape[1])
    prior[: spacetime._datablock_size] = data_prior
    prior[spacetime._datablock_size:] = meas_prior
    return prior


@dataclass
class BPOSDCorrect:
    """BP+OSD on the full spacetime matrix (reference ``:62-83``)."""

    def __init__(self, code: QuantumCode, rounds: int, bp_osd_options: Dict, priors: Tuple[float, float],
                 basis: str = "z"):
        data_prior, meas_prior = priors
        self._checks = code.checks.x if basis == "x" else code.checks.z
        self._spacetime_code = SpacetimeCode(self._checks, rounds)
        prior_vec = _spacetime_prior(self._spacetime_code, data_prior, meas_prior)
        # structured spacetime BP (decoders/spacetime_bp.py) through the
        # selection module; OSD post-processing still runs on the full
        # spacetime matrix
        from .select import make_spacetime_bp_decoder

        bp = make_spacetime_bp_decoder(
            self._checks, rounds, channel_probs=prior_vec,
            **{k: v for k, v in bp_osd_options.items() if not k.startswith("osd_")},
        )
        self._bpd = BPOSDDecoder(
            bp=bp,
            H=self._spacetime_code.spacetime_check_matrix.tocsr(),
            osd_method=bp_osd_options.get("osd_method", "osd_cs"),
            osd_order=bp_osd_options.get("osd_order", 7),
        )

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        """history (S, rounds, r), readout (S, n) -> final-round correction (S, n)."""
        syndromes = self._spacetime_code.syndrome_from_history_batch(history, readout)
        correction = self._bpd.decode_batch(syndromes)
        return self._spacetime_code.final_correction(correction)


@dataclass
class BPOSDCorrectSingleShot:
    """Per-round iterative (H|I) decode with accumulated correction, then a
    clean final-round decode (reference ``:12-60``) — rounds loop on host,
    shots batched inside each step."""

    def __init__(self, code: QuantumCode, rounds: int, bp_osd_options: Dict, priors: Tuple[float, float],
                 basis: str = "z"):
        from .select import qc_kwargs_for_code, qc_kwargs_single_shot

        data_prior, meas_prior = priors
        self._rounds = rounds
        self._checks = code.checks.x if basis == "x" else code.checks.z
        self._Hd = self._checks.toarray()
        self._spacetime_code = SpacetimeCodeSingleShot(self._checks)
        self._bpd_single_shot = BPOSDDecoder.from_check_matrix(
            self._spacetime_code.spacetime_check_matrix,
            channel_probs=_spacetime_prior(self._spacetime_code, data_prior, meas_prior),
            **qc_kwargs_single_shot(code, sector=basis),
            **bp_osd_options,
        )
        self._bpd_final_round = BPOSDDecoder.from_check_matrix(
            self._checks, error_rate=data_prior,
            **qc_kwargs_for_code(code, sector=basis), **bp_osd_options
        )

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        S = readout.shape[0]
        Hd = self._Hd
        acc = np.zeros_like(readout, dtype=np.int64)
        for t in range(self._rounds):
            corr_syndrome = (acc @ Hd.T) % 2
            syndrome = (corr_syndrome + history[:, t]) % 2
            st_correction = self._bpd_single_shot.decode_batch(syndrome)
            acc = (acc + self._spacetime_code.final_correction(st_correction)) % 2
        readout = (acc + readout) % 2
        syndrome = (readout @ Hd.T) % 2
        final = self._bpd_final_round.decode_batch(syndrome)
        return (final + acc) % 2


@dataclass
class BPOSDHybridCorrect:
    """Plain BP on the spacetime matrix + BP+OSD on the final round
    (reference ``:85-126``)."""

    def __init__(self, code: QuantumCode, rounds: int, bp_osd_options: Dict, priors: Tuple[float, float],
                 basis: str = "z"):
        data_prior, meas_prior = priors
        self._rounds = rounds
        self._checks = code.checks.x if basis == "x" else code.checks.z
        self._HdT = self._checks.T.toarray()
        self._spacetime_code = SpacetimeCode(self._checks, rounds)
        bp_options = {
            k: v for k, v in bp_osd_options.items() if not k.startswith("osd_")
        }
        from .select import make_spacetime_bp_decoder, qc_kwargs_for_code

        self._bpd = make_spacetime_bp_decoder(
            self._checks, rounds,
            channel_probs=_spacetime_prior(self._spacetime_code, data_prior, meas_prior),
            **bp_options,
        )

        self._bpd_final_round = BPOSDDecoder.from_check_matrix(
            self._checks, error_rate=data_prior,
            **qc_kwargs_for_code(code, sector=basis), **bp_osd_options
        )

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        syndromes = self._spacetime_code.syndrome_from_history_batch(history, readout)
        correction, _post, _conv, _it = self._bpd.decode_batch(syndromes)
        bp_corr = self._spacetime_code.final_correction(np.asarray(correction))
        readout = (bp_corr + readout) % 2
        syndrome = (readout @ self._HdT) % 2
        final = self._bpd_final_round.decode_batch(syndrome)
        return (final + bp_corr) % 2


@dataclass
class SlidingWindowCorrect:
    """Streaming overlapping-window decode (no reference counterpart — the
    reference stubbed it at ``spacetime_code.py:95-96``).  ``window_size`` /
    ``window_commit`` keys extend the bposd option dict."""

    def __init__(self, code: QuantumCode, rounds: int, bp_osd_options: Dict, priors: Tuple[float, float],
                 basis: str = "z"):
        from .sliding_window import SlidingWindowDecoder

        data_prior, meas_prior = priors
        opts = dict(bp_osd_options)
        window = int(opts.pop("window_size", 4))
        commit = opts.pop("window_commit", None)
        self._dec = SlidingWindowDecoder(
            code.checks.x if basis == "x" else code.checks.z,
            data_prior, meas_prior, window=window,
            commit=None if commit is None else int(commit), bp_options=opts)

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        return self._dec.decode_batch(history, readout)


@dataclass
class SSFCorrect:
    """Single-shot small-set-flip (no reference counterpart — the reference's
    decoder inventory is BP/OSD only): per-round iterative (H|I) SSF with
    accumulated correction, then a clean final-round SSF, following the
    round-loop structure of ``BPOSDCorrectSingleShot`` (reference
    ``misc/_experiment.py:12-60``).  The per-round flip search runs over the
    zero-padded opposite-sector stabilizer generators (data-qubit subsets)
    plus weight-1 generators for each measurement-error column, so syndrome
    noise is corrected by the same greedy gain rule.  ``ssf_max_iter``
    extends the option dict (0 = one flip per spacetime column)."""

    def __init__(self, code: QuantumCode, rounds: int, bp_osd_options: Dict, priors: Tuple[float, float],
                 basis: str = "z"):
        from scipy import sparse

        from .flip import SmallSetFlipDecoder

        self._rounds = rounds
        self._checks = code.checks.x if basis == "x" else code.checks.z
        self._Hd = self._checks.toarray()
        self._spacetime_code = SpacetimeCodeSingleShot(self._checks)
        max_iter = int(dict(bp_osd_options).get("ssf_max_iter", 0) or 0)
        r, n = self._checks.shape
        # flip generators come from the OPPOSITE sector's stabilizers
        gx = code.checks.z if basis == "x" else code.checks.x
        gen_data = sparse.hstack(
            [gx, sparse.csr_matrix((gx.shape[0], r), dtype=np.uint8)]
        )
        gen_meas = sparse.hstack(
            [sparse.csr_matrix((r, n), dtype=np.uint8), sparse.identity(r, dtype=np.uint8)]
        )
        generators = sparse.vstack([gen_data, gen_meas]).tocsr()
        self._dec_ss = SmallSetFlipDecoder.from_css(
            self._spacetime_code.spacetime_check_matrix, generators, max_iter=max_iter
        )
        self._dec_final = SmallSetFlipDecoder.from_css(
            self._checks, gx, max_iter=max_iter
        )

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        Hd = self._Hd
        acc = np.zeros_like(readout, dtype=np.int64)
        for t in range(self._rounds):
            corr_syndrome = (acc @ Hd.T) % 2
            syndrome = (corr_syndrome + history[:, t]) % 2
            st_correction = self._dec_ss.decode_batch(syndrome)[0]
            acc = (acc + self._spacetime_code.final_correction(st_correction)) % 2
        readout = (acc + readout) % 2
        syndrome = (readout @ Hd.T) % 2
        final = self._dec_final.decode_batch(syndrome)[0]
        return (final + acc) % 2


@dataclass
class RelayBPCorrect:
    """Relay (disordered-memory) BP ensemble on the full spacetime matrix —
    the fully-parallel OSD-free mode (PAPERS.md arXiv:2507.00254; no
    reference counterpart).  Accepts the bposd option dict; ``relay_legs``
    and ``relay_iters_per_leg`` extend it (budget defaults mirror the
    ensemble sizes of the paper)."""

    def __init__(self, code: QuantumCode, rounds: int, bp_osd_options: Dict, priors: Tuple[float, float],
                 basis: str = "z"):
        from .relay_bp import RelayBPDecoder

        data_prior, meas_prior = priors
        self._checks = code.checks.x if basis == "x" else code.checks.z
        self._spacetime_code = SpacetimeCode(self._checks, rounds)
        opts = dict(bp_osd_options)
        num_legs = int(opts.pop("relay_legs", 8))
        iters_per_leg = int(opts.pop("relay_iters_per_leg", 30))
        self._bpd = RelayBPDecoder.from_check_matrix(
            self._spacetime_code.spacetime_check_matrix,
            channel_probs=_spacetime_prior(self._spacetime_code, data_prior, meas_prior),
            method=opts.get("bp_method", "ms"),
            ms_scaling_factor=float(opts.get("ms_scaling_factor", 1.0) or 1.0),
            num_legs=num_legs,
            iters_per_leg=iters_per_leg,
            seed=int(opts.pop("relay_seed", 0)),
        )

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        syndromes = self._spacetime_code.syndrome_from_history_batch(history, readout)
        correction, _post, _conv, _leg = self._bpd.decode_batch(syndromes)
        return self._spacetime_code.final_correction(np.asarray(correction))


@dataclass
class BPDetectorCorrect:
    """BP on the detector-error-model fault matrix (reference ``:128-151``,
    with the fault/detector indexing bug SURVEY.md §2.5.1 fixed).

    The reference's mode is plain flooding BP — and circuit-level DEM
    fault matrices are intrinsically hostile to it (huge column
    degeneracy, short cycles: measured 45% non-convergence at p=3e-4 even
    on syndromes sampled from the DEM itself).  Beyond reference parity,
    two opt-in upgrades make the mode usable:

      * ``relay_legs`` / ``relay_iters_per_leg`` / ``relay_seed`` — run the
        disordered-memory relay-BP ensemble instead of one flooding pass
        (measured 45% -> 7% non-convergence at 8x30 legs);
      * ``detector_osd=True`` — OSD post-processing (``osd_method`` /
        ``osd_order``) of the shots BP left unconverged, on the fault
        matrix.
    """

    def __init__(self, dem, bp_osd_options: Dict):
        from scipy import sparse as _sparse

        from .select import make_bp_decoder

        self._dsc = DetectorSpacetimeCode(dem)
        opts = dict(bp_osd_options)
        relay_legs = int(opts.pop("relay_legs", 0) or 0)
        relay_iters = int(opts.pop("relay_iters_per_leg", 30))
        relay_seed = int(opts.pop("relay_seed", 0))
        use_osd = bool(opts.pop("detector_osd", False))
        osd_method = opts.get("osd_method", "osd0")
        osd_order = opts.get("osd_order", 0)
        bp_options = {k: v for k, v in opts.items() if not k.startswith("osd_")}
        H = self._dsc.fault_check_matrix
        if relay_legs > 0:
            from .relay_bp import RelayBPDecoder

            bp = RelayBPDecoder.from_check_matrix(
                H, channel_probs=self._dsc.fault_priors,
                method=bp_options.get("bp_method", "ms"),
                ms_scaling_factor=float(
                    bp_options.get("ms_scaling_factor", 0.625) or 0.625),
                num_legs=relay_legs, iters_per_leg=relay_iters,
                seed=relay_seed)
        else:
            # fault matrices grow with rounds; route through the
            # formulation selection
            bp = make_bp_decoder(
                H, channel_probs=self._dsc.fault_priors, **bp_options)
        self._bpd = (
            BPOSDDecoder(bp=bp, H=_sparse.csr_matrix(H),
                         osd_method=osd_method, osd_order=osd_order)
            if use_osd else bp)
        self._use_osd = use_osd
        self._fault_map_T = self._dsc.fault_map.T.toarray()

    def readout_correction_batch(self, detector_batch: np.ndarray) -> np.ndarray:
        """detector_batch (S, D + L) with observables appended -> corrected
        observable bits (S, L)."""
        D = self._dsc.fault_check_matrix.shape[0]
        syndrome = detector_batch[:, :D]
        logicals = detector_batch[:, D:]
        if self._use_osd:
            fault_set = self._bpd.decode_batch(syndrome)
        else:
            fault_set, _post, _conv, _it = self._bpd.decode_batch(syndrome)
        flips = (np.asarray(fault_set) @ self._fault_map_T) % 2
        return (logicals + flips) % 2


def run_simulation(
    samples,
    code: QuantumCode,
    meas_prior,
    data_prior,
    noise_model,
    noise_model_args,
    bp_osd_options: Dict,
    rounds: int,
    decoder_mode: str,
    seed: Optional[int] = None,
    use_device_sampler: Optional[bool] = None,
    use_x_logicals: Optional[bool] = None,
):
    """Build the storage circuit, sample, decode every shot, return per-shot
    logical-failure booleans (reference ``:154-210``, batch-vectorized).

    ``meas_prior`` / ``data_prior`` are callables ``(x_steps, z_steps) ->
    float`` following the reference's prior-of-circuit-depth hook
    (``:160-168``).

    ``use_x_logicals`` runs the X-basis memory experiment end-to-end: the
    circuit prepares/reads |+> (``storage_sim.py:110-118``), and the decode
    path uses ``checks.x`` / ``logicals.x`` on the X-check history block —
    the reference hardcodes the Z basis here (``misc/_experiment.py:165``).
    """
    if use_x_logicals is None:
        use_x_logicals = False
    basis = "x" if use_x_logicals else "z"
    checks = code.checks
    logicals = code.logicals

    x_steps = max(int(checks.x.sum(axis=0).max()), int(checks.x.sum(axis=1).max()))
    z_steps = max(int(checks.z.sum(axis=0).max()), int(checks.z.sum(axis=1).max()))

    storage_sim = build_storage_simulation(
        rounds, noise_model(**noise_model_args), code, use_x_logicals=use_x_logicals
    )
    meas_p = meas_prior(x_steps, z_steps)
    data_p = data_prior(x_steps, z_steps)

    detectors = decoder_mode == "bpd_detector"
    if decoder_mode == "bposd":
        decoder = BPOSDCorrect(code, rounds, bp_osd_options, (data_p, meas_p), basis=basis)
    elif decoder_mode == "bposd_single_shot":
        decoder = BPOSDCorrectSingleShot(code, rounds, bp_osd_options, (data_p, meas_p), basis=basis)
    elif decoder_mode == "bposd_hybrid":
        decoder = BPOSDHybridCorrect(code, rounds, bp_osd_options, (data_p, meas_p), basis=basis)
    elif decoder_mode == "bpd_detector":
        dem = detector_error_model(storage_sim.circuit)
        decoder = BPDetectorCorrect(dem, bp_osd_options)
    elif decoder_mode == "relay_bp":
        decoder = RelayBPCorrect(code, rounds, bp_osd_options, (data_p, meas_p), basis=basis)
    elif decoder_mode == "ssf_single_shot":
        decoder = SSFCorrect(code, rounds, bp_osd_options, (data_p, meas_p), basis=basis)
    elif decoder_mode == "sliding_window":
        decoder = SlidingWindowCorrect(code, rounds, bp_osd_options, (data_p, meas_p), basis=basis)
    else:
        raise RuntimeError("Unknown decoder operation mode")

    # ---- sample ----
    if use_device_sampler is None:
        use_device_sampler = True
    if use_device_sampler:
        import jax

        from ..sampler.device import DeviceSampler

        sampler = DeviceSampler(storage_sim.circuit, shots=samples)
        key = jax.random.PRNGKey(seed if seed is not None else 0)
        if detectors:
            batch = np.asarray(sampler.sample_detectors(key, append_observables=True))
        else:
            batch = np.asarray(sampler.sample(key))
    else:
        from ..sampler.reference import FrameSampler

        fs = FrameSampler(storage_sim.circuit, seed=seed)
        batch = fs.sample_detectors(samples, append_observables=True) if detectors else fs.sample(samples)

    # ---- decode (batched) ----
    if detectors:
        corrected = decoder.readout_correction_batch(batch)
        return list(np.any(corrected != 0, axis=1))

    x_count = checks.x.shape[0]
    z_count = checks.z.shape[0]
    mpr = x_count + z_count
    S = batch.shape[0]
    # record layout per round: [x_checks..., z_checks...]; decode the block
    # belonging to the memory basis (X-basis readout is measured by X checks)
    blk_off = 0 if use_x_logicals else x_count
    blk_len = x_count if use_x_logicals else z_count
    if rounds > 0:
        history = np.stack(
            [batch[:, r * mpr + blk_off : r * mpr + blk_off + blk_len] for r in range(rounds)],
            axis=1,
        ).astype(np.int64)
    else:
        history = np.zeros((S, 0, blk_len), dtype=np.int64)
    readout = batch[:, mpr * rounds : mpr * rounds + code.num_qubits].astype(np.int64)

    correction = decoder.readout_correction_batch(history, readout)
    corrected_readout = (readout + correction) % 2
    final_logicals = logicals.x if use_x_logicals else logicals.z
    logical_flips = (corrected_readout @ final_logicals.T.astype(np.int64)) % 2
    return list(np.any(logical_flips != 0, axis=1))


def add_bposd_args(parser):
    """BP+OSD CLI arguments (reference ``:213-219``)."""
    parser.add_argument(
        "--bposd_max_iter",
        type=lambda x: int(x) if x is not None else None,
        help="BP iteration cap (defaults to the code's qubit count)",
        default=None,
    )
    parser.add_argument(
        "--bposd_bp_method",
        choices=["ps", "ms", "msl"],
        help="BP update rule: product-sum, min-sum, or log-domain min-sum",
        default="ps",
    )
    parser.add_argument(
        "--bposd_ms_scaling_factor",
        type=float,
        help="min-sum scaling alpha; 0 selects the adaptive 1-2^-t schedule",
        default=0,
    )
    parser.add_argument(
        "--bposd_osd_method",
        choices=["osd_e", "osd_cs", "osd0"],
        help="OSD post-processing variant",
        default="osd_cs",
    )
    parser.add_argument("--bposd_osd_order", type=int, help="OSD combination-sweep / exhaustion depth", default=7)


def unpack_bposd_args(parsed_args, code: QuantumCode) -> Dict:
    """CLI arguments -> decoder options dict (reference ``:221-229``)."""
    return {
        "max_iter": parsed_args.bposd_max_iter
        if parsed_args.bposd_max_iter is not None
        else code.checks.num_qubits,
        "bp_method": parsed_args.bposd_bp_method,
        "ms_scaling_factor": parsed_args.bposd_ms_scaling_factor,
        "osd_method": parsed_args.bposd_osd_method,
        "osd_order": parsed_args.bposd_osd_order,
    }


def load_code(args) -> QuantumCode:
    """Load and validate a code file (reference ``:231-235``)."""
    from ..codes.io import read_quantum_code

    with args.code.open() as code_file:
        return read_quantum_code(code_file, validate_stabilizer_code=True)
