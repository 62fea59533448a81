#!/usr/bin/env python
"""bpd_detector-mode LER campaign: the detector-error-model decode at scale.

The reference's ``bpd_detector`` mode is broken (it wires faults to
enumeration indices instead of detector ids,
``/root/reference/python/qldpc/spacetime_code.py:168-171``, SURVEY.md
§2.5.1); ours is the FIXED mode (``decoders/dem.py`` + ``BPDetectorCorrect``)
— but until round 5 it was validated only by unit tests.  This runs the
full chain under circuit noise at campaign scale: device detector sampler
(observables appended) -> stage-1 flooding BP on the DEM fault matrix,
streamed over sampler batches -> the unconverged residue accumulates on
the host and is redecoded once per point in compacted fixed-shape chunks
(relay-BP ensemble, then host OSD on the relay posterior of whatever the
ensemble leaves) -> observable correction via the fault map.  One JSONL
record per p, for overlay against the bposd spacetime curve
(``scripts/validate_ler.py --decode bposd --noise circuit``).

DEM fault matrices are cascade-bound, not BP-bound: near p=1e-3 most
shots fail stage-1 (column degeneracy + short cycles) and a large share
reach host OSD on the 864x36491 matrix, so per-point sample budgets
(``--samples-list``) should shrink as p grows — the Wilson CI is carried
by the failure count, which high-p points reach quickly.

  python scripts/validate_dem.py \
    --p-list 0.0012,... --samples-list 5120,... \
    --out chiprun_out/ler_hgp225_dem_circuit.jsonl
"""
import argparse
import json
import time

import numpy as np


def wilson_interval(k, n, z=2.0):
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=100000)
    ap.add_argument("--batch-shots", type=int, default=8192)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--p-grid", type=str, default="(1.5e-4,1.2e-3,6)")
    ap.add_argument("--p-list", type=str, default=None,
                    help="comma-separated explicit p values (overrides "
                         "--p-grid; use to match another curve's grid)")
    ap.add_argument("--samples-list", type=str, default=None,
                    help="comma-separated per-point sample counts matching "
                         "--p-list (high-p points are cascade-bound: ~half "
                         "of all shots hit host OSD at p=1.2e-3, so a flat "
                         "budget wastes the cheap low-p regime)")
    ap.add_argument("--max-iter", type=int, default=48)
    ap.add_argument("--msf", type=float, default=0.0,
                    help="stage-1 min-sum scaling (0 = adaptive; measured "
                         "2x fewer unconverged than 0.625 on DEM matrices)")
    ap.add_argument("--relay-legs", type=int, default=12,
                    help="relay-BP ensemble legs for the stage-2 redecode "
                         "of stage-1-unconverged shots (0 = skip relay)")
    ap.add_argument("--relay-iters", type=int, default=40)
    ap.add_argument("--relay-cap", type=int, default=2048,
                    help="fixed stage-2 batch size (compacted unconverged "
                         "shots pad up to this; one compile)")
    ap.add_argument("--osd-cap", type=int, default=2048,
                    help="per-batch cap on host-OSD redecode of "
                         "BP-unconverged shots (0 = no OSD)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import jax

    from exp_ldpc_tpu.circuits.noise import circuit_noise
    from exp_ldpc_tpu.circuits.storage_sim import build_storage_simulation
    from exp_ldpc_tpu.codes.hgp import biregular_hgp
    from exp_ldpc_tpu.decoders.dem import detector_error_model
    from exp_ldpc_tpu.decoders.drivers import BPDetectorCorrect
    from exp_ldpc_tpu.decoders.osd import osd_decode_batch
    from exp_ldpc_tpu.experiments.p_sweep import parse_sweep_spec
    from exp_ldpc_tpu.sampler.device import DeviceSampler

    if args.p_list:
        p_grid = np.asarray([float(x) for x in args.p_list.split(",")])
    else:
        lo, hi, pts = parse_sweep_spec(args.p_grid)
        p_grid = np.geomspace(lo, hi, pts)
    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)

    batch = args.batch_shots
    if args.samples_list:
        samples_grid = [int(x) for x in args.samples_list.split(",")]
        assert len(samples_grid) == p_grid.size
    else:
        samples_grid = [args.samples] * p_grid.size
    for i, p in enumerate(p_grid):
        n_calls = -(-samples_grid[i] // batch)
        p = float(p)
        sim = build_storage_simulation(args.rounds, circuit_noise(p, p), code)
        dem = detector_error_model(sim.circuit)
        decoder = BPDetectorCorrect(dem, {
            "max_iter": args.max_iter, "bp_method": "ms",
            "ms_scaling_factor": args.msf})
        bp_stage = decoder._bpd
        Hf = decoder._dsc.fault_check_matrix
        relay = None
        if args.relay_legs > 0:
            from exp_ldpc_tpu.decoders.relay_bp import RelayBPDecoder

            relay = RelayBPDecoder.from_check_matrix(
                Hf, channel_probs=decoder._dsc.fault_priors, method="ms",
                ms_scaling_factor=0.625, num_legs=args.relay_legs,
                iters_per_leg=args.relay_iters, seed=0)
        sampler = DeviceSampler(sim.circuit, shots=batch)
        D = decoder._dsc.fault_check_matrix.shape[0]
        F = decoder._dsc.fault_check_matrix.shape[1]
        import jax.numpy as jnp

        # fault->observable map on device: flips are computed where the
        # fault vectors live, so only (S, L) bits ever cross to the host
        # (naively shipping fault_set+posterior is ~190 MB per 1024-shot
        # batch and dominated the first version of this campaign)
        fmapT_dev = jnp.asarray(decoder._fault_map_T, jnp.float32)

        def dev_flips(fset):
            return np.asarray(jnp.mod(
                fset.astype(jnp.float32) @ fmapT_dev, 2.0)).astype(np.int64)

        t0 = time.perf_counter()
        fails = shots = unconv = relay_n = osd_n = overflow = 0
        # stage 1 streams over sampler batches; the unconverged residue
        # (syndrome rows + logical/flip slots) accumulates on the host and
        # is redecoded ONCE per point in compacted relay_cap chunks.  The
        # per-batch version ran the full fixed-shape relay ensemble every
        # batch even when 5 shots needed it — at low p that was ~98 relay
        # dispatches per point doing ~2 batches of real work.
        res_synd: list = []   # unconverged syndrome rows (uint8)
        res_logi: list = []   # their observable records
        for j in range(n_calls):
            key = jax.random.fold_in(jax.random.PRNGKey(300 + i), j)
            rec = np.asarray(
                sampler.sample_detectors(key, append_observables=True))
            syndrome = rec[:, :D].astype(np.uint8)
            logicals = rec[:, D:].astype(np.int64)
            # stage 1: plain flooding BP on every shot (device-resident)
            f1, _p1, c1, _it = bp_stage.decode_batch(syndrome)
            flips = dev_flips(f1)          # (S, L)
            conv = np.array(c1)
            unconv += int((~conv).sum())
            uncv = np.nonzero(~conv)[0]
            if uncv.size:
                res_synd.append(syndrome[uncv])
                res_logi.append(logicals[uncv])
            keep = conv
            corrected = (logicals[keep] + flips[keep]) % 2
            fails += int(np.any(corrected != 0, axis=1).sum())
            shots += rec.shape[0]
        # stages 2+3 on the compacted residue: relay ensemble per chunk,
        # host OSD directly on the relay posterior of whatever relay left
        if res_synd:
            rs = np.concatenate(res_synd)
            rl = np.concatenate(res_logi)
            for lo in range(0, rs.shape[0], args.relay_cap):
                sel = np.arange(lo, min(lo + args.relay_cap, rs.shape[0]))
                flips = np.zeros((sel.size, rl.shape[1]), np.int64)
                if relay is not None:
                    pad = np.resize(sel, args.relay_cap)  # fixed shape
                    f2, p2, c2, _l = relay.decode_batch(rs[pad])
                    k = sel.size
                    flips = dev_flips(f2)[:k]
                    conv2 = np.asarray(c2)[:k]
                    relay_n += k
                    post = np.asarray(jnp.asarray(p2)[:k])
                else:
                    conv2 = np.zeros(sel.size, bool)
                    post = np.tile(np.log(
                        (1 - decoder._dsc.fault_priors)
                        / decoder._dsc.fault_priors), (sel.size, 1))
                uncv = np.nonzero(~conv2)[0]
                if args.osd_cap > 0 and uncv.size:
                    o = uncv[: args.osd_cap]
                    f3 = osd_decode_batch(Hf, rs[sel[o]], post[o], "osd0", 0)
                    flips[o] = (f3.astype(np.int64)
                                @ decoder._fault_map_T.astype(np.int64)) % 2
                    osd_n += o.size
                    overflow += uncv.size - o.size
                corrected = (rl[sel] + flips) % 2
                fails += int(np.any(corrected != 0, axis=1).sum())
        dt = time.perf_counter() - t0
        low, high = wilson_interval(fails, shots)
        rec_out = {
            "noise": "circuit", "decode": "bpd_detector", "p_ph": p,
            "failures": fails, "samples": shots, "ler": fails / shots,
            "ler_ci_low": low, "ler_ci_high": high,
            "bp_unconverged": unconv, "relay_decoded": relay_n,
            "osd_decoded": osd_n,
            "osd_overflow": overflow,
            "relay_legs": args.relay_legs,
            "detectors": int(D), "faults": int(F),
            "walltime": dt,
        }
        print(json.dumps(rec_out), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec_out) + "\n")


if __name__ == "__main__":
    main()
