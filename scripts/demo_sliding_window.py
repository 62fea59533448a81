#!/usr/bin/env python
"""Long-stream sliding-window decode demo on real hardware.

The reference stubbed sliding-window decoding and cannot run it at all
(``/root/reference/python/qldpc/spacetime_code.py:95-96``); its full
spacetime decode grows O(rounds) in matrix size and memory.  This demo
decodes a LONG memory experiment (HGP-225, rounds >= 64) in O(window)
memory: one compiled window program reused ceil(rounds/commit) times,
walltime scaling linearly in rounds at constant per-round cost.

  python scripts/demo_sliding_window.py --out chiprun_out/sliding_window.jsonl
"""
import argparse
import json
import time

import numpy as np


def run(rounds, shots, p, window, commit, out):
    import jax

    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.circuits.storage_sim import build_storage_simulation
    from exp_ldpc_tpu.codes.hgp import biregular_hgp
    from exp_ldpc_tpu.decoders.sliding_window import (
        SlidingWindowDecoder, window_check_matrix)
    from exp_ldpc_tpu.sampler.device import DeviceSampler

    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
    Hz = code.checks.z
    r, n = Hz.shape
    x_count = code.checks.x.shape[0]
    mpr = x_count + r
    Lz = np.asarray(code.logicals.z, dtype=np.int64)

    sim = build_storage_simulation(rounds, depolarizing_noise(p, p), code)
    sampler = DeviceSampler(sim.circuit, shots=shots)
    t0 = time.perf_counter()
    rec = np.asarray(sampler.sample(jax.random.PRNGKey(1)))
    t_sample = time.perf_counter() - t0
    hist = rec[:, : mpr * rounds].reshape(shots, rounds, mpr)[
        :, :, x_count:].astype(np.int64)
    readout = rec[:, mpr * rounds: mpr * rounds + n].astype(np.int64)

    dec = SlidingWindowDecoder(
        Hz, 2 / 3 * p, 2 / 3 * p, window=window, commit=commit,
        bp_options=dict(max_iter=48, bp_method="ms",
                        ms_scaling_factor=0.625))
    # warm the two compiled programs (window + tail) on a small prefix
    dec.decode_batch(hist[:, : 2 * window], readout)

    t0 = time.perf_counter()
    corr = dec.decode_batch(hist, readout)
    dt = time.perf_counter() - t0
    corrected = (readout + np.asarray(corr, dtype=np.int64)) % 2
    fails = int((((corrected @ Lz.T) % 2) != 0).any(axis=1).sum())

    Hw = window_check_matrix(Hz, window)
    rec_out = {
        "bench": "sliding_window", "code": "hgp225", "rounds": rounds,
        "shots": shots, "p": p, "window": window, "commit": commit,
        "window_matrix": list(Hw.shape),
        "full_spacetime_cols": (rounds + 1) * n + rounds * r,
        "sample_walltime_s": t_sample,
        "decode_walltime_s": dt,
        "decode_ms_per_round_per_kshot": dt / rounds / shots * 1e3 * 1000,
        "failures": fails, "ler": fails / shots,
    }
    print(json.dumps(rec_out), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(rec_out) + "\n")
    return rec_out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shots", type=int, default=512)
    ap.add_argument("--p", type=float, default=1e-3)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--commit", type=int, default=2)
    ap.add_argument("--rounds", type=str, default="64,128")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    recs = [run(int(rr), args.shots, args.p, args.window, args.commit,
                args.out)
            for rr in args.rounds.split(",")]
    if len(recs) >= 2:
        # linear scaling in rounds = constant per-round cost (same window
        # program; memory does not grow with the stream length)
        r0, r1 = recs[0], recs[1]
        ratio = (r1["decode_walltime_s"] / r0["decode_walltime_s"]) / (
            r1["rounds"] / r0["rounds"])
        print(json.dumps({"bench": "sliding_window_scaling",
                          "walltime_ratio_vs_rounds_ratio": ratio}))
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps({
                    "bench": "sliding_window_scaling",
                    "walltime_ratio_vs_rounds_ratio": ratio}) + "\n")


if __name__ == "__main__":
    main()
