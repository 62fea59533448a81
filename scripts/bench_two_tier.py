#!/usr/bin/env python
"""Paired two-tier adaptive-decode measurement on a large code.

Runs the production pipeline on the n=4862 cyclic lifted product with
fixed-iteration decode and with the two-tier adaptive decode
(``tier1_iters``), same seeds, and prints failures, unconverged shots and
walltime for each.  The failure counts should match; whether the tiers
pay is what the walltimes say.

  python scripts/bench_two_tier.py --out chiprun_out/two_tier.jsonl
"""
import argparse
import json
import time
import warnings

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--p", type=float, default=2e-4)
    ap.add_argument("--shots", type=int, default=2048)
    ap.add_argument("--max-iter", type=int, default=48)
    ap.add_argument("--tier1", type=int, default=8)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    warnings.filterwarnings("ignore")
    import jax

    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.codes.lifted import lifted_product_code_cyclic
    from exp_ldpc_tpu.parallel.pipeline import StorageDecodePipeline

    code = lifted_product_code_cyclic(
        q=22, m=1, w=14, r=5, seed=42, compute_logicals=True)
    p = args.p

    def build(**over):
        return StorageDecodePipeline(
            code=code, rounds=args.rounds, noise_model=depolarizing_noise(p, p),
            data_prior=2 / 3 * p, meas_prior=2 / 3 * p,
            shots_per_device=args.shots, max_iter=args.max_iter,
            bp_method="ms", ms_scaling_factor=0.625, **over)

    results = {}
    for label, over in [("fixed", {}),
                        ("two_tier", dict(tier1_iters=args.tier1,
                                          tier2_cap=512))]:
        pipe = build(**over)
        pipe.run(jax.random.PRNGKey(0))  # compile + warm
        t0 = time.perf_counter()
        fails = shots = unconv = 0
        for k in range(args.reps):
            f, s, u = pipe.run(jax.random.PRNGKey(100 + k))
            fails, shots, unconv = fails + f, shots + s, unconv + u
        dt = time.perf_counter() - t0
        results[label] = (fails, shots, unconv, dt)
        rec = {
            "bench": "two_tier_large", "code": "cyclic_lp_4862",
            "rounds": args.rounds, "p": p, "mode": label,
            "tier1_iters": args.tier1 if label == "two_tier" else 0,
            "max_iter": args.max_iter, "failures": fails, "shots": shots,
            "bp_unconverged": unconv, "walltime_s": dt,
            "shots_per_s": shots / dt,
        }
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")

    f1, s1, u1, t1 = results["fixed"]
    f2, s2, u2, t2 = results["two_tier"]
    summary = {
        "bench": "two_tier_large_summary", "speedup": t1 / t2,
        "failures_fixed": f1, "failures_two_tier": f2,
        "unconv_fixed": u1, "unconv_two_tier": u2,
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
