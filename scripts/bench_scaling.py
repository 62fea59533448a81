#!/usr/bin/env python
"""Decode-throughput scaling harness (BASELINE.md scaling row).

Measures end-to-end sample+decode throughput of the fused Monte-Carlo
pipeline on growing device meshes.  On real hardware this scales over the
cards (shot sharding over DATA_AXIS, `psum` reduction); with
``--virtual N`` it runs on N virtual CPU devices to exercise the same SPMD
program without hardware (useful for CI and single-host development; note
virtual devices SHARE one host's cores, so total throughput stays roughly
flat there — the virtual mode validates the sharded program, not speedup).

Usage:
  python scripts/bench_scaling.py                 # real devices, 1..all
  python scripts/bench_scaling.py --virtual 8     # 8 virtual CPU devices
"""
import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="use N virtual CPU devices instead of real chips")
    ap.add_argument("--shots-per-device", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--p", type=float, default=3e-3)
    ap.add_argument("--max-iter", type=int, default=32)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()

    if args.virtual:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()

    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")

    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.codes.hgp import biregular_hgp
    from exp_ldpc_tpu.parallel.mesh import make_mesh
    from exp_ldpc_tpu.parallel.pipeline import StorageDecodePipeline

    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
    n_total = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_total]

    results = []
    base = None
    for n in sizes:
        pipe = StorageDecodePipeline(
            code=code, rounds=args.rounds,
            noise_model=depolarizing_noise(args.p, args.p),
            data_prior=2 / 3 * args.p, meas_prior=2 / 3 * args.p,
            shots_per_device=args.shots_per_device, max_iter=args.max_iter,
            bp_method="ms", ms_scaling_factor=0.625,
            mesh=make_mesh(n))
        pipe.run(jax.random.PRNGKey(0))  # compile
        t0 = time.perf_counter()
        shots = 0
        for i in range(args.reps):
            _f, s, _u = pipe.run(jax.random.PRNGKey(i + 1))
            shots += s
        dt = time.perf_counter() - t0
        rate = shots / dt
        if base is None:
            base = rate
        results.append({
            "devices": n,
            "decoded_shots_per_s": rate,
            "scaling_efficiency": rate / (base * n),
        })
        print(json.dumps(results[-1]), flush=True)

    return 0


if __name__ == "__main__":
    sys.exit(main())
