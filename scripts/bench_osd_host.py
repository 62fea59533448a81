#!/usr/bin/env python
"""Host OSD throughput on realistic BP-failure posteriors.

Quantifies the scaling wall of the bposd contract (OSD touches only the
BP-unconverged shots, reference ``misc/_experiment.py:62-83``): at the top
circuit-noise campaign points a large share of shots ship to host OSD, so
the sustained campaign rate is bounded by host-OSD shots/s.  This measures the
threaded C++ kernel (``native/gf2_kernels.cpp::osd_batch``) on the
spacetime matrix the campaign actually decodes (HGP-225, rounds=4), with
posteriors taken from genuinely BP-unconverged shots under circuit noise.

  python scripts/bench_osd_host.py --out chiprun_out/osd_host_throughput.jsonl
"""
import argparse
import json
import os
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--p", type=float, default=1.2e-3)
    ap.add_argument("--shots", type=int, default=4096,
                    help="sampled shots to harvest BP failures from")
    ap.add_argument("--bench-shots", type=int, default=512,
                    help="OSD batch size per timing run")
    ap.add_argument("--osd-order", type=int, default=7)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")  # host benchmark: no device

    from exp_ldpc_tpu.circuits.noise import circuit_noise
    from exp_ldpc_tpu.circuits.storage_sim import build_storage_simulation
    from exp_ldpc_tpu.codes.hgp import biregular_hgp
    from exp_ldpc_tpu.decoders.osd import osd_decode_batch
    from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode
    from exp_ldpc_tpu.decoders.spacetime_bp import SpacetimeBPDecoder
    from exp_ldpc_tpu.sampler.reference import FrameSampler

    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
    Hz = code.checks.z
    r, n = Hz.shape
    R = args.rounds
    st = SpacetimeCode(Hz, R)
    Hst = st.spacetime_check_matrix.tocsr()

    # circuit-noise records -> differenced spacetime syndromes (the decode
    # input of the campaign's top point)
    sim = build_storage_simulation(R, circuit_noise(args.p, args.p), code)
    fs = FrameSampler(sim.circuit, seed=7)
    rec = np.asarray(fs.sample(args.shots))
    mpr = code.checks.x.shape[0] + r
    hist = rec[:, : mpr * R].reshape(args.shots, R, mpr)[
        :, :, code.checks.x.shape[0]:].astype(np.int64)
    readout = rec[:, mpr * R: mpr * R + n].astype(np.int64)
    synd = st.syndrome_from_history_batch(hist, readout)

    # depth-aware data prior (matches validate_ler's circuit binding)
    steps = max(int(code.checks.x.sum(axis=0).max()),
                int(code.checks.x.sum(axis=1).max())) + max(
                    int(code.checks.z.sum(axis=0).max()),
                    int(code.checks.z.sum(axis=1).max()))
    prior = np.concatenate([np.full((R + 1) * n, args.p * steps),
                            np.full(R * r, args.p)])
    bp = SpacetimeBPDecoder.from_check_matrix(
        Hz, R, channel_probs=prior, max_iter=48, bp_method="ms",
        ms_scaling_factor=0.625, early_stop=False)
    _hard, post, conv, _it = bp.decode_batch(synd)
    fails = np.nonzero(~np.asarray(conv))[0]
    print(f"harvested {len(fails)} BP-unconverged / {args.shots} shots "
          f"at p={args.p}")
    if len(fails) == 0:
        raise SystemExit("no BP failures at this p; raise --p")
    idx = fails[np.arange(args.bench_shots) % len(fails)]
    synd_b = synd[idx]
    post_b = np.asarray(post)[idx]

    ncpu = os.cpu_count()
    records = []
    for method in ("osd0", "osd_cs"):
        for nthreads in sorted({1, 2, ncpu}):
            # warm once (page-in, lazy csr->dense), then time
            osd_decode_batch(Hst, synd_b[:32], post_b[:32], method,
                             args.osd_order, nthreads=nthreads)
            t0 = time.perf_counter()
            out = osd_decode_batch(Hst, synd_b, post_b, method,
                                   args.osd_order, nthreads=nthreads)
            dt = time.perf_counter() - t0
            # validity: OSD output must satisfy its syndrome exactly
            par = (out.astype(np.int64) @ Hst.T.toarray().astype(np.int64)) % 2
            assert (par == synd_b).all(), "OSD output violates syndrome"
            rate = args.bench_shots / dt
            rec_out = {
                "bench": "osd_host", "matrix": f"hgp225-spacetime-r{R}",
                "rows": int(Hst.shape[0]), "cols": int(Hst.shape[1]),
                "method": method, "osd_order": args.osd_order,
                "nthreads": nthreads, "host_cores": ncpu,
                "shots": args.bench_shots, "walltime_s": dt,
                "shots_per_s": rate,
                "p_source": args.p,
            }
            records.append(rec_out)
            print(json.dumps(rec_out), flush=True)

    if args.out:
        with open(args.out, "a") as f:
            for rec_out in records:
                f.write(json.dumps(rec_out) + "\n")


if __name__ == "__main__":
    main()
