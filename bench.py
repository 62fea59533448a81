"""Benchmark: BP decode throughput on the (3,4) HGP-225 code, one GPU.

Prints ONE JSON line:
  {"metric": "bp_iter_shots_per_s", "value": N, "unit": "iter*shots/s",
   "formulation": ..., "device": {"platform", "kind", "count"},
   "gpu": "<name>, <power limit>"}

Measured as fixed-32-iteration min-sum batched decodes (batch 1024,
p = 1e-3 syndromes) with the decoder ``make_bp_decoder`` picks for this
code, ``reps`` DISTINCT batches back-to-back.  Exits non-zero without a GPU:
a CPU number is not a device number.

Methodology notes:
  * Each repeat decodes a DISTINCT syndrome batch.
  * The repeats run as one on-device ``lax.scan`` over the stacked batches,
    as the production sweep scans Monte-Carlo batches on device, so
    per-call dispatch latency is excluded from the sustained rate.
  * Two repeat counts are timed and the slope taken, removing the one
    remaining fixed cost (single dispatch + final transfer) from the
    estimate.
"""
import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from exp_ldpc_tpu.codes.hgp import biregular_hgp
    from exp_ldpc_tpu.decoders.bp import BPDecoder, _bp_core, dense_ops_device, resolve_use_matmul
    from exp_ldpc_tpu.decoders.select import make_bp_decoder
    from exp_ldpc_tpu.utils.observability import gpu_power_report

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1

    shots = 1024
    iters = 32
    p = 1e-3
    reps_lo, reps_hi = 8, 64

    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False)
    Hz = code.checks.z
    dec = make_bp_decoder(Hz, error_rate=p, max_iter=iters, bp_method="ms",
                          ms_scaling_factor=0.625, early_stop=False)
    assert isinstance(dec, BPDecoder), type(dec)
    tanner = dec.tanner
    prior = jnp.asarray(dec.prior_llr)
    use_matmul = resolve_use_matmul(tanner, dec.formulation)
    dense = dense_ops_device(tanner) if use_matmul else None
    Hz_dense = Hz.T.toarray()

    rng = np.random.default_rng(0)

    def make_syndromes(n_batches):
        errors = (rng.random((n_batches, shots, Hz.shape[1])) < p).astype(np.uint8)
        stacked = (errors @ Hz_dense) % 2  # (R, S, C)
        return jnp.asarray(stacked.astype(np.uint8).transpose(0, 2, 1))  # (R, C, S)

    @jax.jit
    def run_many(synds):  # (R, C, S) distinct batches, scanned on device
        def step(carry, synd):
            hard, _post, _conv, _it = _bp_core(
                tanner, prior, synd, "ms", iters, jnp.float32(0.625), False,
                dec.formulation, dense)
            return carry + hard.sum(), None

        total, _ = jax.lax.scan(step, jnp.int32(0), synds)
        return total  # tiny device->host transfer

    los = [jax.device_put(make_syndromes(reps_lo)) for _ in range(3)]
    his = [jax.device_put(make_syndromes(reps_hi)) for _ in range(3)]

    t0 = time.perf_counter()
    run_many(los[0]).block_until_ready()
    run_many(his[0]).block_until_ready()
    compile_s = time.perf_counter() - t0

    def timed(xs):
        best = np.inf
        for x in xs:
            t0 = time.perf_counter()
            run_many(x).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best

    per_batch = (timed(his) - timed(los)) / (reps_hi - reps_lo)
    print(json.dumps({
        "metric": "bp_iter_shots_per_s",
        "value": iters * shots / per_batch,
        "unit": "iter*shots/s",
        "formulation": "matmul" if use_matmul else "gather",
        "setup_compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "gpu": gpu_power_report(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
