#!/usr/bin/env python
"""GPU smoke check: the user's sweep, end to end, on one NVIDIA card.

    python chip_smoke.py               # phases (a)-(d) on one card
    python chip_smoke.py --four-cards  # only the multi-device paths, 4 cards

Phases, in one JAX process (``nvidia-smi`` runs as a child that never
imports JAX):

  (a) device: the card's name and power limit, the JAX device, the native
      GF(2) library that host OSD needs.  No GPU, no run.
  (b) full-width parity: structured spacetime BP (``_stbp_core``, both
      routing formulations, and the Triton kernel the pipeline runs on the
      GPU) and flat BP (``make_bp_decoder``) on HGP-225 against the numpy
      oracle (``decoders/bp_numpy.py``), plus the decode time of the XLA
      core and of the kernel.
  (c) the user's sweep: ``p_sweep`` through the fused pipeline (device
      sampler -> spacetime BP -> host BP+OSD of the BP failures) on HGP-225
      under circuit noise, 4 rounds, >= 100,000 shots per point, and its
      LER against the CPU oracle chain (CPU frame sampler + host driver).
  (d) the large-code path: the n=4862 cyclic lifted product, 8 rounds,
      through ``StorageDecodePipeline.run`` at the largest batch that fits.

Any failed check raises; the last line of standard output is a JSON object
``{"ok": true, "device": {...}}`` only when every phase passed.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# (b) sizes
P_PARITY = 1e-3           # channel prior of the parity decodes
ERR_PARITY_ST = 4e-3      # error draws: ~6 flips per shot, so a share of
ERR_PARITY_FLAT = 2e-2    # shots stays unconverged and the comparison
SHOTS_PARITY = 2048       # covers unconverged decisions too
SHOTS_ORACLE = 256
ITERS_PARITY = 32

# Tolerances of (b).  Min-sum with HIGHEST-precision dots differs from the
# oracle only in the f32 summation order of the variable update, which can
# move a posterior that sits at zero; sum-product also runs the GPU's own
# log/tanh.  Either can flip the convergence of a knife-edge shot, or send a
# shot that converged in both to a different valid fixed point.  Syndrome
# validity of a converged shot has no tolerance: it is a parity check.
TOL_CONV = {"ms": 0.99, "ps": 0.98}        # share of shots, flags agree
TOL_BOTH = {"ms": 0.99, "ps": 0.99}        # share of both-converged shots,
                                           # hard decisions identical
Z_MAX = 3.0                                # (c) LER two-proportion z bound

# (c) sizes: the README quickstart's decoder options, >= 100,000 shots/point
SWEEP_SHOTS = 100_000
SWEEP_SPD = 16384
ORACLE_SHOTS = 20_000
# (d) batch search: largest power of two within this share of device memory
LARGE_MEM_SHARE = 0.6


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def hgp225():
    from exp_ldpc_tpu.codes.hgp import biregular_hgp

    return biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)


def cyclic_lp_4862():
    """The n=4862 abelian (cyclic) lifted product, 1540 Z checks of weight
    24: 56,078 spacetime columns at 8 rounds."""
    import warnings

    from exp_ldpc_tpu.codes.lifted import lifted_product_code_cyclic

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return lifted_product_code_cyclic(
            q=22, m=1, w=14, r=5, seed=42, compute_logicals=True)


def memory_line(ma):
    if ma is None:
        return "memory_analysis=None"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis " + " ".join(
        f"{k.replace('_size_in_bytes', '')}={getattr(ma, k, None)}" for k in keys)


def memory_stat(name):
    import jax

    return (jax.devices()[0].memory_stats() or {}).get(name)


# ----------------------------------------------------------------- (a)
def phase_device(n_cards):
    import jax

    from exp_ldpc_tpu.native import get_gf2_lib
    from exp_ldpc_tpu.utils.observability import gpu_power_report

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devs[0].platform!r})")
    if len(devs) < n_cards:
        fail(f"need {n_cards} GPUs, JAX found {len(devs)}")
    report = gpu_power_report()
    if not report:
        fail("nvidia-smi gave no name and power limit")
    log("(a) nvidia-smi name, power.limit:")
    for line in report.splitlines():
        log(f"    {line}")
    log(f"(a) jax {jax.__version__} devices: {devs} platform={devs[0].platform} "
        f"kind={devs[0].device_kind}")
    if n_cards == 1:
        if get_gf2_lib() is None:
            fail("native GF(2) library did not load: host OSD would fall back "
                 "to the much slower numpy path")
        log("(a) native GF(2) library loaded")
    return devs


# ----------------------------------------------------------------- (b)
def _agreement(name, method, synd, H, h, c, ho, co):
    """Device (h, c) against oracle (ho, co) decisions on syndromes ``synd``
    of the dense 0/1 matrix ``H``; fails outside the tolerances above."""
    both = c & co
    conv_agree = float((c == co).mean())
    both_agree = float((h[both] == ho[both]).all(axis=1).mean()) if both.any() else 1.0
    valid = ((h.astype(np.int64) @ H.T) % 2 == synd).all(axis=1)
    log(f"(b) {name} {method}: conv agree {conv_agree:.4f} "
        f"(dev {int(c.sum())}/{c.size}, oracle {int(co.sum())}/{co.size}), "
        f"both-converged decisions identical {both_agree:.4f}, "
        f"converged shots syndrome-valid {int(valid[c].sum())}/{int(c.sum())}")
    if conv_agree < TOL_CONV[method]:
        fail(f"{name} {method}: convergence agreement {conv_agree} < {TOL_CONV[method]}")
    if both_agree < TOL_BOTH[method]:
        fail(f"{name} {method}: decision agreement {both_agree} < {TOL_BOTH[method]}")
    if not valid[c].all():
        fail(f"{name} {method}: a converged shot is not syndrome-valid")


def phase_parity():
    import jax
    import jax.numpy as jnp

    from exp_ldpc_tpu.decoders.bp import dense_ops_device, priors_to_llr
    from exp_ldpc_tpu.decoders.bp_numpy import NumpyBPDecoder
    from exp_ldpc_tpu.decoders.select import make_bp_decoder
    from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode
    from exp_ldpc_tpu.decoders.spacetime_bp import _stbp_core
    from exp_ldpc_tpu.decoders.spacetime_bp_triton import stbp_triton_fixed
    from exp_ldpc_tpu.decoders.tanner import TannerELL

    code = hgp225()
    Hz = code.checks.z
    rounds = 4
    st = SpacetimeCode(Hz, rounds)
    Hst = st.spacetime_check_matrix.toarray().astype(np.int64) % 2
    log(f"(b) HGP-225 x {rounds} rounds: spacetime checks {Hst.shape[0]} x "
        f"columns {Hst.shape[1]}")
    rng = np.random.default_rng(0)
    errs = (rng.random((SHOTS_PARITY, Hst.shape[1])) < ERR_PARITY_ST).astype(np.int64)
    synd = ((errs @ Hst.T) % 2).astype(np.uint8)
    sub = synd[:SHOTS_ORACLE]
    tanner = TannerELL.from_check_matrix(Hz)
    prior = jnp.asarray(priors_to_llr(np.full(Hst.shape[1], P_PARITY)))
    synd_dev = jnp.asarray(synd.T)
    for method, msf in (("ms", 0.625), ("ps", 0.0)):
        oracle = NumpyBPDecoder.from_check_matrix(
            Hst, error_rate=P_PARITY, max_iter=ITERS_PARITY, bp_method=method,
            ms_scaling_factor=msf, early_stop=False)
        ho, _po, co, _io = oracle.decode_batch(sub)
        for form in ("matmul", "gather", "triton"):
            dense = dense_ops_device(tanner) if form == "matmul" else None
            if form == "triton":
                h, _p, c, _i = stbp_triton_fixed(
                    tanner, rounds, prior, synd_dev, method, ITERS_PARITY, msf)
            else:
                h, _p, c, _i = _stbp_core(
                    tanner, rounds, prior, synd_dev, method, ITERS_PARITY,
                    jnp.float32(msf), False, form, dense)
            h, c = np.asarray(h).T, np.asarray(c)
            valid_all = ((h.astype(np.int64) @ Hst.T) % 2 == synd).all(axis=1)
            if not valid_all[c].all():
                fail(f"spacetime {form} {method}: converged shot not syndrome-valid")
            _agreement(f"spacetime-{form}", method, sub, Hst,
                       h[:SHOTS_ORACLE], c[:SHOTS_ORACLE], ho, co)

    # flat BP through the selection module
    Hd = Hz.toarray().astype(np.int64) % 2
    errs = (rng.random((SHOTS_PARITY, Hd.shape[1])) < ERR_PARITY_FLAT).astype(np.int64)
    synd = ((errs @ Hd.T) % 2).astype(np.uint8)
    sub = synd[:SHOTS_ORACLE]
    for method, msf in (("ms", 0.625), ("ps", 0.0)):
        kw = dict(error_rate=ERR_PARITY_FLAT, max_iter=ITERS_PARITY,
                  bp_method=method, ms_scaling_factor=msf, early_stop=False)
        dec = make_bp_decoder(Hz, **kw)
        h, _p, c, _i = map(np.asarray, dec.decode_batch(synd))
        ho, _po, co, _io = NumpyBPDecoder.from_check_matrix(Hz, **kw).decode_batch(sub)
        _agreement("flat", method, sub, Hd, h[:SHOTS_ORACLE], c[:SHOTS_ORACLE], ho, co)

    # decode time alone, XLA core and kernel (48 iterations, distinct
    # inputs, in turns: xla, kernel, kernel, xla)
    dense = dense_ops_device(tanner)
    runs = {
        "_stbp_core": lambda s: _stbp_core(tanner, rounds, prior, s, "ms", 48,
                                           jnp.float32(0.625), False, "auto", dense),
        "triton kernel": lambda s: stbp_triton_fixed(tanner, rounds, prior, s, "ms",
                                                     48, 0.625),
    }
    for S in (4096, 16384):
        errs = (rng.random((3, S, Hst.shape[1])) < ERR_PARITY_ST).astype(np.int64)
        batches = [jnp.asarray(((e @ Hst.T) % 2).astype(np.uint8).T) for e in errs]
        times = {k: [] for k in runs}
        for k in runs:
            t0 = time.perf_counter()
            jax.block_until_ready(runs[k](batches[0]))
            log(f"(b) {k} S={S}: first call {time.perf_counter() - t0:.3f}s "
                f"(compile included)")
        for k in ("_stbp_core", "triton kernel", "triton kernel", "_stbp_core"):
            t0 = time.perf_counter()
            for s in batches[1:]:
                out = runs[k](s)
            jax.block_until_ready(out)
            times[k].append((time.perf_counter() - t0) / (len(batches) - 1))
        for k, v in times.items():
            log(f"(b) {k} ms 48 iter S={S}: {min(v) * 1e3:.2f} ms/batch "
                f"(runs {[round(x * 1e3, 2) for x in v]}), {S / min(v):.0f} shots/s")


# ----------------------------------------------------------------- (c)
def sweep_kwargs(code):
    from exp_ldpc_tpu.circuits.noise import circuit_noise

    return dict(
        code=code, rounds=4, decoder_mode="bposd",
        noise_model=circuit_noise,
        noise_model_args=lambda p: {"p": p, "pm": p},
        # depth-aware data prior (scripts/validate_ler.py): a data qubit
        # sees ~(x_steps + z_steps) two-qubit gates per round
        data_prior=lambda p, xs, zs: p * (xs + zs),
        meas_prior=lambda p, xs, zs: p,
        bp_osd_options=dict(bp_method="ms", ms_scaling_factor=0.625,
                            max_iter=48, osd_method="osd_cs", osd_order=7),
    )


def phase_sweep():
    from exp_ldpc_tpu.experiments.p_sweep import p_sweep

    code = hgp225()
    kw = sweep_kwargs(code)
    stats = []
    t0 = time.perf_counter()
    recs = p_sweep(samples=SWEEP_SHOTS, p_values=np.array([1e-3, 2e-3]), seed=11,
                   pipeline={"mesh_devices": 1, "shots_per_device": SWEEP_SPD},
                   point_stats=stats, **kw)
    log(f"(c) sweep wall {time.perf_counter() - t0:.1f}s")
    for rec, st in zip(recs, stats):
        log(f"(c) p={rec['p_ph']:g}: failures={rec['failures']} shots={rec['samples']} "
            f"osd_decoded={st['osd_decoded']} batches={st['batches']} "
            f"first_batch_s={st['first_batch_s']:.3f} "
            f"steady_batch_s={st['steady_batch_s']:.3f} walltime={rec['walltime']:.1f}s")
        log(f"(c)   {memory_line(st['memory_analysis'])} "
            f"peak_bytes_in_use={st['peak_bytes_in_use']}")
        if rec["samples"] < SWEEP_SHOTS:
            fail(f"p={rec['p_ph']}: only {rec['samples']} shots")
        if not 0 < rec["failures"] < rec["samples"]:
            fail(f"p={rec['p_ph']}: failure count {rec['failures']} out of range")
    if not recs[0]["failures"] / recs[0]["samples"] < recs[1]["failures"] / recs[1]["samples"]:
        fail("LER does not grow with p")

    # the CPU oracle chain at the upper point: CPU frame sampler + the host
    # BP+OSD driver, decoded with the same options
    t0 = time.perf_counter()
    ref = p_sweep(samples=ORACLE_SHOTS, p_values=np.array([2e-3]), seed=23,
                  use_device_sampler=False, **kw)[0]
    f1, n1 = recs[1]["failures"], recs[1]["samples"]
    f2, n2 = ref["failures"], ref["samples"]
    pool = (f1 + f2) / (n1 + n2)
    z = abs(f1 / n1 - f2 / n2) / np.sqrt(pool * (1 - pool) * (1 / n1 + 1 / n2))
    log(f"(c) CPU oracle chain p=2e-3: failures={f2}/{n2} (LER {f2 / n2:.5f}) vs "
        f"pipeline {f1}/{n1} (LER {f1 / n1:.5f}): z={z:.3f} "
        f"[{time.perf_counter() - t0:.1f}s]")
    if z > Z_MAX:
        fail(f"pipeline LER differs from the CPU oracle chain: z={z:.2f} > {Z_MAX}")


# ----------------------------------------------------------------- (d)
def phase_large():
    import jax
    import jax.numpy as jnp
    from scipy import sparse

    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.decoders.bp import priors_to_llr
    from exp_ldpc_tpu.decoders.spacetime_bp import _stbp_core
    from exp_ldpc_tpu.parallel.pipeline import StorageDecodePipeline

    t0 = time.perf_counter()
    code = cyclic_lp_4862()
    rounds, p, iters = 8, 1e-3, 32
    log(f"(d) cyclic LP n={code.num_qubits}, Z checks {code.checks.z.shape[0]}, "
        f"{rounds} rounds [{time.perf_counter() - t0:.1f}s to build]")

    def build(S):
        return StorageDecodePipeline(
            code=code, rounds=rounds, noise_model=depolarizing_noise(p, p),
            data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=S,
            max_iter=iters, bp_method="ms", ms_scaling_factor=0.625,
            osd_fallback_cap=0)

    # largest power-of-two batch whose compiled footprint fits in
    # LARGE_MEM_SHARE of the device memory, from a probe compile
    # (conservative: the probe's fixed bytes are counted as if they grew
    # with the batch)
    probe_S = 256
    ma = build(probe_S).memory_analysis()
    per_shot = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
                + ma.output_size_in_bytes) / probe_S
    limit = memory_stat("bytes_limit")
    S = probe_S
    while 2 * S * per_shot < LARGE_MEM_SHARE * limit:
        S *= 2
    log(f"(d) probe S={probe_S}: {per_shot / 2**20:.2f} MiB/shot, "
        f"bytes_limit={limit} -> shots_per_device={S}")
    pipe = build(S)
    t0 = time.perf_counter()
    f, s, u = pipe.run(jax.random.PRNGKey(3))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    f2, s2, u2 = pipe.run(jax.random.PRNGKey(4))
    second = time.perf_counter() - t0
    log(f"(d) batch 1: failures={f} shots={s} bp_unconverged={u} "
        f"[{first:.2f}s, compile included]; batch 2: failures={f2} "
        f"bp_unconverged={u2} [{second:.2f}s]")
    log(f"(d)   {memory_line(pipe.memory_analysis())} peak_bytes_in_use={memory_stat('peak_bytes_in_use')}")
    if s != S or s2 != S:
        fail("wrong shot count")

    # syndrome validity of the converged shots of the same decode core on
    # spacetime errors drawn on the host, checked with the sparse matrix
    Hst = pipe.spacetime.spacetime_check_matrix.tocsr()
    n_chk = 1024
    rng = np.random.default_rng(5)
    errs = sparse.random(n_chk, Hst.shape[1], density=p, format="csr",
                         random_state=rng, data_rvs=np.ones).astype(np.int64)
    synd = np.asarray((Hst @ errs.T).T.todense() % 2, dtype=np.uint8)
    h, _post, c, _it = _stbp_core(
        pipe.tanner, rounds, jnp.asarray(pipe.prior_llr), jnp.asarray(synd.T),
        "ms", iters, jnp.float32(0.625), False, "auto", None)
    h, c = np.asarray(h).T, np.asarray(c)
    resid = np.asarray((Hst @ sparse.csr_matrix(h[c].astype(np.int64)).T).T.todense() % 2)
    valid = (resid == synd[c]).all(axis=1)
    log(f"(d) decode check: converged {int(c.sum())}/{n_chk}, "
        f"syndrome-valid {int(valid.sum())}/{int(c.sum())}")
    if not c.any() or not valid.all():
        fail("large-code decode: converged shots not syndrome-valid")


# ----------------------------------------------------------------- (f)
def phase_four_cards():
    import jax

    from exp_ldpc_tpu.experiments.p_sweep import p_sweep
    from exp_ldpc_tpu.parallel.pipeline import StorageDecodePipeline

    sys.path.insert(0, HERE)
    from __graft_entry__ import dryrun_multichip

    from exp_ldpc_tpu.circuits.noise import depolarizing_noise

    code = hgp225()
    # the CLI's phenomenological model (qldpc-p-sweep): a much smaller
    # circuit than (c)'s circuit noise, so the mesh program compiles fast
    kw = dict(sweep_kwargs(code), noise_model=depolarizing_noise,
              data_prior=lambda p, xs, zs: 2 / 3 * p,
              meas_prior=lambda p, xs, zs: 2 / 3 * p)
    spd, p, seed = 4096, 1e-2, 7
    t0 = time.perf_counter()
    rec = p_sweep(samples=4 * spd, p_values=np.array([p]), seed=seed,
                  pipeline={"mesh_devices": 4, "shots_per_device": spd}, **kw)[0]
    log(f"(f) p_sweep --mesh_devices 4: failures={rec['failures']} "
        f"shots={rec['samples']} [{time.perf_counter() - t0:.1f}s]")
    # the same per-shard keys on one device each: p_sweep's one batch uses
    # split(PRNGKey(seed), 1)[0]; the mesh step splits that over the shards
    batch_key = jax.random.split(jax.random.PRNGKey(seed), 1)[0]
    shard_keys = jax.random.split(batch_key, 4)
    opts = kw["bp_osd_options"]
    steps = [max(int(H.sum(axis=0).max()), int(H.sum(axis=1).max()))
             for H in (code.checks.x, code.checks.z)]
    pipe = StorageDecodePipeline(
        code=code, rounds=4, noise_model=kw["noise_model"](**kw["noise_model_args"](p)),
        data_prior=kw["data_prior"](p, *steps), meas_prior=kw["meas_prior"](p, *steps),
        shots_per_device=spd, max_iter=opts["max_iter"],
        bp_method=opts["bp_method"], ms_scaling_factor=opts["ms_scaling_factor"],
        osd_fallback_cap=spd, osd_options=opts)
    f_tot = s_tot = 0
    for k in shard_keys:
        f, s, _o = pipe.run_bposd(k)
        f_tot, s_tot = f_tot + f, s_tot + s
    log(f"(f) four single-device runs: failures={f_tot} shots={s_tot}")
    if (f_tot, s_tot) != (rec["failures"], rec["samples"]):
        fail("mesh sweep counts differ from the single-device runs")
    t0 = time.perf_counter()
    dryrun_multichip(4, code=code, shots_per_device=256, max_iter=32)
    log(f"(f) sharded BP and rounds-sharded spacetime BP checks passed "
        f"[{time.perf_counter() - t0:.1f}s]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on four cards")
    args = ap.parse_args(argv)

    try:
        import exp_ldpc_tpu
    except ImportError as e:
        fail(f"the package is not beside this script: {e}")
    pkg = os.path.dirname(os.path.abspath(exp_ldpc_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        fail(f"imported the package from {pkg}, not from this checkout")

    import jax

    n_cards = 4 if args.four_cards else 1
    devs = phase_device(n_cards)
    from exp_ldpc_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # before the first compile of the process
    t_all = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        for name, phase in (("b", phase_parity), ("c", phase_sweep),
                            ("d", phase_large)):
            t0 = time.perf_counter()
            phase()
            log(f"({name}) passed [{time.perf_counter() - t0:.1f}s]")
    log(f"all phases passed [{time.perf_counter() - t_all:.1f}s]")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
