"""Two-process ``jax.distributed`` dry run: exercise the multi-host path.

The reference scales out with a trivially-working CPU process pool
(``/root/reference/python/qldpc/misc/p_sweep.py:18-29``); this framework's
declared multi-host story is ``jax.distributed`` across hosts
(:func:`exp_ldpc_tpu.parallel.mesh.init_distributed` + global meshes,
SURVEY.md §2.4).  Until round 5 that path was never executed anywhere — a
single-process virtual mesh cannot catch coordinator/topology bugs.  This
module is the executable proof: run as

    python -m exp_ldpc_tpu.parallel.dcn_dryrun --coordinator localhost:PORT \
        --num-processes 2 --process-id K

in N processes (each given its own CPU virtual devices via
``XLA_FLAGS=--xla_force_host_platform_device_count=...``), it joins the
distributed runtime, builds a GLOBAL (data, 1) mesh spanning every
process's devices, runs the fused sample+decode pipeline with the shot
axis sharded across processes, and prints the psum-reduced global counts
as one JSON line.  Every process must print identical counts, and they
must equal a single-process run over the same total device count with the
same key (asserted by ``tests/test_distributed.py``, which spawns the
processes).
"""
from __future__ import annotations

import argparse
import json
import sys


def run_workload(shots_per_device: int = 16, seed: int = 0):
    """The cross-process workload: fused sample+decode on a small HGP with
    shot sharding over the GLOBAL data axis; returns (failures, shots,
    bp_unconverged) — identical on every process (psum-reduced)."""
    import jax

    from ..circuits.noise import depolarizing_noise
    from ..codes.hgp import biregular_hgp
    from .mesh import make_mesh
    from .pipeline import StorageDecodePipeline

    code = biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)
    mesh = make_mesh()  # every global device: spans all processes
    p = 0.01
    pipe = StorageDecodePipeline(
        code=code,
        rounds=2,
        noise_model=depolarizing_noise(p, p),
        data_prior=2 / 3 * p,
        meas_prior=2 / 3 * p,
        shots_per_device=shots_per_device,
        max_iter=8,
        mesh=mesh,
    )
    failures, shots, unconverged = pipe.run(jax.random.PRNGKey(seed))
    return int(failures), int(shots), int(unconverged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", required=True,
                    help="coordinator address, host:port")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--shots-per-device", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    # a CPU dry run wherever it is started
    jax.config.update("jax_platforms", "cpu")

    from .mesh import init_distributed

    pid = init_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert pid == args.process_id, (pid, args.process_id)
    assert jax.process_count() == args.num_processes

    failures, shots, unconverged = run_workload(
        args.shots_per_device, args.seed)
    print(json.dumps({
        "process_id": pid,
        "num_processes": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "failures": failures,
        "shots": shots,
        "bp_unconverged": unconverged,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
