"""Physical-error-rate sweep driver.

Behavioral parity with ``/root/reference/python/qldpc/misc/p_sweep.py``:
same CLI surface (code file, --samples, --p_sweep "(lo,hi,points)",
--rounds, --decoder_mode, --linspace, BP+OSD options) and the same CSV
output schema (p_ph, failures, samples, walltime + flattened decoder
options).

The parallelism is re-designed for the hardware: where the reference forks a
``multiprocessing.Pool`` of CPU workers each decoding shot-by-shot
(``p_sweep.py:17-29``), here every sweep point is ONE batched
sample+decode call (device sampler + vectorized BP, OSD on the few BP
failures) — optionally sharded over a device mesh by the caller via
:mod:`exp_ldpc_tpu.parallel`.
"""
from __future__ import annotations

import csv
import json
import sys
import time
from argparse import ArgumentParser
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..decoders.drivers import add_bposd_args, load_code, run_simulation, unpack_bposd_args
from ..utils.observability import get_logger

__all__ = ["p_sweep", "p_sweep_main", "parse_sweep_spec", "write_csv"]

_log = get_logger("p_sweep")


def _load_checkpoint(path: Path):
    """Completed sweep-point records from a JSONL checkpoint (resume support).

    The reference has no partial-sweep resume at all — a crashed Pool loses
    the whole sweep (SURVEY.md §5 'Checkpoint / resume').  Here every
    completed point is appended to the checkpoint file as one JSON line, and
    an interrupted sweep restarted with the same checkpoint skips them.
    """
    records = []
    if path.exists():
        with path.open() as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
    return records


class _PipelineSweeper:
    """Mesh-sharded fused sample+decode for the ``bposd`` sweep mode.

    The reference saturates one host with a multiprocessing Pool per sweep
    point (``misc/p_sweep.py:17-29``); here each point is a handful of fully
    fused on-device batches (:class:`~exp_ldpc_tpu.parallel.pipeline.
    StorageDecodePipeline`) with host-side OSD touching only the BP
    failures.  ONE compile serves the whole p grid (noise probabilities and
    priors rebind as runtime arguments)."""

    def __init__(self, code, rounds, noise_model, noise_model_args,
                 meas_prior, data_prior, bp_osd_options,
                 mesh_devices: int, shots_per_device: int,
                 use_x_logicals: bool = False, mode: str = "bposd"):
        checks = code.checks
        self._x_steps = max(int(checks.x.sum(axis=0).max()),
                            int(checks.x.sum(axis=1).max()))
        self._z_steps = max(int(checks.z.sum(axis=0).max()),
                            int(checks.z.sum(axis=1).max()))
        self.code = code
        self.rounds = rounds
        self.noise_model = noise_model
        self.noise_model_args = noise_model_args
        self.meas_prior = meas_prior
        self.data_prior = data_prior
        self.options = dict(bp_osd_options)
        self.shots_per_device = shots_per_device
        self.use_x_logicals = use_x_logicals
        self.mode = mode
        self.mesh = None
        self.n_devices = 1
        if mesh_devices > 1:
            from ..parallel.mesh import make_mesh

            self.mesh = make_mesh(mesh_devices)
            self.n_devices = mesh_devices
        self.pipe = None

    def run_point(self, p_ph: float, samples: int, seed: Optional[int],
                  with_memory: bool = False):
        """-> (failures, shots, stats): stats holds the OSD-decoded shot
        count and the batch times; ``with_memory`` adds the compiled step's
        memory analysis and the device's peak bytes in use."""
        import jax

        from ..parallel.pipeline import StorageDecodePipeline

        noise = self.noise_model(**self.noise_model_args(p_ph))
        data_p = self.data_prior(p_ph, self._x_steps, self._z_steps)
        meas_p = self.meas_prior(p_ph, self._x_steps, self._z_steps)
        if self.pipe is None:
            opts = self.options
            self.pipe = StorageDecodePipeline(
                code=self.code,
                rounds=self.rounds,
                noise_model=noise,
                data_prior=data_p,
                meas_prior=meas_p,
                shots_per_device=self.shots_per_device,
                max_iter=int(opts.get("max_iter", 40)),
                bp_method=opts.get("bp_method", "ps"),
                ms_scaling_factor=float(opts.get("ms_scaling_factor", 0.0)),
                mesh=self.mesh,
                osd_fallback_cap=self.shots_per_device,
                osd_options=opts,
                use_x_logicals=self.use_x_logicals,
                mode=self.mode,
                # two-tier adaptive decode (mode "bposd"): short stage-1
                # budget, fixed-shape redecode of the unconverged
                tier1_iters=(int(opts.get("tier1_iters", 0) or 0)
                             if self.mode == "bposd" else 0),
            )
        else:
            self.pipe.rebind_noise(noise, data_p, meas_p)

        per_batch = self.shots_per_device * self.n_devices
        n_batches = max(1, -(-samples // per_batch))
        key = jax.random.PRNGKey(seed if seed is not None else 0)
        failures = total = osd = 0
        batch_s = []
        for k in jax.random.split(key, n_batches):
            t0 = time.perf_counter()
            f, s, o = self.pipe.run_bposd(k)
            batch_s.append(time.perf_counter() - t0)
            failures += f
            total += s
            osd += o
        stats = {"osd_decoded": osd, "batches": n_batches,
                 "first_batch_s": batch_s[0],
                 "steady_batch_s": (float(np.mean(batch_s[1:]))
                                    if n_batches > 1 else None)}
        if with_memory:
            stats["memory_analysis"] = self.pipe.memory_analysis()
            stats["peak_bytes_in_use"] = (
                jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
        return failures, total, stats


def p_sweep(samples, p_values, noise_model, noise_model_args, meas_prior, data_prior,
            seed=None, use_device_sampler=None, checkpoint: Optional[Path] = None,
            pipeline: Optional[dict] = None,
            point_stats: Optional[List[Dict]] = None, **kwargs) -> List[Dict]:
    """Sweep physical error rates; returns one record (dict) per point, in
    the reference's CSV schema (see :func:`write_csv`).

    With ``checkpoint`` set, completed points are streamed to a JSONL file
    and a restarted sweep resumes after the last completed point.  With
    ``pipeline`` set (dict of ``mesh_devices``/``shots_per_device``), the
    ``bposd`` mode runs through the fused mesh-sharded device pipeline;
    a ``point_stats`` list then receives each point's OSD count, batch
    times and device memory (kept out of the records, whose schema is the
    reference's).
    """
    data = []
    done_p = set()
    if checkpoint is not None:
        checkpoint = Path(checkpoint)
        data = _load_checkpoint(checkpoint)
        done_p = {round(float(rec["p_ph"]), 12) for rec in data}
        if data:
            _log.info("resuming sweep: %d completed points in %s", len(data), checkpoint)

    sweeper = None
    if pipeline is not None:
        mode = kwargs.get("decoder_mode", "bposd")
        if mode not in ("bposd", "bposd_single_shot", "bposd_hybrid"):
            raise ValueError(
                "the fused pipeline implements the bposd/bposd_single_shot/"
                "bposd_hybrid modes; drop --pipeline for other decoder modes")
        sweeper = _PipelineSweeper(
            code=kwargs["code"],
            rounds=kwargs.get("rounds", 1),
            noise_model=noise_model,
            noise_model_args=noise_model_args,
            meas_prior=meas_prior,
            data_prior=data_prior,
            bp_osd_options=kwargs["bp_osd_options"],
            mesh_devices=int(pipeline.get("mesh_devices", 1)),
            shots_per_device=int(pipeline.get("shots_per_device", 4096)),
            use_x_logicals=bool(kwargs.get("use_x_logicals", False)),
            mode=mode,
        )

    for i, p_ph in enumerate(p_values):
        if round(float(p_ph), 12) in done_p:
            continue
        time_start = datetime.now()
        if sweeper is not None:
            failures, total, stats = sweeper.run_point(
                p_ph, samples, seed + i if seed is not None else None,
                with_memory=point_stats is not None)
            _log.info("p=%g: %s", p_ph, stats)
            if point_stats is not None:
                point_stats.append({"p_ph": p_ph, **stats})
        else:
            logical_values = run_simulation(
                samples,
                noise_model=noise_model,
                noise_model_args=noise_model_args(p_ph),
                meas_prior=lambda xs, zs, p=p_ph: meas_prior(p, xs, zs),
                data_prior=lambda xs, zs, p=p_ph: data_prior(p, xs, zs),
                seed=(seed + i if seed is not None else None),
                use_device_sampler=use_device_sampler,
                **kwargs,
            )
            failures, total = sum(logical_values), len(logical_values)
        runtime = (datetime.now() - time_start).total_seconds()
        point = {
            "p_ph": p_ph,
            "failures": failures,
            "samples": total,
            "walltime": runtime,
            **kwargs,
            **(kwargs["bp_osd_options"]),
        }
        del point["code"]
        del point["bp_osd_options"]
        _log.info("p=%g: %d/%d failures in %.1fs", p_ph, point["failures"],
                  point["samples"], runtime)
        data.append(point)
        if checkpoint is not None:
            def _jsonable(v):
                if hasattr(v, "item"):  # numpy scalars
                    v = v.item()
                return v if isinstance(v, (int, float, str, bool, type(None))) else repr(v)
            with checkpoint.open("a") as f:
                json.dump({k: _jsonable(v) for k, v in point.items()}, f)
                f.write("\n")
    return data


def write_csv(records: List[Dict], out) -> None:
    """Write sweep records as CSV in the layout ``pandas.DataFrame.to_csv``
    gives (the schema shared with the reference): a leading unnamed index
    column, then the columns in order of first appearance."""
    columns: List[str] = []
    for rec in records:
        columns.extend(k for k in rec if k not in columns)
    writer = csv.writer(out, lineterminator="\n")
    writer.writerow([""] + columns)
    for i, rec in enumerate(records):
        writer.writerow([i] + ["" if rec.get(c) is None else str(rec[c])
                               for c in columns])


def parse_sweep_spec(x: str) -> Tuple[float, float, int]:
    """Parse a sweep-grid spec like ``(1e-3, 0.05, 6)``.

    Accepts the same mini-DSL as the reference CLI (``misc/p_sweep.py:43-55``):
    a parenthesized triple ``(lower, upper, points)`` with float bounds
    ``lower <= upper`` and a positive integer point count.
    """
    body = x.strip()
    if not (body.startswith("(") and body.endswith(")")):
        raise RuntimeError(f"sweep spec must be a parenthesized triple, got {x!r}")
    parts = body[1:-1].split(",")
    if len(parts) != 3:
        raise RuntimeError(
            f"sweep spec needs exactly 3 comma-separated fields "
            f"(lower, upper, points), got {len(parts)} in {x!r}"
        )
    try:
        lower, upper, points = float(parts[0]), float(parts[1]), int(parts[2])
    except ValueError as exc:
        raise RuntimeError(f"sweep spec {x!r}: {exc}") from exc
    if points <= 0:
        raise RuntimeError(f"sweep spec {x!r}: point count must be positive")
    if lower > upper:
        raise RuntimeError(f"sweep spec {x!r}: lower bound exceeds upper bound")
    return (lower, upper, points)


def p_sweep_main(noise_model_args, noise_model, meas_prior, data_prior):
    """argparse main (reference ``:57-78``)."""
    parser = ArgumentParser(
        description="Perform a batched sweep in the physical error rate for the given "
        "quantum code under BP+OSD"
    )
    parser.add_argument("code", type=Path)
    parser.add_argument("--samples", type=int, help="Monte-Carlo shots per sweep point")
    parser.add_argument(
        "--p_sweep",
        type=parse_sweep_spec,
        help="sweep grid as (lower, upper, points)",
    )
    parser.add_argument("--rounds", type=int, help="syndrome-extraction rounds per shot", default=1)
    parser.add_argument(
        "--decoder_mode",
        choices=["bposd", "bposd_single_shot", "bposd_hybrid", "bpd_detector",
                 "relay_bp", "sliding_window", "ssf_single_shot"],
        help="Operate decoder in BP+OSD, BP+OSD (single shot), hybrid BP + (BP+OSD), "
        "detector-model BP, the OSD-free relay-BP ensemble, streaming "
        "sliding-window BP+OSD, or single-shot small-set-flip",
        default="bposd",
    )
    parser.add_argument(
        "--linspace",
        type=bool,
        help="linearly spaced sweep points (default: geometric spacing)",
        default=False,
    )
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--cpu_sampler", action="store_true", help="Use the CPU oracle sampler instead of the device sampler"
    )
    parser.add_argument(
        "--x_basis", action="store_true",
        help="Run the X-basis memory experiment (prepare/read |+>, decode "
        "X errors with the X checks/logicals) instead of the Z basis",
    )
    parser.add_argument(
        "--checkpoint", type=Path, default=None,
        help="JSONL file to stream completed sweep points to; re-running with "
        "the same file resumes after the last completed point",
    )
    parser.add_argument(
        "--pipeline", action="store_true",
        help="Run each sweep point through the fused on-device "
        "sample+decode pipeline (bposd, bposd_single_shot, and bposd_hybrid "
        "modes): BP on device, host BP+OSD redecode of the returned BP "
        "failures, one compile for the whole sweep",
    )
    parser.add_argument(
        "--mesh_devices", type=int, default=1,
        help="Shard pipeline shots over this many devices (data-axis mesh)",
    )
    parser.add_argument(
        "--shots_per_device", type=int, default=4096,
        help="Monte-Carlo sub-batch size per device per pipeline step",
    )
    add_bposd_args(parser)

    args = parser.parse_args(sys.argv[1:])
    code = load_code(args)
    bp_osd_options = unpack_bposd_args(args, code)

    sweep = np.linspace(*args.p_sweep) if args.linspace else np.geomspace(*args.p_sweep)

    result = p_sweep(
        samples=args.samples,
        code=code,
        rounds=args.rounds,
        noise_model=noise_model,
        noise_model_args=noise_model_args,
        meas_prior=meas_prior,
        data_prior=data_prior,
        p_values=sweep,
        decoder_mode=args.decoder_mode,
        bp_osd_options=bp_osd_options,
        use_x_logicals=args.x_basis,
        seed=args.seed,
        use_device_sampler=not args.cpu_sampler,
        checkpoint=args.checkpoint,
        pipeline=(
            {"mesh_devices": args.mesh_devices,
             "shots_per_device": args.shots_per_device}
            if args.pipeline else None
        ),
    )
    write_csv(result, sys.stdout)


def cli_main():
    """Console entry point: pheno noise with the reference's 2/3*p prior
    (``/root/reference/scripts/p_sweep.py:4-11``)."""
    from ..circuits.noise import depolarizing_noise

    p_sweep_main(
        noise_model_args=lambda p: {"p": p, "pm": p},
        noise_model=depolarizing_noise,
        meas_prior=lambda p, x_steps, z_steps: 2 / 3 * p,
        data_prior=lambda p, x_steps, z_steps: 2 / 3 * p,
    )


if __name__ == "__main__":
    cli_main()
