"""p_sweep through the fused mesh-sharded device pipeline
(experiments/p_sweep.py `pipeline=` path, VERDICT item: the BASELINE-scale
sweep must be reachable from the shipped CLI)."""
import numpy as np
import pytest

from exp_ldpc_tpu.circuits.noise import depolarizing_noise
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.experiments.p_sweep import p_sweep


@pytest.fixture(scope="module")
def code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


def common_kwargs(code, **over):
    kw = dict(
        samples=64,
        code=code,
        rounds=1,
        noise_model=depolarizing_noise,
        noise_model_args=lambda p: {"p": p, "pm": p},
        meas_prior=lambda p, xs, zs: 2 / 3 * p,
        data_prior=lambda p, xs, zs: 2 / 3 * p,
        decoder_mode="bposd",
        bp_osd_options=dict(bp_method="ms", ms_scaling_factor=0.625,
                            max_iter=12, osd_order=2, osd_method="osd0"),
        seed=5,
    )
    kw.update(over)
    return kw


def test_pipeline_sweep_schema_and_counts(code):
    """The pipeline path produces the same CSV schema, runs >= the requested
    samples (ceil-to-batch, reference p_sweep.py:20-21 semantics report the
    TRUE count), and failure rates grow with p."""
    ps = np.array([0.002, 0.02])
    recs = p_sweep(p_values=ps,
                   pipeline={"mesh_devices": 1, "shots_per_device": 32},
                   **common_kwargs(code))
    assert [r["p_ph"] for r in recs] == pytest.approx(ps.tolist())
    for col in ("p_ph", "failures", "samples", "walltime", "max_iter",
                "osd_method"):
        assert all(col in r for r in recs)
    assert all(r["samples"] >= 64 for r in recs)
    assert all(r["samples"] % 32 == 0 for r in recs)
    assert all(r["failures"] <= r["samples"] for r in recs)


def test_pipeline_sweep_matches_run_simulation(code):
    """Pipeline-path and run_simulation-path LERs agree within binomial
    bounds (same decode contract: BP + OSD on BP failures)."""
    ps = np.array([0.03])
    n = 512
    kw = common_kwargs(code, samples=n)
    df_pipe = p_sweep(p_values=ps,
                      pipeline={"mesh_devices": 1, "shots_per_device": 256},
                      **kw)
    df_ref = p_sweep(p_values=ps, use_device_sampler=False, **kw)
    r_p = df_pipe[0]["failures"] / df_pipe[0]["samples"]
    r_r = df_ref[0]["failures"] / df_ref[0]["samples"]
    sigma = np.sqrt(max(r_r * (1 - r_r), 1e-3) / n)
    assert abs(r_p - r_r) < 5 * sigma + 0.02


def test_pipeline_sweep_sharded(code):
    """The mesh path shards shots over the 8 virtual devices."""
    df = p_sweep(p_values=np.array([0.01]),
                 pipeline={"mesh_devices": 8, "shots_per_device": 16},
                 **common_kwargs(code, samples=128))
    assert df[0]["samples"] == 128


def test_pipeline_sweep_rejects_other_modes(code):
    with pytest.raises(ValueError):
        p_sweep(p_values=np.array([0.01]),
                pipeline={"mesh_devices": 1, "shots_per_device": 16},
                **common_kwargs(code, decoder_mode="relay_bp"))


def test_pipeline_cli_flags():
    """CLI surface: --pipeline/--mesh_devices/--shots_per_device parse."""
    from argparse import ArgumentParser

    from exp_ldpc_tpu.decoders.drivers import add_bposd_args

    parser = ArgumentParser()
    parser.add_argument("--pipeline", action="store_true")
    parser.add_argument("--mesh_devices", type=int, default=1)
    parser.add_argument("--shots_per_device", type=int, default=4096)
    add_bposd_args(parser)
    args = parser.parse_args(
        ["--pipeline", "--mesh_devices", "8", "--shots_per_device", "128"])
    assert args.pipeline and args.mesh_devices == 8


@pytest.mark.parametrize("mode", ["bposd_single_shot", "bposd_hybrid"])
def test_pipeline_sweep_accepts_fused_modes(code, mode):
    """--pipeline now covers the single-shot and hybrid contracts too
    (one fused device program per sweep point)."""
    ps = np.array([0.02])
    df = p_sweep(p_values=ps,
                 pipeline={"mesh_devices": 1, "shots_per_device": 64},
                 **common_kwargs(code, decoder_mode=mode, rounds=2))
    assert len(df) == 1
    assert int(df[0]["samples"]) >= 64
    assert 0 <= int(df[0]["failures"]) <= int(df[0]["samples"])
