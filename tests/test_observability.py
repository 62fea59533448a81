"""Observability (logging/metrics/timing) and sweep checkpoint/resume."""
import json
import logging

import numpy as np
import pytest

from exp_ldpc_tpu.utils.observability import Metrics, get_logger, timed


def test_metrics_counters_and_rates():
    m = Metrics()
    m.add("shots", 1000)
    m.add("shots", 24)
    m.add("bp_iters", 32768)
    rep = m.report()
    assert rep["shots"] == 1024
    assert rep["bp_iters"] == 32768
    assert rep["shots_per_s"] > 0
    assert rep["elapsed_s"] > 0
    m.reset()
    assert m.report().get("shots") is None


def test_timed_accumulates_into_metrics():
    m = Metrics()
    with timed("decode", metrics=m):
        pass
    with timed("decode", metrics=m):
        pass
    rep = m.report()
    assert rep["decode_calls"] == 2
    assert rep["decode_s"] >= 0


def test_get_logger_namespacing(caplog):
    log = get_logger("unit")
    assert log.name == "exp_ldpc_tpu.unit"
    with caplog.at_level(logging.INFO, logger="exp_ldpc_tpu"):
        log.info("hello %d", 7)
    assert any("hello 7" in r.message for r in caplog.records)


def test_p_sweep_checkpoint_resume(tmp_path):
    """A sweep interrupted after some points resumes without redoing them."""
    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.codes.hgp import biregular_hgp
    from exp_ldpc_tpu.experiments.p_sweep import p_sweep

    code = biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)
    ckpt = tmp_path / "sweep.jsonl"
    common = dict(
        samples=8,
        code=code,
        rounds=1,
        noise_model=depolarizing_noise,
        noise_model_args=lambda p: {"p": p, "pm": p},
        meas_prior=lambda p, xs, zs: 2 / 3 * p,
        data_prior=lambda p, xs, zs: 2 / 3 * p,
        decoder_mode="bposd",
        bp_osd_options=dict(bp_method="ms", ms_scaling_factor=0.625,
                            max_iter=8, osd_order=2, osd_method="osd0"),
        seed=3,
        use_device_sampler=False,
        checkpoint=ckpt,
    )
    ps = np.array([0.001, 0.002, 0.004])

    df1 = p_sweep(p_values=ps[:2], **common)
    assert len(df1) == 2
    lines1 = [json.loads(l) for l in ckpt.read_text().splitlines()]
    assert len(lines1) == 2

    # resume with the full grid: only the third point runs
    df2 = p_sweep(p_values=ps, **common)
    assert len(df2) == 3
    lines2 = [json.loads(l) for l in ckpt.read_text().splitlines()]
    assert len(lines2) == 3
    # the first two records were NOT recomputed (identical rows preserved)
    assert [l["p_ph"] for l in lines2[:2]] == [l["p_ph"] for l in lines1]
    assert [l["failures"] for l in lines2[:2]] == [l["failures"] for l in lines1]
    assert sorted(r["p_ph"] for r in df2) == pytest.approx(ps.tolist())
