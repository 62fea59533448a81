"""What the GPU bring-up rests on, checked on the CPU: the one platform
decision, the compile-cache placement, explicit precision on every dot
that carries LLRs, the pandas-free CSV layout, the in-order mesh, and the
GPU entry points refusing to run without a GPU.  Tests marked ``gpu`` run
only on the card (see tests/conftest.py)."""
import csv
import importlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Dev:
    def __init__(self, platform):
        self.platform = platform


# ------------------------------------------------------ platform decision
@pytest.mark.parametrize("platform,backend", [("cpu", "xla"), ("gpu", "triton")])
def test_bp_backend_known_platforms(platform, backend):
    from exp_ldpc_tpu.decoders.select import bp_backend

    assert bp_backend([_Dev(platform)] * 2) == backend


def test_bp_backend_unknown_platform_raises():
    from exp_ldpc_tpu.decoders.select import bp_backend

    with pytest.raises(ValueError, match="no BP backend for platform 'metal'"):
        bp_backend([_Dev("metal")])


def test_bp_backend_mixed_platforms_raise():
    from exp_ldpc_tpu.decoders.select import bp_backend

    with pytest.raises(ValueError, match="mixed"):
        bp_backend([_Dev("cpu"), _Dev("gpu")])
    assert bp_backend() == "xla"  # the test process's own CPU devices


# ------------------------------------------------------ compile cache
def _fresh_cache_module():
    from exp_ldpc_tpu.utils import compile_cache

    return importlib.reload(compile_cache)


def test_compile_cache_env_dir_sets_nothing(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting is used and
    the package sets nothing."""
    monkeypatch.delenv("EXP_LDPC_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    mod = _fresh_cache_module()
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        mod.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_default_dir_is_fixed_in_checkout():
    """Unset, the cache goes to one fixed directory at the checkout root,
    derived from the package's location and ignored by git."""
    mod = _fresh_cache_module()
    assert mod.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_cpu_backend_sets_no_default(monkeypatch):
    monkeypatch.delenv("EXP_LDPC_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    mod = _fresh_cache_module()
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        mod.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


# ------------------------------------------------------ dot precision
def _dot_precisions(closed):
    """Precision params of every dot_general in a jaxpr, sub-jaxprs too."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params.get("precision"))
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(closed.jaxpr)
    return out


def _is_highest(prec):
    return prec is not None and all(
        p == jax.lax.Precision.HIGHEST for p in (prec if isinstance(prec, tuple) else (prec,)))


def _small():
    from exp_ldpc_tpu.decoders.tanner import TannerELL
    from exp_ldpc_tpu.codes.hgp import biregular_hgp

    H = biregular_hgp(6, 2, 3, seed=1, compute_logicals=False).checks.z
    return H, TannerELL.from_check_matrix(H)


def _jaxpr_bp():
    from exp_ldpc_tpu.decoders.bp import _bp_core

    _H, t = _small()
    prior = jnp.zeros(t.num_vars)
    synd = jnp.zeros((t.num_checks, 8), jnp.uint8)
    return jax.make_jaxpr(lambda pr, s: _bp_core(
        t, pr, s, "ms", 4, jnp.float32(0.625), False, "matmul"))(prior, synd)


def _jaxpr_spacetime():
    from exp_ldpc_tpu.decoders.spacetime_bp import _stbp_core

    _H, t = _small()
    R = 2
    prior = jnp.zeros((R + 1) * t.num_vars + R * t.num_checks)
    synd = jnp.zeros(((R + 1) * t.num_checks, 8), jnp.uint8)
    return jax.make_jaxpr(lambda pr, s: _stbp_core(
        t, R, pr, s, "ms", 4, jnp.float32(0.625), False, "matmul"))(prior, synd)


def _jaxpr_relay():
    from exp_ldpc_tpu.decoders.relay_bp import _relay_core

    _H, t = _small()
    prior = jnp.zeros(t.num_vars)
    synd = jnp.zeros((t.num_checks, 8), jnp.uint8)
    gammas = jnp.zeros((2, t.num_vars))
    return jax.make_jaxpr(lambda pr, s, g: _relay_core(
        t, pr, s, g, "ms", 2, 3, jnp.float32(0.625), "matmul"))(prior, synd, gammas)


def _jaxpr_rounds_shard():
    from exp_ldpc_tpu.parallel.mesh import make_mesh
    from exp_ldpc_tpu.parallel.rounds_shard import RoundsShardedSpacetimeBP

    H, t = _small()
    R = 3
    dec = RoundsShardedSpacetimeBP.from_check_matrix(
        H, R, make_mesh(4, model_parallel=2), error_rate=0.01, max_iter=4)
    Bp = dec._B_pad
    return jax.make_jaxpr(dec._fn)(
        jnp.zeros((Bp, t.num_checks, 8), jnp.uint8),
        jnp.zeros((Bp, t.num_vars)), jnp.zeros((Bp, t.num_checks)),
        jnp.zeros((Bp, 1, 1)))


@pytest.mark.parametrize("which", ["bp", "spacetime_bp", "relay_bp", "rounds_shard"])
def test_llr_dots_carry_highest_precision(which):
    """The two routing dots of each matmul formulation carry LLRs and ask
    for HIGHEST (TF32 would round them on the GPU); the 0/1 parity dot
    keeps the default, which is exact."""
    closed = {"bp": _jaxpr_bp, "spacetime_bp": _jaxpr_spacetime,
              "relay_bp": _jaxpr_relay, "rounds_shard": _jaxpr_rounds_shard}[which]()
    precs = _dot_precisions(closed)
    assert sum(map(_is_highest, precs)) == 2, precs
    assert any(not _is_highest(p) for p in precs), precs  # the parity dot


# ------------------------------------------------------ CSV without pandas
def test_write_csv_layout_of_dataframe_to_csv():
    """The layout DataFrame.to_csv gave: unnamed index column first, then
    the columns in order of first appearance; None as an empty field."""
    from exp_ldpc_tpu.experiments.p_sweep import write_csv

    recs = [
        {"p_ph": 0.001, "failures": 3, "samples": 64, "walltime": 1.5,
         "rounds": 4, "decoder_mode": "bposd", "use_x_logicals": False,
         "max_iter": 48, "osd_method": "osd_cs"},
        {"p_ph": np.float64(0.002), "failures": 9, "samples": 64,
         "walltime": 0.25, "rounds": 4, "decoder_mode": "bposd",
         "use_x_logicals": False, "max_iter": None, "osd_method": "osd_cs"},
    ]
    buf = io.StringIO()
    write_csv(recs, buf)
    assert buf.getvalue() == (
        ",p_ph,failures,samples,walltime,rounds,decoder_mode,use_x_logicals,"
        "max_iter,osd_method\n"
        "0,0.001,3,64,1.5,4,bposd,False,48,osd_cs\n"
        "1,0.002,9,64,0.25,4,bposd,False,,osd_cs\n")


def test_p_sweep_runs_without_pandas(monkeypatch):
    """The sweep module imports and runs with pandas unimportable."""
    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.codes.hgp import biregular_hgp

    monkeypatch.setitem(sys.modules, "pandas", None)  # import pandas -> error
    import exp_ldpc_tpu.experiments.p_sweep as ps

    ps = importlib.reload(ps)
    recs = ps.p_sweep(
        samples=32, p_values=np.array([0.01]), seed=1,
        code=biregular_hgp(6, 2, 3, seed=1, compute_logicals=True), rounds=1,
        noise_model=depolarizing_noise,
        noise_model_args=lambda p: {"p": p, "pm": p},
        meas_prior=lambda p, xs, zs: 2 / 3 * p,
        data_prior=lambda p, xs, zs: 2 / 3 * p, decoder_mode="bposd",
        bp_osd_options=dict(bp_method="ms", ms_scaling_factor=0.625,
                            max_iter=8, osd_order=0, osd_method="osd0"),
        pipeline={"mesh_devices": 1, "shots_per_device": 32})
    buf = io.StringIO()
    ps.write_csv(recs, buf)
    rows = list(csv.reader(io.StringIO(buf.getvalue())))
    assert rows[0][:4] == ["", "p_ph", "failures", "samples"]
    assert rows[1][0] == "0" and int(rows[1][3]) == 32


# ------------------------------------------------------ in-order mesh
def test_make_mesh_is_in_device_order():
    from exp_ldpc_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

    devs = jax.devices()
    mesh = make_mesh(model_parallel=2)
    assert mesh.axis_names == (DATA_AXIS, MODEL_AXIS)
    np.testing.assert_array_equal(
        mesh.devices, np.asarray(devs).reshape(len(devs) // 2, 2))
    mesh4 = make_mesh(4)
    np.testing.assert_array_equal(mesh4.devices, np.asarray(devs[:4]).reshape(4, 1))


def test_make_mesh_rejects_indivisible_model_axis():
    from exp_ldpc_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(6, model_parallel=4)


# ------------------------------------------------------ GPU entry points
def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_exits_nonzero_without_gpu():
    out = _run(["chip_smoke.py"], REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_exits_nonzero_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository it fails, even with a GPU."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_exits_nonzero_without_gpu():
    out = _run(["bench.py"], REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# ------------------------------------------------------ on the card
@pytest.mark.gpu
def test_spacetime_core_matches_oracle_on_gpu(gpu_device):
    """On the card: the structured spacetime core's min-sum decisions
    equal the numpy oracle's on every shot both converged on, with the
    tolerances chip_smoke.py states."""
    from exp_ldpc_tpu.codes.hgp import biregular_hgp
    from exp_ldpc_tpu.decoders.bp_numpy import NumpyBPDecoder
    from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode
    from exp_ldpc_tpu.decoders.spacetime_bp import SpacetimeBPDecoder

    H = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z
    Hst = SpacetimeCode(H, 4).spacetime_check_matrix
    dense = Hst.toarray().astype(np.int64) % 2
    rng = np.random.default_rng(0)
    synd = (((rng.random((256, dense.shape[1])) < 4e-3) @ dense.T) % 2).astype(np.uint8)
    kw = dict(error_rate=1e-3, max_iter=32, bp_method="ms",
              ms_scaling_factor=0.625, early_stop=False)
    with jax.default_device(gpu_device):
        h, _p, c, _i = SpacetimeBPDecoder.from_check_matrix(H, 4, **kw).decode_batch(synd)
    ho, _po, co, _io = NumpyBPDecoder.from_check_matrix(Hst, **kw).decode_batch(synd)
    assert (c == co).mean() >= 0.99
    both = c & co
    assert (h[both] == ho[both]).all(axis=1).mean() >= 0.99
