"""What runs the solver on a GPU: the compile cache's directory, the
device guard, the published-peak table, the autotuner's key and error
record, the trace reduction, and the rejection of removed options."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfdsim_tpu.solvers import autotune
from cfdsim_tpu.utils import cache

REPO = Path(__file__).resolve().parent.parent


def test_compile_cache_dir_follows_the_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache.compile_cache_dir() == tmp_path / "c"


def test_compile_cache_dir_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.compile_cache_dir() == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_sets_a_directory_only_without_the_env_var(
        monkeypatch, tmp_path, env_set):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(cache, "CHECKOUT_CACHE", tmp_path / "ckout")
    path = cache.enable_compilation_cache()
    if env_set:
        assert path == tmp_path
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert path == tmp_path / "ckout" and path.is_dir()
        assert calls["jax_compilation_cache_dir"] == str(path)
    assert "jax_persistent_cache_min_compile_time_secs" in calls


def test_device_guard_refuses_the_cpu():
    from cfdsim_tpu.utils.device import device_info, require_gpu

    assert device_info() == {"platform": "cpu", "kind": "cpu",
                             "count": len(jax.devices())}
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        require_gpu()


def test_bench_refuses_the_cpu(capsys):
    sys.path.insert(0, str(REPO))
    import bench

    with pytest.raises(RuntimeError, match="GPU"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_published_peaks_resolve_the_h100():
    from cfdsim_tpu.utils.roofline import published_peaks

    pk = published_peaks("NVIDIA H100 80GB HBM3")
    assert pk["hbm_bytes_per_sec"] == 3.35e12
    assert pk["fp32_flops"] == 67e12 and pk["tf32_flops"] == 495e12
    assert "data sheet" in pk["source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB"])
def test_published_peaks_unknown_device_is_an_error(kind):
    from cfdsim_tpu.utils.roofline import published_peaks

    with pytest.raises(KeyError, match="no published peaks"):
        published_peaks(kind)


def test_autotune_key_names_the_device_kind():
    key = autotune._key((48, 64))
    assert key.startswith(jax.devices()[0].device_kind + "|")
    assert key.endswith("48x64")


def test_autotune_reports_a_failing_candidate(monkeypatch, tmp_path):
    monkeypatch.setenv("CFDSIM_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("CFDSIM_DCT_VARIANT", raising=False)
    monkeypatch.setattr(autotune, "_MEM", {})
    monkeypatch.setattr(autotune, "_variants_for",
                        lambda shape: ("rfft", "packed"))
    real = autotune._candidate

    def candidate(variant, *a):
        if variant == "packed":
            def boom(rhs):
                raise RuntimeError("unsupported on this device")
            return boom
        return real(variant, *a)

    monkeypatch.setattr(autotune, "_candidate", candidate)
    assert autotune.best_dct_variant((16, 16), 0.1, 0.1) == "rfft"
    rec = autotune.tuning_record((16, 16))
    assert set(rec["ms"]) == {"rfft"}
    assert rec["errors"]["packed"] == (
        "RuntimeError: unsupported on this device")


@pytest.mark.parametrize("method", ["rbsor_pallas", "sor"])
def test_removed_poisson_methods_are_rejected(method):
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    with pytest.raises(ValueError, match="unknown poisson method"):
        PoissonConfig(method=method)


@pytest.mark.parametrize("option", ["fused_predictor", "mg_pallas_smooth"])
def test_removed_pallas_options_are_rejected(option):
    from cfdsim_tpu.models.incompressible import IncompressibleConfig
    from cfdsim_tpu.grid import Grid
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    cls = IncompressibleConfig if option == "fused_predictor" else PoissonConfig
    kw = {"grid": Grid(nx=8, ny=8), "nu": 0.1} if cls is not PoissonConfig else {}
    with pytest.raises(TypeError, match=option):
        cls(**kw, **{option: True})


def test_trace_reduction_finds_the_predictor_fusions(tmp_path):
    """scope_fusions finds the fusions of a named scope in compiled HLO;
    device_kernel_times sums their durations from a profiler trace (on
    the CPU the kernels run on a host thread, so the plane differs)."""
    from cfdsim_tpu.cases import lid_cavity
    from cfdsim_tpu.utils.profiling import device_kernel_times, scope_fusions

    case = lid_cavity(n=32, Re=100.0, compute_metrics=False)
    f = jax.jit(lambda s: case.step(s, jnp.float32(1.0))[0])
    fusions = scope_fusions(f.lower(case.state).compile().as_text(),
                            "predictor")
    assert fusions and all(b >= 4 * 32 * 32 for b in fusions.values())
    jax.block_until_ready(f(case.state))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(f(case.state))
    times = device_kernel_times(str(tmp_path), plane_prefix="/host:CPU")
    assert any(times.get(k, 0) > 0 for k in fusions)
    assert np.isfinite(sum(times.values()))
