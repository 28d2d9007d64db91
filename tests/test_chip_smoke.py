"""CPU rehearsal of ``chip_smoke.py`` and of the platform rules it relies
on: the phase functions at a tiny size, the refusal of any platform but a
GPU, the compile-cache location, the device-memory budget and the
fast-power product choice.  ``test_smoke_phases_on_gpu`` runs the phases
at their real widths and needs the card."""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke as cs


def test_phase_kernels_tiny():
    out = cs.phase_kernels(n_gauss=200, p_gauss=67, n_mm=600, p_mm=20,
                           m_mm=54)
    assert out["gauss_err"] <= cs.GAUSS_BOUND
    assert out["matmul_err"] <= cs.MATMUL_BOUND


def test_phase_default_fit_matches_cpu_record():
    """The rehearsal that measures the f32-vs-f64 agreement phase 3 holds
    the card to: same data, same fits.  The recorded numbers must still
    describe this CPU run (within a factor of 2, or both under the f32
    epsilon), and the phase passes its own bound."""
    y, X = bench.synthetic_election()
    out = cs.phase_default_fit(y, X, cpu_record=cs.CPU_F32_VS_F64)
    for key, rec in cs.CPU_F32_VS_F64.items():
        got = out["agreement"][key]
        if max(got, rec) > cs.AGREEMENT_FLOOR:
            assert rec / 2 <= got <= 2 * rec, (key, got, rec)
    assert 0.0 < out["r2_oos"] < 1.0


def test_phase_streaming_tiny():
    out = cs.phase_streaming(n=3000, p=20, neig=40)
    assert 0.5 < out["R2"] < 1.0
    assert {"kernel", "eigendecomposition"} <= set(out["timings"])


def test_phase_four_tiny():
    """The --four phase on 4 of the suite's 8 virtual CPU devices."""
    out = cs.phase_four(dense_shape=(400, 12), stream_n=2000, stream_p=20,
                        neig=40)
    for r in out.values():
        assert r["lambda_rel"] <= cs.MESH_LAMBDA_REL
        assert r["ame_rel"] <= cs.MESH_AME_REL


def test_main_refuses_non_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    cs.phase_kernels()
    y, X = bench.synthetic_election()
    cs.phase_default_fit(y, X, cpu_record=cs.CPU_F32_VS_F64)


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(tmp_path, monkeypatch, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting is used and no
    directory is set in code; otherwise the fixed in-repo path."""
    from bigkrls_tpu import warmup

    root = os.path.dirname(os.path.dirname(os.path.abspath(warmup.__file__)))
    assert warmup.REPO_CACHE_DIR == os.path.join(root, ".jax_cache")

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert warmup.enable_compile_cache() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in updates
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(warmup, "REPO_CACHE_DIR",
                            str(tmp_path / ".jax_cache"))
        got = warmup.enable_compile_cache()
        assert got == str(tmp_path / ".jax_cache") and os.path.isdir(got)
        assert updates["jax_compilation_cache_dir"] == got


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_device_memory_budget(monkeypatch, platform):
    """8 GiB stand-in on the CPU only; an accelerator that reports no
    bytes_limit is an error, one that reports it is taken at its word."""
    from bigkrls_tpu.utils import memory

    def fake(stats):
        dev = types.SimpleNamespace(platform=platform, device_kind="fake",
                                    memory_stats=lambda: stats)
        monkeypatch.setattr(jax, "local_devices", lambda: [dev])

    fake(None)
    if platform == "cpu":
        assert memory.device_memory_budget() == 8 * 1024 ** 3
    else:
        with pytest.raises(RuntimeError, match="bytes_limit"):
            memory.device_memory_budget()
    fake({"bytes_limit": 80 * 10 ** 9})
    assert memory.device_memory_budget() == 80 * 10 ** 9


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_fast_power_uses_fast_matmul_on_any_backend(monkeypatch, backend):
    """eigensystem_streaming(fast_power=True) runs its power products
    through kernel_matmul_fast whatever the backend says it is."""
    from bigkrls_tpu.ops import matvec
    from bigkrls_tpu.ops.eig import eigensystem_streaming

    calls = []
    real = matvec.kernel_matmul_fast

    def spy(X, V, sigma, **kw):
        calls.append(V.shape)
        return real(X, V, sigma, **kw)

    monkeypatch.setattr(matvec, "kernel_matmul_fast", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    X = jnp.asarray(np.random.default_rng(3).normal(size=(128, 4)))
    for krylov in (True, False):
        calls.clear()
        eigensystem_streaming(X, 4.0, neig=8, iters=4, fast_power=True,
                              krylov=krylov)
        assert calls, krylov


def test_pick_block_policy():
    """Default policy: the largest divisor candidate under the tile-bytes
    cap, else padding (one block below DEFAULT_BLOCK rows, DEFAULT_BLOCK
    multiples above); an explicit block is returned unchanged."""
    from bigkrls_tpu.ops.matvec import DEFAULT_BLOCK, pick_block

    assert [pick_block(n) for n in (50_000, 100_000, 500_000, 1_000_000)] \
        == [2500, 4000, 2000, 1000]       # pad-free; 4 GiB tile cap above
    assert pick_block(1_000_000, itemsize=8) == 500
    assert pick_block(7 * DEFAULT_BLOCK) == DEFAULT_BLOCK
    assert pick_block(32768) == 2048
    assert pick_block(97) == 128                      # prime: one padded block
    assert pick_block(2 * 1553) == 3200               # one padded block
    assert pick_block(4001) == DEFAULT_BLOCK          # prime: padded
    assert pick_block(2000, block=24) == 24


def test_bench_peaks_table():
    """Peaks are looked up by device_kind; an unknown device is an error."""
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["f32_tflops"] == 67.0 and peaks["hbm_gbs"] == 3350.0
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("unknown card")


def test_bench_refuses_non_gpu():
    with pytest.raises(SystemExit, match="measures a GPU"):
        bench.device_record()
