"""chip_smoke.py on the CPU: every phase at a tiny size, its refusal to run
without a GPU, its spectral oracle, and the compile-cache helper.

Each phase also runs under a recorder of ``dot_general``: every matrix
product the main path traces must ask for "highest" precision, so a GPU
never computes one of them in TF32.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax import lax
from jax._src.lax import lax as lax_internal

import chip_smoke as cs
import exponentialutilities_jl_tpu as eu
from exponentialutilities_jl_tpu.utils import aot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASES = {
    "dense": lambda: cs.phase_dense(12),
    "laplacian_1d": lambda: cs.phase_laplacian_1d(300),
    "poisson_2d": lambda: cs.phase_poisson_2d(10),
    "advdiff": lambda: cs.phase_advdiff(80, bound=1e-7),
    "laplacian_3d": lambda: cs.phase_laplacian_3d(6),
    "reaction_diffusion": lambda: cs.phase_reaction_diffusion(12),
    "kernels": lambda: cs.phase_kernels(1.0, n1=500, nx3=8, nx_big=10,
                                        n_sparse=2048),
    "four_cards": lambda: cs.phase_four_cards(nx=8),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_on_cpu(phase, monkeypatch, capsys):
    seen = []
    bind = lax_internal.dot_general_p.bind

    def recording_bind(*args, **kwargs):
        seen.append(kwargs.get("precision"))
        return bind(*args, **kwargs)

    jax.clear_caches()        # trace afresh so every product is recorded
    monkeypatch.setattr(lax_internal.dot_general_p, "bind", recording_bind)
    PHASES[phase]()
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    assert all(p == highest for p in seen), set(map(str, seen))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines and all(r["phase"] == phase for r in lines)


def test_main_refuses_without_gpu():
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _laplacian_dense(shape):
    A = np.zeros((1, 1))
    for s in shape:
        T = (np.diag(np.full(s, -2.0)) + np.diag(np.ones(s - 1), 1)
             + np.diag(np.ones(s - 1), -1))
        A = np.kron(A, np.eye(s)) + np.kron(np.eye(A.shape[0]), T)
    return A


@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(30,), (6, 7), (3, 4, 5)])
def test_spectral_oracle_matches_expm(shape, k):
    A = _laplacian_dense(shape)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    t = 0.3
    got = cs.spectral_phiv(t, shape, b, k)
    for j, P in enumerate(cs.dense_phi_stack(t * A, k)):
        want = P @ b
        assert np.linalg.norm(got[:, j] - want) / np.linalg.norm(want) \
            < 1e-13


@pytest.fixture
def restore_cache_config():
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", before[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      before[1])


def test_compile_cache_follows_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert aot.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # set no other
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0


def test_compile_cache_defaults_into_checkout(monkeypatch,
                                              restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = aot.use_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("name,args", [
    ("expv_chebyshev", (0.1, None, None)),
    ("funm_chebyshev", (np.exp, None, None)),
    ("chebyshev_apply", (None, None, None, (-1.0, 0.0))),
    ("expv_leja", (0.1, None, None)),
    ("phiv_leja", (0.1, None, None, 1)),
    ("phiv_timestep_leja", (0.1, None, None)),
    ("expv_faber", (0.1, None, None)),
    ("phiv_faber", (0.1, None, None, 1)),
    ("phiv_timestep_faber", (0.1, None, None)),
    ("parallel.expv_sharded", (0.1, None, None, None)),
    ("parallel.expv_chebyshev_sharded", (0.1, None, None, None)),
    ("parallel.expv_leja_sharded", (0.1, None, None, None)),
    ("parallel.expv_faber_sharded", (0.1, None, None, None)),
])
def test_fused_option_is_gone(name, args):
    from exponentialutilities_jl_tpu import parallel
    fn = (getattr(parallel, name.split(".")[1]) if "." in name
          else getattr(eu, name))
    with pytest.raises(TypeError, match="fused"):
        fn(*args, **{"fused": True})


@pytest.mark.gpu
def test_dense_and_3d_phases_on_gpu(gpu):
    cs.phase_dense()
    cs.phase_laplacian_3d()
