"""Compute-path choices a user can name, and where compiled code is cached.

Every kernel name the framework once accepted for a removed kernel raises
a ValueError listing the accepted values; none maps silently onto another
path. The persistent compile cache lives where ``JAX_COMPILATION_CACHE_DIR``
says, else at one fixed git-ignored path in the checkout.
"""

import os

import jax
import pytest

from gcm_tpu import cli
from gcm_tpu.scenarios import get_scenario
from gcm_tpu.task import KERNELS, SimplexTask, Task, check_kernel
from gcm_tpu.utils import backend

REMOVED = ["pallas", "pallas_fused", "pallas_simplex", "fused", "best", ""]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", REMOVED)
def test_task_rejects_removed_kernel(name):
    task = get_scenario("elastic3d_layered", n=8, nsteps=2)
    fields = {f: getattr(task, f) for f in Task.__dataclass_fields__}
    fields["kernel"] = name
    with pytest.raises(ValueError, match="accepted values: auto, jnp"):
        Task(**fields)


@pytest.mark.parametrize("name", REMOVED)
def test_simplex_task_rejects_removed_kernel(name):
    task = get_scenario("simplex3d_layered", n=5, nsteps=2)
    assert isinstance(task, SimplexTask)
    fields = {f: getattr(task, f) for f in SimplexTask.__dataclass_fields__}
    fields["kernel"] = name
    with pytest.raises(ValueError, match="accepted values"):
        SimplexTask(**fields)


@pytest.mark.parametrize("name", ["pallas", "pallas_fused",
                                  "pallas_simplex"])
def test_cli_rejects_removed_kernel(name, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["run", "elastic3d_layered", "--kernel", name])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("knob", ["mat_dtype", "temporal_block"])
def test_removed_task_knobs(knob):
    assert knob not in Task.__dataclass_fields__


@pytest.mark.parametrize("name", KERNELS)
def test_accepted_kernels(name):
    assert check_kernel(name) == name


# ----------------------------------------------------------- compile cache

def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda key, value: calls.append((key, value)))
    return calls


def test_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert backend.setup_compile_cache() == str(tmp_path)
    assert calls == []                   # JAX reads the variable itself


def test_cache_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    first = backend.setup_compile_cache()
    assert first == backend.setup_compile_cache() == os.path.join(
        ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", first)] * 2
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "/.jax_cache/" in f.read().split()


def test_cli_run_sets_up_cache(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(backend, "setup_compile_cache",
                        lambda: seen.append(True) or "")
    rc = cli.main(["run", "acoustic1d", "--n", "32", "--nsteps", "2",
                   "--outdir", str(tmp_path)])
    assert rc == 0 and seen == [True]


def test_compute_platform_follows_default_device():
    cpu = jax.devices("cpu")
    assert backend.compute_device().platform == "cpu"
    with jax.default_device(cpu[1]):
        assert backend.compute_device() == cpu[1]
    with jax.default_device("cpu"):
        assert backend.compute_device() == cpu[0]
