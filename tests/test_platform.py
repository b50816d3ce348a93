"""Backend routing, compile cache, multi-process card assignment, and
the chip smoke test's refusal to run without a card."""
import glob
import os
import subprocess
import sys

import pytest

from sibelia_tpu.core import platform

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("pin", ["cpu", "cpu, cpu"])
def test_device_dispatch_off_under_cpu_pin(monkeypatch, pin):
    monkeypatch.delenv("SIBELIA_TPU_DEVICE", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", pin)
    assert platform.device_dispatch() is False


@pytest.mark.parametrize("env,want", [("0", False), ("1", True)])
def test_device_dispatch_override(monkeypatch, env, want):
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", env)
    assert platform.device_dispatch() is want


def test_backend_init_error_propagates(monkeypatch):
    """A backend that fails to initialize must not read as "cpu"."""
    import jax

    def broken():
        raise RuntimeError("no backend could be initialized")

    monkeypatch.setattr(jax, "default_backend", broken)
    with pytest.raises(RuntimeError, match="no backend"):
        platform.backend_name()
    monkeypatch.delenv("SIBELIA_TPU_DEVICE", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "")
    with pytest.raises(RuntimeError, match="no backend"):
        platform.device_dispatch()


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    import jax

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert updates == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_repo(monkeypatch):
    import jax

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO_ROOT, ".jax_cache")
    assert platform.enable_compile_cache() == want
    assert updates == [("jax_compilation_cache_dir", want)]


@pytest.mark.parametrize("env,cards,pid,want", [
    ("2,3", None, 0, [2, 3]),     # explicit assignment wins
    (None, 4, 5, [1]),            # one process per card, round robin
    (None, None, 1, None),        # no NVIDIA cards: nothing to split
])
def test_init_distributed_assigns_cards(monkeypatch, tmp_path, env, cards,
                                        pid, want):
    import jax
    from sibelia_tpu.parallel import runtime

    for i in range(cards or 0):
        (tmp_path / f"nvidia{i}").touch()
    (tmp_path / "nvidiactl").touch()  # not a card
    monkeypatch.setattr(runtime, "_NVIDIA_CARDS",
                        str(tmp_path / "nvidia[0-9]*"))
    if env is None:
        monkeypatch.delenv("SIBELIA_TPU_LOCAL_DEVICES", raising=False)
    else:
        monkeypatch.setenv("SIBELIA_TPU_LOCAL_DEVICES", env)
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    assert runtime.init_distributed("127.0.0.1:1", 8, pid)
    assert seen["process_id"] == pid
    assert seen["local_device_ids"] == want


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke test must fail and print no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO_ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.fixture
def gpu_env():
    """Environment for a child process that may open the card; skips
    unless this host has an NVIDIA card."""
    if not glob.glob("/dev/nvidia[0-9]*"):
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


_GPU_CHILD = r"""
import numpy as np
import jax
from sibelia_tpu.index.enumeration import enumerate_bifurcations
assert jax.default_backend() == "gpu", jax.default_backend()
rng = np.random.default_rng(3)
base = rng.choice(list(b"ACGT"), size=200000).astype(np.uint8)
mut = base.copy()
mut[rng.integers(0, base.size, 2000)] = rng.choice(list(b"ACGT"), 2000)
chroms = [bytes(base), bytes(mut)]
import os
for k in (30, 100):
    dev = enumerate_bifurcations(chroms, k)
    os.environ["SIBELIA_TPU_DEVICE"] = "0"
    host = enumerate_bifurcations(chroms, k)
    del os.environ["SIBELIA_TPU_DEVICE"]
    assert dev.count == host.count, k
    for s in (0, 1):
        assert np.array_equal(dev.pos[s], host.pos[s]), k
        assert np.array_equal(dev.bif_id[s], host.bif_id[s]), k
print("ok")
"""


@pytest.mark.gpu
def test_device_enumeration_on_gpu(gpu_env):
    r = subprocess.run([sys.executable, "-c", _GPU_CHILD], cwd=REPO_ROOT,
                       env=gpu_env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
