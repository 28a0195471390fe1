"""The port stands alone: it imports without JAX and without Triton,
its sources name neither JAX nor the JAX package, and its entry points
refuse to run on a box without CUDA unless the caller asks for the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# an import of jax, or of the JAX package (``repro`` but not ``repro_torch``)
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                       re.MULTILINE)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_port_imports_without_jax_and_triton():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton'] = None\n"
        "import repro_torch\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        "assert {'repro_torch.parallel', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.launch.shardings'} <= names, names\n"
        "assert not any(k == 'repro' or k.startswith('repro.')\n"
        "               for k in sys.modules), 'the JAX package was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_name_no_jax_and_no_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.models import build", "import repro",
                 "    from repro.core import probe"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.models import build",
                 "jax_like = 1"):
        assert not FORBIDDEN.search(line), line


def _entry_points():
    from repro_torch.configs import get_config
    from repro_torch.core.calibrator import StaticCalibrator, TTTCalibrator
    from repro_torch.core.probe import ProbeConfig, init_outer
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.models.convert import from_jax_theta
    from repro_torch.serving import serve_replay
    from repro_torch.trajectories import synthetic

    cfg = get_config("smollm-360m").reduced()
    pc = ProbeConfig(d_phi=8)
    ts = synthetic.generate(synthetic.TrajectoryDistribution(
        "p", d_phi=8, t_min=4, t_max=6), 8, 0)
    return {
        "model.init": lambda: build(cfg).init(torch.Generator()),
        "init_decode_state": lambda: build(cfg).init_decode_state(2, 8),
        "init_paged_state": lambda: build(cfg).init_paged_state(2, 5, 4, 2),
        "init_outer": lambda: init_outer(pc),
        "from_jax_theta": lambda: from_jax_theta({"W0": np.zeros(8)}),
        "TTTCalibrator.fit": lambda: TTTCalibrator(
            pc=pc, epochs=1, epoch_select=False).fit(ts, "consistent"),
        "StaticCalibrator.fit": lambda: StaticCalibrator(
            n_components=4, epochs=1).fit(ts, "consistent"),
        "serve.main": lambda: serve.main(["--arch", "smollm-360m",
                                          "--reduced"]),
        "serve_replay": lambda: serve_replay(
            np.zeros((2, 3, 4), np.float32),
            {"W0": np.zeros(4, np.float32), "b0": np.float32(0)}),
    }


@pytest.mark.parametrize("name", ["model.init", "init_decode_state",
                                  "init_paged_state", "init_outer",
                                  "from_jax_theta", "TTTCalibrator.fit",
                                  "StaticCalibrator.fit", "serve.main",
                                  "serve_replay"])
def test_entry_point_without_cuda_raises(monkeypatch, name):
    """With no CUDA device and no ``device=``, an entry point raises and
    says how to run on the CPU; it never drops to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def _mesh_entry_points():
    from repro_torch.launch import mesh, train
    return {
        "init_distributed": lambda: mesh.init_distributed(),
        "make_production_mesh": lambda: mesh.make_production_mesh(),
        "make_test_mesh": lambda: mesh.make_test_mesh(),
        "train --mesh single": lambda: train.main([
            "--arch", "smollm-360m", "--reduced", "--mesh", "single"]),
        "train --mesh multi": lambda: train.main([
            "--arch", "smollm-360m", "--reduced", "--mesh", "multi"]),
    }


@pytest.mark.parametrize("name,match", [
    ("init_distributed", "no CUDA device"),
    ("make_production_mesh", "need 256 ranks for mesh \\(16, 16\\), have 1"),
    ("make_test_mesh", "need 4 ranks, have 1"),
    ("train --mesh single", "need 256 ranks for mesh \\(16, 16\\), have 1"),
    ("train --mesh multi", "need 512 ranks for mesh \\(2, 16, 16\\), "
                           "have 1")])
def test_mesh_entry_point_without_cuda_or_ranks_raises(monkeypatch, name,
                                                       match):
    """The multi-device entry points pick no backend or device by
    themselves: with no CUDA device the NCCL helper raises, and a mesh
    larger than the process group raises with both sizes (the trainer's
    ``--mesh`` before it touches a device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match=match):
        _mesh_entry_points()[name]()


def _probe_state(B, f, win, device):
    return [torch.zeros((B, f), device=device), torch.zeros(B, device=device),
            torch.zeros((B, win), device=device),
            torch.zeros(B, dtype=torch.int32, device=device),
            torch.zeros(B, dtype=torch.bool, device=device),
            torch.zeros(B, dtype=torch.int32, device=device)]


def test_probe_step_on_other_devices_never_takes_the_plain_version():
    """Only CPU tensors take K1's plain version: any other device reaches
    the kernel path or raises — here the meta device, which has none."""
    from repro_torch.kernels.probe_step import serving_probe_step
    B, f, win = 2, 8, 3
    z = torch.zeros((B, f), device="meta")
    args = [z, z, torch.zeros(B, dtype=torch.bool, device="meta"),
            *_probe_state(B, f, win, "meta")]
    with pytest.raises(RuntimeError, match="no kernel for device"):
        serving_probe_step(*args, 0.01, 0.5, burn_in=1)


def test_probe_spec_step_on_other_devices_never_takes_the_plain_version():
    """K4 keeps K1's rule: the meta device raises; the CPU takes the plain
    version, which leaves the state untouched at accept = 0."""
    from repro_torch.kernels.probe_spec import serving_probe_spec_step
    B, T, f, win = 2, 3, 8, 3
    for device in ("meta", "cpu"):
        z = torch.ones((B, T, f), device=device)
        st = _probe_state(B, f, win, device)
        args = [z, z, torch.ones((B, T), dtype=torch.bool, device=device),
                torch.zeros(B, dtype=torch.int32, device=device), *st]
        if device == "meta":
            with pytest.raises(RuntimeError, match="no kernel for device"):
                serving_probe_spec_step(*args, 0.01, 0.5, burn_in=1)
            continue
        out = serving_probe_spec_step(*args, 0.01, 0.5, burn_in=1)
        assert out.n_seq.tolist() == [[0] * T] * B
        assert all(not t.any() for t in st)
    with pytest.raises(ValueError, match="T >= 1"):
        serving_probe_spec_step(z[:, :0], z[:, :0], *args[2:], 0.01, 0.5,
                                burn_in=1)


def _dense_attention_call(name, device):
    """One call of K6's or K7's wrapper at the served head dim (G = 3)."""
    if name == "flash_decode":
        from repro_torch.kernels.flash_decode import flash_decode
        B, KV, S, d = 2, 2, 5, 64
        return lambda: flash_decode(
            torch.zeros((B, 3 * KV, d), device=device),
            torch.zeros((B, KV, S, d), device=device),
            torch.zeros((B, KV, S, d), device=device),
            torch.ones((B, S), dtype=torch.bool, device=device))
    from repro_torch.kernels.flash_attention import flash_attention
    B, S, KV, d = 2, 5, 2, 64
    return lambda: flash_attention(
        torch.zeros((B, S, 3 * KV, d), device=device),
        torch.zeros((B, S, KV, d), device=device),
        torch.zeros((B, S, KV, d), device=device), causal=True)


@pytest.mark.parametrize("name", ["flash_decode", "flash_attention"])
def test_dense_attention_on_other_devices_never_takes_the_plain_version(
        name):
    """K6 and K7 keep the rule: the meta device raises, and the CPU takes
    the plain version without counting a launch."""
    import importlib
    wrapper = getattr(importlib.import_module(
        f"repro_torch.kernels.{name}"), name)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="no kernel for device"):
        _dense_attention_call(name, "meta")()
    out = _dense_attention_call(name, "cpu")()
    assert out.device.type == "cpu" and not out.any()
    assert wrapper.launches == before


def test_draft_cache_is_the_ports_own_copy():
    """The draft cache is host-side numpy, imported from the port itself:
    promotion, lookup and LRU eviction without the JAX package."""
    from repro_torch.serving.draft_cache import DraftCache
    cache = DraftCache(capacity=2, ngram=2)
    cache.observe([1, 2], [3, 4])
    drafts, hit = cache.lookup([1, 2], 1, 3)
    assert hit and drafts.tolist() == [[3, 4, 4]]
    cache.observe([7, 8], [9])
    assert len(cache) == 2 and not cache.lookup([1, 2], 1, 1)[1]
    assert (cache.hits, cache.misses) == (1, 1)
