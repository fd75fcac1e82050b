"""Import boundary of the port: ``ray_tpu_torch``, ``chip_smoke.py``
and the ``tools/torch_*.py`` profilers import no JAX (``jax``,
``jaxlib``, ``flax``, ``orbax``) and nothing of the JAX package
``ray_tpu``; the port's entry points run on the card unless the caller
asks for the CPU.

- static: AST-walk every port module and chip_smoke.py;
- dynamic: import every port module (and chip_smoke) in a subprocess
  where ``jax``/``jaxlib``/``flax`` cannot be imported, and check no
  ``ray_tpu`` module entered ``sys.modules``;
- device: without a visible CUDA device, the entry points raise unless
  given ``device="cpu"``.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ray_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "ray_tpu"}


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "tools").glob("torch_*.py"))
    assert len(files) > 16
    return files


def _imports(path):
    seen = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            seen.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            # relative imports are not used: each import names its
            # package, so this check sees all of them
            assert node.level == 0, f"{path}: relative import"
            seen.add(node.module)
    return seen


def test_port_sources_import_no_jax_and_no_ray_tpu():
    bad = {}
    for path in _port_files():
        hits = sorted(m for m in _imports(path)
                      if m.split(".")[0] in FORBIDDEN)
        if hits:
            bad[str(path.relative_to(ROOT))] = hits
    assert not bad, f"forbidden imports in the port: {bad}"


def test_port_planner_imports_within_contract():
    from ray_tpu_torch.serve.scheduler import ALLOWED_IMPORTS
    seen = {m.split(".")[0]
            for m in _imports(PORT / "serve" / "scheduler.py")}
    assert seen and seen <= set(ALLOWED_IMPORTS), seen


def test_port_modules_import_with_jax_blocked():
    prog = f"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "orbax"):
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {str(ROOT)!r})
import ray_tpu_torch
names = ["ray_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                          "ray_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules
                if m == "ray_tpu" or m.startswith("ray_tpu."))
print(json.dumps({{"modules": names, "leaked": leaked}}))
"""
    out = subprocess.run([sys.executable, "-c", prog], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == [], res["leaked"]
    for name in ("ray_tpu_torch.serve.engine", "ray_tpu_torch.serve.llm",
                 "ray_tpu_torch.ops.paged_attention",
                 "ray_tpu_torch.ops._build",
                 "ray_tpu_torch.models.llama",
                 "ray_tpu_torch.ops.flash_attention",
                 "ray_tpu_torch.ops.attention",
                 "ray_tpu_torch.models.gpt2",
                 "ray_tpu_torch.train.spmd",
                 "ray_tpu_torch.util.envknobs",
                 "ray_tpu_torch.serve.prefix_cache",
                 "ray_tpu_torch.serve.spec_decode",
                 "ray_tpu_torch.serve.kv_migration",
                 "ray_tpu_torch.serve.obs",
                 "ray_tpu_torch.serve.engine_pool",
                 "ray_tpu_torch.serve.fleet.routing",
                 "ray_tpu_torch.util.tracing",
                 "ray_tpu_torch.serve.fleet.wire",
                 "ray_tpu_torch.serve.fleet.transport",
                 "ray_tpu_torch.serve.fleet.directory",
                 "ray_tpu_torch.serve.fleet.agent",
                 "ray_tpu_torch.serve.fleet.router",
                 "ray_tpu_torch.util.metrics",
                 "ray_tpu_torch.serve.watchdog",
                 "ray_tpu_torch.serve.pool_autoscaler",
                 "ray_tpu_torch.autoscaler.node_provider",
                 "ray_tpu_torch.air.checkpoint",
                 "ray_tpu_torch.air.checkpoint_manager",
                 "ray_tpu_torch.serve.weight_rollout",
                 "ray_tpu_torch.serve.batch_tier"):
        assert name in res["modules"]


def test_entry_points_raise_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device works")
    from ray_tpu_torch._device import NoCudaError, resolve_device
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.kv_cache import init_kv_pool
    from ray_tpu_torch.models.llama import build_model, init_params, \
        llama_tiny
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.train.spmd import put_batch
    from ray_tpu_torch.serve.llm import LlamaDeployment
    cfg = llama_tiny(dtype=torch.float32)
    with pytest.raises(NoCudaError):
        resolve_device()
    with pytest.raises(NoCudaError):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(NoCudaError):
        init_params(cfg, seed=0)
    sd = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NoCudaError):
        build_model(cfg, sd)
    model = build_model(cfg, sd, "cpu")
    assert model.tok_embeddings.device.type == "cpu"
    with pytest.raises(NoCudaError):
        LLMEngine(model)
    with pytest.raises(NoCudaError):
        LLMEngine(model, kv_dtype="int8", prefix_cache=True)
    with pytest.raises(NoCudaError):
        LlamaDeployment(cfg)
    eng = LLMEngine(model, device="cpu")
    assert eng.device.type == "cpu"
    dep = LlamaDeployment(cfg, device="cpu")
    assert dep.model.tok_embeddings.device.type == "cpu"
    with pytest.raises(NoCudaError):
        init_kv_pool(cfg, 4, 8)
    with pytest.raises(NoCudaError):
        init_kv_pool(cfg, 4, 8, kv_dtype="int8")
    assert init_kv_pool(cfg, 4, 8, device="cpu")[0][0].device.type == "cpu"
    assert all(t.device.type == "cpu" for t in init_kv_pool(
        cfg, 4, 8, kv_dtype="int8", device="cpu")[0])
    assert LLMEngine(model, kv_dtype="int8", prefix_cache=True,
                     device="cpu").kv_dtype == "int8"
    gcfg = gpt2.gpt2_tiny(dtype=torch.float32)
    with pytest.raises(NoCudaError):
        gpt2.init_params(gcfg, seed=0)
    sd = gpt2.init_params(gcfg, seed=0, device="cpu")
    with pytest.raises(NoCudaError):
        gpt2.build_model(gcfg, sd)
    assert gpt2.build_model(gcfg, sd, "cpu").wte.device.type == "cpu"
    batch = {"ids": torch.zeros(2, 9, dtype=torch.int32)}
    with pytest.raises(NoCudaError):
        put_batch(batch)
    assert put_batch(batch, "cpu")["ids"].device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
