"""coati_tpu_torch stands alone: it and chip_smoke.py import nothing of
JAX, flax or coati_tpu; without a GPU its entry points refuse to run
unless asked for the CPU; the kernel wrappers take their plain path only
for CPU tensors, without launching anything; and importing the kernel
build module builds nothing."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "coati_tpu")


def _port_sources():
    return sorted((ROOT / "coati_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_or_coati_tpu():
    code = (
        "import sys, coati_tpu_torch.models.api, coati_tpu_torch.models.io\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr


def test_loader_without_device_raises_when_no_cuda(monkeypatch):
    from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_e3gnn_smiles_clip_e2e(str(ROOT / "docs" / "eval_model_r5.pkl"))


def test_kernel_wrappers_take_plain_path_on_cpu_without_building(monkeypatch):
    from coati_tpu_torch.models.transformer import quantize_kv
    from coati_tpu_torch.ops.kernels import build
    from coati_tpu_torch.ops.kernels.decode_attention import (
        decode_attention,
        decode_attention_quant,
    )
    from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA build")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    wrappers = (flash_causal_attention, decode_attention, decode_attention_quant)
    before = [w.launches for w in wrappers]
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 4, 16, generator=g)
    flash_causal_attention(q, q, q)
    decode_attention(q[:, 0], q, q, 5)
    q8, qs = quantize_kv(q)
    decode_attention_quant(q[:, 0], q8, qs, q8, qs, 5)
    assert [w.launches for w in wrappers] == before == [0, 0, 0]


def test_kernel_build_module_imports_without_nvcc(monkeypatch):
    """Importing the build module compiles nothing and needs no nvcc: the
    build runs at the first launch on a CUDA tensor."""
    calls = []
    monkeypatch.setattr(subprocess, "Popen", lambda *a, **k: calls.append(a))
    from coati_tpu_torch.ops.kernels import build

    importlib.reload(build)
    assert calls == []
    assert build.SOURCES == ("flash_attention", "decode_attention")
    for name in build.SOURCES:
        assert (build.CSRC_DIR / f"{name}.cu").exists()
        assert build.library_path(name).parent == build.BUILD_DIR


def test_kernel_input_checks_refuse_non_cuda_tensors():
    """The checks that run before a launch refuse a tensor that is not on a
    CUDA device (here, meta tensors) instead of routing it anywhere else."""
    from coati_tpu_torch.ops.kernels import decode_attention as kd
    from coati_tpu_torch.ops.kernels import flash_attention as kf

    meta = torch.device("meta")
    q = torch.empty(2, 8, 4, 16, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        kf._check_inputs(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        kd._check_common(q[:, 0], q, q, 3)
