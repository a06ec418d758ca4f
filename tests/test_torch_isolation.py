"""coati_tpu_torch stands alone: it, chip_smoke.py and scripts/torch_*.py
import nothing of JAX, flax, optax or coati_tpu; without a GPU its entry
points refuse to run unless asked for the CPU; the kernel wrappers take
their plain path only for CPU tensors, without launching anything; and
importing the kernel build module builds nothing."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "coati_tpu")


def _port_sources():
    """Every module of the port (models, ops, tokenizers, data, training,
    ...), the smoke script and the port's scripts (scripts/torch_*.py:
    the decode-quality protocols, the kernel variants, the probes)."""
    return (sorted((ROOT / "coati_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("torch_*.py")))


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
        "import coati_tpu_torch.training.train, coati_tpu_torch.data\n"
        "import coati_tpu_torch.parallel.tp, coati_tpu_torch.parallel.fsdp\n"
        "import coati_tpu_torch.parallel.inference\n"
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
    from coati_tpu_torch.ops.kernels.egnn_messages import egnn_messages
    from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention
    from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA build")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    wrappers = (flash_causal_attention, decode_attention, decode_attention_quant,
                egnn_messages, packed_causal_attention)
    before = [w.launches for w in wrappers]
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 4, 16, generator=g)
    flash_causal_attention(q, q, q)
    decode_attention(q[:, 0], q, q, 5)
    q8, qs = quantize_kv(q)
    decode_attention_quant(q[:, 0], q8, qs, q8, qs, 5)
    packed_causal_attention(q, q, q)
    a, pair = q[:, :, 0], q[:, :, 0, :8]  # (2, 8, 16) and (2, 8, 8)
    for mm_dtype in (torch.float32, torch.bfloat16):
        egnn_messages(a, a, pair, pair, a[0, 0], a[0, 1], q[0, 0, 0, :, None] * a[0, 2], a[0, 3],
                      mm_dtype=mm_dtype)
    assert [w.launches for w in wrappers] == before == [0, 0, 0, 0, 0]


def test_kernel_build_module_imports_without_nvcc(monkeypatch):
    """Importing the build module compiles nothing and needs no nvcc: the
    build runs at the first launch on a CUDA tensor."""
    calls = []
    monkeypatch.setattr(subprocess, "Popen", lambda *a, **k: calls.append(a))
    from coati_tpu_torch.ops.kernels import build

    importlib.reload(build)
    assert calls == []
    assert build.SOURCES == (
        "flash_attention", "decode_attention", "egnn_messages", "packed_attention",
        "egnn_messages_bwd", "packed_attention_bwd", "mla_decode", "top_k",
    )
    for name in build.SOURCES:
        assert (build.CSRC_DIR / f"{name}.cu").exists()
        assert build.library_path(name).parent == build.BUILD_DIR


def test_every_included_header_is_hashed_into_the_build():
    """A library is keyed on its source, build.HEADERS and the flags: every
    header that a source (or a header) includes must be in build.HEADERS,
    or an edit to it would leave a stale library to be loaded."""
    import re

    from coati_tpu_torch.ops.kernels import build

    files = sorted(build.CSRC_DIR.glob("*.cu")) + sorted(build.CSRC_DIR.glob("*.cuh"))
    included = {
        (path.name, name)
        for path in files
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M)
    }
    assert {name for _, name in included} >= {"common.cuh", "mma.cuh"}
    missing = sorted((src, name) for src, name in included if name not in build.HEADERS)
    assert not missing, f"included but not hashed into the build: {missing}"
    for name in build.HEADERS:
        assert (build.CSRC_DIR / name).exists()
    assert sorted(p.name for p in build.CSRC_DIR.glob("*.cuh")) == sorted(build.HEADERS)


def test_kernel_input_checks_refuse_non_cuda_tensors():
    """The checks that run before a launch refuse a tensor that is not on a
    CUDA device (here, meta tensors) instead of routing it anywhere else."""
    from coati_tpu_torch.ops.kernels import decode_attention as kd
    from coati_tpu_torch.ops.kernels import flash_attention as kf

    meta = torch.device("meta")
    q = torch.empty(2, 8, 4, 16, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        kf.check_qkv(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        kd._check_common(q[:, 0], q, q, 3)
    from coati_tpu_torch.ops.kernels import egnn_messages as ke

    a, pair = torch.empty(2, 8, 16, device=meta), torch.empty(2, 8, 8, device=meta)
    vec, mat = torch.empty(16, device=meta), torch.empty(16, 16, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        ke._check_inputs(a, a, pair, pair, vec, vec, mat, vec, torch.float32)


def test_message_kernel_refuses_inputs_that_require_grad():
    """The message kernel used to be forward only and refused an input that
    requires grad. It is differentiable now: such an input is taken, the
    output carries a grad_fn, a, c and the weights get a gradient, and the
    pair geometry d2 and w get none."""
    from coati_tpu_torch.ops.kernels import egnn_messages as ke

    assert not hasattr(ke, "_check_no_grad")
    g = torch.Generator().manual_seed(0)
    a, c = (torch.randn(2, 3, 4, generator=g, requires_grad=True) for _ in range(2))
    d2, w = (torch.rand(2, 3, 3, generator=g, requires_grad=True) for _ in range(2))
    wd, b1, b2 = (torch.randn(4, generator=g, requires_grad=True) for _ in range(3))
    w2 = torch.randn(4, 4, generator=g, requires_grad=True)
    out = ke.egnn_messages(a, c, d2, w, wd, b1, w2, b2)
    assert out.grad_fn is not None
    out.sum().backward()
    for x in (a, c, wd, b1, w2, b2):
        assert x.grad is not None and bool(x.grad.abs().sum() > 0)
    assert d2.grad is None and w.grad is None
    assert ke.egnn_messages.launches == 0 and ke.egnn_messages.bwd_launches == 0
