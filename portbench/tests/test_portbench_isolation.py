"""Nothing the benchmark runs loads JAX or the JAX package, the reference
imports nothing of the program, and the measurement refuses to run without
a card."""

import ast

from small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "coati_tpu"}
BENCH = ROOT / "portbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_module_of_jax_or_the_jax_package_is_imported():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_whole_name_is_compared(monkeypatch):
    import sys
    import types

    from portbench.harness import forbidden_modules

    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "coati_tpu_torch_probe", types.ModuleType("probe"))
    assert forbidden_modules() == []  # the port's name begins with the JAX package's
    monkeypatch.setitem(sys.modules, "coati_tpu.models", types.ModuleType("probe"))
    assert forbidden_modules() == ["coati_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "coati_tpu_torch" not in tops, path
        assert tops <= {"__future__", "json", "math", "pickle", "functools", "pathlib", "numpy",
                        "torch", "portbench"}, (path, tops)


def test_a_run_without_a_card_prints_no_result(capsys, monkeypatch):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "coati.roundtrip.smiles", "--seed", str(2**31 + 5),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err
