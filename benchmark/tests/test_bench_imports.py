"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level names; the reference imports nothing of the program."""

import ast
import os
import sys

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_whole_top_level_names(monkeypatch):
    base = dict(sys.modules)
    for name in ("jax", "jaxlib", "flax", "speech_editing_tpu"):
        monkeypatch.setattr(sys, "modules", dict(base))
        for k in [k for k in sys.modules if k.split(".")[0] in harness.FORBIDDEN]:
            del sys.modules[k]
        sys.modules[f"{name}.sub"] = object()
        assert harness.forbidden_modules() == [name]
    monkeypatch.setattr(sys, "modules", {k: v for k, v in base.items()
                                         if k.split(".")[0] not in harness.FORBIDDEN})
    sys.modules["speech_editing_tpu_torch.infer"] = object()
    sys.modules["jaxtyping"] = object()
    assert harness.forbidden_modules() == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                top = mod.split(".")[0]
                assert top not in ("speech_editing_tpu_torch", "speech_editing_tpu", "jax",
                                   "flax"), (f, mod)
                assert top in ("benchmark", "numpy", "torch", "scipy", "math", "re", "zlib", "functools",
                               "__future__"), (f, mod)


def test_no_benchmark_file_imports_jax():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(root, f)):
                    assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                                     "speech_editing_tpu"), (f, mod)
