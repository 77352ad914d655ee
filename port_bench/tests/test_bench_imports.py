"""No module of the benchmark imports JAX, flax or the JAX package, and the
reference imports nothing of the port; names compare by whole top-level
name, so the port (`mp_former_tpu_torch`) passes where the JAX package
(`mp_former_tpu`) fails."""

import ast
import os

from port_bench.run import FORBIDDEN, forbidden_modules
from port_bench.tests.tiny import BENCH


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = [(p, m) for p in _sources() for m in _imports(p) if m in FORBIDDEN]
    assert not bad


def test_reference_imports_nothing_of_the_port():
    bad = [(p, m) for p in _sources("reference") for m in _imports(p)
           if m.startswith("mp_former")]
    assert not bad


def test_forbidden_modules_compares_whole_top_level_names():
    assert forbidden_modules({"mp_former_tpu_torch": 1, "mp_former_tpu_torch.ops": 1,
                              "jax_like": 1, "numpy": 1}) == []
    assert forbidden_modules({"mp_former_tpu.models": 1, "jax": 1, "jaxlib.xla": 1,
                              "flax": 1}) == ["flax", "jax", "jaxlib.xla", "mp_former_tpu.models"]
