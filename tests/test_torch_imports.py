"""The port never imports JAX or the JAX package.

An AST scan of every Python file of `diskann_tpu_torch/`: no `import
jax...`, `from jax... import`, `import diskann_tpu...` or `from
diskann_tpu... import` (the port's own `diskann_tpu_torch` is fine).
Importing any `diskann_tpu` module runs `diskann_tpu/__init__.py`, which
imports jax.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "diskann_tpu_torch").rglob("*.py")
)
FORBIDDEN = ("jax", "jaxlib", "diskann_tpu")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_the_scan_sees_the_package():
    assert "diskann_tpu_torch/graph/index.py" in FILES
    assert "diskann_tpu_torch/ops/kernels/fatrow_expand.py" in FILES
    for mod in ("__init__", "predicate", "labels", "compile"):
        assert f"diskann_tpu_torch/filters/{mod}.py" in FILES
    for path in ("graph/delete.py", "bench/runbook.py", "devices.py", "graph/modes.py"):
        assert f"diskann_tpu_torch/{path}" in FILES
    for mod in ("__init__", "bits", "binary", "transforms", "kmeans", "pq", "scalar",
                "minmax", "spherical"):
        assert f"diskann_tpu_torch/quant/{mod}.py" in FILES
    for path in ("io_/__init__.py", "io_/fbin.py", "io_/record.py", "native/__init__.py",
                 "tiered/__init__.py", "tiered/index.py", "tiered/stores.py",
                 "tiered/merged_build.py", "parallel/__init__.py", "parallel/partition.py"):
        assert f"diskann_tpu_torch/{path}" in FILES
    for path in ("trace.py", "testing.py", "service.py", "server.py", "ops/multivec.py",
                 "tools/__init__.py", "tools/__main__.py", "flat/index.py"):
        assert f"diskann_tpu_torch/{path}" in FILES
    for path in ("bench/stats.py", "bench/registry.py", "bench/abgate.py", "bench/kernels.py",
                 "bench/__main__.py", "bench/harness.py", "bench/recall.py",
                 "parallel/sharded.py", "convert.py"):
        assert f"diskann_tpu_torch/{path}" in FILES
    roots = set(_imported_roots(ast.parse("import jax.numpy\nfrom diskann_tpu.x import y")))
    assert roots == {"jax", "diskann_tpu"}


@pytest.mark.parametrize("path", FILES)
def test_no_jax_imports(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"
