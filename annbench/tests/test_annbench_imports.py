"""What the benchmark loads: nothing whose top-level name, compared whole,
is ``jax``, ``jaxlib``, ``flax`` or the JAX package ``diskann_tpu``; and
the reference loads nothing of the port either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "annbench"
JAX = {"jax", "jaxlib", "flax", "diskann_tpu"}


def _roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT))
                                        for p in BENCH_DIR.rglob("*.py")))
def test_no_source_imports_jax_or_the_jax_package(path):
    roots = set(_roots(ROOT / path))
    assert not roots & JAX, roots & JAX
    if path.startswith("annbench/reference/"):
        assert "diskann_tpu_torch" not in roots


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_port():
    got = _loaded_after("import annbench.reference.check, annbench.reference.flat, "
                        "annbench.reference.synth, annbench.reference.exact")
    assert "annbench" in got
    assert not got & (JAX | {"diskann_tpu_torch"})


def test_a_whole_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, 'annbench/tests')\n"
            "from annbench import manifest, run\nfrom small import SMALL\n"
            "res, _ = run.run_cell(manifest.Bench(), 'stream1m.churn', seed=5, seconds=0.2,"
            " trace=False, device='cpu', t0=time.perf_counter(),"
            " overrides=SMALL['stream1m.churn'])\nassert res['correct']")
    got = _loaded_after(code)
    assert "diskann_tpu_torch" in got
    assert not got & JAX


def test_without_the_port_a_run_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and annbench/ cannot run."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "annbench")
    code = ("import sys, time; sys.path[:0] = ['.', 'annbench/tests']\n"
            "from annbench import manifest, run\nfrom small import SMALL\n"
            "run.run_cell(manifest.Bench(), 'stream1m.churn', seed=5, seconds=0.2,"
            " trace=False, device='cpu', t0=time.perf_counter(),"
            " overrides=SMALL['stream1m.churn'])")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and "diskann_tpu_torch" in p.stderr
