"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole: the port's own name begins with the JAX
package's), and the reference takes nothing from the program."""

import ast
import subprocess
import sys

from port_bench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mdt_policy_tpu"}


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_reference_sources_import_nothing_of_the_program():
    for path in sorted((ROOT / "port_bench" / "reference").glob("*.py")):
        names = set(_top_level_imports(path))
        assert not names & (FORBIDDEN | {"mdt_policy_tpu_torch"}), (path.name, names)


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_reference_alone_loads_no_program_and_no_jax():
    loaded = _loaded_after("import port_bench.reference.mdtv, port_bench.reference.mdt")
    assert not loaded & (FORBIDDEN | {"mdt_policy_tpu_torch"}), loaded


def test_a_harness_run_loads_no_jax():
    loaded = _loaded_after(
        "from port_bench.tests.conftest import run_tiny\n"
        "for cell in ('mdtv-controller-b1', 'mdt-eval-b32', 'mdtv-train-b512'):\n"
        "    run_tiny(cell, limits={k: 1e9 for k in ('chunk_gap', 'loss_gap', 'grad_gap',"
        " 'step_gap', 'ema_gap')}, seconds=0.3)\n"
        "from port_bench.harness.bench import forbidden_modules\n"
        "assert forbidden_modules() == []")
    assert "mdt_policy_tpu_torch" in loaded and not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_names():
    from port_bench.harness import bench
    saved = dict(sys.modules)
    try:
        sys.modules["mdt_policy_tpu_torch_probe"] = sys
        assert "mdt_policy_tpu" not in bench.forbidden_modules()
        sys.modules["mdt_policy_tpu.x"] = sys
        assert bench.forbidden_modules() == ["mdt_policy_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
