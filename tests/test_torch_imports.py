"""The port imports nothing it must not: in a process where JAX, flax,
optax, orbax, the JAX package, Lightning and omegaconf cannot be imported,
every module of `mdt_policy_tpu_torch` and `chip_smoke.py` import."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# the roots of the modules the port may not import (`mdt_policy_tpu` is the
# bare JAX package: `mdt_policy_tpu_torch` has another root)
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "mdt_policy_tpu", "lightning",
           "pytorch_lightning", "lightning_fabric", "omegaconf")

# source run first in a subprocess: a finder ahead of every other that
# raises on an import of a blocked root and records the attempt
BLOCK_IMPORTS = f"""
import importlib.abc, sys
BLOCKED, ATTEMPTS = {BLOCKED!r}, []

class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in BLOCKED:
            ATTEMPTS.append(name)
            raise ModuleNotFoundError(f"{{name}} may not be imported here", name=name)
        return None

sys.meta_path.insert(0, _Blocker())
for _name in [m for m in sys.modules if m.partition(".")[0] in BLOCKED]:
    del sys.modules[_name]
"""


def run_blocked(code: str, timeout: int = 120, cwd=REPO) -> subprocess.CompletedProcess:
    """`code` in a fresh interpreter behind the blocking finder."""
    return subprocess.run([sys.executable, "-c", BLOCK_IMPORTS + code], capture_output=True,
                          text=True, timeout=timeout, cwd=cwd)


def test_port_imports_nothing_it_must_not():
    code = ("import pkgutil\n"
            "import mdt_policy_tpu_torch as pkg\n"
            "names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "'mdt_policy_tpu_torch.'))\n"
            "assert 'mdt_policy_tpu_torch.utils.from_reference' in names, names\n"
            "for name in names + ['chip_smoke']:\n"
            "    __import__(name)\n"
            "loaded = [m for m in sys.modules if m.partition('.')[0] in BLOCKED]\n"
            "assert not loaded, loaded\n"
            "print(len(names), 'modules;', 'attempts:', ATTEMPTS)\n")
    proc = run_blocked(code)
    assert proc.returncode == 0, proc.stderr
    assert "modules;" in proc.stdout
