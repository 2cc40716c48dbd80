"""The benchmark as data: `BENCHMARK.json` names every cell, metric,
configuration and traffic mix, and the harness finds each one's files by
its name, so a new cell, mix or metric is new files and new entries:

* `configs/<config>.json`: the configuration as it is run (`family`, the
  agent's fields under `agent`), its source, and its plain reference
  (`reference`, a module under `reference/`);
* `traffic/<traffic>.json`: a mix's parameters; its `kind` names the
  runner `kinds/<kind>.py` that one general generator of that kind runs;
* `metrics/<metric>.py`: a per-layer metric's reader, `read(obs)` ->
  a number or None;
* `limits/<cell>.json`: each compared number's limit in that cell.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mdt_policy_tpu")


def load_module(path: Path, name: Optional[str] = None):
    """Import the file at `path` as a module of its own."""
    name = name or "pb_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_") + \
        "_" + hashlib.sha256(str(path).encode()).hexdigest()[:8]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Bench:
    def __init__(self, root: Path, spec: Optional[Dict] = None):
        self.root = Path(root)
        self.home = self.root / "port_bench"
        self.spec = spec if spec is not None else json.loads(
            (self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> Dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def kind(self, kind: str):
        return load_module(self.home / "kinds" / f"{kind}.py")

    def reference(self, config_doc: Dict):
        return importlib.import_module(f"port_bench.reference.{config_doc['reference']}")

    def limits(self, cell: str) -> Dict[str, float]:
        return json.loads((self.home / "limits" / f"{cell}.json").read_text())["limits"]

    def metrics_of(self, cell: str, section: str) -> List[Dict]:
        """The `end_to_end` or `per_layer` metrics that `cell` reports."""
        return [m for m in self.spec[section] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return load_module(self.home / "metrics" / f"{metric}.py")
