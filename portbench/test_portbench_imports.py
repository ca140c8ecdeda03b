"""What each part of the benchmark loads, in a fresh interpreter: the
reference neither JAX nor the JAX package nor the program; the harness, its
drivers and its metric readers neither JAX nor the JAX package (the program,
pointcloud_tpu_torch, is the system under test). Top-level names are compared
whole."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.core import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    code = PROBE.format(repo=str(ROOT.parent), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_no_program():
    mods = loaded("import portbench.reference, portbench.counts, portbench.scene")
    assert not mods & {"jax", "jaxlib", "flax", "pointcloud_tpu", "pointcloud_tpu_torch"}


def test_harness_imports_no_jax():
    body = """
from portbench import core
import portbench.run
for p in sorted((core.ROOT / "drivers").glob("*.py")) + sorted((core.ROOT / "metrics").glob("*.py")):
    if p.name != "__init__.py":
        core.load_module(p)
import portbench.readings
"""
    mods = loaded(body)
    assert "pointcloud_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "pointcloud_tpu"}
