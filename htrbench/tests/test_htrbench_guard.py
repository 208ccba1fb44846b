"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port."""

import json
import subprocess
import sys

from htrbench import guard
from htrbench.manifest import ROOT


def test_top_level_names_compared_whole():
    assert guard.forbidden_loaded(["htr_vt_torch.models", "numpy", "flaxen", "jaxtyping"]) == []
    assert guard.forbidden_loaded(["jax._src.core", "jaxlib", "flax.linen", "optax",
                                   "orbax.checkpoint", "htr_vt_tpu.ops"]) == [
        "flax.linen", "htr_vt_tpu.ops", "jax._src.core", "jaxlib", "optax",
        "orbax.checkpoint"]


def test_reference_sources_import_nothing_of_the_port():
    assert guard.reference_faults() == []
    assert "htr_vt_torch.train.state" in guard.reference_faults(ROOT / "htr_vt_torch" / "train")


def _python(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, check=True, timeout=600).stdout


def test_reference_loads_no_port_module():
    out = _python("import sys, htrbench.reference.model, htrbench.reference.train, "
                  "htrbench.reference.serve, htrbench.reference.numerics; "
                  "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = json.loads(out.replace("'", '"'))
    assert "htr_vt_torch" not in loaded and "jax" not in loaded


def test_a_dry_run_loads_no_jax():
    out = _python(
        "import sys, json\n"
        "from htrbench.run import execute\n"
        "from htrbench.tests.tiny import CELLS\n"
        "from htrbench import guard\n"
        "for cell in CELLS:\n"
        "    execute(cell, 7, 0.05, False, 'cpu', CELLS[cell])\n"
        "print(json.dumps(guard.forbidden_loaded()))\n")
    assert json.loads(out.splitlines()[-1]) == []
