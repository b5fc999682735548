"""graftlint over the port's host-federation plane.

graftlint (the JAX package's ``analysis/``) reads source and scopes every
rule to paths under ``pytensor_federated_tpu/``.  So the test lays the
port out in a temporary tree under that package name, with the JAX
package's ``analysis/`` inside it and the repository's ``native/`` and
``docs/`` beside it (the wire and observability rules read those), and
appends a no-op ``force_cpu_backend`` to the copy's ``utils.py`` (the
checker calls it before a check; the port's own one hides CUDA from the
process).  In a fresh interpreter rooted there, the eleven rules that
are not about the JAX ``fed`` primitives run over the copy's
``service/``, ``routing/``, ``gateway/``, ``faultinject/`` and
``telemetry/``, and must find nothing; with one blocking call seeded
into the copy they find exactly it.  (The two ``fed`` rules inspect JAX
primitives and jaxprs, which the port has none of.)  About 15 s a case
on one worker.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RULES = [
    "async-blocking", "fault-shim-coverage", "loop-affinity", "loop-escape",
    "observability-drift", "resource-leak", "shared-state-lock", "unbounded-spin",
    "unbounded-wait", "wire-loudness", "wire-registry",
]
SUBTREES = ("service", "routing", "gateway", "faultinject", "telemetry")
IGNORE = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "*.o")


def _lint_tree(tmp_path: Path) -> Path:
    pkg = tmp_path / "pytensor_federated_tpu"
    shutil.copytree(ROOT / "pytensor_federated_torch", pkg, ignore=IGNORE)
    shutil.copytree(ROOT / "pytensor_federated_tpu" / "analysis", pkg / "analysis", ignore=IGNORE)
    for extra in ("native", "docs"):
        shutil.copytree(ROOT / extra, tmp_path / extra, ignore=IGNORE)
    with open(pkg / "utils.py", "a") as f:
        f.write("\n\ndef force_cpu_backend(*args, **kwargs):\n    return None\n")
    return tmp_path


#: A blocking sleep inside a coroutine: the ``async-blocking`` rule must
#: flag it, which shows the run above checks the copy at all.
SEEDED = "import time\n\n\nasync def handler():\n    time.sleep(1)\n"


@pytest.mark.parametrize("seeded", [False, True], ids=["port", "seeded-fault"])
def test_graftlint_over_the_ports_federation_plane(tmp_path, seeded):
    root = _lint_tree(tmp_path)
    if seeded:
        (root / "pytensor_federated_tpu" / "service" / "seeded_fault.py").write_text(SEEDED)
    want_files = sum(1 for d in SUBTREES for _ in (ROOT / "pytensor_federated_torch" / d).rglob("*.py"))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from pathlib import Path\n"
        "from pytensor_federated_tpu.analysis import core\n"
        f"root = Path({str(root)!r})\n"
        "pkg = root / 'pytensor_federated_tpu'\n"
        f"paths = sorted(p for d in {SUBTREES!r} for p in (pkg / d).rglob('*.py'))\n"
        "stats = {}\n"
        f"found = core.run(rules={RULES!r}, paths=paths, root=root, stats=stats)\n"
        "print(json.dumps({'files': len(paths), 'stats': stats,\n"
        "                  'findings': [str(f) for f in found]}))\n"
    )
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)},
    )
    seconds = time.perf_counter() - t0
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["files"] == want_files + seeded, result
    if seeded:
        assert len(result["findings"]) == 1, result["findings"]
        assert "seeded_fault.py:5" in result["findings"][0]
        assert "async-blocking" in result["findings"][0]
    else:
        assert result["findings"] == [], "\n".join(result["findings"])
    assert seconds < 60, seconds
