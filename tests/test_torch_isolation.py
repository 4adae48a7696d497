"""The PyTorch port imports neither JAX nor anything of the JAX package
``repro`` (not even its JAX-free modules), nor ``msgpack`` (its checkpoints
carry their own codec), and neither does ``chip_smoke.py``: the machine
with the card has none of them."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax|jaxlib|repro|msgpack)(\.|\s|$)")
_DYNAMIC = re.compile(
    r"""(import_module|__import__)\(\s*f?["'](jax|repro|msgpack)[."']""")

_CHILD = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, ".")
import chip_smoke  # noqa: F401  (module level only; main() needs a card)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))
print(len(names), "modules;", "foreign:", bad)
assert not bad, bad
"""


def test_importing_every_port_module_loads_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split()[0])
    assert n >= 20, proc.stdout                # the whole tree was walked


def test_sources_have_no_jax_or_repro_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    hits = []
    for path in files:
        for no, line in enumerate(path.read_text().splitlines(), 1):
            if _IMPORT.search(line) or _DYNAMIC.search(line):
                hits.append(f"{path.relative_to(ROOT)}:{no}: {line.strip()}")
    assert not hits, "\n".join(hits)
