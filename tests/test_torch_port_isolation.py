"""The port stands alone: no module of ``tpugan_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and the package imports
with JAX made unimportable."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "tpugan_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_tpugan_import(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "tpugan", "flax", "optax")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['tpugan'] = None; import tpugan_torch; "
            "import tpugan_torch.serve.server, tpugan_torch.sample.sampler, "
            "tpugan_torch.ops.cuda_gen2, tpugan_torch.ckpt.from_jax, "
            "tpugan_torch.models.registry, tpugan_torch.train.trainer, "
            "tpugan_torch.ops.cuda_conv_stats, "
            "tpugan_torch.losses.adversarial; "
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules "
            "if sys.modules[m] is not None]")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
