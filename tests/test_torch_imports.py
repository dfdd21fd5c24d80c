"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and importing the port changes no global
torch state (tests of both packages share xdist workers)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_loads_no_jax_and_keeps_torch_state():
    code = (
        "import sys, torch\n"
        "before = (torch.get_num_threads(), torch.get_default_dtype(), "
        "torch.initial_seed(), torch.backends.cuda.matmul.allow_tf32, "
        "torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())\n"
        "import repro_torch.fl.simulator, repro_torch.kernels.delta_pipeline.ops\n"
        "import repro_torch.convert, repro_torch.random\n"
        "import repro_torch.serve.engine, repro_torch.serve.oracle, repro_torch.models.api\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.kernels.paged_attention.ops\n"
        "import repro_torch.kernels.wkv6.ops, repro_torch.kernels.fedavg.ops, repro_torch.models.rwkv6\n"
        "import repro_torch.launch.serve, repro_torch.configs\n"
        "import repro_torch.obs, repro_torch.sim.faults, repro_torch.fl.attacks\n"
        "import repro_torch.sim, repro_torch.sim.events, repro_torch.sim.sweep\n"
        "import repro_torch.fl, repro_torch.fl.round, repro_torch.fl.state\n"
        "import repro_torch.optim, repro_torch.optim.schedules, repro_torch.data.synthetic\n"
        "import repro_torch.checkpoint, repro_torch.launch.train\n"
        "import repro_torch.models.moe, repro_torch.serve.sweep, repro_torch.sim.faas\n"
        "import repro_torch.models.encdec, repro_torch.models.ssm, repro_torch.tools.profile_serve\n"
        "import repro_torch.dist, repro_torch.dist.world, repro_torch.dist.selftest\n"
        "import repro_torch.dist.tensor_parallel, repro_torch.dist.sharding\n"
        "import repro_torch.kernels.delta_pipeline.sharded_selftest\n"
        "import repro_torch.kernels.delta_pipeline.fog_selftest\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "[get_config(a) for a in ARCH_IDS]\n"
        "after = (torch.get_num_threads(), torch.get_default_dtype(), "
        "torch.initial_seed(), torch.backends.cuda.matmul.allow_tf32, "
        "torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())\n"
        "assert before == after, (before, after)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
