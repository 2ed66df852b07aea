"""The port stands alone: it imports with jax blocked, names nothing of
tensorf_tpu, and its entry points refuse to fall back to the CPU quietly
when no GPU is present."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tensorf_tpu_torch"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import tensorf_tpu_torch, tensorf_tpu_torch.__main__\n"
        "from tensorf_tpu_torch import convert, ops, models, render, train, data, config, eval\n"
        "from tensorf_tpu_torch.train import loop\n"
        "from tensorf_tpu_torch.utils import ckpt, import_torch, misc, tracing, watchdog\n"
        "from tensorf_tpu_torch.models import alpha_mask\n"
        "from tensorf_tpu_torch.ops import resize, sh\n"
        "from tensorf_tpu_torch.render import chunked, culling\n"
        "from tensorf_tpu_torch.eval import evaluation, lpips, mesh, metrics, vis\n"
        "from tensorf_tpu_torch import profile_step, seed_spread\n"
        "from tensorf_tpu_torch.data import colmap2nerf, human, io, llff, nsvf, synthetic\n"
        "from tensorf_tpu_torch.data import tankstemple, your_own_data\n"
        "from tensorf_tpu_torch import parallel\n"
        "from tensorf_tpu_torch.parallel import launch, mesh, parity\n"
        "assert not {'imageio', 'PIL', 'matplotlib', 'tensorboardX'} & set(sys.modules)\n"
        "bad = [m for m, mod in sys.modules.items()"
        " if mod is not None and m.split('.')[0] in ('jax', 'tensorf_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_tensorf_tpu_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "tensorf_tpu"), (path, mod)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from tensorf_tpu_torch import resolve_device
    from tensorf_tpu_torch.config import TrainConfig
    from tensorf_tpu_torch.models import ModelConfig, TensorVMSplit
    from tensorf_tpu_torch.train.loop import reconstruction, render_test, train_steps
    from tensorf_tpu_torch.utils.ckpt import load_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TensorVMSplit(ModelConfig(), (4, 4, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_steps(TrainConfig(), 1)
    for entry in (reconstruction, render_test):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(TrainConfig())
    for path in ("unused.npz", "unused.th"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_checkpoint(path)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
