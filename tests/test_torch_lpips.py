"""LPIPS in the port (tensorf_tpu_torch/eval/lpips.py) against
tensorf_tpu/eval/lpips_jax.py.

Seeded random weights are written in the JAX package's ``.npz`` layout, as
tests/test_lpips.py writes them, and both packages read them from
``TENSORF_LPIPS_DIR``: AlexNet and VGG agree on a non-square pair within
1e-5 relative (float32 convolutions in both).  Without weights the metric
is None, and the evaluation's mean.txt holds NaN in its two LPIPS lines.
"""

import numpy as np
import pytest

from tensorf_tpu.eval import lpips_jax
from tensorf_tpu_torch import __main__ as cli
from tensorf_tpu_torch.eval import lpips
from tensorf_tpu_torch.eval.metrics import rgb_lpips


def _write_random_weights(path, net):
    arch = lpips_jax._ALEX if net == "alex" else lpips_jax._VGG
    rng = np.random.default_rng(0)
    out = {}
    in_ch = 3
    for i, (out_ch, k, stride, pad) in enumerate(arch["convs"]):
        out[f"conv{i}.w"] = (rng.standard_normal((k, k, in_ch, out_ch))
                             * np.sqrt(2.0 / (k * k * in_ch))).astype(np.float32)
        out[f"conv{i}.b"] = (0.01 * rng.standard_normal(out_ch)).astype(np.float32)
        in_ch = out_ch
    for t, ci in enumerate(arch["taps"]):
        out[f"lin{t}.w"] = rng.uniform(0, 1, size=arch["convs"][ci][0]).astype(np.float32)
    np.savez(path, **out)


@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TENSORF_LPIPS_DIR", str(tmp_path))
    lpips.clear_cache()
    lpips_jax.load_weights.cache_clear()
    yield tmp_path
    lpips.clear_cache()
    lpips_jax.load_weights.cache_clear()


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(weights_dir, net):
    for key in ("convs", "pool_before", "taps"):
        assert lpips.ARCHS[net][key] == (lpips_jax._ALEX if net == "alex" else lpips_jax._VGG)[key]
    _write_random_weights(weights_dir / f"lpips_{net}.npz", net)
    rng = np.random.default_rng(2)
    # non-square, to catch an H/W transposition
    a = rng.uniform(size=(72, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    want = lpips_jax.lpips(a, b, net=net)
    got = rgb_lpips(a, b, net, device="cpu")
    assert want is not None and got is not None and got > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert abs(lpips.lpips(a, a, net, device="cpu")) < 1e-6


def _tiny_run(basedir):
    argv = ["--config", "configs/synth_sphere.txt", "--device", "cpu", "--synthetic",
            "--synthetic_scene", "sphere", "--synthetic_wh", "40", "--synthetic_views", "2,1",
            "--downsample_train", "1", "--n_iters", "2", "--N_voxel_init", "1000",
            "--N_voxel_final", "1000", "--upsamp_list", "[]", "--update_AlphaMask_list", "[]",
            "--batch_size", "128", "--basedir", str(basedir)]
    assert cli.main(argv) == 0
    (mean,) = basedir.glob("*/synth_sphere/imgs_test_all/mean.txt")
    return np.loadtxt(mean)


def test_absent_weights_give_none_and_nan_lines(weights_dir, capsys):
    a = np.zeros((16, 16, 3), np.float32)
    assert rgb_lpips(a, a, "alex", device="cpu") is None
    assert rgb_lpips(a, a, "vgg", device="cpu") is None
    lines = _tiny_run(weights_dir / "without")
    assert lines.shape == (4,) and np.all(np.isfinite(lines[:2])) and np.all(np.isnan(lines[2:]))
    assert "LPIPS weights unavailable" in capsys.readouterr().out
    for net in ("alex", "vgg"):
        _write_random_weights(weights_dir / f"lpips_{net}.npz", net)
    lpips.clear_cache()
    lines = _tiny_run(weights_dir / "with")
    assert np.all(np.isfinite(lines)) and np.all(lines[2:] > 0)
    assert "LPIPS weights unavailable" not in capsys.readouterr().out
