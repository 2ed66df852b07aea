"""The FLOP and byte counters against hand-worked numbers."""

from types import SimpleNamespace

from portbench import counts, fields


def test_density_and_shading_flops_of_synth_full():
    vm = fields.load("TensorVMSplit", "MLP_Fea")
    cfg = SimpleNamespace(n_lamb_sigma=(16, 16, 16), n_lamb_sh=(48, 48, 48), data_dim_color=27,
                          view_pe=2, fea_pe=2, featureC=128)
    # 14 FLOPs a rank: 4 plane taps and 2 line taps (a multiply-add each),
    # the product and the sum over ranks
    assert vm.density_flops(cfg) == 672
    # 13 a rank for the appearance reads (no sum), the 144 x 27 basis, the
    # MLP_Fea 150 -> 128 -> 128 -> 3 (150 = 12 view PE + 108 feature PE
    # + 3 + 27)
    assert vm.app_read_flops(cfg) == 13 * 144
    assert counts.mlp_in(2, 2, 27) == 150
    assert counts.shade_flops(vm, cfg) == (
        13 * 144 + 2 * 144 * 27 + 2 * (150 * 128 + 128 * 128 + 128 * 3))
    assert counts.forward_flops(vm, cfg, 1000, 10) == 1000 * 672 + 10 * 81584
    assert counts.step_flops(vm, cfg, 1000, 10) == 3 * (1000 * 672 + 10 * 81584)


def test_flower_mlp_width():
    # PE 0: the MLP reads the 27 features and the 3 view directions
    assert counts.mlp_in(0, 0, 27) == 30


def test_scatter_bound_of_the_128_cube_density_stream():
    # 1,814,528 rows x 64 channels into 16,384 rows: chip_smoke's
    # density_128 case, whose bound reads 0.1421 ms at 3.35 TB/s
    b = counts.scatter_bound_bytes(1814528, 64, 4, 16384)
    assert b == 1814528 * 64 * 4 + 1814528 * 4 + 16384 * 64 * 4 == 475971584
    assert abs(b / counts.PEAK_HBM_BYTES * 1e3 - 0.14208) < 1e-4
    # bf16 gradients halve the rows' bytes only
    assert counts.scatter_bound_bytes(10, 8, 2, 4) == 10 * 8 * 2 + 40 + 4 * 8 * 4
