"""The FLOP and byte counters against hand counts at the reduced
configurations (the port's ``get_reduced``), and the qwen3-moe bound
against the one the repo measured against (``PERF.md``: 8.37 ms)."""
import pytest

from portbench_cpu import small_cell


def _ref(cell):
    from portbench.harness import manifest
    return manifest.reference_model(cell.config)


def test_moe_train_flops_by_hand():
    cell = small_cell('qwen3moe-d4.eva.4k')
    # a layer: q 64x64 + k, v 64x32 + o 64x64 + router 64x8 + 2 experts x
    # 3 x 64x32 = 4096 + 4096 + 4096 + 512 + 12288 = 25088; 2 layers and
    # the 64x512 head: 82944 weights; 6 x 82944 x 256 tokens
    weights = 6 * 82944 * 4 * 64
    # 2 layers x 4 rows x 3 x 2 x 2 x (64²/2) x 4 heads x 16
    attn = 2 * 4 * 3 * 2 * 2 * 2048 * 64
    assert _ref(cell).train_flops(cell.config, 4, 64) == weights + attn \
        == 139_984_896


def test_ssm_train_flops_by_hand():
    cell = small_cell('mamba2-780m.eva.16k')
    # d_inner 128, 8 heads, in_proj 64 x (256 + 32 + 8) + out_proj 128x64
    # = 27136 a layer; 2 layers and the tied 64x512 head: 87040
    weights = 6 * 87040 * 4 * 64
    # chunk 8, 4 x 64/8 = 32 chunks a layer: 2·8²·16 + 2·8²·8·16 +
    # 4·8·16·8·16 = 2048 + 16384 + 65536 = 83968 a chunk, x3, x2 layers
    scan = 3 * 2 * 32 * 83968
    assert _ref(cell).train_flops(cell.config, 4, 64) == weights + scan \
        == 149_815_296


def test_eva_fused_work_by_hand():
    from portbench.harness import manifest
    cell = small_cell('qwen3moe-d4.eva.4k')
    work = manifest.metric_reader('roofline.eva_fused').work
    # float32 G: 12 bytes an element (G, m, out) and 4 x (d_in + d_out + 3)
    # an item: q, o (2 x 64x64): 98304 + 1048 each; k, v (2 x 64x32):
    # 49152 + 792 each; router (2 x 64x8): 12288 + 600; gate, up, down
    # (16 x 64x32): 393216 + 6336 each; head (64x512): 393216 + 2316
    want = 2 * 99352 + 2 * 49944 + 12888 + 3 * 399552 + 395532
    # 13 operations an element over 156672 elements
    assert work(cell.config, _ref(cell)) == (want, 13 * 156672) \
        == (1_905_668, 2_036_736)


def test_eva_fused_bound_at_qwen3_moe_depth_4():
    from portbench.harness import manifest
    from portbench.harness.peaks import PEAKS
    cell = manifest.load_cell('qwen3moe-d4.eva.4k')
    n_bytes, n_ops = manifest.metric_reader('roofline.eva_fused').work(
        cell.config, _ref(cell))
    peaks = PEAKS['NVIDIA H100 80GB HBM3']
    assert n_ops / peaks['f32_flops'] < n_bytes / peaks['hbm_bytes']
    assert n_bytes / peaks['hbm_bytes'] * 1e3 == pytest.approx(8.37,
                                                               rel=2e-3)


def test_train_flops_at_published_widths():
    """qwen3-moe depth 4: 538.7M matmul weights a token (PERF.md's 539M)
    and 0.82 TFLOP of attention a step."""
    from portbench.harness import manifest
    cell = manifest.load_cell('qwen3moe-d4.eva.4k')
    flops = _ref(cell).train_flops(cell.config, 2, 2048)
    attn = 4 * 2 * 3 * 2 * 2 * (2048 ** 2 / 2) * 32 * 128
    assert (flops - attn) / (6 * 4096) == 538_705_920
