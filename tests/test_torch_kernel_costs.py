"""Each kernel's cost function (`kernels/<name>/kernel.py`, read by both
`chip_smoke.py`'s bounds and the dry run) against the bounds PERF.md's
kernel table prints: the larger of the bytes over 3.35 TB/s and the FLOPs
over the peak of their type (67 TFLOP/s fp32, 989 TFLOP/s dense bf16, the
H100 SXM data sheet), at the table's shapes, within the rounding of the
printed digits; and the meta branch of every wrapper records the same
cost and launches nothing."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dry                                # noqa: E402
from repro_torch.kernels.band_reclassify import kernel as band     # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec     # noqa: E402
from repro_torch.kernels.eps_affine import kernel as eps           # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash    # noqa: E402
from repro_torch.kernels.wkv6 import kernel as wkv                 # noqa: E402

BYTES_PER_S, FP32, BF16 = 3.35e12, 67e12, 989e12
DBLIFE = (124_000, 1024)

CASES = {
    # name: (cost, peak, PERF.md's bound_ms)
    "flash_attention": (flash.flash_attention_cost(8, 2048, 32, 4, 64, 2),
                        BF16, 0.13904),
    "flash_attention_bwd": (flash.flash_attention_bwd_cost(
        8, 2048, 32, 4, 64, 2), BF16, 0.34759),
    "decode_attention": (dec.decode_attention_cost(64, 4, 8, 64, 2048, 2, 2),
                         BF16, 0.04022),
    "decode_attention_f8": (dec.decode_attention_cost(
        32, 40, 1, 128, 2048, 2, 1), BF16, 0.20052),
    "wkv6": (wkv.wkv6_cost(8, 2048, 48, 64, 64), FP32, 0.30049),
    "wkv6_bwd": (wkv.wkv6_bwd_cost(8, 2048, 48, 64, 64), FP32, 0.74746),
    "eps_affine": (eps.eps_affine_cost(*DBLIFE, 4), FP32, 0.15180),
    "band_reclassify": (band.band_reclassify_cost(
        int(0.01 * DBLIFE[0]), DBLIFE[1], 4), FP32, 0.00152),
}


def _bound_ms(cost, peak):
    return max(cost.bytes / BYTES_PER_S, cost.flops / peak) * 1e3


@pytest.mark.parametrize("name", sorted(CASES))
def test_cost_gives_the_printed_bound(name):
    cost, peak, want = CASES[name]
    assert abs(_bound_ms(cost, peak) - want) <= 0.5e-5, name


def test_the_lse_output_adds_its_bytes_and_an_empty_block_nothing():
    plain = dec.decode_attention_cost(64, 4, 8, 64, 2048, 2, 2)
    lse = dec.decode_attention_cost(64, 4, 8, 64, 2048, 2, 2, lse=True)
    assert lse.flops == plain.flops
    assert lse.bytes - plain.bytes == 64 * 4 * 8 * 4
    assert dec.decode_attention_cost(64, 4, 8, 64, 0, 2, 2) == (0, 0)


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_meta_branches_record_the_costs_and_launch_nothing():
    from repro_torch.kernels.band_reclassify import ops as band_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.eps_affine import ops as eps_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    launches = (flash.flash_attention.launches, dec.decode_attention.launches,
                wkv.wkv6.launches, eps.eps_affine.launches,
                band.band_reclassify.launches)
    dry.reset()
    q = _meta(2, 64, 8, 16, grad=True)
    k, v = _meta(2, 64, 2, 16, grad=True), _meta(2, 64, 2, 16, grad=True)
    out = flash_ops.flash_attention(q, k, v)
    assert out.device.type == "meta" and out.shape == q.shape
    torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    qd = _meta(2, 1, 8, 16)
    cache = _meta(2, 32, 2, 16)
    o, lse = dec_ops.decode_attention(qd, cache, cache, 40, row0=16,
                                      with_lse=True)
    assert o.shape == qd.shape and lse.shape == (2, 8)
    dec_ops.decode_attention(qd, cache, cache, 10, row0=16, with_lse=True)
    r = _meta(2, 64, 2, 16, dtype=torch.float32, grad=True)
    u = _meta(2, 16, dtype=torch.float32)
    y = wkv_ops.wkv6(r, r, r, r, u, chunk=16)
    torch.autograd.grad(y, r, torch.empty_like(y))
    F = _meta(1000, 24, dtype=torch.float32)
    w = _meta(24, dtype=torch.float32)
    e, lab, cnt = eps_ops.eps_affine(F, w, 0.5)
    assert (e.dtype, lab.dtype, cnt.dtype) == (torch.float32, torch.int8,
                                               torch.int32)
    band_ops.band_reclassify_rows(F, lab, w, 0.5, 100, 64)
    got = dry.snapshot()
    want = {
        "flash_attention": flash.flash_attention_cost(2, 64, 8, 2, 16, 2,
                                                      lse=True),
        "flash_attention_bwd": flash.flash_attention_bwd_cost(2, 64, 8, 2,
                                                              16, 2),
        "decode_attention": dec.decode_attention_cost(2, 2, 4, 16, 25, 2, 2,
                                                      lse=True),
        "wkv6": wkv.wkv6_cost(2, 64, 2, 16, 16),
        "wkv6_bwd": wkv.wkv6_bwd_cost(2, 64, 2, 16, 16),
        "eps_affine": eps.eps_affine_cost(1000, 24, 4),
        "band_reclassify": band.band_reclassify_cost(64, 24, 4),
    }
    assert set(got) == set(want)
    for name, cost in want.items():
        # the block after the index (row0 16 > index 10) records nothing
        assert got[name] == {"calls": 1, "flops": cost.flops,
                             "bytes": cost.bytes}, name
    assert launches == (flash.flash_attention.launches,
                        dec.decode_attention.launches, wkv.wkv6.launches,
                        eps.eps_affine.launches,
                        band.band_reclassify.launches)
