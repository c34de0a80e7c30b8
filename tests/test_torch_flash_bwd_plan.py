"""The launch plan of the port's flash attention backward
(`flash_bwd_plan` and `flash_bwd_items` in
`repro_torch/kernels/flash_attention/kernel.py`), which repeats on the
host what `csrc/flash_attention_bwd.cu` computes for its TMA + wgmma
kernels: the route each dtype and head dim takes, the shared memory a
block asks for, the padded lse/D scratch the wrapper allocates, and the
work items the blocks take in launch order. The kernels themselves are
held to the plain version on the card by chip_smoke.py (phase 28)."""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, smoke_config          # noqa: E402
from repro_torch.kernels.checks import MAX_SMEM               # noqa: E402
from repro_torch.kernels.flash_attention import kernel        # noqa: E402

CSRC = (Path(kernel.__file__).resolve().parents[2] / "csrc"
        / "flash_attention_bwd.cu")
LENGTHS = (1, 63, 64, 65, 333, 2048)


def _layouts():
    """(nq, nkv, hd) of every registered config with attention, as the
    port runs it and with its q heads padded, and of the smoke twins."""
    out = {}
    for name, cfg in ARCHS.items():
        if cfg.family == "ssm":
            continue
        out[name] = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        nkv = cfg.padded_heads if cfg.mha_padded else cfg.num_kv_heads
        out[name + "-padded"] = (cfg.padded_heads, nkv, cfg.head_dim)
        smoke = smoke_config(name)
        out[name + "-smoke"] = (smoke.num_heads, smoke.num_kv_heads,
                                smoke.head_dim)
    out["smoke-hd32"] = (4, 2, 32)
    return out


LAYOUTS = _layouts()
REGISTERED = [n for n in LAYOUTS if not n.endswith("-smoke")
              and not n.startswith("smoke")]


def test_plan_constants_are_the_kernels():
    """The Python plan uses the tile, step and ring depth the CUDA source
    was built with."""
    src = CSRC.read_text()
    consts = {name: int(val) for name, val in re.findall(
        r"constexpr int (kWgTile|kWgStep|kWgStages) = (\d+);", src)}
    assert consts == {"kWgTile": kernel.BWD_TILE,
                      "kWgStep": kernel.BWD_STEP,
                      "kWgStages": kernel.BWD_STAGES}


@pytest.mark.parametrize("hd", kernel.BWD_WGMMA_HEAD_DIMS)
def test_shared_memory_fits_with_the_swizzle_slack(hd):
    """Two owned 128-row tiles, the ring's stages of two 64-row steps and
    their lse/D rows, the barriers, and 1 KB to align the base to the
    128-byte swizzle's 1,024-byte atom: within the 227 KB a block can
    use."""
    plan = kernel.flash_bwd_plan(8, 2048, 32, 8, hd, torch.bfloat16)
    row_bytes = hd * 2
    tiles = 2 * kernel.BWD_TILE * row_bytes
    stages = kernel.BWD_STAGES * (2 * kernel.BWD_STEP * row_bytes
                                  + 2 * kernel.BWD_STEP * 4)
    barriers = (2 * kernel.BWD_STAGES + 1) * 8
    assert plan["smem"] == tiles + stages + barriers + 1024
    assert plan["smem"] <= MAX_SMEM
    # every tile and stage starts on a 1,024-byte boundary
    assert tiles % 1024 == 0 and (2 * kernel.BWD_STEP * row_bytes) % 1024 == 0


@pytest.mark.parametrize("name", REGISTERED)
def test_registered_bf16_layouts_take_the_wgmma_route(name):
    nq, nkv, hd = LAYOUTS[name]
    for s in LENGTHS:
        plan = kernel.flash_bwd_plan(2, s, nq, nkv, hd, torch.bfloat16)
        assert plan["route"] == "wgmma"
        s_pad = plan["s_pad"]
        assert s_pad % kernel.BWD_TILE == 0 and s <= s_pad < s + 128
        assert plan["scratch"] == (2, 2, nq, s_pad)
        tiles = -(-s // kernel.BWD_TILE)
        assert plan["dkdv_blocks"] == tiles * nkv * 2
        assert plan["dq_blocks"] == tiles * nq * 2
        f32 = kernel.flash_bwd_plan(2, s, nq, nkv, hd, torch.float32)
        assert f32 == {"route": "cuda cores", "scratch": (2, nq, s)}


@pytest.mark.parametrize("hd", (16, 32))
def test_small_head_dims_and_f32_keep_their_kernels(hd):
    for dtype, route in ((torch.bfloat16, "mma.sync"),
                         (torch.float32, "cuda cores")):
        plan = kernel.flash_bwd_plan(2, 333, 4, 2, hd, dtype)
        assert plan == {"route": route, "scratch": (2, 4, 333)}
    for name in ARCHS:
        cfg = smoke_config(name)
        plan = kernel.flash_bwd_plan(2, 32, cfg.num_heads, cfg.num_kv_heads,
                                     cfg.head_dim, torch.bfloat16)
        assert plan["route"] == "mma.sync"


def _check_order(items, key_count):
    counts = [n for _, n in items]
    assert counts == sorted(counts, reverse=True), "not longest first"
    keys = [key for key, _ in items]
    assert len(set(keys)) == len(keys) == key_count, "an item twice or lost"
    return keys


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_dkdv_items_cover_every_kv_tile_once(name, s):
    """Every (kv tile, batch row, kv head) once, the tiles nearest
    position 0 first; an item's steps are the group's 64-row q tiles that
    hold a row below s and at or past the tile's first kv row."""
    nq, nkv, _ = LAYOUTS[name]
    b = 2
    tiles = -(-s // kernel.BWD_TILE)
    items = kernel.flash_bwd_items("dkdv", b, s, nq, nkv)
    keys = _check_order(items, tiles * nkv * b)
    assert set(keys) == {(t, bi, h) for t in range(tiles)
                         for bi in range(b) for h in range(nkv)}
    q_tiles = -(-s // kernel.BWD_STEP)
    for (jt, _, _), steps in items:
        k0 = jt * kernel.BWD_TILE
        needed = [it for it in range(q_tiles)
                  if it * kernel.BWD_STEP + kernel.BWD_STEP - 1 >= k0]
        assert steps == nq // nkv * len(needed) > 0


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_dq_items_cover_every_q_tile_once(name, s):
    """Every (q tile, batch row, q head) once, the last q tiles first and
    the q heads of one kv group side by side; an item's steps are the
    64-row kv tiles that hold a row below s and at or before its last q
    row."""
    nq, nkv, _ = LAYOUTS[name]
    b = 2
    group = nq // nkv
    tiles = -(-s // kernel.BWD_TILE)
    items = kernel.flash_bwd_items("dq", b, s, nq, nkv)
    keys = _check_order(items, tiles * nq * b)
    assert set(keys) == {(t, bi, h) for t in range(tiles)
                         for bi in range(b) for h in range(nq)}
    for i in range(0, len(keys), group):            # a kv group together
        run = keys[i:i + group]
        assert len({(t, bi, h // group) for t, bi, h in run}) == 1
    kv_tiles = -(-s // kernel.BWD_STEP)
    for (iq, _, _), steps in items:
        last = min(iq * kernel.BWD_TILE + kernel.BWD_TILE, s) - 1
        needed = [kt for kt in range(kv_tiles)
                  if kt * kernel.BWD_STEP <= last]
        assert steps == len(needed) > 0


def test_items_reject_an_unknown_kernel():
    with pytest.raises(ValueError):
        kernel.flash_bwd_items("dqkv", 1, 64, 4, 2)
