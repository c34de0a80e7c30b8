"""The shared-memory layout of the port's WKV6 backward (`wkv6_bwd_plan`
and `wkv6_bwd_scratch` in `repro_torch/kernels/wkv6/kernel.py`), which
repeats on the host what `csrc/wkv6_bwd.cu` computes for its state pass
and reverse pass: the constants and byte tables read from the source, the
fit in a block's shared memory at every chunk and head size, the banks
that the lanes of each mma fragment load reach at each tile's pitch, and
the scratch the wrapper hands the C entry. The kernels themselves are held
to the plain version on the card by chip_smoke.py (phase 31)."""
import inspect
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.checks import MAX_SMEM               # noqa: E402
from repro_torch.kernels.wkv6 import kernel                   # noqa: E402

CSRC = (Path(kernel.__file__).resolve().parents[2] / "csrc"
        / "wkv6_bwd.cu").read_text()
SIZES = [(c, k) for c in kernel.CHUNKS for k in kernel.HEAD_SIZES]
SM_SMEM = 233472               # shared memory of one SM, 228 KB
BLOCK_RESERVED = 1024          # what the runtime keeps of it for each block


def _struct(name, chunk, K):
    """The `static constexpr int` members of struct `name` in the source,
    evaluated in order at this chunk and head size."""
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", CSRC, re.S)
    env = {"CH": chunk, "K": K,
           "kStatesStages": kernel.BWD_STATE_STAGES}
    for member, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);",
                                   body.group(1)):
        env[member] = eval(expr, {}, env)           # noqa: S307 (own source)
    return env


def test_plan_constants_are_the_kernels():
    """The plan's block, ring depth and pitches are the source's."""
    consts = dict(re.findall(r"constexpr int (kThreads|kStatesStages) = "
                             r"(\d+);", CSRC))
    assert {k: int(v) for k, v in consts.items()} == {
        "kThreads": kernel.BWD_THREADS,
        "kStatesStages": kernel.BWD_STATE_STAGES}
    for chunk, K in SIZES:
        plan = kernel.wkv6_bwd_plan(chunk, K)
        bwd, st = _struct("Bwd", chunk, K), _struct("States", chunk, K)
        tiles = plan["reverse"]["tiles"]
        assert (tiles["r"]["pitch"], tiles["r_in"]["pitch"],
                tiles["att"]["pitch"], tiles["datt"]["pitch"]) == (
            bwd["PR"], bwd["PC"], bwd["PA"], bwd["PD"])
        assert {t["pitch"] for t in plan["states"]["tiles"].values()} == {
            st["P"]}


@pytest.mark.parametrize("chunk,K", SIZES)
def test_byte_tables_are_the_sources(chunk, K):
    """Every region's offset and the total, as the source's structs add
    them up; regions in order, back to back."""
    plan = kernel.wkv6_bwd_plan(chunk, K)
    bwd = _struct("Bwd", chunk, K)
    regions = plan["reverse"]["regions"]
    offsets = {"r": "kR", "k": "kK", "v": "kV", "la": "kLa", "do": "kDo",
               "S": "kS", "k_dec": "kKd", "r_in": "kRin", "dS": "kDS",
               "att": "kAtt", "datt": "kDatt", "vectors": "kVec",
               "barriers": "kBars"}
    assert {name: off for name, (off, _) in regions.items()} == {
        name: bwd[member] for name, member in offsets.items()}
    assert plan["reverse"]["smem"] == bwd["kBytes"]
    st = _struct("States", chunk, K)
    st_regions = plan["states"]["regions"]
    assert (st_regions["e_last"][0], st_regions["barriers"][0],
            plan["states"]["smem"]) == (st["kLast"], st["kBars"],
                                         st["kBytes"])
    for plan_regions, total in ((regions, plan["reverse"]["smem"]),
                                (st_regions, plan["states"]["smem"])):
        spans = sorted(plan_regions.values())
        assert spans[0][0] == 0
        assert all(a + n == b for (a, n), (b, _) in zip(spans, spans[1:]))
        assert spans[-1][0] + spans[-1][1] == total


@pytest.mark.parametrize("chunk,K", SIZES)
def test_shared_memory_fits(chunk, K):
    """The reverse pass within the 227 KB a block can use; the state pass
    twice in one SM, as its launch bounds ask; every tile TMA writes on a
    128-byte boundary and the barriers on 8."""
    plan = kernel.wkv6_bwd_plan(chunk, K)
    assert plan["reverse"]["smem"] <= MAX_SMEM
    st = plan["states"]
    assert st["blocks_per_sm"] * (st["smem"] + BLOCK_RESERVED) <= SM_SMEM
    tma = ("r", "k", "v", "la", "do", "S")
    regions = plan["reverse"]["regions"]
    assert all(regions[name][0] % 128 == 0 for name in tma)
    assert regions["barriers"][0] % 8 == 0
    assert st["regions"]["stages"][1] % (3 * st["stages"] * 128) == 0
    assert st["regions"]["barriers"][0] % 8 == 0


def _fragment_offsets(form, pitch):
    """Word offsets of the elements that the 32 lanes (lane = 4 g + t) read
    in one load of an m16n8k8 TF32 fragment, for each register: the A
    fragment of a row-major tile (ld_a) or of the transpose of one
    (ld_at), a B fragment of a tile stored n-major (ld_b_nk) or k-major
    (ld_b_kn)."""
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    regs = {"ld_a": [(0, 0), (8, 0), (0, 4), (8, 4)],   # (row, col) offsets
            "ld_b_nk": [(0, 0), (0, 4)],
            "ld_at": [(0, 0), (0, 8), (4, 0), (4, 8)],
            "ld_b_kn": [(0, 0), (4, 0)]}[form]
    along_rows = form in ("ld_a", "ld_b_nk")
    out = []
    for dr, dc in regs:
        out.append([((g if along_rows else t) + dr) * pitch
                    + (t if along_rows else g) + dc for g, t in lanes])
    return out


def _worst_conflict(form, pitch):
    """The most lanes of one load that land in one bank (4-byte words, 32
    banks), over the loads of a fragment."""
    return max(max([off % 32 for off in reg].count(bank)
                   for bank in range(32))
               for reg in _fragment_offsets(form, pitch))


@pytest.mark.parametrize("chunk,K", SIZES)
def test_fragment_loads_reach_32_banks(chunk, K):
    """Each tile's first read direction puts the 32 lanes of every A and B
    fragment load on 32 distinct banks; a tile also read the other way
    pays at most two-way conflicts there, as the source note says."""
    plan = kernel.wkv6_bwd_plan(chunk, K)
    forms = {"rows": ("ld_a", "ld_b_nk"), "cols": ("ld_at", "ld_b_kn")}
    for kernel_plan in (plan["reverse"], plan["states"]):
        for name, tile in kernel_plan["tiles"].items():
            for i, direction in enumerate(tile["reads"]):
                worst = max(_worst_conflict(form, tile["pitch"])
                            for form in forms[direction])
                assert worst == (1 if i == 0 else 2), (name, direction)
    read_twice = {name for name, t in plan["reverse"]["tiles"].items()
                  if len(t["reads"]) == 2}
    assert read_twice == {"r", "k", "do", "dS", "datt"}
    note = re.search(r"Five tiles\s+// are read both ways(.*?)\n//\n",
                     CSRC, re.S)
    assert note and all(name in note.group(1).replace("//", "")
                        for name in ("r_f", "k_f", "do", "datt", "dS"))


def test_scratch_is_what_the_entry_expects():
    """The wrapper allocates its scratch from `wkv6_bwd_scratch`, whose
    shapes are the C entry's: each (batch row, head) owns ceil(s / chunk)
    states of K x K f32 that the state pass writes at (bi·H + h)·n_chunks
    and the reverse pass reads through a (K, K, n_chunks, b·H) tensor map,
    and one du slot of K."""
    assert kernel.wkv6_bwd_scratch(8, 2048, 48, 64, 64) == dict(
        states=(8, 48, 32, 64, 64), du_part=(8, 48, 64))
    assert kernel.wkv6_bwd_scratch(2, 100, 3, 16, 64) == dict(
        states=(2, 3, 2, 16, 16), du_part=(2, 3, 16))
    assert kernel.wkv6_bwd_scratch(1, 1, 1, 32, 16)["states"] == (
        1, 1, 1, 32, 32)
    assert "wkv6_bwd_scratch(b, s, H, K, chunk)" in inspect.getsource(
        kernel.wkv6_bwd)
    assert "static_cast<int64_t>(bi * H + h) * n_chunks * K * K" in CSRC
    assert "{kk, kk, static_cast<cuuint64_t>(n_chunks)," in CSRC
    assert "du_part[static_cast<int64_t>(bh) * K + tid]" in CSRC
    assert "`states` is f32 scratch of b·H·ceil(s / chunk)·K·K" in CSRC


@pytest.mark.parametrize("chunk,K", [(8, 64), (64, 128), (48, 32)])
def test_plan_rejects_sizes_without_a_kernel(chunk, K):
    with pytest.raises(ValueError):
        kernel.wkv6_bwd_plan(chunk, K)
