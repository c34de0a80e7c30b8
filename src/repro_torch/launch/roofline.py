"""Roofline report from the dry run's records, the counterpart of
`repro/launch/roofline.py` with its names: reads results/dryrun/*.json
(`launch/dryrun.py`) and gives the three-term roofline of each
(arch × shape) on the single-pod mesh, with H100 constants:

  compute_s    = corrected_flops_per_device / PEAK_FLOPS
  memory_s     = corrected_bytes_per_device / HBM_BW
  collective_s = corrected_collective_bytes_per_device / ICI_BW

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE), D = tokens per step
(train) / batch (decode). The MODEL/count ratio flags remat and the
dispatch's waste. Every number is a prediction from counts and data-sheet
constants, not a measurement.

  PEAK_FLOPS  989 TFLOP/s, dense bf16 on the tensor cores, and
  HBM_BW      3.35 TB/s, HBM3: the H100 SXM data sheet.
  ICI_BW      50 GB/s: the rate at which one GPU sends to another across
              nodes. A (16, 16) mesh of H100s spans 32 nodes of 8 GPUs,
              so every "model" group of 16 crosses a node boundary; a
              DGX H100 gives each GPU one 400 Gb/s NDR InfiniBand link
              (the DGX H100 data sheet: eight ConnectX-7 ports), 50 GB/s
              each way. NVLink inside a node (450 GB/s each way) is not
              the bound of a group that spans two nodes.

  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir results/dryrun] [--md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional

PEAK_FLOPS = 989e12     # bf16 dense, H100 SXM data sheet
HBM_BW = 3.35e12        # B/s, HBM3, H100 SXM data sheet
ICI_BW = 50e9           # B/s: one 400 Gb/s NDR link a GPU across nodes

# non-embedding parameter counts (computed analytically from the configs)
def param_counts():
    from repro_torch.configs import ARCHS
    out = {}
    for name, cfg in ARCHS.items():
        d, ff, L = cfg.d_model, cfg.d_ff, cfg.num_layers
        nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        attn = d * nq * hd * 2 + d * nkv * hd * 2
        dense_mlp = 3 * d * ff
        if cfg.family == "ssm":
            H = cfg.rwkv_num_heads
            tm = 5 * d * d + d * 64 + 64 * d   # r/k/v/g/o + decay lora
            cm = d * ff + ff * d + d * d
            total = L * (tm + cm)
            active = total
        elif cfg.family == "hybrid":
            di = cfg.mamba_d_inner
            mamba_p = d * 2 * di + di * (cfg.dt_rank + 2 * cfg.mamba_d_state) \
                + cfg.dt_rank * di + di * d
            n_attn = L // cfg.attn_every
            n_mamba = L - n_attn
            n_moe = L // cfg.moe_every
            n_dense = L - n_moe
            total = n_attn * attn + n_mamba * mamba_p \
                + n_moe * cfg.num_experts * dense_mlp + n_dense * dense_mlp
            active = n_attn * attn + n_mamba * mamba_p \
                + n_moe * cfg.num_experts_per_tok * dense_mlp + n_dense * dense_mlp
        elif cfg.family == "moe":
            total = L * (attn + cfg.num_experts * dense_mlp
                         + cfg.num_shared_experts * dense_mlp)
            active = L * (attn + cfg.num_experts_per_tok * dense_mlp
                          + cfg.num_shared_experts * dense_mlp)
        elif cfg.family == "audio":
            enc = cfg.num_encoder_layers * (attn + 2 * d * ff)
            dec = L * (2 * attn + 2 * d * ff)
            total = active = enc + dec
        else:
            total = active = L * (attn + dense_mlp)
        out[name] = (total, active)
    return out


def model_flops(arch: str, meta: Dict, counts) -> Optional[float]:
    if arch not in counts:
        return None
    total, active = counts[arch]
    kind = meta.get("kind")
    if kind == "train":
        tokens = meta["seq_len"] * meta["global_batch"]
        return 6.0 * active * tokens
    if kind == "prefill":
        tokens = meta["seq_len"] * meta["global_batch"]
        return 2.0 * active * tokens
    if kind == "decode":
        return 2.0 * active * meta["global_batch"]
    return None


def load_cells(dir_: str):
    cells = []
    for fn in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(fn) as f:
            cells.append(json.load(f))
    return cells


def hazy_rows(cell, num_chips=256, cap_frac=1 / 64):
    """hazy-view cells: one row per maintenance step.

    The reference's analytic per-row traffic (2d/16 feature bytes of
    bf16, eps and a label a row; the banded step over its `cap_frac`
    window, the reorganize reading and writing each row) is memory_s, as
    the reference reports it; the count's own bytes stay in memory_s_hlo
    (the port's eager traffic, not HLO's)."""
    n, d = cell["meta"]["entities"], cell["meta"]["feature_dim"]
    # rows shard over data (16); every model shard holds all its data-shard's
    # rows but only d/16 feature columns
    rows_per_device = n / 16
    row_bytes = 2 * d / 16 + 5  # bf16 feature slice + eps + label
    out = []
    for step in cell["steps"]:
        flops = step["flops_per_device"]
        bts = step["bytes_per_device"]
        coll = step["collectives"].get("total", 0)
        name = step["step"]
        if "banded" in name:
            analytic = min(bts, rows_per_device * cap_frac * row_bytes)
        elif "reorg" in name:
            analytic = rows_per_device * (2 * row_bytes + 8)  # read+write+keys
        else:  # naive: full scan
            analytic = rows_per_device * row_bytes
        compute_s = flops / PEAK_FLOPS
        memory_s = analytic / HBM_BW
        coll_s = coll / ICI_BW
        dominant = max(("compute", compute_s), ("memory", memory_s),
                       ("collective", coll_s), key=lambda kv: kv[1])[0]
        out.append({
            "arch": "hazy-view", "shape": cell["shape"], "step": name,
            "compute_s": compute_s, "memory_s": memory_s,
            "memory_s_hlo": bts / HBM_BW,
            "collective_s": coll_s, "dominant": dominant,
            "model_hlo_ratio": (2.0 * n * d / num_chips) / flops if flops else None,
            "roofline_frac": None,
            "temp_GiB": step["memory"]["temp_bytes"] / 2**30,
            "corrected": False,
        })
    return out


def roofline_row(cell, counts, num_chips=256):
    step = cell["steps"][0]
    corr = step.get("loop_corrected", {}).get("corrected")
    flops = corr["flops"] if corr else step["flops_per_device"]
    bts = corr["bytes"] if corr else step["bytes_per_device"]
    coll = corr["coll"] if corr else step["collectives"].get("total", 0)
    compute_s = flops / PEAK_FLOPS
    memory_s = bts / HBM_BW
    coll_s = coll / ICI_BW
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", coll_s), key=lambda kv: kv[1])[0]
    mf = model_flops(cell["arch"], cell.get("meta", {}), counts)
    ratio = (mf / num_chips) / flops if (mf and flops) else None
    # roofline fraction: useful model flops per second at the bottleneck,
    # relative to peak — i.e. (model_flops/chips / bottleneck_time) / peak
    bottleneck_s = max(compute_s, memory_s, coll_s)
    frac = ((mf / num_chips) / bottleneck_s / PEAK_FLOPS) if (mf and bottleneck_s) else None
    return {
        "arch": cell["arch"], "shape": cell["shape"], "step": step["step"],
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "dominant": dominant, "model_hlo_ratio": ratio,
        "roofline_frac": frac,
        "temp_GiB": step["memory"]["temp_bytes"] / 2**30,
        "corrected": bool(corr),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    counts = param_counts()
    rows = []
    for cell in load_cells(args.dir):
        if cell["mesh"] != "pod16x16":
            continue
        if cell["arch"] == "hazy-view":
            rows.extend(hazy_rows(cell))
        else:
            rows.append(roofline_row(cell, counts))
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    if args.md:
        print("| arch | shape | step | compute_s | memory_s | collective_s |"
              " dominant | MODEL/HLO | roofline | temp GiB |")
        print("|---|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            mh = f"{r['model_hlo_ratio']:.2f}" if r["model_hlo_ratio"] else "-"
            rf = f"{r['roofline_frac']*100:.1f}%" if r["roofline_frac"] else "-"
            print(f"| {r['arch']} | {r['shape']} | {r['step']} | "
                  f"{r['compute_s']:.4f} | {r['memory_s']:.4f} | "
                  f"{r['collective_s']:.4f} | {r['dominant']} | {mh} | {rf} | "
                  f"{r['temp_GiB']:.1f} |")
    else:
        for r in rows:
            print(json.dumps(r))


if __name__ == "__main__":
    main()
