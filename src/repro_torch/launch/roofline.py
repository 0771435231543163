"""Roofline analysis of the dry-run records, the counterpart of
``repro.launch.roofline``: three terms per (arch x shape x mesh) cell, the
dominant bottleneck, and the MODEL_FLOPS / counted-FLOPs usefulness ratio.

    compute    = sum over types of FLOPs_per_device[type] / peak[type]
    memory     = bytes_per_device / HBM rate
    collective = sum over groups of link_bytes[group] / link rate

The per-device terms come from ``launch.op_analysis``. The card is one
NVIDIA H100 SXM at its published dense peaks (``core.dse.H100Spec``): 989
TFLOP/s for bf16 products on the tensor cores, 67 TFLOP/s for fp32
products outside them (TF32 off, as torch's matmul default), one third of
the tf32 rate for the fused GNN kernel's three-product fp32 split, 3.35
TB/s of HBM; 450 GB/s a direction of NVLink within a group of at most 8
cards, 50 GB/s (one 400 Gb/s port) for a group that leaves the node.
"fits" means the cell's estimated peak is within the card's 80 GB.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline \\
           --dryrun-dir build/dryrun_torch [--fmt md|json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.dse import H100Spec

SPEC = H100Spec()
PEAKS = {"bfloat16": SPEC.peak_bf16, "float16": SPEC.peak_bf16,
         "float32": SPEC.peak_fp32, "tf32x3": SPEC.peak_tf32 / 3}
NVLINK_GROUP = 8            # cards a node joins by NVLink


def compute_s(flops_by_dtype: Dict[str, float]) -> float:
    """Seconds of the products at each type's peak (fp32's for a type
    without one of its own)."""
    return sum(f / PEAKS.get(dt, SPEC.peak_fp32)
               for dt, f in flops_by_dtype.items())


def collective_s(link_bytes_by_group: Dict[str, float]) -> float:
    return sum(b / (SPEC.nvlink_bw if int(g) <= NVLINK_GROUP
                    else SPEC.net_bw)
               for g, b in link_bytes_by_group.items())


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS


def _param_counts(arch: str) -> Dict[str, float]:
    """(total, active, embedding) parameter counts from the ``meta`` tree
    (no memory)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    tree = init_params(cfg, device="meta", max_seq=4096)
    total = active = embed = 0.0
    moe = cfg.moe

    def walk(t, keys):
        nonlocal total, active, embed
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, keys + (k,))
            return
        n = float(t.numel())
        total += n
        if any(k in ("embed", "lm_head", "pos_emb", "enc_pos_emb")
               for k in keys):
            embed += n
            return
        is_routed = (moe is not None and "ffn" in keys
                     and any(k in ("w_gate", "w_up", "w_down")
                             for k in keys)
                     and t.dim() >= 3
                     and moe.num_experts in tuple(t.shape))
        active += n * (moe.top_k / moe.num_experts) if is_routed else n

    walk(tree, ())
    return {"total": total, "active": active, "embed": embed,
            "nonembed": total - embed, "active_nonembed": active - 0.0}


def model_flops(arch: str, shape_kind: str, tokens: float) -> float:
    """6*N*D train / 2*N*D forward-only, N = active non-embedding params."""
    counts = _param_counts(arch)
    n = counts["active"] - 0.0
    n_nonembed = n - counts["embed"] if n > counts["embed"] else n
    factor = 6.0 if shape_kind == "train" else 2.0
    return factor * n_nonembed * tokens


SHAPE_TOKENS = {"train_4k": 4096 * 256, "prefill_32k": 32768 * 32,
                "decode_32k": 128.0, "long_500k": 1.0}
SHAPE_KIND = {"train_4k": "train", "prefill_32k": "prefill",
              "decode_32k": "decode", "long_500k": "decode"}


# ---------------------------------------------------------------------------


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: Optional[float]
    hlo_flops_global: float
    useful_ratio: Optional[float]
    fit: bool
    hint: str
    n_devices: int = 1

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """compute-term share of the binding constraint: 1.0 = compute
        bound at peak; lower = dominated by memory/collective."""
        return self.t_compute / self.t_bound if self.t_bound else 0.0


_HINTS = {
    "compute": "at compute roof — reduce recompute (remat policy) or keep"
               " the products on the tensor cores (bf16, hand kernels)",
    "memory": "HBM-bound — increase arithmetic intensity: fuse attention"
              " (flash), keep activations bf16, fuse the elementwise"
              " chains, raise the per-step batch a card",
    "collective": "link-bound — reshard to cut all-gathers (kv-head"
                  " replication, expert-parallel all-to-all), keep groups"
                  " inside the NVLink node, overlap collectives with"
                  " compute",
}


def terms(h: dict):
    """(compute, memory, collective) seconds of one op summary."""
    by_dt = h.get("flops_by_dtype") or {"float32": h["flops"]}
    by_group = h.get("link_bytes_by_group") or {}
    return (compute_s(by_dt), h["hbm_bytes"] / SPEC.hbm_bw,
            collective_s(by_group))


def row_from_record(rec: dict) -> Optional[RooflineRow]:
    if not rec.get("ok"):
        return None
    rec = dict(rec, shape=rec["shape"].replace(".opt", "+opt"))
    h = rec["hlo"]
    ndev = rec["n_devices"]
    t_c, t_m, t_l = terms(h)
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_l),
              key=lambda kv: kv[1])[0]
    mf = None
    ratio = None
    base_shape = rec["shape"].replace("+opt", "")
    if (base_shape in SHAPE_TOKENS and not rec.get("reduced")
            and not rec["arch"].startswith(("gcn", "sage", "gat", "gin"))):
        mf = model_flops(rec["arch"], SHAPE_KIND[base_shape],
                         SHAPE_TOKENS[base_shape])
        ratio = mf / (h["flops"] * ndev) if h["flops"] else None
    peak = rec["memory"]["peak_bytes_est"]
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        t_compute=t_c, t_memory=t_m, t_collective=t_l, dominant=dom,
        model_flops=mf, hlo_flops_global=h["flops"] * ndev,
        useful_ratio=ratio, fit=peak <= SPEC.hbm_bytes, hint=_HINTS[dom],
        n_devices=ndev)


def load_rows(dryrun_dir: str):
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        r = row_from_record(rec)
        if r:
            rows.append(r)
    return rows


def _fmt_t(t: float) -> str:
    if t >= 1:
        return f"{t:.2f}s"
    if t >= 1e-3:
        return f"{t*1e3:.2f}ms"
    return f"{t*1e6:.1f}us"


SHARDED_NOTE = (
    "* sharded: per-card terms follow the port's placement rules "
    "(models/common.py). The reduced cells on a 2x4 mesh match the "
    "reference's HLO FLOPs (v3 decode 1.07x), link bytes only for the "
    "dense archs with even head splits. Unvalidated where a dim splits "
    "unevenly over an axis (phi3: 40 heads on 16) and for link bytes "
    "elsewhere.")


def render_md(rows) -> str:
    out = ["| arch | shape | mesh | compute | memory | collective | "
           "bound | useful FLOPs | fits 80G |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        ur = f"{r.useful_ratio:.2f}" if r.useful_ratio else "—"
        mesh = r.mesh + ("*" if r.n_devices > 1 else "")
        out.append(
            f"| {r.arch} | {r.shape} | {mesh} | {_fmt_t(r.t_compute)} | "
            f"{_fmt_t(r.t_memory)} | {_fmt_t(r.t_collective)} | "
            f"{r.dominant} | {ur} | {'y' if r.fit else 'NO'} |")
    bounds = {}
    for r in rows:
        bounds[r.dominant] = bounds.get(r.dominant, 0) + 1
    fits = sum(1 for r in rows if r.fit)
    fracs = sorted(r.roofline_fraction for r in rows) or [0.0]
    out.append("")
    out.append(f"cells: {len(rows)}; fits 80G: {fits}; bound mix: "
               + ", ".join(f"{k}={v}" for k, v in sorted(bounds.items()))
               + f"; roofline fraction median {fracs[len(fracs)//2]:.3f}, "
                 f"best {fracs[-1]:.3f}")
    if any(r.n_devices > 1 for r in rows):
        out.append(SHARDED_NOTE)
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="build/dryrun_torch")
    ap.add_argument("--fmt", default="md", choices=["md", "json"])
    args = ap.parse_args(argv)
    rows = load_rows(args.dryrun_dir)
    if args.fmt == "md":
        print(render_md(rows))
    else:
        print(json.dumps([dict(r.__dict__, t_bound=r.t_bound)
                          for r in rows], indent=1))


if __name__ == "__main__":
    main()
