"""Kernel entry points, as the reference's ``repro.kernels.ops``.

Each wrapper launches its CUDA kernel for CUDA tensors and takes its plain
version for CPU tensors; ``impl="torch"`` programs call the plain versions
(``kernels.ref``) directly. ``launch_counts`` / ``reset_launch_counts``
read and zero the wrappers' launch counters (``flash_attention`` also
counts each of its two kernels: ``flash_attention.variant_launches``; the
fused layer its launches by kernel, Fin and form, ``form_launches``; the
scatter-gather also its sort kernel's widths, ``width_launches``, its
launches by named caller, ``caller_launches``, and by shape,
``shape_launches``; the GAT kernel its fused
form's launches, ``fused_launches``, and the attention steps that ran
unfused on the card, ``fused_fallbacks``).
"""
from __future__ import annotations

from repro_torch.kernels import fused_gnn, gat_attention as _gat
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import scatter_gather
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.fused_gnn import fused_gnn_layer  # noqa: F401
from repro_torch.kernels.gat_attention import (  # noqa: F401
    gat_attention, gat_attention_layer)
from repro_torch.kernels.scatter_gather import \
    scatter_gather_aggregate  # noqa: F401

KERNEL_MODULES = {"fused_gnn_layer": fused_gnn,
                  "scatter_gather_aggregate": scatter_gather,
                  "gat_attention": _gat,
                  "flash_attention": _flash}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {k: m.launches for k, m in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for m in KERNEL_MODULES.values():
        with m._count_lock:
            m.launches = 0
            if hasattr(m, "variant_launches"):
                m.variant_launches = dict.fromkeys(m.variant_launches, 0)
            if hasattr(m, "form_launches"):
                m.form_launches = {}
            if hasattr(m, "width_launches"):
                m.width_launches = dict.fromkeys(m.width_launches, 0)
            if hasattr(m, "caller_launches"):
                m.caller_launches = {}
            if hasattr(m, "shape_launches"):
                m.shape_launches = {}
            if hasattr(m, "fused_launches"):
                m.fused_launches = m.fused_fallbacks = 0
