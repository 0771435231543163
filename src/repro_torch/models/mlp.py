"""Feed-forward block: SwiGLU (llama family), the PyTorch counterpart of
``repro.models.mlp``. The plain GELU MLP (whisper) comes with the audio
family (ROADMAP.md queue 1, item 14.5)."""
from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, dense_init, matmul


def init_mlp(gen, n_layers, d_model, d_ff, act="silu",
             dtype=torch.float32):
    """SwiGLU gate/up/down weights of ``n_layers`` layers, stacked on a
    leading axis and drawn at once."""
    if act != "silu":
        raise NotImplementedError(
            f"act={act!r}: the plain MLP is not ported yet (ROADMAP.md "
            f"queue 1, item 14.5: audio)")
    return {"w_gate": dense_init(gen, (n_layers, d_model, d_ff), dtype),
            "w_up": dense_init(gen, (n_layers, d_model, d_ff), dtype),
            "w_down": dense_init(gen, (n_layers, d_ff, d_model), dtype)}


def mlp(params, x, act="silu"):
    if "w_gate" not in params:
        raise NotImplementedError(
            "the plain MLP (w_in/w_out) is not ported yet (ROADMAP.md "
            "queue 1, item 14.5: audio)")
    f = act_fn(act)
    h = f(matmul(x, params["w_gate"])) * matmul(x, params["w_up"])
    return matmul(h, params["w_down"])
