"""Feed-forward blocks: SwiGLU (llama family) and the plain GELU MLP
(whisper), the PyTorch counterpart of ``repro.models.mlp``."""
from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, dense_init, matmul, shard


def init_mlp(gen, n_layers, d_model, d_ff, act="silu",
             dtype=torch.float32):
    """The FFN weights of ``n_layers`` layers, stacked on a leading axis and
    drawn at once: SwiGLU's gate/up/down for ``act="silu"``, else the plain
    two-layer MLP's w_in/b_in/w_out/b_out (zero biases)."""
    L = n_layers
    if act == "silu":
        return {"w_gate": dense_init(gen, (L, d_model, d_ff), dtype),
                "w_up": dense_init(gen, (L, d_model, d_ff), dtype),
                "w_down": dense_init(gen, (L, d_ff, d_model), dtype)}
    zeros = lambda *s: torch.zeros(s, dtype=dtype,  # noqa: E731
                                   device=gen.device)
    return {"w_in": dense_init(gen, (L, d_model, d_ff), dtype),
            "b_in": zeros(L, d_ff),
            "w_out": dense_init(gen, (L, d_ff, d_model), dtype),
            "b_out": zeros(L, d_model)}


def mlp(params, x, act="silu"):
    f = act_fn(act)
    axes = ("batch",) + (None,) * (x.ndim - 2) + ("ff",)
    if "w_gate" in params:
        h = f(matmul(x, params["w_gate"])) * matmul(x, params["w_up"])
        h = shard(h, axes)
        return matmul(h, params["w_down"])
    h = f(matmul(x, params["w_in"]) + params["b_in"])
    h = shard(h, axes)
    return matmul(h, params["w_out"]) + params["b_out"]
