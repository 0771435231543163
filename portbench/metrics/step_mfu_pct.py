"""The device step's share of the card's peak: the model's operations in
its dense form (the configuration's reference module's ``layer_flops``,
at C subgraphs of N vertices, every layer) for each batch launched from
the window's first launch to its last, over the seconds a kernel ran on
the card in that span times the H100's dense TF32 rate. The same count
whatever mode or kernel runs the step; it bounds the kernels' rooflines on
the same end-to-end metric, ``kernel_us_per_target``."""
import importlib

from portbench.peaks import TF32_FLOP_S


def batch_flops(cfg):
    model = importlib.import_module(
        f"portbench.reference.{cfg['reference']}")
    c, n, f = cfg["batch_size"], cfg["receptive_field"], cfg["f_hidden"]
    return sum(model.layer_flops(cfg, c, n, cfg["f_in"] if i == 0 else f, f)
               for i in range(cfg["n_layers"]))


def read(rec):
    t = rec.trace
    span = t.launch_span() if t is not None and t.ops else None
    if span is None:
        return None
    a, b, k = span
    busy = t.kernels().busy_s_between(a, b)
    if busy <= 0:
        return None
    return 100.0 * k * batch_flops(rec.cfg) / (busy * TF32_FLOP_S)
