"""``fused_gnn_layer`` (kernels/fused_gnn.py) against its roofline: the
mean bound of the window's launches over their mean time on the card.

A launch's bound is the larger of its products over the TF32 peak and its
bytes over HBM bandwidth, for the function's own work at its call's
shapes (C subgraphs, N vertices, the call's Fin, Fout = f_hidden):
    out = act(A (H W_neigh) + H W_self + b) * mask,
each product counted once, inputs read once, the output written once.
The calls' shapes come from the program's ``form_launches`` counter
((kernel, Fin, form) -> launches); the time from the profiler's trace."""
from portbench.peaks import HBM_BYTES_S, TF32_FLOP_S

KERNEL = r"fused_tf32x3_kernel|fused_bf16_kernel|gemm_epilogue_kernel"


def work(c, n, f_in, f_out, form, elem=4):
    """(operations, bytes) of one call; form is "w_neigh" (A and one
    weight), "+w_self" (A and two) or "self-only" (one weight, no A)."""
    neigh = form != "self-only"
    weights = 2 if form == "+w_self" else 1
    ops = 2.0 * c * n * f_in * f_out * weights
    byts = (c * n * f_in + weights * f_in * f_out + f_out + c * n
            + c * n * f_out) * elem
    if neigh:
        ops += 2.0 * c * n * n * f_out
        byts += c * n * n * 4
    return ops, byts


def bound_s(c, n, f_in, f_out, form):
    ops, byts = work(c, n, f_in, f_out, form)
    return max(ops / TF32_FLOP_S, byts / HBM_BYTES_S)


def read(rec):
    if rec.trace is None:
        return None
    count, seconds = rec.trace.by_name(KERNEL)
    b, a = rec.before["fused_forms"], rec.after["fused_forms"]
    calls = {k: v - b.get(k, 0) for k, v in a.items() if v - b.get(k, 0)}
    if not count or not calls:
        return None
    c, n, f = (rec.cfg["batch_size"], rec.cfg["receptive_field"],
               rec.cfg["f_hidden"])
    total = sum(calls.values())
    mean_bound = sum(k_n * bound_s(c, n, fin, f, form)
                     for (_, fin, form), k_n in calls.items()) / total
    return 100.0 * mean_bound / (seconds / count)
