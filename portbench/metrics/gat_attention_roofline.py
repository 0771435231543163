"""``gat_attention`` (kernels/gat_attention.py) against its roofline: the
bound of one launch at the cell's shapes over the launches' mean time on
the card (profiler trace).

One call: z [C, N, F], s_src and s_dst [C, N, heads], the structure
[C, N, N] in, out [C, N, F]. Its products (the weighted sum, 2 C N^2 F)
at the TF32 peak, its elementwise work (8 a (head, i, j): add, LeakyReLU,
mask, max, subtract, exp, sum, scale) at the fp32 peak, its bytes at HBM
bandwidth; the bound is the largest of the three."""
from portbench.peaks import FP32_FLOP_S, HBM_BYTES_S, TF32_FLOP_S

KERNEL = r"gat_slab_kernel|gat_row_kernel"


def work(c, n, f, heads, elem=4):
    """(products, elementwise operations, bytes) of one call."""
    prod = 2.0 * c * n * n * f
    ew = 8.0 * c * heads * n * n
    byts = (2 * c * n * f + 2 * c * n * heads) * elem + c * n * n * 4
    return prod, ew, byts


def bound_s(c, n, f, heads):
    prod, ew, byts = work(c, n, f, heads)
    return max(prod / TF32_FLOP_S, ew / FP32_FLOP_S, byts / HBM_BYTES_S)


def read(rec):
    if rec.trace is None:
        return None
    count, seconds = rec.trace.by_name(KERNEL)
    if not count:
        return None
    cfg = rec.cfg
    b = bound_s(cfg["batch_size"], cfg["receptive_field"], cfg["f_hidden"],
                cfg["n_heads"])
    return 100.0 * b / (seconds / count)
