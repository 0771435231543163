"""A numpy model of ``gat_attention``'s slab kernel (csrc/gat_attention.cu),
shared by ``test_torch_gat.py`` (the plain form against the oracle) and
``test_torch_gat_fused.py`` (the fused form against the plain composition).

``slab_model``: per (subgraph, head, slice of at most 64 columns) the
structure as a bitmap, each row's structural columns as a list in ascending
j, the max over the list seeded at -1e30 where the list is shorter than N,
exp, one reciprocal of the clamped sum, the weighted sum over the list with
zero weights included (even and odd entries summed apart, then added, as
the two half-warps do), and NaN in the columns where a z row outside the
row's structure is not finite.

``layer_model``: the fused form around it: each head's score terms as fp32
dot products of its slab rows with a_src[h] and a_dst[h], the structure
``(sign(adj) + I) * mask[j] > 0`` with sign(NaN) = 0, ``slab_model``'s
list walk, then ``act(acc + b) * mask[i]``. ``LAYER_FAULTS`` plants one
fault each in what the fused form adds.
"""
import numpy as np

SLOPE = 0.2

FAULTS = ("skip weight 0", "no NaN from rows outside", "drop last entry",
          "max seeded at -inf")


def slab_model(z, s_src, s_dst, struct, heads, fault=None):
    """The slab kernel's arithmetic in numpy float32 (see the docstring)."""
    C, N, F = z.shape
    fh = F // heads
    f32 = np.float32
    out = np.zeros((C, N, F), f32)
    for c in range(C):
        bits = struct[c] > 0
        for hh in range(heads):
            for s0 in range(0, fh, 64):
                cols = slice(hh * fh + s0, hh * fh + min(fh, s0 + 64))
                slab = z[c, :, cols]
                bad = ~np.isfinite(slab)
                for i in range(N):
                    lst = np.nonzero(bits[i])[0]          # ascending j
                    acc = np.zeros(slab.shape[1], f32)
                    if len(lst):
                        e = s_dst[c, i, hh] + s_src[c, lst, hh]
                        e = np.where(e >= 0, e, f32(SLOPE) * e)
                        m = np.fmax.reduce(e)             # as fmaxf
                        if len(lst) < N and fault != "max seeded at -inf":
                            m = np.fmax(m, f32(-1e30))
                        x = np.exp(e - m)
                        inv = f32(1) / np.maximum(x.sum(dtype=f32),
                                                  f32(1e-20))
                        w = x * inv
                        if fault == "drop last entry":
                            lst, w = lst[:-1], w[:-1]
                        if fault == "skip weight 0":
                            lst, w = lst[w != 0], w[w != 0]
                        halves = [np.zeros_like(acc), np.zeros_like(acc)]
                        for k, (j, wk) in enumerate(zip(lst, w)):
                            halves[k % 2] = halves[k % 2] + wk * slab[j]
                        acc = halves[0] + halves[1]
                    if fault != "no NaN from rows outside":
                        acc[bad[~bits[i]].any(0)] = np.nan
                    out[c, i, cols] = acc
    return out


LAYER_FAULTS = ("scores from the wrong head", "no diagonal",
                "row mask skipped", "bias after the ELU")


def layer_model(z, a_src, a_dst, adj, mask, b, heads, act="elu",
                fault=None):
    """The fused form's arithmetic in numpy float32 (see the docstring)."""
    C, N, F = z.shape
    fh = F // heads
    f32 = np.float32
    z4 = z.reshape(C, N, heads, fh)
    wrong = fault == "scores from the wrong head"
    s_src = np.zeros((C, N, heads), f32)
    s_dst = np.zeros((C, N, heads), f32)
    for h in range(heads):
        k = (h + 1) % heads if wrong else h
        s_src[..., h] = (z4[:, :, h] * a_src[k]).sum(-1, dtype=f32)
        s_dst[..., h] = (z4[:, :, h] * a_dst[k]).sum(-1, dtype=f32)
    sign = (adj > 0).astype(f32) - (adj < 0).astype(f32)
    eye = np.zeros((N, N), f32) if fault == "no diagonal" \
        else np.eye(N, dtype=f32)
    struct = (sign + eye) * mask[:, None, :]
    acc = slab_model(z, s_src, s_dst, struct, heads)
    fn = {"none": lambda x: x,
          "relu": lambda x: np.where((x > 0) | np.isnan(x), x, f32(0)),
          "elu": lambda x: np.where(x > 0, x, np.expm1(x))}[act]
    if b is None:
        out = fn(acc)
    elif fault == "bias after the ELU":
        out = fn(acc) + b
    else:
        out = fn(acc + b)
    if fault != "row mask skipped":
        out = out * mask[..., None]
    return out.astype(f32)
