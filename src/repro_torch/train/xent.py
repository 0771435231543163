"""Cross-entropy over logits, the PyTorch counterpart of
``repro.train.xent``."""
from __future__ import annotations

import torch


def _pick(lg, labels):
    """lg[..., label]: a ``gather``, or for a DTensor (whose gather over a
    sharded vocab fails in DTensor's mask buffer) the sum of lg where the
    vocab index is the label, 0 elsewhere: one term, the same value."""
    from repro_torch.models.common import is_dtensor
    if not is_dtensor(lg):
        return lg.gather(-1, labels[..., None])[..., 0]
    vocab = torch.arange(lg.shape[-1], device=lg.device)
    return torch.where(labels[..., None] == vocab, lg, 0.0).sum(dim=-1)


def softmax_xent(logits, labels, mask=None):
    """logits [B,S,V] (any float type), labels [B,S] ints. Returns (mean
    loss fp32, per-token loss [B,S]).

    The reference's formula, lse = log(sum(exp(lg - m))) + m, with the
    max m taken out of the graph, so the gradient is softmax -
    onehot(label) per token. The reference stops the gradient inside the
    exponentials only, so its ``+ m`` term adds a one-hot at each row's
    max to its gradient; training with it makes whisper-tiny's loss rise
    (ROADMAP.md section 3). The values are the reference's, bit for bit;
    the gradient is the true one. The mask is optional; the denominator
    is max(sum(mask), 1)."""
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
    labels = torch.as_tensor(labels, device=lg.device).long()
    per_tok = lse - _pick(lg, labels)
    if mask is None:
        mask = torch.ones_like(per_tok)
    mask = torch.as_tensor(mask, device=lg.device).float()
    loss = (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, per_tok
