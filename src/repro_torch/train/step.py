"""The LM training loss and step, the PyTorch counterpart of
``repro.train.step``: forward (``train_logits``), backward by
``torch.autograd.grad`` over the parameter leaves, then AdamW
(``train.optim.apply_updates``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import roll_left
from repro_torch.models.transformer import train_logits
from repro_torch.train.optim import (AdamWConfig, OptState, apply_updates,
                                     value_and_grad)
from repro_torch.train.xent import softmax_xent

AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3


def loss_fn(cfg: ModelConfig, params, batch, remat=True):
    """(total loss, {"xent", "aux"}): the cross-entropy of the logits
    against ``batch["labels"]`` (under ``batch["loss_mask"]`` where given),
    plus ``AUX_WEIGHT`` times the MoE balance loss, plus for deepseek-v3
    ``MTP_WEIGHT`` times the MTP head's cross-entropy against the labels
    rolled by one more position (wrapping, as ``jnp.roll``)."""
    logits, extras = train_logits(cfg, params, batch, remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    loss, _ = softmax_xent(logits, labels, batch.get("loss_mask"))
    aux = extras["aux_loss"]
    total = loss + AUX_WEIGHT * aux
    if "mtp_logits" in extras:
        mtp_loss, _ = softmax_xent(extras["mtp_logits"],
                                   roll_left(labels))
        total = total + MTP_WEIGHT * mtp_loss
    return total, {"xent": loss, "aux": aux}


def grads_of(cfg: ModelConfig, params, batch, remat=True):
    """(loss, metrics, gradients as a tree of ``params``' layout)."""
    loss, metrics, grads = value_and_grad(
        lambda p: loss_fn(cfg, p, batch, remat), params)
    return loss, {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, remat=True,
                    impl="torch"):
    """One step: (params, opt_state, batch) -> (params, opt_state, metrics
    with "loss", "xent", "aux", "grad_norm"). Only ``impl="torch"`` trains:
    the CUDA kernels have no backward, and a train step does not switch
    impls behind the caller's back."""
    if impl != "torch":
        raise ValueError(f"impl={impl!r}: LM training runs the plain path "
                         f"(impl='torch'); the CUDA kernels have no "
                         f"backward")

    def train_step(params, opt_state: OptState, batch):
        loss, metrics, grads = grads_of(cfg, params, batch, remat)
        params, opt_state, opt_metrics = apply_updates(params, grads,
                                                       opt_state, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step
