#!/usr/bin/env python3
"""How far decode lies from prefill in a deep bf16 Mamba-2 stack, in the
reference and in the PyTorch package, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/ssm_depth_probe.py \
        [--depths 8,64] [--tokens 16]

mamba2-2.7b's ``reduced()`` config (d_model 64) at each depth, in the full
config's types (fp32 parameters, bf16 compute), random weights from the
reference's ``init_params`` (PRNGKey 0) carried to the port by
``params_from_jax``: the logits of ``--tokens`` decode steps against the
prefill of the same tokens, as max |decode - prefill| / max |prefill|,
for the reference jit'd, the reference run op by op, and the port. The
two paths round to bf16 at other points (the prefill's conv runs in the
compute type, decode's in fp32; chunked against step-by-step SSD), and
random weights amplify such differences layer by layer. It checks
nothing; it needs jax and the reference package besides torch.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as j_registry
from repro.models import transformer as j_tf
from repro_torch.configs import base as t_base
from repro_torch.configs import registry as t_registry
from repro_torch.models import transformer as t_tf

ARCH = "mamba2-2.7b"


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def reference_gap(jc, jp, tokens, jit):
    prefill = lambda p, t: j_tf.prefill(jc, p, {"tokens": t})  # noqa: E731
    step = lambda p, c, t, pos: j_tf.decode_step(jc, p, c, t, pos)  # noqa
    if jit:
        prefill, step = jax.jit(prefill), jax.jit(step)
    with jax.disable_jit(not jit):
        full = np.asarray(prefill(jp, jnp.asarray(tokens)))
        cache, steps = j_tf.init_cache(jc, 1, tokens.shape[1]), []
        for pos in range(tokens.shape[1]):
            lg, cache = step(jp, cache, jnp.asarray(tokens[:, pos:pos + 1]),
                             pos)
            steps.append(np.asarray(lg)[:, 0])
    return _rel(np.stack(steps, 1), full)


def port_gap(tc, params, tokens):
    full = t_tf.prefill(tc, params, {"tokens": tokens}, impl="torch").numpy()
    cache, steps = t_tf.init_cache(tc, 1, tokens.shape[1], device="cpu"), []
    for pos in range(tokens.shape[1]):
        lg, cache = t_tf.decode_step(tc, params, cache,
                                     tokens[:, pos:pos + 1], pos)
        steps.append(lg[:, 0].numpy())
    return _rel(np.stack(steps, 1), full)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="8,64")
    ap.add_argument("--tokens", type=int, default=16)
    args = ap.parse_args()
    full = j_registry.get_config(ARCH)
    vocab = j_registry.get_config(ARCH, reduced=True).vocab_size
    tokens = np.random.default_rng(0).integers(
        0, vocab, (1, args.tokens)).astype(np.int32)
    for depth in (int(d) for d in args.depths.split(",")):
        jc = dataclasses.replace(j_registry.get_config(ARCH, reduced=True),
                                 n_layers=depth, dtype=full.dtype)
        tc = dataclasses.replace(
            t_registry.get_config(ARCH, reduced=True), n_layers=depth,
            dtype=t_base.DTypePolicy(**dataclasses.asdict(full.dtype)))
        jp = j_tf.init_params(jc, jax.random.PRNGKey(0))
        params = t_tf.params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu")
        print(f"{ARCH} reduced (d_model {jc.d_model}), {depth} layers, "
              f"bf16 compute, {args.tokens} tokens: decode vs prefill, max "
              f"abs err / max |logit|: reference jit "
              f"{reference_gap(jc, jp, tokens, True):.4f}, reference op by "
              f"op {reference_gap(jc, jp, tokens, False):.4f}, port "
              f"{port_gap(tc, params, tokens):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
