#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Environment: requires a CUDA device; prints the card's name and power
   limit, the torch and CUDA versions, and turns TF32 off.
2. Builds every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc each,
   in parallel) and prints the build time and ptxas' register report.
3. Holds each GNN kernel against its plain PyTorch version on the card, at
   the serving path's shapes (C=64, N=256, Fin=512 for layer 0 and 256
   inner, Fout=256, 4 heads, E = the engine's edge budget) with inputs from
   a real batch of the Flickr-sized graph, and on the edge cases of the CPU
   tests (unaligned f_in=500 in all three forms, block_f invariance, 64
   edges into one vertex, GAT rows that are empty, dense, or whose scores
   are all -inf, rows summing to one). Tolerance: rtol = atol = 2e-5
   (fp32, as tests/test_kernels.py). ``fused_gnn_layer``: its four serving
   rows and the self-only Transform (Fin 256), each launched twice (bitwise
   equal, both on the tf32x3 kernel). ``scatter_gather_aggregate``: F 512
   and 256 (bitwise equal over two launches), and inf and NaN on the source
   row of the weight-0 padding edges: NaN exactly where the plain version
   puts it (the oracle's 0 * h[src]), the rest within the tolerance; and
   at the shape of gat/sg's softmax sums (256 (subgraph, head) items, the
   edge lists with the self loops, F 68: a head's 64 columns, the ones
   column and padding), on the sort kernel, bitwise equal over two
   launches and at every ``block_cols`` width; the sort kernel timed at
   each width at F 512, 256 and 68 beside its default (``sort_block_cols``,
   which follows F); and at the GraphSAGE cell's served shape (C=512,
   F 512 and 256, a batch of the benchmark's graph planned by a sage/sg
   engine: its edge slots follow its largest subgraph, mean weights),
   against its plain version and timed beside ``index_add_``. ``gat_attention``: the real structure at 4, 1, 2 and 8 heads (head
   widths 64, 256, 128, 32), N=200 on the slab kernel and N=320 on the row
   kernel, each launched twice (bitwise equal, on the kernel named), and
   inf and NaN in z behind a weight of 0 (outside the structure, or a
   structural exp that underflows) and behind a subnormal weight: NaN
   exactly where the plain version puts it (the oracle's attn @ z). The
   checks are lists (``fused_checks``, ``sg_checks``, ``gat_checks``) that
   scripts/gnn_fault_check.py runs on planted faults.
   ``gat_attention_layer`` (the slab kernel's fused form: GAT's whole
   attention step) against its plain PyTorch composition
   (``gat_attention_layer_ref``) and against the unfused chain it replaces
   (the score einsums, the structure, ``gat_attention``, the bias,
   activation and row mask) at C=64 and C=512 (``gat_layer_checks``), and
   timed in turns with that chain at both, the plain composition after
   them (``gat_layer_row``). Times each kernel,
   its plain version and the one PyTorch library call that computes the
   same function (CUDA events, mean of many launches after warm-up)
   beside the least time the card could take (bytes over 3.35 TB/s or
   operations over the peak for their type, whichever is larger: 67
   TFLOP/s fp32, 989 TFLOP/s bf16; the fused layer's three tf32 products
   of each multiply-add at 494.7 TFLOP/s). The fused layer's five fp32
   rows are timed in turns with the ``baddbmm`` chain (``turns``: 5
   rounds, through the host and in a CUDA graph), each required no slower
   than the chain both ways; the wrapper's host time a call at Fin=512
   (``host_us``) is printed, as the scatter-gather's.
4. Holds ``flash_attention``'s two kernels against their plain version.
   The CUDA-core kernel (fp32, and bf16 at a head dim the wgmma kernel does
   not take): fp32 at rtol = atol = 2e-5 on the shapes of
   tests/test_kernels.py (causal and not, Sq != Sk), on ragged S=1000 at
   D=64 and 128 and with grouped KV heads; bf16 at D=32 to one bf16 ulp
   with at least 99 % of the outputs bitwise equal. The wgmma kernel (bf16,
   D=64 and 128; (192, 128) in step 15) on small, ragged, non-causal and
   grouped shapes and at
   the prefill's shape (B=1, H=40, 10 KV heads, S=8192, D=128, causal):
   ``flash_bf16_check`` (every element within ``flash_bf16_tol``, the mean
   signed error within 0.1 bf16 ulp, two launches bitwise equal; planted
   faults in the kernel fail it: scripts/flash_fault_check.py). Times the
   kernel there beside its plain version and in turns with
   ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` (timed
   only; the package never calls it) through the host and in a CUDA graph
   (``flash_row``, as Jamba's and pixtral's rows in step 15), and the
   kernel once more with K/V repeated to 40 heads.
5. Drives ``DecoupledEngine.infer`` for GCN, GraphSAGE and GAT at the
   paper's width (L=5, N=256, f_hidden=256, 4 heads, C=64, impl="cuda") in
   forced dense and forced sg mode on Zipf traffic, with random weights from
   a seed; the kernels' launch counts are zeroed before and read after, and
   each must match the program's count per batch; every ``fused_gnn_layer``
   launch must be the tf32x3 kernel and every ``gat_attention`` launch the
   slab kernel, gat/dense's all fused (``fused_launches``); gat/sg's scatter-gather launches, and no other engine's,
   count under ``SG_SOFTMAX_SUMS`` (its softmax sums: the launches of that
   kernel row). Each engine's embeddings are compared with an impl="torch"
   engine on the same card and params (rtol 1e-4, atol 1e-5). Then one
   traced device step (``run_device``: the copy and the program) of a
   gat/dense, a gcn/sg and a gat/sg batch: device time by kernel and copy,
   and the card's busy share (``torch.profiler``).
6. LM serving: phi3-medium-14b at full width (d_model 5120, 40 heads, 10 KV
   heads, d_ff 17920, vocab 100352, fp32 params, bf16 compute), depth cut
   to 8 layers, random weights from seed 0, one prompt of 8192 tokens from
   ``numpy.random.default_rng(0)``. ``prefill(impl="cuda")`` must launch
   ``flash_attention`` exactly once a layer, every launch the wgmma kernel,
   and no other kernel; its logits
   are held against ``prefill(impl="torch")`` on the same card and params,
   and 16 ``decode_step``s from an empty cache against the prefill of the
   same 16 tokens (tolerances at ``LM_TOL`` and ``DECODE_TOL``, with their
   reasons). Prints latency, tokens/s and peak device memory on ``[lm]``
   lines, and the device time by kernel from ``torch.profiler``.
7. The scatter-gather's bucket kernel (its sort split over tiles of
   2048 edge slots, scratch in device memory, n_out output rows) against
   its plain version at ``KERNEL_TOL`` and bitwise against
   ``sg_edge_order`` (each destination's edges added one at a time in
   edge order in plain PyTorch): on a real forced-sg batch of the
   Flickr-sized graph at N=1024 (74,496 edge slots, C cut to 8, F=256)
   and its first 512 destinations (n_out=512), NaN in the same places on
   the weight-0 probe, and on the serving batch's edge lists padded to
   E = 65,537; the scatter-gather rows timed in turns beside
   ``index_add_`` (host and CUDA graph). The
   three GNN kernels in bf16 at the serving shapes (fused: wgmma_bf16, and
   cuda_core at Fin=500; GAT: row; sg: sort, and bucket at N=1024), each
   within one bf16 ulp of its plain version's fp32 result rounded to bf16
   (``bf16_reading``) and within the reference's 2e-2; the fused rows also
   with a mean signed error within 0.1 ulp (``bf16_bias_ulp``), two
   launches bitwise equal, on the row's kernel (``fused_bf16_checks``).
   Each row timed beside its bound, plain and library times; the fused
   rows beside two library chains (bf16, and HW and A.HW in fp32), each
   in turns with the kernel, through the host and in a CUDA graph
   (``turns``). The [engine] phase's 75 sg launches must all be on the
   sort kernel.
8. ``[serve]``: one ``GNNServer`` on the Flickr-sized graph registers GCN
   (mode sg), GraphSAGE (dense, resident feature store) and GAT (dense)
   at the [engine] phase's width and depth under one H100 DSE plan, and
   answers 3 x 192 Zipf(1.1) requests; every embedding is held to the same
   engine's ``infer`` (``ENGINE_TOL``), the launch counts (zeroed just
   before) to the lanes' batches, every launch on the serving kernels
   (tf32x3, sort, slab); a GAT at N=8192 raises PlanViolation at
   register. Prints the plan, each lane's p50/p90/p99 and overlap, and the
   bytes the resident lane ships against a dense lane.
9. ``[repeat]``: two device steps of one gat/sg and one gcn/sg batch under
   impl="torch" and impl="cuda". Under impl="cuda" they must be bitwise
   equal (the sg Aggregates and the sg softmax's segment sums run on the
   scatter-gather kernel, which sums in one order); the impl="torch"
   lines report whether they are and the largest difference (the plain sg
   paths sum with ``index_add_``, whose order on a card varies).
10. ``[dispatch]``: for GCN, GraphSAGE and GAT at the [engine] phase's width
   and graph (impl="cuda", random weights from seed 0), an engine with
   ``trace=TraceConfig(calibrate_every=1)`` and ``dispatch=DispatchConfig(
   warmup_passes=2, autotune_blocks=True, artifact=...)`` serves
   ``DISPATCH_BATCHES`` Zipf(1.1) batches: the warm-up, then at least 3
   batches on measured decisions. Required: (1) each batch's embeddings are
   bitwise equal to an untraced engine with dispatch off whose program is
   ``respecialize``d to the mode vector the policy chose for that batch
   (the trace's device spans carry the choice); (2) an engine restarted
   from the saved calibration artifact serves the same bits traced and
   untraced; (3) the table has every mux op's ``cuda/dense`` and
   ``cuda/sg`` cells and the sort kernel's cell at every ``block_cols``
   that fits; (4) no exploration pass failed (``explore_failures`` 0);
   (5) the exported trace passes ``validate_chrome_trace`` and every traced
   batch has select, build, pack and device spans; (6) the restarted
   engine's first decision is measured; (7) its launch counts equal what
   its served variants launch, every fused launch on tf32x3 and every GAT
   launch on slab; (8) the measured decisions being all-dense at this
   width, one more engine serves a batch from a table that prices every
   sg step and the sort kernel's 32-column width cheapest: it must decide
   all-sg with ``block_cols=32`` (measured), serve the bits of the engine
   with dispatch off respecialized all-sg at the default widths, and
   launch what that variant launches, sort launches width by width
   (``scatter_gather.width_launches``). Prints each op's dense and sg p50
   by size bucket, each batch's decision, the variant cache's hits and
   evictions, and the device step's time with dispatch on and off (host
   clock around ``run_device`` and a synchronize, on batches planned
   once).
11. ``[shard]``: GCN (sg), GraphSAGE (dense) and GAT (dense) at the
   [engine] phase's width and depth behind ``StorePolicy(features=
   "sharded", num_shards=4)``: the whole 182.8 MB table in hash and then
   range placement (four shard tables on the one card: ``simulated``),
   per-shard budgets holding about half of it (host miss rows shipped), a
   ``repin()`` after Zipf traffic, and a feature mutation through
   ``invalidate()``. Every batch must be bitwise equal to the
   resident-store engine's (after the mutation: to a resident engine built
   on the mutated graph), with ``cross_shard_rows`` > 0, every shard
   non-empty and the program's launches a batch. Prints the bytes a batch
   per shard, their balance and the device step beside the resident
   engine's.
12. ``[precompute]``: the scatter-gather at the offline build's chunk
   shape (C=1, the largest chunk of 2048 destinations, its distinct
   sources gathered from the [V, F] register, F 500 and 256, n_out = the
   chunk's 2048 rows) against its plain version (``KERNEL_TOL``, bitwise
   ``sg_edge_order``, two launches bitwise equal, the bucket kernel, NaN
   from an inf/NaN row 0 behind the padding edges), timed in turns beside
   ``index_add_`` into the same 2048 rows, with its bound (and the bound
   with all N rows written), plain time and the wrapper's host time a
   call. Then GCN (sg online)
   and GraphSAGE (dense online) with readout="target" through the tier:
   the offline build on the Flickr-sized graph under impl="cuda" (its
   scatter-gather launches exactly chunks x Aggregates, nothing else
   launched) against impl="torch" on the card (``ENGINE_TOL``), two cuda
   builds bitwise equal; all-fresh batches launching nothing and returning
   the tier's rows bitwise, their p50 beside the online engine's; the
   artifact saved, loaded bitwise and refused on a mutated graph
   (``PrecomputeArtifactError``). On a 256-vertex graph of two components
   (receptive field 256: the online subgraph is the whole component): an
   all-fresh batch against the online engine (``ENGINE_TOL``, hits == C);
   a mixed batch after ``on_invalidate`` (the program launched once, its
   online rows against the online engine, its tier rows bitwise); an edge
   update and ``drain()`` (refresh chunks launch the kernel; the tier
   against a fresh build). Last, one ``GNNServer`` with a tiered and an
   untiered GCN lane, 192 Zipf(1.1) requests each: the tiered lane
   launches nothing and answers the tier's rows, with its ``precompute``
   report section; p50/p99 of both lanes printed.
13. ``[rpc]``: two graph-host processes (``python -m
   repro_torch.distributed.graph_host`` on the Flickr-sized graph, seed 0,
   ephemeral ports read from their ``GRAPH_HOST_LISTENING`` lines; a host
   that does not answer within ``RPC_HOST_DEADLINE_S`` fails the run; both
   are killed at the end; no caches on either side) serve Select and
   Build for GCN (sg), GraphSAGE
   (dense) and GAT (dense, ``routing="affine"``) at the [engine] phase's
   width, depth and params over ``transport="socket"``: a warm-up batch and
   ``N_BATCHES`` Zipf(1.1) batches, every batch bitwise equal to the local
   engine's, the program's launches a batch. One traced remote engine: its
   export validates and carries remote select/build spans from both hosts,
   with ``clock_sync`` for both endpoints. Then one host is killed between
   batches: the next batches are served by the other, bitwise equal to the
   local engine, with the retry or quarantine counted. Prints per kind,
   local against remote: p50 host+device, wall per batch, the device step,
   rpc calls, bytes in and out a batch and ``t_rpc_wire`` /
   ``t_rpc_remote``.
14. ``[telemetry]``: one ``GNNServer`` with a telemetry port
   (``TelemetryConfig(port=0)``) and three metered lanes at the [engine]
   width and depth: GCN (sg) behind ``transport="inproc"``, GraphSAGE
   (dense) on the resident store, GAT ``mode="auto"`` with a
   ``DispatchConfig`` (no table, no warm-up: every decision from the
   static model, so ``repro_dispatch_total`` counts ``source="flop"``),
   ``SERVE_REQUESTS`` requests a lane. The ``/metrics`` body, scraped over
   loopback HTTP, must pass the package's exposition validator with at
   least ``MIN_SERIES`` series, among them the inproc graph host's
   ``repro_host_select_seconds`` (the cluster scrape),
   ``repro_rpc_calls_total`` and ``repro_dispatch_total``; every lane
   bitwise equal to an unmetered engine replaying the batches it served
   (launching what the lanes launched); each lane's device-stage histogram
   counting its batches.
15. ``[kernels] flash_attention`` at MLA prefill's shape (B=1, H=16,
   S=8192, q and k 192 wide, v 128, bf16, causal) on the ``wgmma``
   kernel's (192, 128) instance, v at its own width: ``flash_bf16_check``
   against its plain version, timed beside its plain version,
   ``scaled_dot_product_attention`` with v at 128 (timed only; the package
   never calls it) and, in the same run, the ``cuda_core`` kernel on v
   zero-padded to 192 (the route before; checked too, its padded output
   columns zero), with a bound from the function's own work (Q.K^T at 192
   and P.V at 128 over the causal half: ``flash_cost(v_dim=128)``). Runs after step 4,
   and is followed by the wgmma kernel at Jamba's attention shape (B=1,
   H=64, 8 KV heads, S=8192, D=128, bf16, causal): ``flash_bf16_check``,
   timed beside its plain version and in turns with
   ``scaled_dot_product_attention(enable_gqa=True)`` (``turns``: through
   the host and in a CUDA graph), bound from the operations; then at
   whisper's encoder shape (B=16, H=6, S=1500, D=64, non-causal, ragged)
   and decoder shape (S=448, causal) and pixtral's (B=1, H=32, 8 KV heads,
   S=8192, D=128, causal), each the same way (``flash_row``).
16. ``[train]``: ``train_gnn`` for GCN, GraphSAGE and GAT at the
   [engine] width and depth (L=5, N=256, f_hidden=256, 4 heads, the
   graph's label count) on the Flickr-sized graph, batch 32, lr 3e-3, 30
   steps. The first step on the card is held against the same step on
   the CPU (same params and batch: loss, acc and grad_norm in float32,
   loss and every gradient leaf in float64, at ``TRAIN_TOL``), the mean
   loss of the last 5 steps
   must be below the first 5's, and no kernel may launch (training runs
   the plain program under autograd). Prints ms a step split into the
   host ``build_batch`` and the device (copy, forward, backward, update).
17. ``[lm]`` deepseek-v2-lite-16b (after phi3, whose parameters are freed
   first) at full width (d_model 2048, 16 heads, MLA kv_lora 512, qk
   128 + 64, v 128; 64 routed experts top-6 + 2 shared, expert ff 1408,
   shared ff 2816, dense first layer ff 10944; vocab 102400; fp32 params,
   bf16 compute), depth cut to 8 layers, seed-0 weights, the 8192-token
   prompt. ``prefill(impl="cuda")`` must launch ``flash_attention`` once
   a layer, all on ``wgmma`` (q/k 192, v 128 unpadded) and none on
   ``cuda_core``, and no other kernel; two such prefills must be bitwise
   equal; impl="torch" launches none. Routing is compared first
   (``MOE_ROUTE_AGREE``; the agreement by layer is printed), then the
   logits at ``LM_TOL``
   with the plain path routed as the kernel path (``RouteLog``), and 16
   decode steps (which never drop: capacity 8 for one token) against the
   prefill of the same 16 tokens given capacity for every assignment, at
   ``DECODE_TOL``, routed as that prefill (the same prefill at the
   config's capacity factor drops assignments on this prompt: counted and
   printed). Prints latency, tokens/s, peak memory, capacity drops and
   the profile.
18. ``[lm]`` mamba2-2.7b (after deepseek, whose parameters are freed) at
   full width and full depth (64 layers, d_model 2560, d_inner 5120, SSM
   H=80 P=64 N=128, chunk 256, vocab 50280; fp32 params, bf16 compute),
   seed-0 weights, the 8192-token prompt. No kernel of the repository is
   on its path (SSD is plain torch in fp32 on both impls): the prefill
   must launch none, two prefills and the impl="torch" prefill must be
   bitwise equal; the chunked SSD on layer 32's real inputs is held
   against the float64 recurrence (``SSD_TOL``); 16 decode steps at all
   64 layers, timed and set beside the 16-token prefill, and held against
   it at ``DECODE_TOL`` on the first ``SSM_DECODE_LAYERS`` layers (the
   reason is at the constant). Prints latency, tokens/s, peak memory, the
   profile with its busy share and kernels and copies a layer against the
   prediction ``SSM_OPS``, and decode's p50 and busy share.
19. ``[lm]`` jamba-1.5-large-398b, one period of 8 layers at full width
   (d_model 8192, 64/8 heads at D=128, d_ff and expert ff 24576, SSM
   H=256; bf16), its experts cut from 16 to ``HYBRID_EXPERTS`` = 4, top-2
   kept (the cut printed). impl="cuda" against impl="torch" on a
   2048-token prompt as deepseek's (routing agreement, then the logits
   with the plain path routed as the kernel path); the timed 8192-token
   prefill on impl="cuda" must launch ``flash_attention`` once (wgmma) and
   nothing else, two of them bitwise equal; 16 decode steps against the
   16-token prefill, routed as it. Prints latency, tokens/s, peak memory,
   capacity drops a layer, the profile and decode's p50 and busy share.
20. ``[lm]`` whisper-tiny (after Jamba) at full width and depth (4
   encoder layers over 1500 frames, 4 decoder layers, d_model 384, 6
   heads at D=64, GELU, vocab 51865; fp32 params, bf16 compute), seed-0
   weights, 16 clips of random frames and a 448-token prompt:
   ``prefill(impl="cuda")`` must launch ``flash_attention`` 8 times, all
   on the wgmma kernel (the encoder's 4 non-causal at S=1500, the
   decoder's 4 causal; ``FlashLog`` splits them), two prefills bitwise
   equal, held against impl="torch" at ``LM_TOL``; 16 decode steps over
   the cross cache filled from the encoder (``_fill_cross_cache``) against
   the prefill's first 16 positions at ``DECODE_TOL``. Prints latency,
   tokens/s, peak memory, busy share, the launches by flash variant and
   decode's p50 and busy share.
21. ``[lm]`` pixtral-12b at full width (d_model 5120, 32/8 heads at
   D=128, d_ff 14336, vocab 131072), 8 of 40 layers, seed-0 weights, the
   8192-token prompt with 256 random patch embeddings spliced: one wgmma
   flash launch a layer, held against impl="torch" at ``LM_TOL``; the
   identity splice (the prompt's own first 256 token embeddings) bitwise
   equal to the dense family's prefill of the same params; 16 decode
   steps against that prefill's first 16 positions at ``DECODE_TOL``.
22. ``[lm-train]``: whisper-tiny (full width and depth) through
   ``train.loop.train`` (``TRAIN_LM``: batch 8, S=448, 30 steps,
   checkpoints every 10): finite losses, the last 5 below the first 5,
   then a run killed at step 20 and resumed, every logged loss within
   rtol 1e-4 of the uninterrupted run's; one deepseek-v2-lite step (2
   layers at full width, gather dispatch, B=1, S=2048): finite, grad_norm
   > 0, and its MoE layer's input gradient through the autograd pair held
   against autograd through plain indexing in float64 (``GRAD64_TOL``).
   No kernel may launch (training runs the plain path). Prints ms a step
   (host and device), peak memory and the loss curve.
23. ``[launch]``: the launch analysis (``src/repro_torch/launch``). (a)
   The survey: ``python -m repro_torch.launch.dryrun`` in four
   subprocesses at once (the fake process group stays out of this
   process) at full width on the single 16x16 mesh: phi3-medium-14b
   prefill_32k, deepseek-v2-lite-16b train_4k, whisper-tiny decode_32k
   and the five GNN serve cells; every cell must be ``ok``, and the
   roofline table of the records is printed. Beside them, in a fifth
   process, the reduced train cells of mamba2-2.7b and
   jamba-1.5-large-398b on the (2, 4) fake mesh (SSD's cumulative sum
   and its backward on local shards, ``models.common.cumsum``): both must
   be ``ok``. (b) Cells measured on one
   card, at one card's share of the survey's GNN batch (4096 / 256 = 16
   targets) and at ``[lm]``'s phi3 prefill (B=1, S=8192, 8 of 40
   layers): the GNN cells on a real Build + Pack batch of the
   Flickr-sized graph at each cell's N, dense, f_in 512. Each cell is
   counted once on ``meta`` (impl="torch"), once on the card with
   impl="torch" (its FLOPs must equal the meta count exactly, and its
   argument bytes the bytes of the tensors on the card) and once with
   impl="cuda" (the kernels' own counts from their ``*_cost``), then
   timed without the analysis (p50 of single calls between CUDA events).
   Prints the counts, the p50, the roofline bound of the impl="cuda"
   count and ``bound_share`` = bound / p50 (at most 1.05: a higher
   reading means the count is wrong), the card's peak memory beside the
   estimate, and the launches; impl="cuda" is held against impl="torch"
   at ``ENGINE_TOL`` (GNN) and ``LM_TOL`` (phi3). The path must launch
   ``fused_gnn_layer``, ``gat_attention`` and ``flash_attention``.
24. Prints the ``kernels`` JSON line (each kernel with its ``variants``:
   the bucket scatter-gather, the offline chunk shape, GAT's fused form at
   C=64 (with the main path's launches of it) and C=512, the bf16 kernels
   and flash at the MLA, Jamba, whisper-encoder and pixtral shapes) and,
   last, the ``ok`` line.

Any failure exits nonzero before the last line.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import queue
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.dispatch import DispatchConfig  # noqa: E402
from repro_torch.core.dse import (H100Spec, PlanViolation,  # noqa: E402
                                  plan_covers)
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.core.ini import ini_batch  # noqa: E402
from repro_torch.core.subgraph import (batch_from_node_lists,  # noqa: E402
                                       default_edge_pad)
from repro_torch.core.program import (Aggregate,  # noqa: E402
                                      SG_SOFTMAX_SUMS, AttentionScore,
                                      AttentionSoftmax, Transform,
                                      _step_attention_score,
                                      _step_attention_softmax,
                                      compile_steps, lower, mux_sites,
                                      required_adjacency, respecialize)
from repro_torch.gnn import train as gnn_train  # noqa: E402
from repro_torch.gnn.layers import dense_init  # noqa: E402
from repro_torch.gnn.model import GNNConfig, init_gnn  # noqa: E402
from repro_torch.graphs.csr import CSRGraph  # noqa: E402
from repro_torch.graphs.synthetic import (DatasetSpec,  # noqa: E402
                                          get_graph, make_graph,
                                          zipf_traffic)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kernels  # noqa: E402
from repro_torch.kernels import fused_gnn as fused_kernels  # noqa: E402
from repro_torch.kernels import gat_attention as gat_kernels  # noqa: E402
from repro_torch.kernels import scatter_gather as sg_kernels  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref, flash_bf16_check, flash_bf16_tol,
    flash_cost, flash_variant)
from repro_torch.kernels.fused_gnn import (ACTS,  # noqa: E402
                                           fused_cost, fused_gnn_layer,
                                           fused_gnn_layer_ref)
from repro_torch.kernels.gat_attention import (  # noqa: E402
    gat_attention, gat_attention_layer, gat_attention_layer_ref,
    gat_attention_ref, gat_cost, gat_layer_cost, gat_variant)
from repro_torch.kernels.ref import (BF16_BIAS_ULP,  # noqa: E402
                                     bf16_bias_ulp, bf16_reading)
from repro_torch.kernels.scatter_gather import (  # noqa: E402
    scatter_gather_aggregate, scatter_gather_aggregate_ref, sg_cost,
    sg_variant)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as launch_dryrun  # noqa: E402
from repro_torch.launch import op_analysis as launch_analysis  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import specs as launch_specs  # noqa: E402
from repro_torch.launch.cells import build_cell, build_gnn_cell  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.data.pipeline import (TokenPipelineConfig,  # noqa: E402
                                       synthetic_batch)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.common import cast_tree, param_count  # noqa: E402
from repro_torch.obs.calib import op_label, op_mode, size_bucket  # noqa: E402
from repro_torch.obs.export import validate_chrome_trace  # noqa: E402
from repro_torch.obs.metrics import (TelemetryConfig,  # noqa: E402
                                     series_count)
from repro_torch.obs.promexp import validate_exposition  # noqa: E402
from repro_torch.obs.trace import TraceConfig  # noqa: E402
from repro_torch.precompute import (PrecomputeArtifactError,  # noqa: E402
                                    PrecomputeConfig, agg_hops,
                                    layer_major_embeddings, save_artifact)
from repro_torch.precompute.propagate import (_apply_section,  # noqa: E402
                                              _layer, _LocalCSR)
from repro_torch.serve.gnn_server import GNNServer  # noqa: E402
from repro_torch.store import StorePolicy  # noqa: E402
from repro_torch.train import loop as lm_loop  # noqa: E402
from repro_torch.train.optim import (AdamWConfig, global_norm,  # noqa
                                     init_opt, tree_leaves, tree_map)
from repro_torch.train.step import make_train_step  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
PEAK_TF32_FLOPS = 494.7e12       # H100 SXM tf32 tensor cores, dense
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
# flash_attention's CUDA-core kernel in bf16: it and its plain version both
# compute in fp32 from the same bf16 inputs (agreeing to KERNEL_TOL) and
# round once on the store, so they may land on neighbouring bf16 values: one
# ulp, at most 2^-7 of the value. Most elements round alike; a truncating
# store would not. (The wgmma kernel rounds P to bf16 before P.V: it is held
# by flash_bf16_check instead.)
FLASH_BF16_TOL = dict(rtol=2.0 ** -7, atol=2e-5)
FLASH_BF16_EQUAL = 0.99
ENGINE_TOL = dict(rtol=1e-4, atol=1e-5)
C, N, F_IN, F_HID, HEADS, LAYERS = 64, 256, 500, 256, 4, 5
N_BATCHES = 4                    # measured batches per engine (+1 warm-up)
# the scatter-gather's bucket kernel on a real forced-sg batch of the
# Flickr-sized graph at N=1024 (its edge budget: 74,496 slots); C cut from
# 64 to 8 (a host Build of 64 subgraphs at N=1024 would take tens of
# seconds), and on the serving batch's edge lists padded past the sort
# kernel's 16-bit indices to 65,537 slots
BIG_N, BIG_C, WIDE_E = 1024, 8, 65537
# [serve]: requests a lane (3 batches of C), and GCN, GraphSAGE and GAT
# at the [engine] phase's width and depth, each lane's mode fixed so that
# all three GNN kernels run on the server path
SERVE_REQUESTS = 3 * C
SERVE_LANES = {"gcn": dict(mode="sg"),
               "sage": dict(mode="dense", features="resident"),
               "gat": dict(mode="dense")}
# LM phase: phi3-medium-14b at full width, depth cut to 8 of its 40 layers
# (the fp32 parameters of 40 layers, 58.6 GB, and the plain path's 27 GB of
# transient scores do not fit one 80 GB card together)
LM_ARCH, LM_LAYERS, LM_SEQ, LM_DECODE = "phi3-medium-14b", 8, 8192, 16
# impl="cuda" against impl="torch" (and decode against prefill) in bf16:
# the paths round at different points (the kernel rounds the unnormalized
# probabilities to bf16 before P.V, the plain path the normalized ones, as
# JAX does; decode runs other matmul shapes), and every bf16 op after that
# rounds the residual stream again, 8 layers deep. Held: max |diff| over
# max |logit|, and the share of positions whose top-1 token agrees.
LM_TOL = dict(rel=5e-2, top1=0.9)
DECODE_TOL = dict(rel=5e-2, top1=0.875)
# [train]: the paper's three models at the [engine] width and depth,
# train_gnn's steps, batch and learning rate. The first step on the card
# against the CPU's: the float32 step's loss and grad_norm at
# tests/test_torch_train.py's rtol 1e-5 and acc within one target. Its
# gradient leaves are held in float64 (the same step with the params and
# batch widened), to 1e-10 of each leaf's largest |g| (loss 1e-12): at
# this width ~10^7 ReLU inputs a step are summed in other orders on the
# two sides, and the few within float32 rounding of 0 switch a path's
# gradient on or off, which float64 rounding does not reach (on an H100,
# GraphSAGE's float32 leaves lay 9.5e-4 of a leaf's max from float64 on
# the CPU and 2.3e-7 on the card, while the float64 steps agreed to
# 1.6e-15); the float32 leaves' distances are printed
TRAIN_KINDS = ("gcn", "sage", "gat")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR = 30, 32, 3e-3
TRAIN_TOL = dict(rtol=1e-5, rtol64=1e-12, grad64=1e-10)
# [lm] MoE family: deepseek-v2-lite-16b at full width, depth cut to 8 of 27
# layers (the dense first layer and 7 MoE layers: 4.59 B parameters, 18.4
# GB in fp32), the same prompt as phi3's. impl="cuda" and impl="torch" (and
# decode against prefill) round at other points, as phi3's do, and a token
# whose top-k router probabilities nearly tie then routes to another
# expert: a whole expert's output apart, which no rounding tolerance
# covers. So the routing is compared first (the share of each MoE layer's
# (token, k) decisions made alike, at least MOE_ROUTE_AGREE: near-ties are
# rare), then the logits are held at LM_TOL / DECODE_TOL with the plain
# path routed as the kernel path (each MoE layer's experts pinned; the
# router's own probabilities of them weight the experts)
MOE_ARCH, MOE_LAYERS = "deepseek-v2-lite-16b", 8
MOE_ROUTE_AGREE = 0.9
# [lm] SSM family: mamba2-2.7b at full width and full depth (64 layers,
# 2.831 B parameters, 11.33 GB in fp32), the same prompt as phi3's. Its
# SSD runs as plain torch ops on both impls (fp32, TF32 off), so the
# kernel-vs-plain comparison does not apply: the chunked SSD is held
# against the step-by-step recurrence in float64 on one layer's real
# inputs at the full layer shape (H=80, P=64, N=128, S=8192), to SSD_TOL of
# the largest |y| (and |final state|): fp32 rounds each exp(cumsum) (the
# cumulative decay reaches ~1e3 in a chunk, so ~1e3 x 2^-24 relative) and
# sums 256 + 128 terms a chunk, and the state carries 32 chunks deep.
# SSM_OPS is the prediction of a prefill's kernels and copies a layer
# (PERF.md section 6): the per-layer cast of 9 leaves, two norms, the
# projections, the conv, ~36 state-free SSD ops and the chunk loop's
# 32 addcmuls.
# Decode against prefill is held at DECODE_TOL on the model's first
# SSM_DECODE_LAYERS layers (phi3's and deepseek's depth), and the 64-layer
# decode is timed with its agreement printed: the two paths round to bf16
# at other points, and 64 layers of random weights amplify that past
# DECODE_TOL in the reference itself (scripts/ssm_depth_probe.py on the
# CPU at the reduced width: decode vs prefill 0.116 op by op and 0.206
# jit'd at 64 layers; on an H100 the port's full-width 64-layer gap was
# 6.944e-02, top-1 0.9375)
SSM_ARCH = "mamba2-2.7b"
SSD_TOL = 1e-4
SSM_OPS = (100, 160)
SSM_DECODE_LAYERS = 8
# [lm] hybrid family: one period of jamba-1.5-large-398b (8 layers, every
# layer kind whole) at full width (d_model 8192, 64/8 heads at D=128,
# d_ff 24576, expert ff 24576, SSM H=256), its 16 experts cut to 4, top-2
# kept: 16.15 B parameters, 32.3 GB in bf16 (16 experts: 90.3 GB; 8: 51.6
# GB, which with the plain path's transient scores does not fit one card).
# impl="cuda" against impl="torch" on a HYBRID_SHORT-token prompt (the
# plain attention's 64 x S^2 fp32 scores are 17.2 GB a tensor at 8192),
# routing first, as deepseek's; the timed prefill at LM_SEQ on impl="cuda"
HYBRID_ARCH, HYBRID_EXPERTS, HYBRID_SHORT = "jamba-1.5-large-398b", 4, 2048
# [lm] audio family: whisper-tiny at full width and depth (0.059 B
# parameters), 16 clips of its 1500 frames and a 448-token prompt (its
# text context, which sizes pos_emb), 16 decode steps over the cross cache
# filled from the encoder
AUDIO_ARCH, AUDIO_B, AUDIO_SEQ = "whisper-tiny", 16, 448
# [lm] VLM family: pixtral-12b at full width, depth cut to 8 of 40 layers
# (3.523 B parameters, 14.09 GB in fp32; the full model's 48.99 GB with
# the plain path's transient scores and a 4.29 GB fp32 logits tensor does
# not fit one card), its 256 random patch embeddings spliced over the
# 8192-token prompt
VLM_ARCH, VLM_LAYERS = "pixtral-12b", 8
# [lm-train]: whisper-tiny at full width and depth through
# train.loop.train (batch 8, its 448-token context, lr 1e-3, 30 steps, a
# checkpoint every 10), killed at step 20 and resumed: the resumed losses
# held to the uninterrupted run's at tests/test_substrate.py's rtol (the
# embedding's backward on the card sums with atomics, so two runs differ
# in the last bits, not more). Then one step of deepseek-v2-lite at full
# width, cut to 2 layers (its dense first layer and one MoE layer, ~1.1 B
# parameters: 4.4 GB fp32 + gradients + two AdamW moments ~18 GB before
# activations), B=1, S=2048, the gather dispatch: its MoE layer's input
# gradient through the autograd pair held against autograd through plain
# indexing, in float64 on the card, to GRAD64_TOL of the largest element
TRAIN_LM = dict(arch="whisper-tiny", batch=8, seq=448, lr=1e-3, steps=30,
                ckpt_every=10, fail_at=20, rtol=1e-4)
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, GRAD64_TOL = 2, 2048, 1e-12
LM_TRAIN_DIR = ROOT / "build" / "chip_smoke_lm_train"
# [kernels] the scatter-gather at the GraphSAGE cell's served shape: the
# benchmark's graph (Flickr's vertices at avg_degree 5.75 from seed 5, mean
# degree 10.02), a batch of C=512 Zipf targets planned by a sage/sg engine
# at e_pad = N(N-1), whose edge slots follow its largest subgraph
SERVED_C, SERVED_SEED = 512, 5
SERVED_GRAPH = DatasetSpec("flickr", 89_250, 5.75, 500, 7)
# kernel launches per batch at L=5 (the program's count, see README)
EXPECTED = {
    ("gcn", "dense"): {"fused_gnn_layer": 5},
    ("sage", "dense"): {"fused_gnn_layer": 5},
    ("gat", "dense"): {"fused_gnn_layer": 5, "gat_attention": 5},
    ("gcn", "sg"): {"fused_gnn_layer": 5, "scatter_gather_aggregate": 5},
    # the Transform [W_neigh; W_self] after an sg mean: one self-only
    # tf32x3 launch on [z | h] a layer
    ("sage", "sg"): {"fused_gnn_layer": 5, "scatter_gather_aggregate": 5},
    # the sg softmax's segment sums (denominator and numerator) run on the
    # scatter-gather kernel: one launch a layer
    ("gat", "sg"): {"fused_gnn_layer": 5, "scatter_gather_aggregate": 5},
}
# [dispatch]: batches an adaptive engine serves (warm-up ends within two:
# both mode columns of the table are full after one pass a side) and the
# device-step timings a batch with dispatch on and off; the calibration
# artifacts go under build/ (ignored by git)
DISPATCH_BATCHES, DISPATCH_TIMED = 6, 5
CALIB_DIR = ROOT / "build" / "chip_smoke_calib"
# [shard]: four shard tables (one card each where the host has four, else
# simulated on the one card), and the three GNN kernels behind them
SHARDS = 4
SHARD_KINDS = (("gcn", "sg"), ("sage", "dense"), ("gat", "dense"))
# [precompute]: the paper's two precomputable models (readout="target"),
# online halves in these modes; the offline build's chunk of destination
# vertices (PrecomputeConfig's default); the full-coverage graph's
# vertices (two components of 128: at L=5 the dependency ball of any
# vertex is its whole component, so a mixed batch needs a second one);
# the artifacts go under build/ (ignored by git)
PRE_KINDS = (("gcn", "sg"), ("sage", "dense"))
PRE_CHUNK, COVER_V = 2048, 256
PRE_DIR = ROOT / "build" / "chip_smoke_precompute"
# [rpc]: two graph hosts, the three GNN kernels behind them (GAT routed
# partition-affine, the others round-robin); a host must print its
# endpoint within the deadline (it builds the Flickr-sized graph first)
RPC_HOSTS = 2
RPC_KINDS = (("gcn", "sg", "round_robin"), ("sage", "dense", "round_robin"),
             ("gat", "dense", "affine"))
RPC_HOST_DEADLINE_S = 300.0
RPC_DIR = ROOT / "build" / "chip_smoke_rpc"
# [telemetry]: the exposition's series floor (scripts/metrics_smoke.py's)
MIN_SERIES = 20
REPLACES = {
    "fused_gnn_layer": ("src/repro_torch/csrc/fused_gnn.cu",
                        "src/repro/kernels/fused_gnn.py:65"),
    "scatter_gather_aggregate": ("src/repro_torch/csrc/scatter_gather.cu",
                                 "src/repro/kernels/scatter_gather.py:67"),
    "gat_attention": ("src/repro_torch/csrc/gat_attention.cu",
                      "src/repro/kernels/gat_attention.py:53"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:79"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def turns(fns, rounds: int = 5, iters: int = 50, calls: int = 20):
    """Times each callable of ``fns`` ({name: fn}) in turns, ``rounds``
    rounds of each in the order given (reversed every other round): through
    the host (``cuda_ms`` of ``iters`` back-to-back calls) and on the device
    (a CUDA graph of ``calls`` calls, captured once a callable and replayed
    5 times a round). Returns {name: {"host": [ms a round], "graph": [ms a
    round]}}. The card's SM clock falls from 1980 MHz to 1240-1800 MHz
    under sustained load as it heats (``scripts/timing_probe.py``), so one
    reading moves with what ran before it; in turns, the calls compared
    see the same states, and the rounds give a median and a spread."""
    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(calls):
                fn()
    out = {name: {"host": [], "graph": []} for name in fns}
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            out[name]["host"].append(cuda_ms(fns[name], iters=iters))
            out[name]["graph"].append(
                cuda_ms(graphs[name].replay, iters=5, warmup=1) / calls)
    del graphs
    return out


def spread(xs) -> str:
    """'median [min-max]' of a list of milliseconds."""
    return (f"{statistics.median(xs):.4f} [{min(xs):.4f}-{max(xs):.4f}]")


def host_us(fn, calls: int = 200) -> float:
    """Mean host microseconds one call of ``fn`` takes to return (no
    synchronize between the calls, so launches queue behind the device):
    what back-to-back calls cost when the host, not the card, is slower."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bound_ms(nbytes: float, flops: float, peak_flops=PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def closeness(got, want, tol):
    """(max |got - want|, the largest |got - want| / (atol + rtol |want|),
    which is <= 1 exactly where allclose holds, and the share of elements
    that are bitwise equal)."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    worst = float(diff.div_(tol["atol"] + tol["rtol"] * w.abs()).max())
    return err, worst, float((g == w).float().mean())


def compare(name, got, want, tol=KERNEL_TOL, equal_share=None) -> float:
    """Holds ``got`` to ``want`` at ``tol`` and, where ``equal_share`` is
    given, requires at least that share of elements bitwise equal."""
    err, worst, share = closeness(got, want, tol)
    ok = worst <= 1.0 and (equal_share is None or share >= equal_share)
    print(f"  {name}: max_abs_err={err:.3e} (rtol={tol['rtol']:.4g}, "
          f"atol={tol['atol']:.4g}; worst {worst:.3f} of the tolerance), "
          f"bitwise equal {share:.6f}"
          f"{'' if equal_share is None else f' (at least {equal_share})'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name} disagrees with its plain version")
    return err


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 3: kernels against their plain versions ------------------------


def nan_reading(got, want, tol=KERNEL_TOL):
    """(ok, text): NaN in the same places, infinities equal, and the finite
    elements within ``tol`` (allclose with equal_nan)."""
    torch.cuda.synchronize()
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    ok = same_nan and bool(torch.allclose(got, want, equal_nan=True, **tol))
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    return ok, (f"NaN {int(torch.isnan(got).sum())} (plain "
                f"{int(torch.isnan(want).sum())}), same places {same_nan}, "
                f"finite max_abs_err={err:.3e}")


def reading(got, want, tol=KERNEL_TOL):
    """(ok, text, max |got - want|) at ``tol``."""
    err, worst, share = closeness(got, want, tol)
    return worst <= 1.0, (f"max_abs_err={err:.3e} (rtol={tol['rtol']:.4g}, "
                          f"atol={tol['atol']:.4g}; worst {worst:.3f} of the "
                          f"tolerance), bitwise equal {share:.6f}"), err


def gnn_inputs(sb, dev):
    """The serving path's inputs from the SubgraphBatch ``sb`` (features
    padded to 512 columns, adjacency, mask, edge lists) and seed-0 weights:
    Fin 512 (layer 0) and 256 (inner layers), Fout 256."""
    gen = torch.Generator().manual_seed(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    x = dict(adj=t(sb.adj), adj_mean=t(sb.adj_mean), mask=t(sb.mask),
             src=t(sb.edge_src), dst=t(sb.edge_dst), w=t(sb.edge_w))
    x["feats"] = t(np.pad(sb.feats, ((0, 0), (0, 0), (0, 512 - F_IN))))
    x["h256"] = torch.relu(torch.randn(C, N, F_HID, generator=gen).to(dev)) \
        * x["mask"][..., None]
    for fin in (512, F_HID):
        x[f"wn{fin}"] = dense_init(gen, (fin, F_HID)).to(dev)
        x[f"ws{fin}"] = dense_init(gen, (fin, F_HID)).to(dev)
    x["b"] = (0.1 * torch.randn(F_HID, generator=gen)).to(dev)
    x["w500"] = dense_init(gen, (F_IN, F_HID)).to(dev)
    x["wb"] = dense_init(gen, (512, 512)).to(dev)
    return x


def fused_rows(x):
    """The fused layer's serving-shape rows: (tag, args, kwargs)."""
    rows = []
    for fin, h in ((512, x["feats"]), (F_HID, x["h256"])):
        for self_w in (False, True):
            args = (x["adj"], h, x[f"wn{fin}"],
                    x[f"ws{fin}"] if self_w else None, x["b"], x["mask"])
            rows.append((f"C={C} N={N} Fin={fin} Fout={F_HID} "
                         f"{'+w_self' if self_w else 'w_neigh'}", args, {}))
    rows.append((f"C={C} N={N} Fin={F_HID} Fout={F_HID} self-only",
                 (None, x["h256"], None, x[f"ws{F_HID}"], x["b"], x["mask"]),
                 dict(act="none")))
    return rows


def fused_checks(x):
    """Every check of ``fused_gnn_layer`` against its plain version:
    [(name, ok, text)]. The serving rows (each launched twice: bitwise
    equal, and all on the tf32x3 kernel), the CPU tests' edge cases,
    block_f invariance and the kept weight splits
    (``fused_split_checks``)."""
    out = []
    for tag, args, kw in fused_rows(x):
        before = fused_kernels.variant_launches["tf32x3"]
        got = fused_gnn_layer(*args, **kw)
        again = fused_gnn_layer(*args, **kw)
        ok, text, _ = reading(got, fused_gnn_layer_ref(*args, **kw))
        same = bool(torch.equal(got, again))
        tf32 = fused_kernels.variant_launches["tf32x3"] == before + 2
        out.append((f"fused {tag}", ok and same and tf32,
                    f"{text}, repeat bitwise {same}, tf32x3 {tf32}"))
    h500 = x["feats"][:2, :64, :F_IN].contiguous()
    a64 = x["adj"][:2, :64, :64].contiguous()
    m64 = x["mask"][:2, :64].contiguous()
    for name, args, kw in (
            ("fused unaligned f_in=500", (a64, h500, x["w500"], None, None,
                                          m64), {}),
            ("fused f_in=500 +w_self", (a64, h500, x["w500"], x["w500"],
                                        x["b"], m64), dict(act="elu")),
            ("fused self-only f_in=500", (None, h500, None, x["w500"], None,
                                          m64), dict(act="none"))):
        ok, text, _ = reading(fused_gnn_layer(*args, **kw),
                              fused_gnn_layer_ref(*args, **kw))
        out.append((name, ok, text))
    b128 = fused_gnn_layer(x["adj"], x["feats"], x["wb"], None, None,
                           x["mask"], block_f=128)
    b256 = fused_gnn_layer(x["adj"], x["feats"], x["wb"], None, None,
                           x["mask"], block_f=256)
    torch.cuda.synchronize()
    same = bool(torch.equal(b128, b256))
    out.append(("fused block_f 128 == 256", same, f"bitwise {same}"))
    out += fused_split_checks(x)
    return out


def fused_split_checks(x):
    """The tf32x3 kernel's kept weight splits (``weight_split``) are never
    stale: a weight updated in place, and a new weight at a freed weight's
    address with the same shape and ``_version``, each give the plain
    version's result on the new values. [(name, ok, text)]"""
    out = []
    w = x["wn512"].clone()
    args = (x["adj"], x["feats"], w, None, x["b"], x["mask"])
    before = fused_gnn_layer(*args)
    w.mul_(-0.5)                                    # _version 0 -> 1
    got = fused_gnn_layer(*args)
    ok, text, _ = reading(got, fused_gnn_layer_ref(*args))
    moved = not bool(torch.equal(got, before))
    out.append(("fused weight updated in place", ok and moved,
                f"{text}, output changed {moved}"))
    ptr = w.data_ptr()
    del args, w, got, before
    w = torch.empty_like(x["wn512"])
    w.copy_(x["ws512"])                             # _version 1, as above
    args = (x["adj"], x["feats"], w, None, x["b"], x["mask"])
    ok, text, _ = reading(fused_gnn_layer(*args),
                          fused_gnn_layer_ref(*args))
    out.append(("fused new weight at a freed weight's address", ok,
                f"{text}, same address {w.data_ptr() == ptr}"))
    return out


def sg_rows(x):
    """The scatter-gather's serving rows: (tag, (src, dst, w, h))."""
    nnz = int((x["w"] != 0).sum())
    return [(f"C={C} N={N} F={f} E={x['src'].shape[1]} real_edges={nnz}",
             (x["src"], x["dst"], x["w"], h))
            for f, h in ((512, x["feats"]),
                         (F_HID, x["feats"][..., :F_HID].contiguous()))]


def sg_checks(x):
    """Every check of ``scatter_gather_aggregate`` against its plain
    version: [(name, ok, text)]. The serving rows (two launches bitwise
    equal), inf and NaN on the source row of the weight-0 padding edges
    (the oracle's 0 * h[src]: NaN where the plain version has it), and 64
    edges into one vertex (exact)."""
    out = []
    for tag, args in sg_rows(x):
        got = scatter_gather_aggregate(*args)
        again = scatter_gather_aggregate(*args)
        ok, text, _ = reading(got, scatter_gather_aggregate_ref(*args))
        same = bool(torch.equal(got, again))
        out.append((f"sg {tag}", ok and same,
                    f"{text}, repeat bitwise {same}"))
    h = x["feats"].clone()
    h[0, N - 1, 1] = float("inf")       # the padding edges' source is N - 1
    h[3, N - 1, 7] = float("nan")
    h[5, N - 1, 300] = float("-inf")
    args = (x["src"], x["dst"], x["w"], h)
    ok, text = nan_reading(scatter_gather_aggregate(*args),
                           scatter_gather_aggregate_ref(*args))
    out.append(("sg weight-0 edges from inf/NaN sources", ok, text))
    raw = scatter_gather_aggregate(
        torch.zeros(1, 64, dtype=torch.int32, device=h.device),
        torch.full((1, 64), 3, dtype=torch.int32, device=h.device),
        torch.ones(1, 64, device=h.device),
        torch.ones(1, 16, 32, device=h.device))
    torch.cuda.synchronize()
    ok = float(raw[0, 3, 0]) == 64.0 and float(raw[0, :3].abs().sum()) == 0.0
    out.append(("sg 64 edges into one vertex", ok, f"out[3] = "
                f"{float(raw[0, 3, 0])}, rows 0-2 sum "
                f"{float(raw[0, :3].abs().sum())}"))
    return out


def sg_softmax_rows(x):
    """The scatter-gather at the shape gat/sg's softmax gives it (its
    segment sums, in one launch): one item a (subgraph, head), the serving
    edge lists with the N self loops appended, w like ex (seed-3 uniforms
    on the live edges and the loops, 0 on the padding), h a head's 64
    columns of z (seed-3 normals), a ones column and zeros to 68 columns:
    [(tag, (src, dst, w, h))]."""
    if "softmax" not in x:
        dev = x["mask"].device
        gen = torch.Generator().manual_seed(3)
        iota = torch.arange(N, dtype=torch.int32, device=dev).expand(C, N)
        e_all = x["src"].shape[1] + N
        live = torch.cat([x["w"] != 0, torch.ones(C, N, dtype=torch.bool,
                                                  device=dev)], 1)

        def per_head(t):
            return t.unsqueeze(1).expand(C, HEADS, e_all).reshape(
                C * HEADS, e_all).contiguous()
        src = per_head(torch.cat([x["src"], iota], 1))
        dst = per_head(torch.cat([x["dst"], iota], 1))
        w = torch.rand(C * HEADS, e_all, generator=gen).to(dev) \
            * per_head(live)
        fh = F_HID // HEADS
        h = torch.zeros(C * HEADS, N, fh // 4 * 4 + 4)
        h[..., :fh] = torch.randn(C * HEADS, N, fh, generator=gen)
        h[..., fh] = 1
        x["softmax"] = [
            (f"gat sg softmax sums C*heads={C * HEADS} N={N} "
             f"F={h.shape[2]} E={e_all}", (src, dst, w, h.to(dev)))]
    return x["softmax"]


def sg_softmax_checks(x):
    """The scatter-gather at the sg softmax's shapes against its plain
    version: two launches bitwise equal, both on the sort kernel, and every
    block_cols width that fits bitwise equal to the default.
    [(name, ok, text)]"""
    out = []
    for tag, args in sg_softmax_rows(x):
        before = sg_kernels.variant_launches["sort"]
        got = scatter_gather_aggregate(*args)
        again = scatter_gather_aggregate(*args)
        on = sg_kernels.variant_launches["sort"] == before + 2
        ok, text, _ = reading(got, scatter_gather_aggregate_ref(*args))
        widths = {bc: bool(torch.equal(got, scatter_gather_aggregate(
            *args, block_cols=bc)))
            for bc in sg_kernels.BLOCK_COLS_CANDIDATES
            if sg_kernels.sort_block_fits(N, args[0].shape[1], bc)}
        same = bool(torch.equal(got, again))
        out.append((f"sg {tag}", ok and same and on and all(
            widths.values()), f"{text}, repeat bitwise {same}, sort {on}, "
            f"block_cols bitwise {widths}"))
    return out


def gat_rows(x):
    """GAT's serving rows, 4 heads first, then 1, 2 and 8 (head widths 64,
    256, 128, 32): (tag, (z, s_src, s_dst, struct)). z and the scores are
    seed-1 normals; the structure is the real batch's (in-edges plus self
    loops, real columns only, as core/program.py builds it)."""
    if "gat" not in x:
        dev = x["mask"].device
        gen = torch.Generator().manual_seed(1)
        z = torch.randn(C, N, F_HID, generator=gen).to(dev)
        s = torch.randn(2, C, N, 8, generator=gen).to(dev)
        eye = torch.eye(N, device=dev)
        st = ((torch.sign(x["adj_mean"]) + eye)
              * x["mask"][:, None, :]).contiguous()
        x["gat"] = (z, s, st)
    z, s, st = x["gat"]
    nnz = int((st > 0).sum())
    return [(f"C={C} N={N} F={F_HID} heads={h} struct_nnz={nnz}",
             (z, s[0, ..., :h].contiguous(), s[1, ..., :h].contiguous(), st))
            for h in (HEADS, 1, 2, 8)]


def gat_checks(x):
    """Every check of ``gat_attention`` against its plain version:
    [(name, ok, text)]. The serving rows (each launched twice: bitwise
    equal, both on the slab kernel), N=200 on the slab kernel and N=320 on
    the row kernel, an empty row, a dense row, a row whose structural
    scores are all -inf (0) and a dense one (NaN), rows summing to one, and
    inf and NaN in z: outside the structure, behind a structural weight
    that underflows to 0, and behind one that is subnormal (the oracle's
    attn @ z: NaN exactly where the plain version has it)."""
    out = []
    dev = x["mask"].device

    def held(name, args, heads, variant, nan=False):
        before = gat_kernels.variant_launches[variant]
        got = gat_attention(*args, n_heads=heads)
        again = gat_attention(*args, n_heads=heads)
        want = gat_attention_ref(*args, n_heads=heads)
        if nan:
            ok, text = nan_reading(got, want)
        else:
            ok, text, _ = reading(got, want)
        same = bool(torch.equal(got.isnan(), again.isnan())
                    and torch.equal(got.nan_to_num(), again.nan_to_num()))
        on = gat_kernels.variant_launches[variant] == before + 2
        out.append((name, ok and same and on, f"{text}, repeat bitwise "
                    f"{same}, {variant} {on}"))
        return got

    rows = gat_rows(x)
    for tag, args in rows:
        held(f"gat {tag}", args, args[1].shape[-1], "slab")
    z, ss, sd, st = rows[0][1]
    cut = tuple(t[:8, :200, :200].contiguous() if t is st
                else t[:8, :200].contiguous() for t in (z, ss, sd, st))
    held("gat C=8 N=200 heads=4 (slab)", cut, HEADS, "slab")
    gen = torch.Generator().manual_seed(2)
    big = (torch.randn(4, 320, F_HID, generator=gen).to(dev),
           torch.randn(4, 320, HEADS, generator=gen).to(dev),
           torch.randn(4, 320, HEADS, generator=gen).to(dev),
           ((torch.rand(4, 320, 320, generator=gen) < 0.06).float()
            + torch.eye(320)).to(dev))
    held("gat C=4 N=320 heads=4 (row)", big, HEADS, "row")

    st2, sd2 = st.clone(), sd.clone()
    st2[:, 5, :] = 0.0                  # empty
    st2[:, 9, :] = 1.0                  # dense
    sd2[:, 11, :] = float("-inf")       # structural scores all -inf
    st2[:, 13, :] = 1.0                 # dense, all -inf: NaN
    sd2[:, 13, :] = float("-inf")
    got = held("gat empty, dense and all -inf rows", (z, ss, sd2, st2),
               HEADS, "slab", nan=True)
    zero = float(got[:, 5].abs().max()) == 0.0 \
        and float(got[:, 11].abs().max()) == 0.0
    nan13 = bool(torch.isnan(got[:, 13]).all())
    out.append(("gat empty and all -inf rows are 0, the dense all -inf row "
                "NaN", zero and nan13, f"rows 5, 11 zero {zero}, row 13 NaN "
                f"{nan13}"))

    ones = gat_attention(torch.ones(1, 32, 64, device=dev),
                         torch.zeros(1, 32, 1, device=dev),
                         torch.zeros(1, 32, 1, device=dev),
                         torch.ones(1, 32, 32, device=dev), n_heads=1)
    ok, text, _ = reading(ones, torch.ones_like(ones),
                          dict(rtol=1e-5, atol=0.0))
    out.append(("gat rows sum to one", ok, text))

    zb, ssb = z.clone(), ss.clone()
    zb[0, 7, 1] = float("inf")          # rows outside the structure
    zb[3, 100, 70] = float("nan")
    zb[5, N - 1, 200] = float("-inf")
    edges = torch.nonzero((st > 0) & ~torch.eye(N, dtype=torch.bool,
                                                device=dev))
    c, i, j = [int(v) for v in edges[len(edges) // 2]]
    ssb[c, j, 0] = -1e4                 # e ~ -2000 at (i, j): weight 0
    zb[c, j, 3] = float("inf")
    held(f"gat inf/NaN in z outside the structure and behind a weight that "
         f"underflows to 0 (subgraph {c}, {j} -> {i})", (zb, ssb, sd, st),
         HEADS, "slab", nan=True)

    zs = torch.randn(1, 32, 64, generator=gen).to(dev)
    s_src = torch.zeros(1, 32, 1, device=dev)
    s_src[0, 3, 0] = -475.0             # e = -95: exp subnormal, not 0
    zs[0, 3, :] = float("inf")
    st3 = torch.eye(32, device=dev)[None].contiguous()
    st3[0, 0, 3] = 1.0
    held("gat inf in z behind a subnormal weight", (zs, s_src,
         torch.zeros(1, 32, 1, device=dev), st3), 1, "slab", nan=True)
    return out


def gat_layer_args(x, c):
    """The fused step's inputs at C=``c`` (the serving batch's 64 subgraphs
    repeated): ``gat_rows``' z, seed-3 normals for a_src and a_dst [4, 64],
    the batch's adj_mean and mask, and the bias."""
    gat_rows(x)
    reps = c // C
    tile = lambda t: torch.cat([t] * reps).contiguous()  # noqa: E731
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(2, HEADS, F_HID // HEADS, generator=gen).to(
        x["mask"].device)
    return (tile(x["gat"][0]), a[0].contiguous(), a[1].contiguous(),
            tile(x["adj_mean"]), tile(x["mask"]), x["b"])


def gat_chain(args, act="elu"):
    """The unfused chain the fused launch replaces, as the program runs it
    apart: the score einsums, the structure, ``gat_attention`` and the
    bias, activation and row mask."""
    z, a_src, a_dst, adj, mask, b = args
    score = AttentionScore(n_heads=HEADS)
    soft = AttentionSoftmax(n_heads=HEADS, act=act, mode="dense",
                            b="b" if b is not None else None)
    p, regs = {"a_src": a_src, "a_dst": a_dst, "b": b}, {"z": z}
    batch = {"adj_mean": adj, "mask": mask}
    _step_attention_score(score)(p, regs, batch)
    _step_attention_softmax(soft, "cuda")(p, regs, batch)
    return regs["h"]


def gat_layer_checks(x):
    """Every check of ``gat_attention_layer`` (the slab kernel's fused form)
    on the card against its plain PyTorch composition
    (``gat_attention_layer_ref``: the score einsums, the structure, a plain
    softmax and einsum, the bias, activation and row mask) and against the
    unfused chain (the same steps with ``gat_attention``): [(name, ok,
    text)]. The serving batch at C=64 and C=512 with ELU and the bias, ReLU
    without it and no activation, N=200, and inf and NaN in z (NaN exactly
    where the plain version has it); each launched twice (bitwise equal,
    counted as fused)."""
    out = []

    def held(name, args, act="elu"):
        before = gat_kernels.fused_launches
        got = gat_attention_layer(*args, n_heads=HEADS, act=act)
        again = gat_attention_layer(*args, n_heads=HEADS, act=act)
        ok, text = nan_reading(
            got, gat_attention_layer_ref(*args, n_heads=HEADS, act=act))
        ok_chain, text_chain = nan_reading(got, gat_chain(args, act))
        same = bool(torch.equal(got.isnan(), again.isnan())
                    and torch.equal(got.nan_to_num(), again.nan_to_num()))
        on = gat_kernels.fused_launches == before + 2
        out.append((name, ok and ok_chain and same and on,
                    f"plain: {text}; chain: {text_chain}; repeat bitwise "
                    f"{same}, fused {on}"))

    args = gat_layer_args(x, C)
    held(f"gat layer C={C} elu +b", args)
    held(f"gat layer C={C} relu", (*args[:5], None), "relu")
    held(f"gat layer C={C} none", args, "none")
    held("gat layer C=512 elu +b", gat_layer_args(x, 512))
    z, a_src, a_dst, adj, mask, b = args
    held("gat layer C=8 N=200 elu +b",
         (z[:8, :200].contiguous(), a_src, a_dst,
          adj[:8, :200, :200].contiguous(), mask[:8, :200].contiguous(), b))
    zb = z.clone()
    zb[0, 7, 1] = float("inf")
    zb[3, 100, 70] = float("nan")
    zb[5, N - 1, 200] = float("-inf")
    held("gat layer inf/NaN in z", (zb, a_src, a_dst, adj, mask, b))
    return out


def gat_layer_row(x, c, label):
    """The fused launch timed in turns with the unfused chain at C=``c``,
    and its plain PyTorch composition timed after them (``cuda_ms``): a
    ``variants`` record of ``gat_attention`` (``variant`` "fused";
    ``max_abs_err`` against the plain composition)."""
    args = gat_layer_args(x, c)
    fns = {"fused": lambda: gat_attention_layer(*args, n_heads=HEADS),
           "chain": lambda: gat_chain(args)}
    t = turns(fns)
    plain_fn = lambda: gat_attention_layer_ref(  # noqa: E731
        *args, n_heads=HEADS)
    plain = cuda_ms(plain_fn)
    got, want = fns["fused"](), plain_fn()
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    cost = gat_layer_cost(*args, n_heads=HEADS)
    bnd, by = bound_ms(cost["hbm_bytes"], cost["flops"])
    tag = f"fused step C={c} N={N} F={F_HID} heads={HEADS}"
    print(f"  gat layer {tag}: fused {spread(t['fused']['host'])} / "
          f"{spread(t['fused']['graph'])} ms (host / graph), unfused chain "
          f"{spread(t['chain']['host'])} / {spread(t['chain']['graph'])} ms, "
          f"plain {plain:.4f} ms (host), max_abs_err {err:.3e} against "
          f"plain, bound {bnd:.4f} ms ({by}) [{label}]", flush=True)
    return dict(variant="fused", shape=tag, max_abs_err=err,
                ms=statistics.median(t["fused"]["host"]), plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None,
                graph_ms=statistics.median(t["fused"]["graph"]),
                chain_ms=statistics.median(t["chain"]["host"]),
                chain_graph_ms=statistics.median(t["chain"]["graph"]))


def run_checks(checks):
    for name, ok, text in checks:
        print(f"  {name}: {text} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name} disagrees with its plain version")


def fused_bound(args):
    """(ms, 'bytes' or 'operations'): inputs read once and the output
    written once over 3.35 TB/s, or three tf32 products of every
    multiply-add over 494.7 TFLOP/s (dense TF32), whichever is larger
    (``fused_cost``, which the launch analysis shares)."""
    c = fused_cost(*args)
    return bound_ms(c["hbm_bytes"], 3 * c["flops"], PEAK_TF32_FLOPS)


def fused_library(args, kw):
    """One chain of PyTorch calls that computes a fused row's function in
    h's dtype: the ``baddbmm`` chain (H.Wn by matmul, A.HW + b and H.Ws by
    baddbmm, then the activation and the mask)."""
    adj, h, wn, ws, b, m = args
    act = ACTS[kw.get("act", "relu")]
    a = adj.to(h.dtype) if adj is not None else None

    def fn():
        if wn is None:
            acc = torch.baddbmm(b, h, ws.expand(h.shape[0], -1, -1))
        else:
            acc = torch.baddbmm(b, a, torch.matmul(h, wn))
            if ws is not None:
                acc = torch.baddbmm(acc, h, ws.expand(h.shape[0], -1, -1))
        return act(acc) * m[..., None].to(h.dtype)
    return fn


def kernel_phase(x, dev, label):
    """Checks and times every kernel at the serving shapes of ``x``
    (``gnn_inputs``); returns {kernel: record} for the JSON line."""
    rec = {}

    print("[kernels] fused_gnn_layer", flush=True)
    run_checks(fused_checks(x))
    rows = []
    for tag, args, kw in fused_rows(x):
        err = closeness(fused_gnn_layer(*args, **kw),
                        fused_gnn_layer_ref(*args, **kw), KERNEL_TOL)[0]
        plain = cuda_ms(lambda: fused_gnn_layer_ref(*args, **kw))
        t = turns({"kernel": lambda: fused_gnn_layer(*args, **kw),
                   "baddbmm": fused_library(args, kw)}, iters=200)
        (ms, dev_ms), (lib, lib_dev) = (
            (statistics.median(t[n]["host"]), statistics.median(t[n]["graph"]))
            for n in ("kernel", "baddbmm"))
        bnd, by = fused_bound(args)
        print(f"  fused {tag}: medians [min-max] of 5 rounds in turns, ms "
              f"through the host / in a CUDA graph: kernel "
              f"{spread(t['kernel']['host'])} / "
              f"{spread(t['kernel']['graph'])}, baddbmm chain "
              f"{spread(t['baddbmm']['host'])} / "
              f"{spread(t['baddbmm']['graph'])}; kernel / chain "
              f"{ms / lib:.3f} / {dev_ms / lib_dev:.3f}; plain {plain:.4f} "
              f"ms, bound {bnd:.4f} ms ({by}) [{label}]", flush=True)
        rows.append(dict(shape=tag, max_abs_err=err, ms=ms, graph_ms=dev_ms,
                         plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=lib, library_graph_ms=lib_dev))
    for r in rows:
        check(r["ms"] <= r["library_ms"] and r["graph_ms"]
              <= r["library_graph_ms"],
              f"fused {r['shape']}: the kernel ({r['ms']:.4f} / "
              f"{r['graph_ms']:.4f} ms) is slower than the baddbmm chain "
              f"({r['library_ms']:.4f} / {r['library_graph_ms']:.4f} ms)")
    tag, args, kw = fused_rows(x)[0]                # gcn layer 0
    us = host_us(lambda: fused_gnn_layer(*args, **kw))
    split = cuda_ms(lambda: fused_kernels.tf32_split(args[2]))
    print(f"  fused {tag}: the wrapper's host time {us:.2f} us a call; "
          f"the weight's split (once a weight, tf32_split) {split:.4f} ms "
          f"[{label}]", flush=True)
    rec["fused_gnn_layer"] = dict(rows[0], host_us=us, split_ms=split,
                                  rows=rows[1:],
                                  served=fused_served_rows(dev, label))

    print("[kernels] scatter_gather_aggregate", flush=True)
    run_checks(sg_checks(x))
    run_checks(sg_softmax_checks(x))
    rows = []
    for tag, args in sg_rows(x) + sg_softmax_rows(x):
        err = closeness(scatter_gather_aggregate(*args),
                        scatter_gather_aggregate_ref(*args), KERNEL_TOL)[0]
        ms = cuda_ms(lambda: scatter_gather_aggregate(*args))
        plain = cuda_ms(lambda: scatter_gather_aggregate_ref(*args))
        lib = cuda_ms(sg_library(args))
        bnd, by = sg_bound(args)
        print(f"  sg {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib:.4f} ms, bound {bnd:.4f} ms ({by}) [{label}]",
              flush=True)
        rows.append((tag, err, ms, plain, lib, bnd, by))
    # the sort kernel at every block_cols that fits (autotune's knob), at
    # the serving widths and the sg softmax's
    by_cols = {}
    for tag, args in sg_rows(x)[:2] + sg_softmax_rows(x):
        e, f = args[0].shape[1], args[3].shape[2]
        by_cols[tag] = {
            bc: cuda_ms(lambda: scatter_gather_aggregate(
                *args, block_cols=bc))
            for bc in sg_kernels.BLOCK_COLS_CANDIDATES
            if sg_kernels.sort_block_fits(N, e, bc)}
        print(f"  sg {tag} by block_cols: " + ", ".join(
            f"{bc}: {t:.4f} ms" for bc, t in by_cols[tag].items())
            + f" (default {sg_kernels.sort_block_cols(N, e, f)}) "
            f"[{label}]",
            flush=True)
    tag, err, ms, plain, lib, bnd, by = rows[0]     # layer-0 width
    served = sg_served_rows(dev, label)
    args = sg_rows(x)[0][1]
    us = host_us(lambda: scatter_gather_aggregate(*args))
    print(f"  sg {tag}: the wrapper's host time {us:.2f} us a call "
          f"[{label}]", flush=True)
    rec["scatter_gather_aggregate"] = dict(
        shape=tag, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
        bound_by=by, library_ms=lib, block_cols_ms=by_cols, host_us=us,
        served=served)
    rec["softmax"] = [dict(shape=t, max_abs_err=e, ms=m, plain_ms=p,
                           bound_ms=b, bound_by=y, library_ms=l)
                      for t, e, m, p, l, b, y in rows[2:]]

    print("[kernels] gat_attention", flush=True)
    run_checks(gat_checks(x))
    tag, args = gat_rows(x)[0]                      # 4 heads
    err = closeness(gat_attention(*args, n_heads=HEADS),
                    gat_attention_ref(*args, n_heads=HEADS), KERNEL_TOL)[0]
    before = dict(gat_kernels.variant_launches)
    ms = cuda_ms(lambda: gat_attention(*args, n_heads=HEADS))
    variant = ",".join(k for k, n in gat_kernels.variant_launches.items()
                       if n > before[k])
    plain = cuda_ms(lambda: gat_attention_ref(*args, n_heads=HEADS))
    c = gat_cost(*args, n_heads=HEADS)
    bnd, by = bound_ms(c["hbm_bytes"], c["flops"])
    print(f"  gat {tag}: kernel {ms:.4f} ms ({variant}), plain {plain:.4f} "
          f"ms, library none, bound {bnd:.4f} ms ({by}) [{label}]",
          flush=True)
    rec["gat_attention"] = dict(shape=tag, variant=variant, max_abs_err=err,
                                ms=ms, plain_ms=plain, bound_ms=bnd,
                                bound_by=by, library_ms=None)
    print("[kernels] gat_attention_layer (the fused form)", flush=True)
    run_checks(gat_layer_checks(x))
    rec["gat_attention_layer"] = [gat_layer_row(x, c, label)
                                  for c in (C, 512)]
    return rec


def fused_served_rows(dev, label):
    """The fused layer in the GraphSAGE cell's sg Transform form: one
    self-only call on [z | h] with the weights stacked [W_neigh; W_self]
    (``core.program.stack_self_weights``), at C=512, N=256, Fout=256 and
    Fin 1024 (layer 0: f_in 500 padded to 512, twice) and 512 (the inner
    layers). Each is checked against ``fused_gnn_layer_ref``, launched twice
    (bitwise equal, both on tf32x3) and timed beside its plain version,
    the ``baddbmm`` chain and its bound. Returns the rows for the JSON
    line."""
    gen = torch.Generator().manual_seed(1)
    c, fo = SERVED_C, F_HID
    mask = (torch.arange(N)[None, :]
            < torch.randint(200, N + 1, (c, 1), generator=gen)).float()
    mask = mask.to(dev)
    b = (0.1 * torch.randn(fo, generator=gen)).to(dev)
    rows = []
    for part in (512, F_HID):
        fin = 2 * part
        x = torch.relu(torch.randn(c, N, fin, generator=gen)).to(dev) \
            * mask[..., None]
        w = torch.cat((dense_init(gen, (part, fo)),
                       dense_init(gen, (part, fo)))).to(dev)
        args = (None, x, None, w, b, mask)
        tag = (f"C={c} N={N} Fin={fin} ([z | h], {part} each) Fout={fo} "
               f"self-only, [W_neigh; W_self] (the sage cell's Transform)")
        before = fused_kernels.variant_launches["tf32x3"]
        got = fused_gnn_layer(*args)
        again = fused_gnn_layer(*args)
        tf32 = fused_kernels.variant_launches["tf32x3"] == before + 2
        ok, text, err = reading(got, fused_gnn_layer_ref(*args))
        same = bool(torch.equal(got, again))
        check(ok and same and tf32, f"fused {tag}: {text}, repeat bitwise "
              f"{same}, tf32x3 {tf32}")
        del got, again
        ms = cuda_ms(lambda: fused_gnn_layer(*args))
        plain = cuda_ms(lambda: fused_gnn_layer_ref(*args), iters=5)
        lib = cuda_ms(fused_library(args, {}), iters=5)
        bnd, by = fused_bound(args)
        print(f"  fused {tag}: kernel {ms:.4f} ms (tf32x3), plain "
              f"{plain:.4f} ms, baddbmm chain {lib:.4f} ms, bound "
              f"{bnd:.4f} ms ({by}), {100 * bnd / ms:.1f} % of it; {text}, "
              f"repeat bitwise {same} [{label}]", flush=True)
        rows.append(dict(shape=tag, variant="tf32x3", max_abs_err=err,
                         ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bnd, bound_by=by))
        del x, args
    return rows


def sg_served_rows(dev, label):
    """The scatter-gather at the GraphSAGE cell's served shape (C=512,
    N=256, F 512 and 256, the batch's edge slots, mean weights): checked
    against its plain version (two launches bitwise equal) and timed beside
    it, ``index_add_`` and its bound. Returns the rows for the JSON line."""
    t0 = time.perf_counter()
    graph = make_graph(SERVED_GRAPH, seed=SERVED_SEED)
    targets = zipf_traffic(graph, SERVED_C, seed=0)
    with DecoupledEngine(graph, GNNConfig(
            kind="sage", n_layers=LAYERS, receptive_field=N, f_in=F_IN,
            f_hidden=F_HID), config=ServingConfig(
            device="cuda", batch_size=SERVED_C, mode="sg",
            e_pad=N * (N - 1))) as eng:
        sb = eng.plan(targets).sb
    e, live = sb.edge_src.shape[1], int((sb.edge_w_mean != 0).sum())
    print(f"[data] sage/sg batch C={SERVED_C} N={N}: edge slots {e}, real "
          f"edges a subgraph mean {sb.n_edges.mean():.1f} max "
          f"{sb.n_edges.max()}, in {time.perf_counter() - t0:.2f} s",
          flush=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    feats = t(np.pad(sb.feats, ((0, 0), (0, 0), (0, 512 - F_IN))))
    src, dst, w = t(sb.edge_src), t(sb.edge_dst), t(sb.edge_w_mean)
    rows = []
    for f, h in ((512, feats), (F_HID, feats[..., :F_HID].contiguous())):
        args = (src, dst, w, h)
        tag = (f"C={SERVED_C} N={N} F={f} E={e} real_edges={live} "
               f"(the sage cell's batch)")
        got = scatter_gather_aggregate(*args)
        ok, text, err = reading(got, scatter_gather_aggregate_ref(*args))
        same = bool(torch.equal(got, scatter_gather_aggregate(*args)))
        check(ok and same, f"sg {tag}: {text}, repeat bitwise {same}")
        del got
        ms = cuda_ms(lambda: scatter_gather_aggregate(*args))
        plain = cuda_ms(lambda: scatter_gather_aggregate_ref(*args), iters=5)
        lib = cuda_ms(sg_library(args), iters=5)
        bnd, by = sg_bound(args)
        variant = sg_kernels.sg_variant(N, e)
        print(f"  sg {tag}: kernel {ms:.4f} ms ({variant}), plain "
              f"{plain:.4f} ms, library (index_add_) {lib:.4f} ms, bound "
              f"{bnd:.4f} ms ({by}); {text} [{label}]", flush=True)
        rows.append(dict(shape=tag, variant=variant, max_abs_err=err, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=bnd,
                         bound_by=by))
    return rows


# -- phase 3b: the scatter-gather's bucket kernel and the bf16 kernels -------


def big_batch(graph, targets):
    """A forced-sg batch of the Flickr-sized graph at N=1024 and C=8, as the
    engine plans it (no budget set: its edge slots follow its largest
    subgraph, default_edge_pad's 74,496 before)."""
    with DecoupledEngine(graph, GNNConfig(
            kind="gcn", n_layers=LAYERS, receptive_field=BIG_N, f_in=F_IN,
            f_hidden=F_HID), config=ServingConfig(
            device="cuda", batch_size=BIG_C, mode="sg")) as eng:
        sb = eng.plan(targets[:BIG_C]).sb
        e_pad = eng.e_pad
    print(f"[data] batch C={BIG_C} N={BIG_N} e_pad={e_pad} mean real edges "
          f"{sb.n_edges.mean():.1f}", flush=True)
    return sb


def sg_wide_rows(x, big, dev):
    """The bucket kernel's rows, (tag, (src, dst, w, h)): the serving batch's
    edge lists padded to 65,537 slots with weight-0 edges at N-1 (F=256),
    and the N=1024 batch (F=256: its first 256 feature columns)."""
    if "wide" not in x:
        pad = WIDE_E - x["src"].shape[1]
        fill = torch.full((C, pad), N - 1, dtype=torch.int32, device=dev)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        x["wide"] = [
            (f"C={C} N={N} F={F_HID} E={WIDE_E} (serving batch, padded)",
             (torch.cat([x["src"], fill], 1), torch.cat([x["dst"], fill], 1),
              torch.cat([x["w"], torch.zeros((C, pad), device=dev)], 1),
              x["feats"][..., :F_HID].contiguous())),
            (f"C={BIG_C} N={BIG_N} F={F_HID} E={big.edge_src.shape[1]} "
             f"real_edges={int((big.edge_w != 0).sum())}",
             (t(big.edge_src), t(big.edge_dst), t(big.edge_w),
              t(big.feats[..., :F_HID])))]
    return x["wide"]


def sg_edge_order(src, dst, w, h, n_out=None):
    """``scatter_gather_aggregate``'s function with each destination's live
    edges added one at a time in edge order, every product and every sum
    rounded to fp32 (the kernels' order), in plain PyTorch: one step a
    rank in the buckets. NaN where a weight-0 edge's source is non-finite.
    The kernels' outputs are bitwise this, NaN in the same places."""
    C, E = src.shape
    _, N, F = h.shape
    n = N if n_out is None else n_out
    dev = h.device
    s, d, wf = src.long(), dst.long(), w.float()
    at = torch.arange(C, device=dev)[:, None]
    inr = (s >= 0) & (s < N) & (d >= 0) & (d < n)
    live = inr & (wf != 0)
    key = torch.where(live, d + at * n, C * n).reshape(-1)
    order = torch.sort(key, stable=True).indices
    nlive = int(live.sum())
    order = order[:nlive]
    key = key[order]
    counts = torch.bincount(key, minlength=C * n)
    rank = torch.arange(nlive, device=dev) - (counts.cumsum(0) - counts)[key]
    by_rank = torch.sort(rank, stable=True).indices
    sizes = torch.bincount(rank).tolist() if nlive else []
    hs = h.float().reshape(C * N, F)
    fsrc = (s + at * N).reshape(-1)[order][by_rank]
    fw = wf.reshape(-1)[order][by_rank, None]
    fdst = key[by_rank]
    acc = torch.zeros(C * n, F, device=dev)
    p = 0
    for m in sizes:
        rows = fdst[p:p + m]
        acc[rows] = acc[rows] + hs[fsrc[p:p + m]] * fw[p:p + m]
        p += m
    zero = inr & (wf == 0)
    pairs = torch.unique(((s + at * N) * (C * n) + d + at * n)[zero])
    bad = torch.zeros(C * n, F, device=dev)
    bad.index_add_(0, pairs % (C * n),
                   (~torch.isfinite(hs[pairs // (C * n)])).float())
    acc[bad > 0] = float("nan")
    return acc.reshape(C, n, F).to(h.dtype)


def same_bits(got, want) -> bool:
    """Bitwise equal, NaN in the same places (any NaN payload)."""
    torch.cuda.synchronize()
    ng, nw = torch.isnan(got), torch.isnan(want)
    return bool(torch.equal(ng, nw)) and bool(torch.equal(got[~ng],
                                                          want[~nw]))


def sg_bucket_checks(x, big, dev):
    """The bucket kernel against its plain version: [(name, ok, text)]. Its
    rows (two launches bitwise equal, both on the bucket kernel, bitwise
    equal to ``sg_edge_order``), the N=1024 batch's first 512 destinations
    (n_out=512: the rows of the others dropped), and inf and NaN on the
    source row of the N=1024 batch's weight-0 padding edges (NaN exactly
    where the plain version puts it)."""
    out = []
    rows = sg_wide_rows(x, big, dev)
    src, dst, w, h = rows[1][1]
    for tag, args, n_out in [(t, a, None) for t, a in rows] + [
            (rows[1][0] + " n_out=512", rows[1][1], 512)]:
        check(sg_variant(args[3].shape[1], args[0].shape[1]) == "bucket",
              f"sg {tag}: not a shape of the bucket kernel")
        before = sg_kernels.variant_launches["bucket"]
        got = scatter_gather_aggregate(*args, n_out=n_out)
        again = scatter_gather_aggregate(*args, n_out=n_out)
        ok, text, _ = reading(got, scatter_gather_aggregate_ref(
            *args, n_out=n_out))
        same = bool(torch.equal(got, again))
        order = same_bits(got, sg_edge_order(*args, n_out))
        on = sg_kernels.variant_launches["bucket"] == before + 2
        out.append((f"sg bucket {tag}", ok and same and on and order,
                    f"{text}, repeat bitwise {same}, bitwise the edge-order "
                    f"sums {order}, bucket {on}"))
    h = h.clone()
    h[0, BIG_N - 1, 1] = float("inf")    # the padding edges' source
    h[3, BIG_N - 1, 7] = float("nan")
    h[5, BIG_N - 1, 200] = float("-inf")
    got = scatter_gather_aggregate(src, dst, w, h)
    ok, text = nan_reading(got, scatter_gather_aggregate_ref(src, dst, w, h))
    order = same_bits(got, sg_edge_order(src, dst, w, h))
    out.append((f"sg bucket N={BIG_N} weight-0 edges from inf/NaN sources",
                ok and order, f"{text}, bitwise the edge-order sums {order}"))
    return out


def bf16_args(adj, h, wn, ws, b, m):
    """A fused row's arguments with h, the weights and b in bf16."""
    bf = lambda t: None if t is None else t.to(torch.bfloat16)  # noqa: E731
    return (adj, bf(h), bf(wn), bf(ws), bf(b), m)


def fused_bf16_rows(x):
    """The fused layer's bf16 rows, (tag, args, kwargs, variant): the
    serving rows (wgmma_bf16), N=100 with Fin=200 (not a multiple of the
    kernel's 64-wide k-tile; rows past N in each box) in each form
    (wgmma_bf16), and Fin=500 (1,000-byte rows, which TMA cannot stride:
    cuda_core)."""
    rows = [(f"{tag} bf16", bf16_args(*args), kw, "wgmma_bf16")
            for tag, args, kw in fused_rows(x)]
    cc, n, fin = 5, 100, 200
    h = x["feats"][:cc, :n, :fin].contiguous()
    a = x["adj"][:cc, :n, :n].contiguous()
    m = x["mask"][:cc, :n].contiguous()
    wn, ws = (x[w][:fin].contiguous() for w in ("wn512", "ws512"))
    for form, args, kw in (("w_neigh", (a, h, wn, None, x["b"], m), {}),
                           ("+w_self", (a, h, wn, ws, x["b"], m),
                            dict(act="elu")),
                           ("self-only", (None, h, None, ws, x["b"], m),
                            dict(act="none"))):
        rows.append((f"C={cc} N={n} Fin={fin} Fout={F_HID} {form} bf16",
                     bf16_args(*args), kw, "wgmma_bf16"))
    h500 = x["feats"][:2, :64, :F_IN].contiguous()
    rows.append((f"C=2 N=64 Fin={F_IN} Fout={F_HID} +w_self bf16",
                 bf16_args(x["adj"][:2, :64, :64].contiguous(), h500,
                           x["w500"], x["w500"], x["b"],
                           x["mask"][:2, :64].contiguous()),
                 dict(act="elu"), "cuda_core"))
    return rows


def fused_bf16_checks(x):
    """Each bf16 row of the fused layer (``fused_bf16_rows``) against the
    plain version's fp32 result on the same bf16 inputs (``bf16_reading``:
    one bf16 ulp outside 2e-5, the reference's 2e-2; ``bf16_bias_ulp``: the
    mean signed error within 0.1 ulp, which a truncating store misses),
    output in bf16, two launches bitwise equal, both on the row's kernel.
    [(name, ok, text)]"""
    out = []
    for tag, args, kw, variant in fused_bf16_rows(x):
        before = dict(fused_kernels.variant_launches)
        got = fused_gnn_layer(*args, **kw)
        again = fused_gnn_layer(*args, **kw)
        ran = {k: n - before[k]
               for k, n in fused_kernels.variant_launches.items()}
        on = ran == {k: 2 if k == variant else 0 for k in ran}
        want = fused_gnn_layer_ref(*widened(args), **kw)
        ok, worst, err = bf16_reading(got, want)
        bias = bf16_bias_ulp(got, want)
        same = bool(torch.equal(got, again))
        out.append((f"fused_gnn_layer {tag}", ok and same and on
                    and abs(bias) <= BF16_BIAS_ULP
                    and got.dtype == torch.bfloat16,
                    f"max_abs_err={err:.3e} against the fp32 result, worst "
                    f"{worst} bf16 ulp outside 2e-5, mean signed error "
                    f"{bias:+.4f} ulp, repeat bitwise {same}, launches "
                    f"{ran} ({variant} expected)"))
    return out


def bf16_rows(x, big, dev):
    """The three GNN kernels' bf16 rows at the serving shapes: (kernel, tag,
    args, kwargs); h, z, the weights and b in bf16, the rest fp32."""
    bf = lambda t: None if t is None else t.to(torch.bfloat16)  # noqa: E731
    rows = [("fused_gnn_layer", f"{tag} bf16", bf16_args(*args), kw)
            for tag, args, kw in fused_rows(x)]
    for tag, (src, dst, w, h) in sg_rows(x) + sg_wide_rows(x, big, dev)[1:]:
        rows.append(("scatter_gather_aggregate", f"{tag} bf16",
                     (src, dst, w, bf(h)), {}))
    tag, (z, ss, sd, st) = gat_rows(x)[0]
    rows.append(("gat_attention", f"{tag} bf16", (bf(z), ss, sd, st),
                 dict(n_heads=HEADS)))
    return rows


def widened(args):
    """``args`` with every floating tensor in fp32 (the plain version's
    fp32 result on a bf16 row's inputs)."""
    return [a.float() if a is not None and a.is_floating_point() else a
            for a in args]


KERNELS_BY_NAME = {"fused_gnn_layer": (fused_gnn_layer, fused_gnn_layer_ref,
                                       fused_kernels),
                   "scatter_gather_aggregate": (
                       scatter_gather_aggregate,
                       scatter_gather_aggregate_ref, sg_kernels),
                   "gat_attention": (gat_attention, gat_attention_ref,
                                     gat_kernels)}


def bf16_checks(x, big, dev):
    """Each bf16 row against its plain version's fp32 result on the same
    (bf16) inputs: within one bf16 ulp of it rounded to bf16 outside the
    fp32 kernels' 2e-5 (``bf16_reading``), within the reference's 2e-2,
    output in bf16, two launches bitwise equal; the fused layer's rows as
    ``fused_bf16_checks``. [(name, ok, text)]"""
    out = fused_bf16_checks(x)
    for kernel, tag, args, kw in bf16_rows(x, big, dev):
        if kernel == "fused_gnn_layer":
            continue
        fn, ref, mod = KERNELS_BY_NAME[kernel]
        before = dict(mod.variant_launches)
        got = fn(*args, **kw)
        again = fn(*args, **kw)
        variant = ",".join(k for k, n in mod.variant_launches.items()
                           if n > before[k])
        ok, worst, err = bf16_reading(got, ref(*widened(args), **kw))
        same = bool(torch.equal(got.isnan(), again.isnan())
                    and torch.equal(got.nan_to_num(), again.nan_to_num()))
        out.append((f"{kernel} {tag}", ok and same
                    and got.dtype == torch.bfloat16,
                    f"max_abs_err={err:.3e} against the fp32 result, worst "
                    f"{worst} bf16 ulp outside 2e-5, repeat bitwise {same}, "
                    f"{variant}"))
    return out


def fused_bf16_bound(args):
    """(ms, by) of a bf16 fused call: its bytes, or its bf16 products over
    989 TFLOP/s plus A.HW's fp32 product (three tf32 products) over 494.7
    TFLOP/s, whichever is larger."""
    adj, h, wn, ws, b, mask = args
    Cc, Nn, fin = h.shape
    fout = (wn if wn is not None else ws).shape[1]
    t_ops = 2.0 * Cc * Nn * fin * fout * ((wn is not None) + (ws is not None)) \
        / PEAK_BF16_FLOPS
    if wn is not None:
        t_ops += 3 * 2.0 * Cc * Nn * Nn * fout / PEAK_TF32_FLOPS
    nb = nbytes(adj if wn is not None else None, h, wn, ws, b, mask) \
        + h.element_size() * Cc * Nn * fout
    t_bytes = nb / PEAK_BYTES_PER_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops \
        else (t_ops * 1e3, "operations")


def sg_bound(args, n_out=None):
    c = sg_cost(*args, n_out)
    return bound_ms(c["hbm_bytes"], c["flops"])


def sg_library(args, n_out=None):
    """``index_add_`` of the weighted source rows into the n_out (None: N)
    destination rows, in h's dtype (every destination of ``args`` lies
    below n_out)."""
    src, dst, w, h = args
    Cc, Nn, f = h.shape
    n = Nn if n_out is None else n_out
    at = torch.arange(Cc, device=h.device)[:, None]
    fs = (src.long() + at * Nn).reshape(-1)
    fd = (dst.long() + at * n).reshape(-1)
    wf = w.reshape(-1, 1).to(h.dtype)
    return lambda: torch.zeros(Cc * n, f, dtype=h.dtype,
                               device=h.device).index_add_(
        0, fd, h.reshape(Cc * Nn, f)[fs] * wf)


def variant_phase(graph, targets, x, dev, label):
    """Checks and times the scatter-gather's bucket kernel and the three GNN
    kernels in bf16; returns {kernel: [variant record]} for the JSON
    line."""
    big = big_batch(graph, targets)
    print("[kernels] scatter_gather_aggregate bucket", flush=True)
    run_checks(sg_bucket_checks(x, big, dev))
    print("[kernels] bf16", flush=True)
    run_checks(bf16_checks(x, big, dev))
    recs = {k: [] for k in KERNELS_BY_NAME}
    timed = [("scatter_gather_aggregate", f"bucket {tag}", args, {})
             for tag, args in sg_wide_rows(x, big, dev)] + \
        bf16_rows(x, big, dev)
    for kernel, tag, args, kw in timed:
        fn, ref, mod = KERNELS_BY_NAME[kernel]
        before = dict(mod.variant_launches)
        ms = cuda_ms(lambda: fn(*args, **kw))
        variant = ",".join(k for k, n in mod.variant_launches.items()
                           if n > before[k])
        plain = cuda_ms(lambda: ref(*args, **kw))
        got = fn(*args, **kw)
        if got.dtype == torch.bfloat16:
            err = bf16_reading(got, ref(*widened(args), **kw))[2]
        else:
            err = closeness(got, ref(*args, **kw), KERNEL_TOL)[0]
        if kernel == "fused_gnn_layer":
            act = ACTS[kw.get("act", "relu")]
            t = turns({"kernel": lambda: fn(*args, **kw),
                       "bf16": fused_library(args, kw),
                       "fp32": fused_bf16_library_fp32(args, act)},
                      iters=200)
            ms, lib, lib32 = (statistics.median(t[n]["host"])
                              for n in ("kernel", "bf16", "fp32"))
            bnd, by = fused_bf16_bound(args)
            lib_name = (f"baddbmm chain, bf16; {lib32:.4f} ms the chain "
                        f"with HW and A.HW in fp32 (mm out_dtype=float32, "
                        f"fp32 baddbmm)")
        elif kernel == "scatter_gather_aggregate":
            t = turns({"kernel": lambda: fn(*args, **kw),
                       "index_add_": sg_library(args)})
            ms, lib = (statistics.median(t[n]["host"])
                       for n in ("kernel", "index_add_"))
            bnd, by = sg_bound(args)
            lib_name = f"index_add_, {str(args[3].dtype)[6:]}"
            print(f"  scatter_gather_aggregate {tag}: medians [min-max] of "
                  f"5 rounds in turns, host / graph: kernel "
                  f"{spread(t['kernel']['host'])} / "
                  f"{spread(t['kernel']['graph'])} ms, index_add_ "
                  f"{spread(t['index_add_']['host'])} / "
                  f"{spread(t['index_add_']['graph'])} [{label}]",
                  flush=True)
        else:
            lib, lib_name = None, "none"
            c = gat_cost(*args, n_heads=HEADS)
            bnd, by = bound_ms(c["hbm_bytes"], c["flops"])
        print(f"  {kernel} {tag}: kernel {ms:.4f} ms ({variant}), plain "
              f"{plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'} ({lib_name}), "
              f"bound {bnd:.4f} ms ({by}) [{label}]", flush=True)
        rec = dict(variant=variant, shape=tag, max_abs_err=err, ms=ms,
                   plain_ms=plain, bound_ms=bnd, bound_by=by,
                   library_ms=lib)
        if kernel == "scatter_gather_aggregate":
            rec.update(graph_ms=statistics.median(t["kernel"]["graph"]),
                       library_graph_ms=statistics.median(
                           t["index_add_"]["graph"]))
        if kernel == "fused_gnn_layer":
            dev_ms, lib_dev, lib32_dev = (statistics.median(t[n]["graph"])
                                          for n in ("kernel", "bf16", "fp32"))
            rec.update(library_fp32_ms=lib32, graph_ms=dev_ms,
                       library_graph_ms=lib_dev,
                       library_fp32_graph_ms=lib32_dev)
            print(f"  fused_gnn_layer {tag}: medians [min-max] of 5 rounds "
                  f"in turns; through the host: kernel "
                  f"{spread(t['kernel']['host'])} ms, bf16 chain "
                  f"{spread(t['bf16']['host'])}, fp32-HW chain "
                  f"{spread(t['fp32']['host'])}; on the device (CUDA graph): "
                  f"kernel {spread(t['kernel']['graph'])} ms, bf16 chain "
                  f"{spread(t['bf16']['graph'])}, fp32-HW chain "
                  f"{spread(t['fp32']['graph'])}; kernel / bf16 chain "
                  f"{ms / lib:.3f} through the host, {dev_ms / lib_dev:.3f} "
                  f"on the device; kernel / fp32-HW chain {ms / lib32:.3f} / "
                  f"{dev_ms / lib32_dev:.3f} (target: no slower than the "
                  f"bf16 chain, both ways: {ms <= lib and dev_ms <= lib_dev})"
                  f" [{label}]", flush=True)
        recs[kernel].append(rec)
    return recs


def fused_bf16_library_fp32(args, act):
    """PyTorch calls that compute a bf16 fused row's function with HW and
    A.HW kept in fp32, as the kernel and the reference do: bf16 products
    with an fp32 output (``torch.mm(..., out_dtype=torch.float32)``), A.HW
    and the sums in fp32, one rounding to bf16."""
    adj, h, wn, ws, b, m = args
    Cc, Nn, fin = h.shape
    h2 = h.reshape(Cc * Nn, fin)

    def mm32(w):
        return torch.mm(h2, w, out_dtype=torch.float32).view(Cc, Nn, -1)

    def fn():
        acc = b.float().expand(Cc, Nn, -1)
        if wn is not None:
            acc = torch.baddbmm(acc, adj, mm32(wn))
        if ws is not None:
            acc = acc + mm32(ws)
        return (act(acc) * m[..., None]).to(h.dtype)
    return fn


# -- phase 4: flash_attention against its plain version --------------------


def flash_wgmma_check(name, q, k, v, causal=True):
    """Runs the wgmma kernel twice and holds it to ``flash_bf16_check``;
    returns the readings."""
    check(flash_variant(q.dtype, q.shape[-1], v.shape[-1]) == "wgmma",
          f"{name}: not a shape of the wgmma kernel")
    before = flash_kernels.variant_launches["wgmma"]
    out = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(flash_kernels.variant_launches["wgmma"] == before + 2,
          f"{name}: the wgmma kernel was not launched")
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               causal=causal)
    r = flash_bf16_check(out, again, want,
                         flash_bf16_tol(q, k, v, causal=causal))
    print(f"  {name}: max_abs_err={r['max_abs_err']:.3e}, worst "
          f"{r['worst']:.3f} of flash_bf16_tol, mean signed error "
          f"{r['bias_ulp']:+.4f} ulp, repeatable {r['repeatable']} "
          f"{'ok' if r['ok'] else 'FAIL'}", flush=True)
    check(r["ok"], f"{name} disagrees with its plain version")
    return r


def flash_phase(dev, label):
    """Checks both flash_attention kernels on the CPU tests' shapes and the
    wgmma kernel at phi3's prefill shape, timed there in turns with SDPA
    (``flash_row``); returns that record."""
    print("[kernels] flash_attention", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for b, h, kh, sq, sk, d in ((1, 2, 2, 64, 64, 32), (2, 1, 1, 128, 128, 64),
                                (1, 2, 2, 64, 128, 32),
                                (1, 3, 3, 1000, 1000, 64),
                                (1, 2, 2, 1000, 1000, 128),
                                (1, 2, 2, 1000, 777, 128),
                                (1, 4, 2, 1000, 1000, 128)):
        q, k, v = rnd((b, h, sq, d)), rnd((b, kh, sk, d)), rnd((b, kh, sk, d))
        for causal in (True, False):
            compare(f"flash cuda_core fp32 B={b} H={h} Kh={kh} Sq={sq} "
                    f"Sk={sk} D={d} causal={causal}",
                    flash_attention(q, k, v, causal=causal),
                    flash_attention_ref(q, k, v, causal=causal))
    q, k, v = (rnd((1, 4, 1000, 32), torch.bfloat16) for _ in range(3))
    check(flash_variant(q.dtype, 32) == "cuda_core", "bf16 D=32 variant")
    compare("flash cuda_core bf16 B=1 H=4 S=1000 D=32 causal",
            flash_attention(q, k, v), flash_attention_ref(q, k, v),
            FLASH_BF16_TOL, FLASH_BF16_EQUAL)
    for b, h, kh, sq, sk, d, causal in (
            (1, 1, 1, 128, 128, 128, True), (1, 2, 1, 128, 128, 64, True),
            (2, 4, 2, 1000, 1000, 128, True), (1, 4, 1, 1000, 777, 64, True),
            (1, 2, 2, 130, 300, 128, False), (2, 2, 1, 256, 256, 64, False)):
        q = rnd((b, h, sq, d), torch.bfloat16)
        k, v = (rnd((b, kh, sk, d), torch.bfloat16) for _ in range(2))
        flash_wgmma_check(f"flash wgmma B={b} H={h} Kh={kh} Sq={sq} Sk={sk} "
                          f"D={d} causal={causal}", q, k, v, causal)
    B, H, KH, S, D = 1, 40, 10, LM_SEQ, 128
    rec = flash_row(dev, label, "phi3", B, H, KH, S, D, True, 0)
    q = rnd((B, H, S, D), torch.bfloat16)
    k, v = (rnd((B, KH, S, D), torch.bfloat16) for _ in range(2))
    k4, v4 = (t.repeat_interleave(H // KH, dim=1) for t in (k, v))
    ms4 = cuda_ms(lambda: flash_attention(q, k4, v4), iters=20)
    lib4 = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k4, v4, is_causal=True), iters=20)
    print(f"  flash wgmma B={B} H={H} Kh={H} S={S} D={D} bf16 causal (K/V "
          f"repeated, PR 12's shape): kernel {ms4:.4f} ms, library "
          f"{lib4:.4f} ms [{label}]", flush=True)
    return rec


# -- phase 5: the serving path ---------------------------------------------


def engine_phase(graph, targets, label):
    """Serves every (model, mode) through the kernels, then through plain
    PyTorch, and compares. Returns the main path's launch counts, and its
    gat_attention launches of the fused form (``gat_attention_fused``)."""
    outs, params = {}, {}
    ops.reset_launch_counts()
    for kind in ("gcn", "sage", "gat"):
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        params[kind] = init_gnn(cfg, seed=0, device="cuda")
        for mode in ("dense", "sg"):
            conf = ServingConfig(device="cuda", batch_size=C, mode=mode,
                                 impl="cuda")
            with DecoupledEngine(graph, cfg, params=params[kind],
                                 config=conf) as eng:
                before = ops.launch_counts()
                sums0 = sg_kernels.caller_launches.get(SG_SOFTMAX_SUMS, 0)
                eng.infer(targets[:C])                   # warm-up batch
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                res = eng.infer(targets)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                after = ops.launch_counts()
                sums = sg_kernels.caller_launches.get(SG_SOFTMAX_SUMS, 0) \
                    - sums0
            st = res.stats
            per = [h + d for h, d in zip(st.host_times, st.device_times)]
            delta = {k: after[k] - before[k] for k in after}
            want = {k: EXPECTED[kind, mode].get(k, 0) * (N_BATCHES + 1)
                    for k in after}
            check(res.embeddings.shape == (len(targets), F_HID)
                  and np.isfinite(res.embeddings).all(),
                  f"{kind}/{mode}: bad embeddings")
            check(delta == want, f"{kind}/{mode}: launches {delta}, "
                                 f"expected {want}")
            # gat/sg's scatter-gather launches are its softmax sums, one
            # a layer; no other engine makes them
            want_sums = delta["scatter_gather_aggregate"] \
                if (kind, mode) == ("gat", "sg") else 0
            check(sums == want_sums, f"{kind}/{mode}: {sums} softmax-sum "
                                     f"launches, expected {want_sums}")
            print(f"[engine] {kind}/{mode}: {N_BATCHES} batches x C={C}, "
                  f"p50 batch host+device {statistics.median(per)*1e3:.2f} "
                  f"ms (p50 device {statistics.median(st.device_times)*1e3:.2f}"
                  f" ms), wall/batch {st.t_wall/N_BATCHES*1e3:.2f} ms, "
                  f"overlap {st.overlap_fraction:.3f}, peak device memory "
                  f"{peak/2**20:.1f} MiB, launches/batch "
                  f"{ {k: v // (N_BATCHES + 1) for k, v in delta.items()} }, "
                  f"host stage totals "
                  f"{ {k: round(v, 4) for k, v in st.stage_times.items()} } "
                  f"s [{label}]", flush=True)
            outs[kind, mode] = res.embeddings
    main_path = ops.launch_counts()
    variants = dict(fused_kernels.variant_launches)
    print(f"[engine] fused_gnn_layer launches by kernel over the six "
          f"engines: {variants}; by (kernel, Fin, form): "
          f"{ {' '.join(map(str, k)): n for k, n in sorted(fused_kernels.form_launches.items())} } "
          f"[{label}]", flush=True)
    check(variants == {"tf32x3": main_path["fused_gnn_layer"],
                       "wgmma_bf16": 0, "cuda_core": 0},
          f"fused_gnn_layer launches by kernel {variants}, expected all "
          f"{main_path['fused_gnn_layer']} on the tf32x3 kernel")
    gat_split = dict(gat_kernels.variant_launches)
    print(f"[engine] gat_attention launches by kernel over the six engines: "
          f"{gat_split} (gat_variant({N}, {F_HID}, {HEADS}, aligned=True) "
          f"= {gat_variant(N, F_HID, HEADS, aligned=True)!r}) [{label}]",
          flush=True)
    check(gat_split == {"slab": main_path["gat_attention"], "row": 0},
          f"gat_attention launches by kernel {gat_split}, expected all "
          f"{main_path['gat_attention']} on the slab kernel")
    fused = (gat_kernels.fused_launches, gat_kernels.fused_fallbacks)
    print(f"[engine] gat_attention fused launches, unfused attention steps: "
          f"{fused} [{label}]", flush=True)
    check(fused == (main_path["gat_attention"], 0),
          f"gat/dense's attention steps: {fused} fused and unfused, "
          f"expected all {main_path['gat_attention']} fused")
    sg_split = dict(sg_kernels.variant_launches)
    print(f"[engine] scatter_gather_aggregate launches by kernel over the six "
          f"engines: {sg_split} [{label}]", flush=True)
    check(sg_split == {"sort": main_path["scatter_gather_aggregate"],
                       "bucket": 0},
          f"scatter_gather_aggregate launches by kernel {sg_split}, expected "
          f"all {main_path['scatter_gather_aggregate']} on the sort kernel")
    for (kind, mode), got in outs.items():
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        conf = ServingConfig(device="cuda", batch_size=C, mode=mode,
                             impl="torch")
        with DecoupledEngine(graph, cfg, params=params[kind],
                             config=conf) as eng:
            want = eng.infer(targets).embeddings
        err = float(np.abs(got - want).max())
        rel = float((np.abs(got - want) / (np.abs(want) + 1e-6)).max())
        ok = np.allclose(got, want, **ENGINE_TOL)
        print(f"[engine] {kind}/{mode} cuda vs torch: max_abs_err "
              f"{err:.3e}, max_rel_err {rel:.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"{kind}/{mode}: kernels disagree with plain PyTorch")
    check(ops.launch_counts() == main_path,
          "the impl='torch' engines launched a kernel")
    return dict(main_path, gat_attention_fused=fused[0])


# -- phase 5b: the multi-model server ----------------------------------------


def serve_phase(graph, label):
    """One GNNServer on the Flickr-sized graph serving GCN (sg:
    scatter_gather_aggregate), GraphSAGE (dense, resident store: the fused
    layer's A.(H.W)+H.Ws form) and GAT (dense: gat_attention) under one H100
    DSE plan; 3 x 192 Zipf(1.1) requests routed by model. Checks every
    embedding against the same engine's infer, the launch counts against the
    lanes' batches, and that a model outside the plan raises PlanViolation
    at register. Returns the server path's launch counts."""
    engines = {}
    for kind, lane in SERVE_LANES.items():
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        engines[kind] = DecoupledEngine(graph, cfg, config=ServingConfig(
            device="cuda", batch_size=C, mode=lane["mode"], impl="cuda",
            store=StorePolicy(features=lane.get("features", "dense"))))
    srv = GNNServer()
    for kind, eng in engines.items():
        srv.register(kind, eng)
    plan = srv.plan
    print(f"[serve] plan (H100 DSE over {', '.join(engines)}): block_f="
          f"{plan.block_f} c_core={plan.c_core} smem_used={plan.smem_used} "
          f"bytes a block, ops_ok={plan.ops_ok} [{label}]", flush=True)
    refused = GNNConfig(kind="gat", n_layers=2, receptive_field=8192,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
    reasons = plan_covers(plan, refused, H100Spec())
    check(bool(reasons), "plan_covers takes GAT at N=8192")
    with DecoupledEngine(graph, refused, config=ServingConfig(
            device="cuda", batch_size=1)) as eng:
        try:
            srv.register("gat-8192", eng)
        except PlanViolation as e:
            print(f"[serve] register GAT N=8192: PlanViolation ({e}) ok",
                  flush=True)
        else:
            check(False, "register took a model outside the plan")
    rng = np.random.default_rng(3)
    traffic = {k: zipf_traffic(graph, SERVE_REQUESTS, a=1.1,
                               seed=int(rng.integers(1 << 30)))
               for k in engines}
    order = [(k, int(t)) for i in range(SERVE_REQUESTS)
             for k, ts in traffic.items() for t in ts[i:i + 1]]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    srv.start()
    reqs = [srv.submit(t, model=k) for k, t in order]
    srv.drain(reqs, timeout=600)
    srv.stop()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    served = ops.launch_counts()
    variants = {name: dict(m.variant_launches) for name, m in
                (("fused", fused_kernels), ("sg", sg_kernels),
                 ("gat", gat_kernels))}
    rep = srv.report()
    batches = {k: srv.model_stats(k).n_batches for k in engines}
    want = {k: 0 for k in served}
    for kind, lane in SERVE_LANES.items():
        for kname, n in EXPECTED[kind, lane["mode"]].items():
            want[kname] += n * batches[kind]
    print(f"[serve] {len(reqs)} requests in {wall:.2f} s wall; batches "
          f"{batches}; launches {served} (expected {want}); by kernel "
          f"{variants} [{label}]", flush=True)
    check(served == want, f"server launches {served}, expected {want}")
    check(variants["fused"]["tf32x3"] == served["fused_gnn_layer"]
          and variants["sg"]["sort"] == served["scatter_gather_aggregate"]
          and variants["gat"]["slab"] == served["gat_attention"],
          f"server launches by kernel {variants}: expected every fused "
          f"launch on tf32x3, every sg launch on sort, every GAT on slab")
    for kind in engines:
        m = rep["models"][kind]
        lat, st = m["latency"], m["store"]
        print(f"[serve] {kind} ({SERVE_LANES[kind]['mode']}, "
              f"{st['features']['strategy']} store): n={lat['n']} p50 "
              f"{lat['p50'] * 1e3:.2f} ms p90 {lat['p90'] * 1e3:.2f} ms p99 "
              f"{lat['p99'] * 1e3:.2f} ms, overlap "
              f"{m['stages']['overlap']:.3f}, bytes shipped "
              f"{st['bytes_shipped']} of {st['bytes_dense']} dense "
              f"({st['bytes_shipped'] / max(1, m['stages']['batches']):.0f}"
              f" a batch, transfer ratio {st['transfer_ratio']}) [{label}]",
              flush=True)
        check(lat["n"] == SERVE_REQUESTS, f"{kind}: {lat['n']} answered")
    res = rep["models"]["sage"]["store"]
    dense = rep["models"]["gat"]["store"]
    print(f"[serve] resident store (sage): {res['features']['device_bytes']}"
          f" bytes on the card, hit rate "
          f"{res['features']['resident_hit_rate']}; a batch ships "
          f"{res['bytes_shipped'] / rep['models']['sage']['stages']['batches']:.0f}"
          f" bytes against "
          f"{dense['bytes_shipped'] / rep['models']['gat']['stages']['batches']:.0f}"
          f" for the dense store (gat) [{label}]", flush=True)
    for kind, eng in engines.items():
        mine = [r for r in reqs if r.model == kind]
        got = np.stack([r.embedding for r in mine])
        want_emb = eng.infer(np.array([r.target for r in mine])).embeddings
        err = float(np.abs(got - want_emb).max())
        ok = got.shape == (SERVE_REQUESTS, F_HID) \
            and np.isfinite(got).all() \
            and np.allclose(got, want_emb, **ENGINE_TOL)
        print(f"[serve] {kind} server vs the engine's infer: max_abs_err "
              f"{err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kind}: served embeddings disagree with infer")
        eng.close()
    return served


def repeatability_phase(graph, targets, label):
    """Two device steps of one planned gat/sg and gcn/sg batch, under
    impl="torch" and impl="cuda": whether the two are bitwise equal, and
    their largest difference. Under impl="cuda" every sg sum runs on the
    scatter-gather kernel, and the two steps must be bitwise equal; the
    plain sg paths (gnn/layers.py agg_sg, core/program.py's sg softmax)
    sum with ``index_add_``, reported only."""
    for kind, impl in (("gat", "torch"), ("gcn", "torch"), ("gat", "cuda"),
                       ("gcn", "cuda")):
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        with DecoupledEngine(graph, cfg, params=init_gnn(
                cfg, seed=0, device="cuda"), config=ServingConfig(
                device="cuda", batch_size=C, mode="sg", impl=impl)) as eng:
            plan = eng.plan(targets[:C])
            a = eng.run_device(plan).clone()
            b = eng.run_device(plan).clone()
            torch.cuda.synchronize()
            step = statistics.median(
                _timed(lambda: eng.run_device(plan))[1] for _ in range(5))
        same = bool(torch.equal(a, b))
        diff = float((a - b).abs().max())
        print(f"[repeat] {kind}/sg impl={impl}: two device steps of one "
              f"batch bitwise equal {same}, max |difference| {diff:.3e}, "
              f"share of elements equal {float((a == b).float().mean()):.6f}"
              f"{' ok' if same else (' FAIL' if impl == 'cuda' else '')}; "
              f"device step (run_device + synchronize) p50 of 5 "
              f"{step * 1e3:.3f} ms [{label}]", flush=True)
        if impl == "cuda":
            check(same, f"{kind}/sg impl=cuda: two device steps differ")


# -- phase 5d: per-batch adaptive dispatch -----------------------------------


def program_launches(prog) -> dict:
    """Kernel launches of one batch through the specialized ``prog`` under
    impl="cuda", read off its step list: a fused group or a Transform
    (with w_self: on [z | h]) is one fused launch, an sg Aggregate one
    scatter-gather,
    a dense AttentionSoftmax (alone, or grouped with its scores) one
    gat_attention, an sg one scatter-gather (its segment sums)."""
    out = dict.fromkeys(REPLACES, 0)
    for seq, times in ((prog.layer0, 1), (prog.inner, prog.n_layers - 1)):
        for ops_, _ in compile_steps(seq, "cuda"):
            head, last = ops_[0], ops_[-1]
            if isinstance(last, AttentionSoftmax):
                if last.mode == "dense":
                    out["gat_attention"] += times
                else:
                    out["scatter_gather_aggregate"] += times
            elif len(ops_) > 1 or isinstance(head, Transform):
                out["fused_gnn_layer"] += times
            elif isinstance(head, Aggregate) and head.mode == "sg":
                out["scatter_gather_aggregate"] += times
    return out


def sort_widths(prog, block_cols, e_slots) -> dict:
    """The sort kernel's launches of one batch through ``prog`` under
    impl="cuda" with ``blocks={"block_cols": block_cols}``, by columns a
    block: the sg Aggregates take ``block_cols``, the sg softmax's sums
    the default at their width (a head's columns and the ones column,
    padded to a multiple of 4)."""
    out = dict.fromkeys(sg_kernels.BLOCK_COLS_CANDIDATES, 0)
    fh = F_HID // HEADS
    soft = sg_kernels.sort_block_cols(N, e_slots + N, fh // 4 * 4 + 4)
    for seq, times in ((prog.layer0, 1), (prog.inner, prog.n_layers - 1)):
        for ops_, _ in compile_steps(seq, "cuda"):
            head = ops_[0]
            if isinstance(head, Aggregate) and head.mode == "sg":
                out[block_cols] += times
            elif isinstance(head, AttentionSoftmax) and head.mode == "sg":
                out[soft] += times
    return out


def span_decisions(spans) -> list:
    """Each traced batch's dispatch, in submission order, from its device
    span: (source, {site: mode}, blocks text)."""
    dev = sorted((s for s in spans if s["name"] == "device"),
                 key=lambda s: s["args"]["seq"])
    return [(s["args"]["dispatch_source"],
             dict(kv.split("=") for kv in
                  s["args"]["dispatch_modes"].split(",")),
             s["args"]["dispatch_blocks"]) for s in dev]


def dispatch_checks(kind, program, table, bucket, e_slots, spans, tree,
                    reports):
    """Checks (3)-(5) of the [dispatch] phase on the exploring engine:
    [(name, ok, text)]."""
    out = []
    missing = []
    sites = mux_sites(program)
    for sec, _ in program.layer_sections():
        for mode in ("dense", "sg"):
            seq = getattr(respecialize(program, {
                s: mode for s in sites if s.startswith(sec)}), sec)
            for ops_, _ in compile_steps(seq, "cuda"):
                if any(o.mux for o in ops_) and table.lookup(
                        op_label(ops_), op_mode(ops_, "cuda"),
                        bucket) is None:
                    missing.append(f"{sec}:{op_label(ops_)}/{mode}")
    fitting = [bc for bc in sg_kernels.BLOCK_COLS_CANDIDATES
               if sg_kernels.sort_block_fits(N, e_slots, bc)]
    bc_missing = [bc for bc in fitting if table.lookup(
        "scatter_gather", f"cuda/bc={bc}", bucket) is None]
    out.append((f"{kind} calibration cells", not missing and not bc_missing
                and bool(fitting), f"mux op cells missing {missing}, sort "
                f"bc cells missing {bc_missing} of {fitting}"))
    fails = [r["explore_failures"] for r in reports]
    out.append((f"{kind} explore_failures", fails == [0] * len(fails),
                f"{fails} (dispatch, trace)"))
    problems = validate_chrome_trace(tree)
    lacking = []
    for tid in sorted({s["trace_id"] for s in spans
                       if s["name"] == "batch"}):
        names = {s["name"] for s in spans if s["trace_id"] == tid}
        if not {"select", "build", "pack", "device"} <= names:
            lacking.append(sorted(names))
    out.append((f"{kind} trace export", not problems and not lacking,
                f"validator problems {problems[:3]}, batches lacking a "
                f"station span {lacking}"))
    return out


def served_sg_checks(kind, graph, cfg, params, static, e_slots, chunk,
                     twin_sg):
    """An sg variant served through the variant cache with a block_cols
    that is not the default: an adaptive engine whose table prices every
    sg step below its dense twin and the sort kernel's narrowest width
    below the others serves ``chunk`` all-sg at that width. Its embeddings
    must equal ``twin_sg`` (the engine with dispatch off, respecialized
    all-sg, default widths) bitwise, and its launches the variant's, width
    by width. [(name, ok, text)]"""
    narrow = sg_kernels.BLOCK_COLS_CANDIDATES[-1]
    sites = mux_sites(static)
    bucket = size_bucket({"mask": torch.empty(C, N)})
    with DecoupledEngine(graph, cfg, params=params, config=ServingConfig(
            device="cuda", batch_size=C, impl="cuda",
            dispatch=DispatchConfig(warmup_passes=0, autotune_blocks=True,
                                    save_on_close=False))) as eng:
        table = eng.dispatch.table
        for sec, _ in static.layer_sections():
            for mode, cost in (("dense", 1e-3), ("sg", 1e-6)):
                seq = getattr(respecialize(static, {
                    s: mode for s in sites if s.startswith(sec)}), sec)
                for ops_, _ in compile_steps(seq, "cuda"):
                    table.record(op_label(ops_), op_mode(ops_, "cuda"),
                                 bucket, cost)
        for bc in sg_kernels.BLOCK_COLS_CANDIDATES:
            if sg_kernels.sort_block_fits(N, e_slots, bc):
                table.record("scatter_gather", f"cuda/bc={bc}", bucket,
                             1e-6 if bc == narrow else 1e-3)
        ops.reset_launch_counts()
        got = eng.infer(chunk).embeddings
        torch.cuda.synchronize()
        launched = ops.launch_counts()
        widths = dict(sg_kernels.width_launches)
        rep = eng.dispatch_report()
    variant = respecialize(static, {s: "sg" for s in sites})
    want = program_launches(variant)
    want_w = sort_widths(variant, narrow, e_slots)
    served = (rep["sources"]["measured"] == 1 and rep["blocks"]
              == {"block_cols": narrow})
    print(f"[dispatch] {kind} served sg variant: sources {rep['sources']}, "
          f"blocks {rep['blocks']}, launches {launched}, sort launches by "
          f"width {widths}", flush=True)
    return [(f"{kind} served sg variant at block_cols={narrow} == forced sg",
             served and bool(np.array_equal(got, twin_sg)),
             f"decision {rep['sources']} {rep['blocks']}, bitwise "
             f"{bool(np.array_equal(got, twin_sg))}"),
            (f"{kind} served sg variant's launches",
             launched == want and widths == want_w,
             f"{launched} (variant's {want}), widths {widths} (variant's "
             f"{want_w})")]


def dispatch_phase(graph, label):
    """Per-batch adaptive dispatch on the card for GCN, GraphSAGE and GAT
    (see the module docstring, 10); returns the phase's launch counts."""
    shutil.rmtree(CALIB_DIR, ignore_errors=True)
    CALIB_DIR.mkdir(parents=True)
    tgt = zipf_traffic(graph, DISPATCH_BATCHES * C, a=1.1, seed=5)
    chunks = [tgt[i:i + C] for i in range(0, len(tgt), C)]
    total = dict.fromkeys(REPLACES, 0)

    def take():
        """Add the launches since the last reset to the phase's total and
        zero the counters."""
        for k, n in ops.launch_counts().items():
            total[k] += n
        ops.reset_launch_counts()

    ops.reset_launch_counts()
    for kind in ("gcn", "sage", "gat"):
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        params = init_gnn(cfg, seed=0, device="cuda")
        art = str(CALIB_DIR / kind)

        def engine(trace=None, save=True):
            return DecoupledEngine(graph, cfg, params=params,
                                   config=ServingConfig(
                device="cuda", batch_size=C, impl="cuda", trace=trace,
                dispatch=DispatchConfig(warmup_passes=2,
                                        autotune_blocks=True, artifact=art,
                                        save_on_close=save)))

        # the exploring engine: calibration on every traced batch, warm-up
        # passes, block autotune; its close() saves the table
        with engine(TraceConfig(calibrate_every=1)) as eng:
            t0 = time.perf_counter()
            res = eng.infer(tgt).embeddings
            wall = time.perf_counter() - t0
            spans = eng.tracer.export_spans()
            tree = eng.export_trace(str(CALIB_DIR / f"{kind}.trace.json"))
            drep, trep = eng.dispatch_report(), eng.trace_report()
            table, program = eng.dispatch.table, eng.program
            bucket = size_bucket({"mask": torch.empty(C, N)})
            e_slots = eng.e_pad
        for mode in ("dense", "sg"):
            got = program_launches(respecialize(
                program, {s: mode for s in mux_sites(program)}))
            want = {k: EXPECTED[kind, mode].get(k, 0) for k in got}
            check(got == want, f"{kind}/{mode}: program_launches {got}, "
                               f"EXPECTED {want}")
        run_checks(dispatch_checks(kind, program, table, bucket, e_slots,
                                   spans, tree, (drep, trep)))
        decisions = span_decisions(spans)
        for i, (src, asg, blocks) in enumerate(decisions):
            print(f"[dispatch] {kind} batch {i}: {src} "
                  f"{','.join(f'{k}={v}' for k, v in sorted(asg.items()))}"
                  f" blocks {{{blocks}}} [{label}]", flush=True)
        measured = sum(src == "measured" for src, _, _ in decisions)
        check(len(decisions) == DISPATCH_BATCHES and measured >= 3,
              f"{kind}: {measured} of {len(decisions)} batches on measured "
              f"decisions, expected at least 3")
        for row in table.rows():
            print(f"[dispatch] {kind} cell {row['op']} {row['mode']} bucket "
                  f"{row['size_bucket']}: p50 {row['p50_s'] * 1e3:.4f} ms "
                  f"(n={row['count']}) [{label}]", flush=True)
        print(f"[dispatch] {kind} exploring engine: {DISPATCH_BATCHES} "
              f"batches in {wall:.2f} s, sources {drep['sources']}, "
              f"variants {drep['variants']}, blocks {drep['blocks']}, "
              f"table {drep['table_cells']} cells, "
              f"{drep['table_passes']} passes [{label}]", flush=True)

        # the twin: untraced, dispatch off, its program respecialized per
        # batch; it ships the adaptive engine's payload union (unused
        # arrays change nothing)
        twin = DecoupledEngine(graph, cfg, params=params, config=ServingConfig(
            device="cuda", batch_size=C, impl="cuda"))
        static = twin.program
        twin.adj_keys = required_adjacency(lower(cfg))
        twin.needs_edges = True
        twin_out = {}

        def forced(i, asg):
            key = (i, tuple(sorted(asg.items())))
            if key not in twin_out:
                twin.program = respecialize(static, asg)
                twin_out[key] = twin.infer(chunks[i]).embeddings
            return twin_out[key]

        same = [bool(np.array_equal(res[i * C:(i + 1) * C], forced(i, asg)))
                for i, (_, asg, _) in enumerate(decisions)]
        run_checks([(f"{kind} adaptive == forced, batch by batch",
                     all(same), f"bitwise {same}")])

        # restarted from the artifact: untraced and traced (no calibration,
        # so neither table moves and both take the same decisions)
        take()
        with engine(save=False) as eng:
            res_b = eng.infer(tgt).embeddings
            torch.cuda.synchronize()
            launched = ops.launch_counts()
            by_kernel = {n: dict(m.variant_launches) for n, m in
                         (("fused", fused_kernels), ("sg", sg_kernels),
                          ("gat", gat_kernels))}
            rep_b = eng.dispatch_report()
            with engine(TraceConfig(), save=False) as traced:
                res_c = traced.infer(tgt).embeddings
                dec_c = span_decisions(traced.tracer.export_spans())
            plans = [eng.plan(ch) for ch in chunks[:DISPATCH_TIMED]]
            times = {"on": [], "off": []}
            twin.program = static
            for p in plans:
                for which in ("on", "off", "off", "on"):
                    e = eng if which == "on" else twin
                    times[which].append(_timed(lambda: e.run_device(p))[1])
        want = dict.fromkeys(launched, 0)
        for _, asg, _ in dec_c:
            for k, n in program_launches(respecialize(static, asg)).items():
                want[k] += n
        first = rep_b["sources"]
        run_checks([
            (f"{kind} restarted from the artifact: first decision measured",
             first["measured"] == rep_b["decisions"] == DISPATCH_BATCHES,
             f"sources {first}"),
            (f"{kind} traced == untraced", bool(np.array_equal(res_b, res_c))
             and all(src == "measured" for src, _, _ in dec_c),
             f"bitwise {bool(np.array_equal(res_b, res_c))}, traced "
             f"sources {[src for src, _, _ in dec_c]}"),
            (f"{kind} restarted engine == forced", all(
                np.array_equal(res_c[i * C:(i + 1) * C], forced(i, asg))
                for i, (_, asg, _) in enumerate(dec_c)), "bitwise"),
            (f"{kind} launches of the served variants",
             launched == want
             and by_kernel["fused"]["tf32x3"] == launched["fused_gnn_layer"]
             and by_kernel["gat"]["slab"] == launched["gat_attention"],
             f"{launched} (variants' {want}), by kernel {by_kernel}")])
        twin_sg = forced(0, {s: "sg" for s in mux_sites(static)})
        take()
        run_checks(served_sg_checks(kind, graph, cfg, params, static, e_slots,
                                    chunks[0], twin_sg))
        twin.close()
        on, off = (statistics.median(times[k]) for k in ("on", "off"))
        print(f"[dispatch] {kind} device step (run_device + synchronize, "
              f"{len(plans)} planned batches x 2 each): dispatch on "
              f"{on * 1e3:.3f} ms p50 (served {dec_c[0][1]}), off "
              f"{off * 1e3:.3f} ms p50 (static "
              f"{dict((s, m.mode) for s, m in static.ops if m.mux)}); "
              f"restarted engine's variants {rep_b['variants']} [{label}]",
              flush=True)
    take()
    return total


# -- phase 5e: the sharded feature store -------------------------------------


def _infer(eng, targets):
    """(embeddings, p50 device time in s, launches by kernel a batch) of
    one ``infer`` call with the launch counters read around it."""
    before = ops.launch_counts()
    res = eng.infer(targets)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    n = len(res.stats.device_times)
    per = {k: (after[k] - before[k]) / n for k in after}
    return res.embeddings, statistics.median(res.stats.device_times), per


def shard_phase(graph, targets, label):
    """GCN (sg), GraphSAGE (dense) and GAT (dense) behind the sharded
    feature store at the [engine] phase's width and depth: four shards in
    hash and range placement holding the whole table, uneven budgets
    holding about half of it, a repin() after Zipf traffic, and a feature
    mutation through invalidate(); every batch bitwise equal to the
    resident-store engine's (or, after the mutation, to a resident engine
    built on the mutated graph). Returns the launch counts of the sharded
    engines' batches."""
    total = dict.fromkeys(ops.launch_counts(), 0)
    batch = targets[:2 * C]
    half = graph.num_vertices // 2
    # uneven per-shard budgets summing to about half of the table
    rows = (half // 2, half // 4, half // 8, half - half // 2 - half // 4
            - half // 8)
    budget = tuple(r * 512 * 4 for r in rows)
    simulated = torch.cuda.device_count() < SHARDS

    def sharded(g, cfg, params, mode, **kw):
        return DecoupledEngine(g, cfg, params=params, config=ServingConfig(
            device="cuda", batch_size=C, mode=mode, impl="cuda",
            store=StorePolicy(features="sharded", num_shards=SHARDS, **kw)))

    def resident(g, cfg, params, mode):
        return DecoupledEngine(g, cfg, params=params, config=ServingConfig(
            device="cuda", batch_size=C, mode=mode, impl="cuda",
            store=StorePolicy(features="resident")))

    def counted(eng, tgt, kind, mode):
        emb, step, per = _infer(eng, tgt)
        want = {k: EXPECTED[kind, mode].get(k, 0) for k in per}
        check(per == want, f"[shard] {kind}: launches a batch {per}, "
                           f"expected {want}")
        for k in total:
            total[k] += int(per[k] * (len(tgt) // C))
        return emb, step

    for kind, mode in SHARD_KINDS:
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        params = init_gnn(cfg, seed=0, device="cuda")
        with resident(graph, cfg, params, mode) as eng:
            want, step_res, _ = _infer(eng, batch)
        for placement in ("hash", "range"):
            with sharded(graph, cfg, params, mode,
                         placement=placement) as eng:
                got, step = counted(eng, batch, kind, mode)
                rep = eng.store_report()["features"]
                st = eng.scheduler.stats
                per_batch = [b // st.n_batches for b in st.shard_bytes]
            same = np.array_equal(got, want)
            print(f"[shard] {kind}/{mode} {SHARDS} shards ({placement}, "
                  f"whole table, simulated {rep['simulated']}): bitwise "
                  f"equal to the resident store {same}; shard rows "
                  f"{rep['shard_rows']}, {rep['device_bytes']} bytes on "
                  f"the card, cross-shard rows {rep['cross_shard_rows']}; "
                  f"bytes a batch per shard {per_batch}, balance "
                  f"{st.shard_balance:.4f}; device step p50 "
                  f"{step * 1e3:.3f} ms (resident store "
                  f"{step_res * 1e3:.3f} ms) [{label}]", flush=True)
            check(same, f"[shard] {kind} {placement}: embeddings differ "
                        f"from the resident store's")
            check(rep["cross_shard_rows"] > 0 and min(rep["shard_rows"]) > 0
                  and rep["simulated"] == simulated,
                  f"[shard] {kind} {placement}: {rep}")
        with sharded(graph, cfg, params, mode, placement="range",
                     shard_budget_bytes=budget) as eng:
            got, _ = counted(eng, batch[:C], kind, mode)
            rep = eng.store_report()["features"]
            same = np.array_equal(got, want[:C])
            print(f"[shard] {kind}/{mode} uneven budgets {list(rows)} rows "
                  f"({rep['resident_fraction']} of the table): bitwise "
                  f"equal {same}, miss rows shipped "
                  f"{rep['miss_rows_shipped']}, resident hit rate "
                  f"{rep['resident_hit_rate']} [{label}]", flush=True)
            check(same and rep["miss_rows_shipped"] > 0,
                  f"[shard] {kind} uneven budgets: bitwise {same}, {rep}")
            counted(eng, zipf_traffic(graph, 2 * C, a=1.1, seed=5), kind,
                    mode)
            moved = eng.repin()
            got, _ = counted(eng, batch[:C], kind, mode)
            rep = eng.store_report()["features"]
            same = np.array_equal(got, want[:C])
            print(f"[shard] {kind}/{mode} after repin() "
                  f"(promoted {moved['promoted']}, demoted "
                  f"{moved['demoted']}, moved {moved['moved']}, mass "
                  f"balance {moved['mass_balance_before']} -> "
                  f"{moved['mass_balance_after']}): bitwise equal {same}, "
                  f"resident hit rate {rep['resident_hit_rate']} "
                  f"[{label}]", flush=True)
            check(same, f"[shard] {kind}: embeddings changed by repin()")
        g2 = copy.deepcopy(graph)
        with sharded(g2, cfg, params, mode) as eng:
            counted(eng, batch[:C], kind, mode)
            touched = np.unique(batch[:8])
            g2.features[touched] += 1.0
            eng.invalidate(touched)
            got, _ = counted(eng, batch[:C], kind, mode)
        with resident(g2, cfg, params, mode) as fresh:
            want2, _, _ = _infer(fresh, batch[:C])
        same = np.array_equal(got, want2)
        print(f"[shard] {kind}/{mode} feature rows of {len(touched)} "
              f"targets mutated, invalidate(): bitwise equal to a resident "
              f"engine built on the mutated graph {same}; differs from "
              f"before {not np.array_equal(got, want[:C])} [{label}]",
              flush=True)
        check(same, f"[shard] {kind}: mutated rows not refreshed")
        del g2
    print(f"[shard] launches over the sharded engines: {total} [{label}]",
          flush=True)
    return total


# -- phase 5f: the offline precompute tier -----------------------------------


def two_components(seed):
    """CSRGraph of 256 vertices: two disjoint copies (128 each) of the
    synthetic generator at the Flickr-sized graph's degree and f_in."""
    spec = DatasetSpec("cover", COVER_V // 2, 10.0, F_IN, 7)
    a, b = (make_graph(spec, seed=2 * seed + i) for i in (1, 2))
    h = a.num_vertices
    check(h + b.num_vertices == COVER_V, f"two_components: "
          f"{h} + {b.num_vertices} vertices, expected {COVER_V}")
    return CSRGraph(indptr=np.concatenate([a.indptr,
                                           a.indptr[-1] + b.indptr[1:]]),
                    indices=np.concatenate([a.indices,
                                            b.indices + h]).astype(np.int32),
                    features=np.concatenate([a.features, b.features]),
                    name="cover").validate()


def chunk_args(local, i, H):
    """The kernel's arguments for chunk ``i`` of ``local`` (a _LocalCSR) on
    the register ``H`` [V, F]: src, dst, w (gcn norm) [1, E] and the
    compact h [1, N, F]."""
    rows, src, dst, nrows = local._chunks[i]
    h = H.index_select(0, rows)
    if nrows > h.shape[0]:
        h = torch.cat([h, h.new_zeros(nrows - h.shape[0], h.shape[1])])
    return src, dst, local._weights("gcn")[i], h[None].contiguous()


def offline_chunk(graph):
    """The offline build's compute set over the whole graph (``_LocalCSR``,
    chunks of PRE_CHUNK destinations) and its chunk with the most edges."""
    t0 = time.perf_counter()
    local = _LocalCSR(graph, np.arange(graph.num_vertices), PRE_CHUNK,
                      "cuda", torch.device("cuda"))
    sizes = [e1 - e0 for e0, e1 in local.e_ranges]
    print(f"[kernels] offline chunk shape: {local.num_chunks} chunks of "
          f"{local.chunk} destinations, e_cap {local.e_cap} (edges a chunk "
          f"mean {np.mean(sizes):.1f}, max {max(sizes)}), distinct sources "
          f"{min(len(c[0]) for c in local._chunks)}-"
          f"{max(len(c[0]) for c in local._chunks)}; compute set built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return local, int(np.argmax(sizes)), sizes


def offline_chunk_checks(graph, chunk):
    """``scatter_gather_aggregate`` at the offline build's chunk shape
    (``chunk = offline_chunk(graph)``: C=1, its distinct sources gathered
    from the full [V, F] register, n_out = the chunk's 2048 rows), at
    F=500 (layer 0, unaligned) and 256, against its plain version (two
    launches bitwise equal, the bucket kernel, bitwise equal to
    ``sg_edge_order``), with inf and NaN on row 0, the source of the
    chunk's weight-0 padding edges. Returns ([(name, ok, text)], [(tag,
    args, max_abs_err, variant)])."""
    local, i, sizes = chunk
    n_out = local.chunk
    gen = torch.Generator().manual_seed(0)
    recs, checks = [], []
    for f in (F_IN, F_HID):
        H = torch.randn(graph.num_vertices, f, generator=gen).to(
            local.device)
        args = chunk_args(local, i, H)
        Nn = args[3].shape[1]
        tag = (f"offline chunk C=1 N={Nn} n_out={n_out} F={f} "
               f"E={local.e_cap} real_edges={sizes[i]}")
        before = dict(sg_kernels.variant_launches)
        got = scatter_gather_aggregate(*args, n_out=n_out)
        again = scatter_gather_aggregate(*args, n_out=n_out)
        variant = ",".join(k for k, n in sg_kernels.variant_launches.items()
                           if n > before[k])
        ok, text, err = reading(got, scatter_gather_aggregate_ref(
            *args, n_out=n_out))
        same = bool(torch.equal(got, again))
        order = same_bits(got, sg_edge_order(*args, n_out))
        checks.append((f"sg {tag}", ok and same and order
                       and variant == "bucket"
                       and tuple(got.shape) == (1, n_out, f),
                       f"{text}, repeat bitwise {same}, bitwise the "
                       f"edge-order sums {order}, kernel {variant}, shape "
                       f"{tuple(got.shape)}"))
        Hn = H.clone()
        Hn[0, 7] = float("inf")
        Hn[0, f - 1] = float("nan")
        nargs = chunk_args(local, i, Hn)
        got = scatter_gather_aggregate(*nargs, n_out=n_out)
        ok, text = nan_reading(got, scatter_gather_aggregate_ref(
            *nargs, n_out=n_out))
        order = same_bits(got, sg_edge_order(*nargs, n_out))
        checks.append((f"sg offline chunk F={f} weight-0 padding from an "
                       f"inf/NaN row 0", ok and order,
                       f"{text}, bitwise the edge-order sums {order}"))
        recs.append((tag, args, err, variant))
    return checks, recs


def offline_chunk_phase(graph, label):
    """``offline_chunk_checks``, then each row timed in turns beside
    ``index_add_`` into the same n_out rows, with the wrapper's host time a
    call. Returns the JSON records."""
    chunk = offline_chunk(graph)
    n_out = chunk[0].chunk
    checks, recs = offline_chunk_checks(graph, chunk)
    run_checks(checks)
    out = []
    for tag, args, err, variant in recs:
        t = turns({"kernel": lambda: scatter_gather_aggregate(
            *args, n_out=n_out), "index_add_": sg_library(args, n_out)})
        ms, lib = (statistics.median(t[n]["host"])
                   for n in ("kernel", "index_add_"))
        g_ms, g_lib = (statistics.median(t[n]["graph"])
                       for n in ("kernel", "index_add_"))
        plain = cuda_ms(lambda: scatter_gather_aggregate_ref(
            *args, n_out=n_out))
        bnd, by = sg_bound(args, n_out)
        bnd_all = sg_bound(args)[0]
        us = host_us(lambda: scatter_gather_aggregate(*args, n_out=n_out))
        print(f"  scatter_gather_aggregate {tag}: medians [min-max] of 5 "
              f"rounds in turns, host / graph: kernel "
              f"{spread(t['kernel']['host'])} / "
              f"{spread(t['kernel']['graph'])} ms ({variant}), index_add_ "
              f"into {n_out} rows {spread(t['index_add_']['host'])} / "
              f"{spread(t['index_add_']['graph'])}; kernel / index_add_ "
              f"{ms / lib:.3f} / {g_ms / g_lib:.3f} (target below 1: "
              f"{ms < lib and g_ms < g_lib}); plain {plain:.4f} ms; bound "
              f"{bnd:.4f} ms ({by}; {bnd_all:.4f} with all {args[3].shape[1]}"
              f" rows written); wrapper host {us:.2f} us a call [{label}]",
              flush=True)
        out.append(dict(variant=variant, shape=tag, max_abs_err=err, ms=ms,
                        graph_ms=g_ms, plain_ms=plain, bound_ms=bnd,
                        bound_by=by, library_ms=lib, library_graph_ms=g_lib,
                        host_us=us))
    return out


class _Float64:
    """A compute set's (``_LocalCSR``) Aggregate and Transform in float64:
    the same edges and float32 edge weights, widened, summed with
    ``index_add_``; the plain build's ops at twice the precision."""

    def __init__(self, local):
        self.local = local
        dev = local.self_w.device
        self.src = torch.from_numpy(local.src.astype(np.int64)).to(dev)
        self.dst = torch.from_numpy(local.dst).to(dev)
        self.w = {k: torch.from_numpy(v.astype(np.float64)).to(dev)
                  for k, v in local._w.items()}
        self.self_w = local.self_w.double()

    def aggregate(self, norm, H):
        z = torch.zeros_like(H).index_add_(
            0, self.dst, H[self.src] * self.w[norm][:, None])
        return z + H * self.self_w[:, None] if norm == "gcn" else z

    def transform(self, op, p, H_src, H_in):
        return self.local.transform(op, p, H_src, H_in)


def float64_build(graph, prog, params):
    """Every vertex's tier row from the layer-major propagation in float64
    on the card (the offline build's reference: the float32 builds sum a
    hub's up to 18,406 in-edges in an order of their own)."""
    local = _LocalCSR(graph, np.arange(graph.num_vertices), PRE_CHUNK,
                      "torch", torch.device("cuda"))
    f64 = _Float64(local)
    p64 = {k: ({kk: vv.double() for kk, vv in v.items()}
               if isinstance(v, dict) else v.double())
           for k, v in params.items()}
    with torch.inference_mode():
        H = torch.from_numpy(graph.features.astype(np.float64)).to(
            local.device)
        H = _apply_section(f64, prog.layer0, p64["layer0"], H, None)
        H0 = H
        for i in range(prog.n_layers - 1):
            H = _apply_section(f64, prog.inner, _layer(p64["layers"], i),
                               H, H0)
        return H.cpu().numpy()


def _tier_engine(graph, cfg, params, mode, **pconf):
    return DecoupledEngine(graph, cfg, params=params, config=ServingConfig(
        device="cuda", batch_size=C, mode=mode, impl="cuda",
        precompute=PrecomputeConfig(chunk_size=PRE_CHUNK, **pconf)))


def _online_engine(graph, cfg, params, mode):
    return DecoupledEngine(graph, cfg, params=params, config=ServingConfig(
        device="cuda", batch_size=C, mode=mode, impl="cuda"))


def _held(name, got, want, label):
    """Holds ``got`` to ``want`` at ENGINE_TOL; prints the bitwise share."""
    err = float(np.abs(got - want).max()) if got.size else 0.0
    share = float((got == want).mean()) if got.size else 1.0
    ok = got.shape == want.shape and np.isfinite(got).all() \
        and np.allclose(got, want, **ENGINE_TOL)
    print(f"[precompute] {name}: max_abs_err {err:.3e} (rtol "
          f"{ENGINE_TOL['rtol']}, atol {ENGINE_TOL['atol']}), bitwise equal "
          f"{share:.6f} {'ok' if ok else 'FAIL'} [{label}]", flush=True)
    check(ok, f"[precompute] {name}")


def precompute_big(graph, targets, kind, mode, label, total):
    """The tier on the Flickr-sized graph: the offline build (impl="cuda"
    against impl="torch" on the card, two cuda builds bitwise equal, its
    scatter-gather launches counted exactly), an all-fresh batch (no
    launch, the tier's rows bitwise), the artifact saved and loaded, and
    the p50 of all-fresh batches against the online engine's. Returns the
    tiered engine (open) and the online one."""
    cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                    f_in=F_IN, f_hidden=F_HID, n_heads=HEADS,
                    readout="target")
    params = init_gnn(cfg, seed=0, device="cuda")
    before = ops.launch_counts()
    split = dict(sg_kernels.variant_launches)
    t0 = time.perf_counter()
    eng = _tier_engine(graph, cfg, params, mode, auto_refresh=False)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    after = ops.launch_counts()
    split = {k: n - split[k] for k, n in sg_kernels.variant_launches.items()}
    built = {k: after[k] - before[k] for k in after}
    local_chunks = -(-graph.num_vertices // PRE_CHUNK)
    hops = agg_hops(eng.program)
    want = {k: 0 for k in built}
    want["scatter_gather_aggregate"] = local_chunks * hops
    check(built == want, f"[precompute] {kind} build launches {built}, "
                         f"expected {want} ({local_chunks} chunks x {hops} "
                         f"Aggregates)")
    for k in total:
        total[k] += built[k]
    table = eng.precompute.tier.table.copy()
    rows_t, t_cuda = _timed(lambda: layer_major_embeddings(
        graph, eng.program, params, chunk_size=PRE_CHUNK, impl="cuda",
        device="cuda"))
    rows_p, t_torch = _timed(lambda: layer_major_embeddings(
        graph, eng.program, params, chunk_size=PRE_CHUNK, impl="torch",
        device="cuda"))
    rows_64 = float64_build(graph, eng.program, params)
    print(f"[precompute] {kind}/L={LAYERS} offline build on V="
          f"{graph.num_vertices}: engine construction (build + tier) "
          f"{t_engine:.3f} s, layer_major_embeddings impl=cuda "
          f"{t_cuda:.3f} s, impl=torch {t_torch:.3f} s; tier "
          f"{eng.precompute.tier.nbytes} bytes; scatter-gather launches "
          f"{built['scatter_gather_aggregate']} ({local_chunks} chunks x "
          f"{hops} Aggregates, by kernel {split}) [{label}]", flush=True)
    same = np.array_equal(rows_t, table)
    print(f"[precompute] {kind} two impl=cuda builds bitwise equal {same}",
          flush=True)
    check(same, f"[precompute] {kind}: two cuda builds differ")
    # the gate: the kernel build against the float64 build (the float32
    # impl="torch" build varies from run to run by up to ~0.7 of the
    # tolerance itself: index_add_'s order, scripts/tier_precision_probe.py)
    _held(f"{kind} offline build impl=cuda vs the float64 build", table,
          rows_64, label)
    for name, got, want in (("impl=cuda vs impl=torch", table, rows_p),
                            ("impl=torch vs the float64 build", rows_p,
                             rows_64)):
        err, worst, share = closeness(torch.from_numpy(got),
                                      torch.from_numpy(want), ENGINE_TOL)
        print(f"[precompute] {kind} offline build {name} (reported): "
              f"max_abs_err {err:.3e}, worst {worst:.3f} of ENGINE_TOL, "
              f"bitwise equal {share:.6f} [{label}]", flush=True)
    # all-fresh batches: no program runs, the rows are the tier's
    before = ops.launch_counts()
    res = eng.infer(targets)
    after = ops.launch_counts()
    tier = eng.precompute.tier
    same = np.array_equal(res.embeddings, tier.table[tier.slot_of[targets]])
    check(after == before, f"[precompute] {kind}: an all-fresh batch "
                           f"launched {after} (before {before})")
    check(same, f"[precompute] {kind}: all-fresh rows are not the tier's")
    st = res.stats
    fresh_p50 = statistics.median(h + d for h, d in
                                  zip(st.host_times, st.device_times))
    online = _online_engine(graph, cfg, params, mode)
    emb_on, _, per = _infer(online, targets)
    for k in total:
        total[k] += int(per[k] * (len(targets) // C))
    st = online.scheduler.stats
    on_p50 = statistics.median(h + d for h, d in
                               zip(st.host_times, st.device_times))
    print(f"[precompute] {kind} {len(targets) // C} all-fresh batches: no "
          f"launch, rows bitwise the tier's {same}; p50 batch host+device "
          f"{fresh_p50 * 1e3:.3f} ms against the online engine's "
          f"{on_p50 * 1e3:.3f} ms ({mode}) [{label}]", flush=True)
    # the artifact: saved, loaded by a new engine, refused on a mutation
    path = str(PRE_DIR / kind)
    shutil.rmtree(path, ignore_errors=True)
    save_artifact(path, table, graph, cfg, params)
    with _tier_engine(graph, cfg, params, mode, artifact=path) as loaded:
        rep = loaded.precompute_report()
        same = np.array_equal(loaded.precompute.tier.table, table)
    g2 = copy.deepcopy(graph)
    g2.features[int(targets[0])] += 1.0
    try:
        _tier_engine(g2, cfg, params, mode, artifact=path).close()
        refused = "no"
    except PrecomputeArtifactError as e:
        refused = str(e).split(":")[1].split("(")[0].strip()
    print(f"[precompute] {kind} artifact: loaded with builds="
          f"{rep['builds']}, rows bitwise equal {same}; mutated graph "
          f"refused: {refused} [{label}]", flush=True)
    check(same and rep["builds"] == 0, f"[precompute] {kind}: artifact")
    check(refused != "no", f"[precompute] {kind}: a mutated graph loaded")
    del g2
    return eng, online, cfg, params


def precompute_small(kind, mode, label, total):
    """The tier where the online subgraph covers the whole component (256
    vertices in two components of 128, receptive field 256): an all-fresh
    batch against the online engine, a mixed batch after on_invalidate
    (the program once, on the stale half; the fresh half the tier's rows),
    and an edge update then drain() against a fresh build."""
    g = two_components(seed=1 if kind == "gcn" else 2)
    cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=COVER_V,
                    f_in=F_IN, f_hidden=F_HID, n_heads=HEADS,
                    readout="target", ppr_eps=1e-9)
    params = init_gnn(cfg, seed=0, device="cuda")
    h = COVER_V // 2
    rng = np.random.default_rng(4)
    a = np.sort(rng.choice(h, C // 2, replace=False))
    b = np.sort(rng.choice(h, C // 2, replace=False)) + h
    batch = np.concatenate([a, b])
    with _tier_engine(g, cfg, params, mode, auto_refresh=False) as hy, \
            _online_engine(g, cfg, params, mode) as on:
        want, _, per = _infer(on, batch)
        for k in total:
            total[k] += int(per[k])
        before = ops.launch_counts()
        got = hy.infer(batch).embeddings
        check(ops.launch_counts() == before,
              f"[precompute] {kind}: an all-fresh batch launched")
        rep = hy.precompute_report()
        check(rep["hits"] == C, f"[precompute] {kind}: hits {rep['hits']}")
        _held(f"{kind} full coverage (V={COVER_V}, two components): "
              f"all-fresh batch (hits {rep['hits']}) vs the online engine",
              got, want, label)
        demoted = hy.precompute.on_invalidate(a[:2])
        tier = hy.precompute.tier
        fresh = tier.fresh[tier.slot_of[batch]]
        got, _, per = _infer(hy, batch)
        want_per = {k: EXPECTED[kind, mode].get(k, 0) for k in per}
        check(per == want_per, f"[precompute] {kind}: the mixed batch "
                               f"launched {per}, expected {want_per}")
        for k in total:
            total[k] += int(per[k])
        print(f"[precompute] {kind} mixed batch: on_invalidate of 2 targets "
              f"demoted {demoted} vertices; {int((~fresh).sum())} stale "
              f"targets online, {int(fresh.sum())} from the tier; launches "
              f"{per} [{label}]", flush=True)
        check(fresh.any() and (~fresh).any(),
              f"[precompute] {kind}: the batch is not mixed")
        _held(f"{kind} mixed batch, online half vs the online engine",
              got[~fresh], want[~fresh], label)
        same = np.array_equal(got[fresh],
                              tier.table[tier.slot_of[batch[fresh]]])
        print(f"[precompute] {kind} mixed batch, tier half bitwise the "
              f"tier's rows {same}", flush=True)
        check(same, f"[precompute] {kind}: tier half of the mixed batch")
        nbrs = set(g.neighbors(int(a[0])).tolist())
        v = next(int(u) for u in a[1:] if int(u) not in nbrs)
        before = ops.launch_counts()
        g.apply_edge_updates(insert=[(int(a[0]), v)])
        hy.precompute.drain()
        after = ops.launch_counts()
        rep = hy.precompute_report()
        launched = after["scatter_gather_aggregate"] \
            - before["scatter_gather_aggregate"]
        for k in total:
            total[k] += after[k] - before[k]
        print(f"[precompute] {kind} edge ({int(a[0])}, {v}) inserted, "
              f"drain(): {rep['refresh_chunks']} refresh chunks, "
              f"scatter-gather launches {launched}, fresh {rep['fresh']} of "
              f"{rep['resident']}, refresh errors {rep['refresh_errors']} "
              f"[{label}]", flush=True)
        check(launched > 0 and rep["fresh"] == COVER_V
              and rep["refresh_errors"] == 0,
              f"[precompute] {kind}: refresh {rep}, launches {launched}")
        rebuilt = layer_major_embeddings(g, hy.program, params,
                                         chunk_size=PRE_CHUNK, impl="cuda",
                                         device="cuda")
        _held(f"{kind} refreshed tier vs a fresh build after the edge "
              f"update", tier.table[tier.slot_of[np.arange(COVER_V)]],
              rebuilt, label)


def precompute_phase(graph, label):
    """GCN (sg online) and GraphSAGE (dense online) with readout="target"
    through the offline tier at the [engine] phase's width and depth, then
    one GNNServer with a tiered and an untiered GCN lane. Returns the launch
    counts of the phase's driven paths (builds, online halves, refreshes,
    the server)."""
    total = dict.fromkeys(ops.launch_counts(), 0)
    targets = zipf_traffic(graph, N_BATCHES * C, a=1.1, seed=7)
    lanes = {}
    for kind, mode in PRE_KINDS:
        lanes[kind] = precompute_big(graph, targets, kind, mode, label,
                                     total)
        precompute_small(kind, mode, label, total)
    hy, online, cfg, _ = lanes["gcn"]
    lanes["sage"][0].close()
    lanes["sage"][1].close()
    srv = GNNServer()
    srv.register("gcn-tier", hy)
    srv.register("gcn", online)
    rng = np.random.default_rng(8)
    order = [(name, int(t)) for name in ("gcn-tier", "gcn")
             for t in zipf_traffic(graph, SERVE_REQUESTS, a=1.1,
                                   seed=int(rng.integers(1 << 30)))]
    ops.reset_launch_counts()
    srv.start()
    reqs = [srv.submit(t, model=k) for k, t in order]
    srv.drain(reqs, timeout=600)
    srv.stop()
    torch.cuda.synchronize()
    served = ops.launch_counts()
    rep = srv.report()["models"]
    batches = srv.model_stats("gcn").n_batches
    want = {k: EXPECTED["gcn", "sg"].get(k, 0) * batches for k in served}
    check(served == want, f"[precompute] server launches {served}, "
                          f"expected {want} (the tiered lane none)")
    for k in total:
        total[k] += served[k]
    tier = hy.precompute.tier
    mine = [r for r in reqs if r.model == "gcn-tier"]
    same = np.array_equal(np.stack([r.embedding for r in mine]),
                          tier.table[tier.slot_of[[r.target for r in mine]]])
    for name in ("gcn-tier", "gcn"):
        lat = rep[name]["latency"]
        pre = rep[name].get("precompute")
        section = "absent" if pre is None else \
            {k: pre[k] for k in ("hits", "misses", "hit_rate")}
        print(f"[precompute] server lane {name}: n={lat['n']} p50 "
              f"{lat['p50'] * 1e3:.2f} ms p99 {lat['p99'] * 1e3:.2f} ms; "
              f"precompute section {section} [{label}]", flush=True)
        check(lat["n"] == SERVE_REQUESTS, f"[precompute] {name}: "
                                          f"{lat['n']} answered")
    pre = rep["gcn-tier"].get("precompute")
    check(pre is not None and pre["misses"] == 0 and same
          and "precompute" not in rep["gcn"],
          f"[precompute] tiered lane: section {pre}, rows the tier's {same}")
    hy.close()
    online.close()
    print(f"[precompute] launches over the phase: {total} [{label}]",
          flush=True)
    return total


# -- phase 5g: multi-host serving --------------------------------------------


def spawn_graph_hosts(n):
    """Start ``n`` graph-host processes on the Flickr-sized graph (seed 0,
    the device host's) and return (processes, endpoints). Each must print
    its ``GRAPH_HOST_LISTENING`` line within ``RPC_HOST_DEADLINE_S``;
    their later output is drained by a daemon thread. The hosts keep no
    neighborhood or row cache, as the local engines they are compared
    with (``StorePolicy()``): shared across the phase's engines, their
    caches would serve later kinds' batches from the first kind's work."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs, lines = [], []
    for _ in range(n):
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.distributed.graph_host",
             "--dataset", "flickr", "--scale", "1.0", "--seed", "0",
             "--port", "0", "--nbr-cache", "none", "--no-row-cache"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        q: "queue.Queue" = queue.Queue()

        def pump(out=proc.stdout, q=q):
            for line in out:
                q.put(line)
            q.put(None)

        threading.Thread(target=pump, daemon=True).start()
        procs.append(proc)
        lines.append(q)
    endpoints = []
    deadline = time.monotonic() + RPC_HOST_DEADLINE_S
    try:
        for proc, q in zip(procs, lines):
            seen = []
            while True:
                try:
                    line = q.get(timeout=max(0.0,
                                             deadline - time.monotonic()))
                except queue.Empty:
                    line = None
                if line is None:
                    raise RuntimeError(
                        f"chip_smoke: graph host pid {proc.pid} gave no "
                        f"endpoint within {RPC_HOST_DEADLINE_S:.0f} s "
                        f"(exit {proc.poll()}): {''.join(seen)[-2000:]}")
                seen.append(line)
                if line.startswith("GRAPH_HOST_LISTENING"):
                    _, host, port = line.split()
                    endpoints.append(f"{host}:{port}")
                    break
    except BaseException:
        stop_graph_hosts(procs)
        raise
    return procs, endpoints


def stop_graph_hosts(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)


def _rpc_counts(stats):
    return {k: getattr(stats, k) for k in (
        "rpc_calls", "rpc_bytes_out", "rpc_bytes_in", "rpc_retries",
        "rpc_timeouts", "rpc_errors", "t_rpc_wall", "t_rpc_remote",
        "t_rpc_wire")}


def _served(eng, targets):
    """(embeddings, call stats, rpc counters of the call, launches by
    kernel) of a warm-up batch and then ``targets`` through ``eng``."""
    eng.infer(targets[:C])                           # warm-up batch
    before = ops.launch_counts()
    r0 = _rpc_counts(eng.scheduler.stats)
    res = eng.infer(targets)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    r1 = _rpc_counts(eng.scheduler.stats)
    return (res.embeddings, res.stats, {k: r1[k] - r0[k] for k in r0},
            {k: after[k] - before[k] for k in after})


def _stat_line(st):
    per = [h + d for h, d in zip(st.host_times, st.device_times)]
    n = len(st.device_times)
    return (f"p50 host+device {statistics.median(per) * 1e3:.2f} ms, wall/"
            f"batch {st.t_wall / n * 1e3:.2f} ms, device step p50 "
            f"{statistics.median(st.device_times) * 1e3:.2f} ms")


def _batches_equal(got, want):
    return [bool(np.array_equal(got[i:i + C], want[i:i + C]))
            for i in range(0, len(want), C)]


def rpc_phase(graph, targets, label):
    """GCN, GraphSAGE and GAT with Select and Build on two graph-host
    processes (see the module docstring, 13). Returns the launch counts of
    the remote engines' batches."""
    total = dict.fromkeys(ops.launch_counts(), 0)
    RPC_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, endpoints = spawn_graph_hosts(RPC_HOSTS)
    try:
        print(f"[rpc] {RPC_HOSTS} graph hosts {endpoints} up in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        local_out, params = {}, {}
        for kind, mode, routing in RPC_KINDS:
            cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                            f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
            params[kind] = init_gnn(cfg, seed=0, device="cuda")
            local_conf = ServingConfig(device="cuda", batch_size=C,
                                       mode=mode, impl="cuda")
            remote_conf = dataclasses.replace(
                local_conf, transport="socket", endpoints=tuple(endpoints),
                routing=routing)
            with DecoupledEngine(graph, cfg, params=params[kind],
                                 config=local_conf) as eng:
                want, st_local, _, _ = _served(eng, targets)
            with DecoupledEngine(graph, cfg, params=params[kind],
                                 config=remote_conf) as eng:
                got, st, rpc, per = _served(eng, targets)
                hosts = eng.store_report()["graph_hosts"]
            local_out[kind] = want
            same = _batches_equal(got, want)
            expected = {k: EXPECTED[kind, mode].get(k, 0) * N_BATCHES
                        for k in per}
            print(f"[rpc] {kind}/{mode} ({routing}) local: "
                  f"{_stat_line(st_local)} [{label}]", flush=True)
            print(f"[rpc] {kind}/{mode} ({routing}) remote over "
                  f"{RPC_HOSTS} hosts: {_stat_line(st)}; rpc calls "
                  f"{rpc['rpc_calls']}, bytes a batch out "
                  f"{rpc['rpc_bytes_out'] / N_BATCHES:.0f} in "
                  f"{rpc['rpc_bytes_in'] / N_BATCHES:.0f}, t_rpc_wall "
                  f"{rpc['t_rpc_wall']:.4f} s, t_rpc_remote "
                  f"{rpc['t_rpc_remote']:.4f} s, t_rpc_wire "
                  f"{rpc['t_rpc_wire']:.4f} s (wire share "
                  f"{rpc['t_rpc_wire'] / max(rpc['t_rpc_wall'], 1e-9):.4f}"
                  f"); requests by host "
                  f"{[h.get('report', {}).get('requests') for h in hosts]};"
                  f" launches {per}; batches bitwise equal to local {same} "
                  f"[{label}]", flush=True)
            check(all(same), f"[rpc] {kind}: remote batches {same} differ "
                             f"from the local engine's")
            check(per == expected, f"[rpc] {kind}: launches {per}, "
                                   f"expected {expected}")
            check(rpc["rpc_calls"] == N_BATCHES and rpc["rpc_errors"] == 0,
                  f"[rpc] {kind}: {rpc}")
            for k in total:
                total[k] += per[k]
        # one traced remote engine: the graph hosts' spans stitched in
        kind, mode, routing = RPC_KINDS[0]
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        conf = ServingConfig(device="cuda", batch_size=C, mode=mode,
                             impl="cuda", transport="socket",
                             endpoints=tuple(endpoints),
                             trace=TraceConfig())
        with DecoupledEngine(graph, cfg, params=params[kind],
                             config=conf) as eng:
            got, st, rpc, per = _served(eng, targets)
            tree = eng.export_trace(str(RPC_DIR / "trace.json"))
            spans = eng.tracer.export_spans()
            rep = eng.trace_report()
        for k in total:
            total[k] += per[k]
        remote = [sp for sp in spans if sp["cat"] == "remote"]
        by_host = {}
        for sp in remote:
            by_host.setdefault(sp["host"], set()).add(sp["name"])
        problems = validate_chrome_trace(tree)
        same = _batches_equal(got, local_out[kind])
        print(f"[rpc] traced {kind}/{mode}: {len(spans)} spans, remote "
              f"spans {rep['remote_spans']} by host "
              f"{ {h: sorted(v) for h, v in by_host.items()} }, clock_sync "
              f"{rep.get('clock_sync')}, export problems {problems[:3]}; "
              f"bitwise equal to local {same} [{label}]", flush=True)
        check(not problems and all(same), f"[rpc] traced: {problems[:3]}, "
                                          f"bitwise {same}")
        check(len(by_host) == RPC_HOSTS and all(
            v == {"remote.select", "remote.build"}
            for v in by_host.values()),
            f"[rpc] traced: remote spans by host {by_host}")
        check(set(rep.get("clock_sync", {})) == set(endpoints),
              f"[rpc] traced: clock_sync {rep.get('clock_sync')}")
        # kill one host between batches: the other serves the rest
        conf = ServingConfig(device="cuda", batch_size=C, mode=mode,
                             impl="cuda", transport="socket",
                             endpoints=tuple(endpoints),
                             telemetry=TelemetryConfig())
        with DecoupledEngine(graph, cfg, params=params[kind],
                             config=conf) as eng:
            before = ops.launch_counts()
            first = eng.infer(targets[:2 * C]).embeddings
            stop_graph_hosts(procs[:1])
            r0 = _rpc_counts(eng.scheduler.stats)
            after_kill = eng.infer(targets[2 * C:4 * C]).embeddings
            r1 = _rpc_counts(eng.scheduler.stats)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            health = {h["endpoint"]: h["healthy"]
                      for h in eng._host_pool.report()}
            quarantines = eng.telemetry_report()["counters"].get(
                "repro_host_quarantines_total", 0)
            served = eng.store_report()["graph_hosts"]
        for k in total:
            total[k] += after[k] - before[k]
        got = np.concatenate([first, after_kill])
        same = _batches_equal(got, local_out[kind])
        retries = r1["rpc_retries"] - r0["rpc_retries"]
        errors = r1["rpc_errors"] - r0["rpc_errors"]
        print(f"[rpc] {endpoints[0]} killed after 2 batches: the next 2 "
              f"served with {retries} retries, {errors} errors, "
              f"{quarantines} quarantines; health {health}; requests by "
              f"host {[h.get('report', {}).get('requests') for h in served]}"
              f"; batches bitwise equal to local {same} [{label}]",
              flush=True)
        check(all(same) and errors == 0, f"[rpc] after the kill: bitwise "
                                         f"{same}, errors {errors}")
        check(retries + quarantines > 0 and not health[endpoints[0]]
              and health[endpoints[1]],
              f"[rpc] after the kill: retries {retries}, quarantines "
              f"{quarantines}, health {health}")
    finally:
        stop_graph_hosts(procs)
    print(f"[rpc] launches over the remote engines: {total} [{label}]",
          flush=True)
    return total


# -- phase 5h: the telemetry plane -------------------------------------------


def telemetry_phase(graph, label):
    """One metered GNNServer (see the module docstring, 14). Returns the
    launch counts of the server's batches."""
    tconf = TelemetryConfig(port=0)
    base = ServingConfig(device="cuda", batch_size=C, impl="cuda",
                         telemetry=tconf)
    lanes = {
        "gcn": dataclasses.replace(base, mode="sg", transport="inproc"),
        "sage": dataclasses.replace(
            base, mode="dense", store=StorePolicy(features="resident")),
        "gat": dataclasses.replace(
            base, mode="auto", dispatch=DispatchConfig(
                warmup_passes=0, autotune_blocks=False)),
    }
    srv = GNNServer(config=base)
    cfgs, params, recorded = {}, {}, {}
    for kind, conf in lanes.items():
        cfgs[kind] = GNNConfig(kind=kind, n_layers=LAYERS,
                               receptive_field=N, f_in=F_IN,
                               f_hidden=F_HID, n_heads=HEADS)
        params[kind] = init_gnn(cfgs[kind], seed=0, device="cuda")
        srv.register(kind, graph=graph, cfg=cfgs[kind],
                     params=params[kind], config=conf)
        eng = srv.engine_for(kind)
        recorded[kind] = []

        def record(targets, on_done=None, eng=eng, log=recorded[kind],
                   submit=eng.submit_chunk, **kw):
            log.append(np.array(targets))
            return submit(targets, on_done=on_done, **kw)

        eng.submit_chunk = record
    rng = np.random.default_rng(9)
    order = [(k, int(t)) for k in lanes
             for t in zipf_traffic(graph, SERVE_REQUESTS, a=1.1,
                                   seed=int(rng.integers(1 << 30)))]
    ops.reset_launch_counts()
    srv.start()
    try:
        reqs = [srv.submit(t, model=k) for k, t in order]
        srv.drain(reqs, timeout=600)
        for k in lanes:
            srv.engine_for(k).scheduler.flush(timeout=60)
        torch.cuda.synchronize()
        served = ops.launch_counts()
        url = srv.metrics_url
        t0 = time.perf_counter()
        with urllib.request.urlopen(url, timeout=60) as resp:
            status = resp.status
            ctype = resp.headers.get("Content-Type", "")
            body = resp.read().decode("utf-8")
        t_scrape = time.perf_counter() - t0
        wire = srv.metrics_wire()
        rep = srv.report()["models"]
        tele = {k: srv.engine_for(k).telemetry_report() for k in lanes}
    finally:
        srv.stop()
    problems = validate_exposition(body)
    n_series = series_count(wire)
    families = sorted({ln.split()[2] for ln in body.splitlines()
                       if ln.startswith("# TYPE ")})
    print(f"[telemetry] scraped {url} (HTTP "
          f"{status}, {ctype}): {len(body)} bytes, {n_series} series "
          f"across {len(families)} families in {t_scrape * 1e3:.2f} ms, "
          f"problems {problems[:3]}; server launches {served} [{label}]",
          flush=True)
    check(status == 200 and "version=0.0.4" in ctype and not problems
          and n_series >= MIN_SERIES,
          f"[telemetry] scrape: HTTP {status} {ctype!r}, {n_series} "
          f"series, problems {problems[:3]}")
    for fam in ("repro_host_select_seconds", "repro_rpc_calls_total",
                "repro_dispatch_total", "repro_request_seconds"):
        check(f"# TYPE {fam} " in body, f"[telemetry] {fam} not exposed")
    disp = [ln for ln in body.splitlines()
            if ln.startswith("repro_dispatch_total{")]
    print(f"[telemetry] {disp} [{label}]", flush=True)
    replay = dict.fromkeys(served, 0)
    for kind, conf in lanes.items():
        eng = srv.engine_for(kind)
        batches = eng.scheduler.stats.n_batches
        hist = tele[kind]["hists"]
        dev = hist.get("repro_stage_seconds{stage=device}", {})
        mine = [r for r in reqs if r.model == kind]
        got = np.stack([r.embedding for r in mine])
        before = ops.launch_counts()
        with DecoupledEngine(graph, cfgs[kind], params=params[kind],
                             config=dataclasses.replace(
                                 conf, telemetry=None)) as twin:
            want = np.concatenate([twin.infer(b).embeddings
                                   for b in recorded[kind]])
        torch.cuda.synchronize()
        after = ops.launch_counts()
        for k in replay:
            replay[k] += after[k] - before[k]
        same = np.array_equal(got, want)
        lat = rep[kind]["latency"]
        print(f"[telemetry] {kind} ({conf.mode}, {conf.transport}, "
              f"{conf.store.features} store): n={lat['n']} p50 "
              f"{lat['p50'] * 1e3:.2f} ms p99 {lat['p99'] * 1e3:.2f} ms; "
              f"{batches} batches, device-stage histogram count "
              f"{dev.get('count')} (p50 {dev.get('p50', 0) * 1e3:.3f} ms), "
              f"series {tele[kind]['series']}; bitwise equal to an "
              f"unmetered engine on the same {len(recorded[kind])} batches "
              f"{same} [{label}]", flush=True)
        check(lat["n"] == SERVE_REQUESTS and same,
              f"[telemetry] {kind}: n={lat['n']}, bitwise {same}")
        check(dev.get("count") == batches == len(recorded[kind]),
              f"[telemetry] {kind}: device-stage count {dev.get('count')},"
              f" batches {batches}")
        eng.close()
    check(replay == served, f"[telemetry] the unmetered replay launched "
                            f"{replay}, the server {served}")
    check(rep["gcn"].get("rpc", {}).get("calls", 0) > 0
          and "rpc" not in rep["sage"],
          f"[telemetry] rpc sections {rep['gcn'].get('rpc')}")
    print(f"[telemetry] launches over the server: {served} [{label}]",
          flush=True)
    return served


# -- phase 6: LM prefill and decode ------------------------------------------


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _agreement(got, want):
    """(max |got - want| / max |want|, share of equal argmaxes)."""
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return rel, top1


def _profile(fn, label, what, tag="lm", top=8):
    """Prints the device time of one call of ``fn`` by kernel, from
    ``torch.profiler``, and the share of the call's wall time the card
    was busy (one stream: the kernels' and copies' times add up)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = _timed(fn)[1]
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    n_ops = sum(r[2] for r in rows)
    print(f"[{tag}] profile of {what}: device {busy * 1e3:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall ({busy / wall:.1%} busy; traced), "
          f"{n_ops} kernels and copies [{label}]", flush=True)
    for name, us, count in rows[:top]:
        print(f"[{tag}]   {us / 1e3:9.3f} ms  x{count:<4d} {name[:80]}",
              flush=True)
    if len(rows) > top:
        rest, count = (sum(r[k] for r in rows[top:]) for k in (1, 2))
        print(f"[{tag}]   {rest / 1e3:9.3f} ms  x{count:<4d} "
              f"{len(rows) - top} other kernels and copies", flush=True)
    return dict(busy=busy / wall, device_ms=busy * 1e3, ops=n_ops)


def profile_phase(graph, targets, label):
    """One traced device step (``DecoupledEngine.run_device``: the batch's
    copy to the card and the program) of a gat/dense, a gcn/sg and a gat/sg
    batch,
    planned on the host first, after one untraced warm-up step: the device
    time by kernel and copy, and the card's busy share of the step."""
    for kind, mode in (("gat", "dense"), ("gcn", "sg"), ("gat", "sg")):
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        conf = ServingConfig(device="cuda", batch_size=C, mode=mode,
                             impl="cuda")
        with DecoupledEngine(graph, cfg, params=init_gnn(
                cfg, seed=0, device="cuda"), config=conf) as eng:
            plan = eng.plan(targets[:C])
            _timed(lambda: eng.run_device(plan))
            _profile(lambda: eng.run_device(plan), label,
                     f"one {kind}/{mode} engine batch's device step (C={C}, "
                     f"L={LAYERS})", tag="engine", top=12)


def lm_phase(label):
    """Serves one 8192-token prompt of phi3-medium-14b (8 layers) through
    prefill and decode; returns the main path's launch counts."""
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    params, t_init = _timed(lambda: transformer.init_params(
        cfg, seed=0, device="cuda"))
    n_params = param_count(params)
    print(f"[lm] {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.n_layers} "
          f"(of 40): {n_params / 1e9:.3f} B parameters, "
          f"{n_params * 4 / 1e9:.2f} GB fp32, drawn on the card in "
          f"{t_init:.2f} s", flush=True)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, LM_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}

    logits, launches, _ = _serve_checks(cfg, params, batch, label,
                                        cfg.n_layers)
    del logits

    cache = transformer.init_cache(cfg, 1, LM_DECODE, device="cuda")
    steps, step_times = [], []
    for pos in range(LM_DECODE):
        (lg, cache), t = _timed(lambda: transformer.decode_step(
            cfg, params, cache, batch["tokens"][:, pos:pos + 1], pos))
        steps.append(lg[:, 0])
        step_times.append(t)
    dec = torch.stack(steps, dim=1)
    check(tuple(dec.shape) == (1, LM_DECODE, cfg.vocab_size)
          and bool(torch.isfinite(dec).all()), "bad decode logits")
    ref = transformer.prefill(
        cfg, params, {"tokens": batch["tokens"][:, :LM_DECODE]}, impl="cuda")
    rel, top1 = _agreement(dec, ref)
    ok = rel <= DECODE_TOL["rel"] and top1 >= DECODE_TOL["top1"]
    p50 = statistics.median(step_times[1:])
    print(f"[lm] decode {LM_DECODE} steps from an empty cache vs prefill "
          f"of the same tokens: max abs err / max |logit| {rel:.3e}, top-1 "
          f"agreement {top1:.4f} (tolerance {DECODE_TOL}); step latency "
          f"p50 {p50 * 1e3:.2f} ms (first {step_times[0] * 1e3:.2f} ms), "
          f"{1 / p50:.1f} tokens/s at B=1 {'ok' if ok else 'FAIL'} "
          f"[{label}]", flush=True)
    check(ok, "decode disagrees with prefill")
    _profile(lambda: transformer.decode_step(
        cfg, params, cache, batch["tokens"][:, LM_DECODE - 1:LM_DECODE],
        LM_DECODE - 1), label, "one decode step")
    return launches


# -- phase 16: GNN training ----------------------------------------------------


def train_phase(graph, label):
    """``train_gnn`` for GCN, GraphSAGE and GAT at the [engine] width on the
    card; the first step held against the same step on the CPU. Returns
    the kernels' launches during training (all 0)."""
    print("[train] GCN, GraphSAGE, GAT: train_gnn on the card", flush=True)
    classes = int(graph.labels.max()) + 1
    ops.reset_launch_counts()
    for kind in TRAIN_KINDS:
        t0 = time.perf_counter()
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS,
                        num_classes=classes)
        # train_gnn's first batch: the first draw of default_rng(seed)
        targets = np.random.default_rng(0).integers(
            0, graph.num_vertices, size=TRAIN_BATCH)
        first = {}
        for d in ("cpu", "cuda"):
            params = init_gnn(cfg, seed=0, device=d)
            batch, labels = gnn_train.train_batch(graph, cfg, targets, d)
            loss, acc, grads = gnn_train.gnn_grads(cfg, params, batch,
                                                   labels)
            l64, _, g64 = gnn_train.gnn_grads(
                cfg, tree_map(torch.Tensor.double, params),
                {k: v.double() for k, v in batch.items()}, labels)
            first[d] = (float(loss), float(acc), float(global_norm(grads)),
                        [g.cpu() for g in tree_leaves(grads)], float(l64),
                        [g.cpu() for g in tree_leaves(g64)])
        (l0, a0, n0, g0, k0, h0), (l1, a1, n1, g1, k1, h1) = \
            first["cpu"], first["cuda"]

        def worst(got, want):
            return max(float((a.double() - b).abs().max())
                       / max(float(b.abs().max()), 1e-300)
                       for a, b in zip(got, want))
        w64 = worst(h1, h0)
        ok = (abs(l1 - l0) <= TRAIN_TOL["rtol"] * abs(l0)
              and abs(n1 - n0) <= TRAIN_TOL["rtol"] * abs(n0)
              and abs(a1 - a0) <= 1.0 / TRAIN_BATCH
              and abs(k1 - k0) <= TRAIN_TOL["rtol64"] * abs(k0)
              and w64 <= TRAIN_TOL["grad64"])
        print(f"[train] {kind} first step, card vs CPU (same params and "
              f"batch): loss {l1:.7f} / {l0:.7f}, acc {a1:.4f} / {a0:.4f}, "
              f"grad_norm {n1:.6f} / {n0:.6f}; in float64 loss "
              f"{k1:.15f} / {k0:.15f} and {len(h1)} gradient leaves within "
              f"{w64:.3e} of each leaf's max |g| (tolerance {TRAIN_TOL}); "
              f"float32 leaves: card vs CPU {worst(g1, g0):.3e}, card vs "
              f"float64 {worst(g1, h1):.3e}, CPU vs float64 "
              f"{worst(g0, h0):.3e} {'ok' if ok else 'FAIL'} [{label}]",
              flush=True)
        out = gnn_train.train_gnn(graph, cfg, steps=TRAIN_STEPS,
                                  batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                                  seed=0, eval_every=0, device="cuda")
        hist = out["history"]
        check(abs(hist[0]["loss"] - l1) <= TRAIN_TOL["rtol"] * abs(l1),
              f"{kind}: train_gnn's first loss {hist[0]['loss']} is not "
              f"the checked step's {l1}")
        head = float(np.mean([h["loss"] for h in hist[:5]]))
        tail = float(np.mean([h["loss"] for h in hist[-5:]]))
        build_ms = statistics.median(out["build_s"]) * 1e3
        dev_ms = statistics.median(out["step_s"][1:]) * 1e3
        print(f"[train] {kind} L={LAYERS} N={N} f_hidden={F_HID} C="
              f"{TRAIN_BATCH} classes={classes}, {TRAIN_STEPS} steps lr "
              f"{TRAIN_LR}: mean loss first 5 {head:.4f}, last 5 {tail:.4f} "
              f"(acc last 5 {np.mean([h['acc'] for h in hist[-5:]]):.3f}); "
              f"a step p50 {build_ms + dev_ms:.2f} ms = host build_batch "
              f"{build_ms:.2f} ms + device (copy, forward, backward, "
              f"update, to a synchronize) {dev_ms:.2f} ms (first step's "
              f"device {out['step_s'][0] * 1e3:.2f} ms); wall "
              f"{out['wall_s']:.2f} s, phase {time.perf_counter() - t0:.2f} "
              f"s {'ok' if tail < head else 'FAIL'} [{label}]", flush=True)
        check(tail < head, f"{kind}: training did not lower the loss")
    launches = ops.launch_counts()
    check(all(n == 0 for n in launches.values()),
          f"training launched kernels {launches}")
    return launches


# -- phase 17: the MoE family: deepseek-v2-lite prefill and decode ----------


class RouteLog:
    """Records each ``models.moe.route`` call's experts (the MoE layers in
    the order they run) and, given ``pin``, routes to those experts
    instead, with the call's own probabilities of them renormalized (so
    two paths can be compared with their routing made equal)."""

    def __init__(self, pin=None):
        self.pin = list(pin) if pin is not None else None
        self.seen = []

    def __enter__(self):
        self._real = moe_mod.route

        def route(router_w, x2d, moe):
            top_e, top_p, aux = self._real(router_w, x2d, moe)
            if self.pin is not None:
                top_e = self.pin.pop(0)
                probs = torch.softmax(x2d.float() @ router_w.float(), -1)
                top_p = probs.gather(1, top_e)
                top_p = top_p / top_p.sum(dim=-1, keepdim=True)
            self.seen.append(top_e)
            return top_e, top_p, aux
        moe_mod.route = route
        return self

    def __exit__(self, *exc):
        moe_mod.route = self._real
        return False


def _route_agreement(a, b):
    """Share of (token, k) decisions of ``a`` that ``b`` also made (the
    same expert among the token's k, in any order)."""
    return float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())


def _drops(top_e, cfg, T):
    """Assignments past capacity in one MoE layer's routing."""
    cap = moe_mod.capacity(T, cfg.moe)
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.moe.num_experts)
    return int((counts - cap).clamp_min(0).sum()), cap


def moe_lm_phase(label):
    """Serves one 8192-token prompt of deepseek-v2-lite-16b (8 layers)
    through prefill and decode; returns the main path's launch counts."""
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    params, t_init = _timed(lambda: transformer.init_params(
        cfg, seed=0, device="cuda"))
    n_params = param_count(params)
    m, a = cfg.moe, cfg.mla
    print(f"[lm] {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} MLA "
          f"kv_lora={a.kv_lora_rank} qk={a.qk_nope_head_dim}+"
          f"{a.qk_rope_head_dim} v={a.v_head_dim}; {m.num_experts} experts "
          f"top-{m.top_k} + {m.num_shared} shared, expert ff "
          f"{m.d_ff_expert}, shared ff {m.d_ff_shared}, dense ff {cfg.d_ff} "
          f"(first {m.dense_first_k}); vocab={cfg.vocab_size} layers="
          f"{cfg.n_layers} (of 27): {n_params / 1e9:.3f} B parameters, "
          f"{n_params * 4 / 1e9:.2f} GB fp32, drawn on the card in "
          f"{t_init:.2f} s ({held / 2**30:.2f} GiB held before)", flush=True)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, LM_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    n_moe = cfg.n_layers - m.dense_first_k

    def prefill(impl, b=batch):
        return _timed(lambda: transformer.prefill(cfg, params, b, impl=impl))

    prefill("cuda")                        # warm-up: cuBLAS, first launches
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with RouteLog() as routes:
        logits, t_main = prefill("cuda")
    launches = ops.launch_counts()
    variants = dict(flash_kernels.variant_launches)
    peak = torch.cuda.max_memory_allocated()
    want = {k: (cfg.n_layers if k == "flash_attention" else 0)
            for k in launches}
    check(launches == want, f"prefill launches {launches}, expected {want}")
    check(variants == {"wgmma": cfg.n_layers, "cuda_core": 0},
          f"prefill's flash_attention launches by kernel {variants}, "
          f"expected all {cfg.n_layers} on the wgmma kernel (q/k 192, "
          f"v 128)")
    check(tuple(logits.shape) == (1, LM_SEQ, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "bad prefill logits")
    check(len(routes.seen) == n_moe, f"{len(routes.seen)} MoE layers "
                                     f"routed, expected {n_moe}")
    drops = [_drops(e, cfg, LM_SEQ) for e in routes.seen]
    again, t2 = prefill("cuda")
    same = bool(torch.equal(logits, again))
    del again
    times = [t_main, t2, prefill("cuda")[1]]
    print(f"[lm] {cfg.name} prefill impl=cuda B=1 S={LM_SEQ}: latency "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms (p50 "
          f"{statistics.median(times) * 1e3:.2f} ms), "
          f"{LM_SEQ / statistics.median(times):.0f} tokens/s, peak device "
          f"memory {peak / 2**30:.2f} GiB, launches {launches} (flash by "
          f"kernel {variants}); capacity {drops[0][1]} a layer, dropped "
          f"assignments by MoE layer {[d for d, _ in drops]} of "
          f"{LM_SEQ * m.top_k}; two prefills bitwise equal {same} "
          f"{'ok' if same else 'FAIL'} [{label}]", flush=True)
    check(same, "two impl='cuda' prefills differ")
    _profile(lambda: prefill("cuda"), label, f"one {cfg.name} prefill")

    before = ops.launch_counts()
    with RouteLog() as plain_routes:
        plain, t_plain = prefill("torch")
    check(ops.launch_counts() == before, "impl='torch' launched a kernel")
    agree = [_route_agreement(x, y)
             for x, y in zip(routes.seen, plain_routes.seen)]
    rel0, top10 = _agreement(logits, plain)
    del plain
    with RouteLog(pin=routes.seen) as pinned:
        plain, _ = prefill("torch")
    check(not pinned.pin, "pinned routing left unused")
    rel, top1 = _agreement(logits, plain)
    ok = (rel <= LM_TOL["rel"] and top1 >= LM_TOL["top1"]
          and min(agree) >= MOE_ROUTE_AGREE)
    print(f"[lm] {cfg.name} prefill impl=cuda vs impl=torch: routing "
          f"agreement by MoE layer {[round(x, 5) for x in agree]} (at least "
          f"{MOE_ROUTE_AGREE}); as routed, max abs err / max |logit| "
          f"{rel0:.3e}, top-1 {top10:.4f}; with impl=torch routed as "
          f"impl=cuda, max abs err / max |logit| {rel:.3e} (max |logit| "
          f"{float(plain.abs().max()):.3f}), top-1 agreement {top1:.4f} "
          f"over {LM_SEQ} positions (tolerance {LM_TOL}); impl=torch "
          f"latency {t_plain * 1e3:.2f} ms {'ok' if ok else 'FAIL'} "
          f"[{label}]", flush=True)
    check(ok, "the MoE prefill through the kernel disagrees with the plain "
              "path")
    del logits, plain

    # decode never drops (capacity 8 >= one token); the prefill of the
    # same 16 tokens may (capacity 8 an expert, and these random weights
    # route the tokens alike): its drops are counted, and decode is held
    # against the prefill with capacity for every assignment
    short = {"tokens": batch["tokens"][:, :LM_DECODE]}
    with RouteLog() as short_routes:
        prefill("cuda", short)
    short_drops = [_drops(e, cfg, LM_DECODE)[0] for e in short_routes.seen]
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=float(m.num_experts)))
    with RouteLog() as short_routes:
        ref = transformer.prefill(roomy, params, short, impl="cuda")
    check(sum(_drops(e, roomy, LM_DECODE)[0] for e in short_routes.seen)
          == 0, "the prefill with room for every assignment dropped one")

    dec, step_times, cache, log = _decode_run(cfg, params, batch["tokens"],
                                              LM_DECODE)
    check(tuple(dec.shape) == (1, LM_DECODE, cfg.vocab_size)
          and bool(torch.isfinite(dec).all()), "bad decode logits")
    by_layer = [torch.cat(log.seen[l::n_moe]) for l in range(n_moe)]
    dagree = [_route_agreement(x, y)
              for x, y in zip(short_routes.seen, by_layer)]
    rel0, top10 = _agreement(dec, ref)
    pin = [short_routes.seen[l][p:p + 1] for p in range(LM_DECODE)
           for l in range(n_moe)]
    dec, _, _, _ = _decode_run(cfg, params, batch["tokens"], LM_DECODE, pin)
    rel, top1 = _agreement(dec, ref)
    ok = rel <= DECODE_TOL["rel"] and top1 >= DECODE_TOL["top1"]
    p50 = statistics.median(step_times[1:])
    print(f"[lm] {cfg.name} decode {LM_DECODE} steps from an empty cache vs "
          f"prefill of the same tokens with capacity "
          f"{moe_mod.capacity(LM_DECODE, roomy.moe)} (at capacity "
          f"{moe_mod.capacity(LM_DECODE, m)} that prefill drops "
          f"{short_drops} assignments by MoE layer): routing agreement by "
          f"MoE layer "
          f"{[round(x, 4) for x in dagree]}; as routed, max abs err / max "
          f"|logit| {rel0:.3e}, top-1 {top10:.4f}; routed as the prefill, "
          f"max abs err / max |logit| {rel:.3e}, top-1 agreement "
          f"{top1:.4f} (tolerance {DECODE_TOL}); step latency p50 "
          f"{p50 * 1e3:.2f} ms (first {step_times[0] * 1e3:.2f} ms), "
          f"{1 / p50:.1f} tokens/s at B=1 {'ok' if ok else 'FAIL'} "
          f"[{label}]", flush=True)
    check(ok, "the MoE decode disagrees with prefill")
    _profile(lambda: transformer.decode_step(
        cfg, params, cache, batch["tokens"][:, LM_DECODE - 1:LM_DECODE],
        LM_DECODE - 1), label, f"one {cfg.name} decode step")
    return launches


# -- phase 19: the SSM family: mamba2-2.7b prefill and decode -------------


class SSDCapture:
    """Keeps the inputs of the ``index``-th ``mamba.ssd_chunked`` call of
    the model's layers (the mamba blocks look it up at call time)."""

    def __init__(self, index):
        self.index, self.calls, self.args = index, 0, None

    def __enter__(self):
        self._real = mamba_mod.ssd_chunked

        def ssd(*args, **kw):
            if self.calls == self.index:
                self.args = tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args)
            self.calls += 1
            return self._real(*args, **kw)
        mamba_mod.ssd_chunked = ssd
        return self

    def __exit__(self, *exc):
        mamba_mod.ssd_chunked = self._real
        return False


def _decode_run(cfg, params, tokens, n, pin=None):
    """``n`` decode steps from an empty cache: (logits [1,n,V], step
    times, cache, the steps' RouteLog)."""
    cache = transformer.init_cache(cfg, 1, n, device="cuda")
    steps, step_times = [], []
    with RouteLog(pin=pin) as log:
        for pos in range(n):
            (lg, cache), t = _timed(lambda: transformer.decode_step(
                cfg, params, cache, tokens[:, pos:pos + 1], pos))
            steps.append(lg[:, 0])
            step_times.append(t)
    return torch.stack(steps, dim=1), step_times, cache, log


def ssm_lm_phase(label):
    """Serves one 8192-token prompt of mamba2-2.7b (all 64 layers) through
    prefill and decode; checks the chunked SSD against the float64
    recurrence on one layer's inputs. No kernel of the repository is on
    this path: returns the prefill's launch counts (all zero)."""
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = get_config(SSM_ARCH)
    params, t_init = _timed(lambda: transformer.init_params(
        cfg, seed=0, device="cuda"))
    n_params = param_count(params)
    d_inner, H, _ = mamba_mod.dims(cfg.d_model, cfg.ssm)
    m = cfg.ssm
    print(f"[lm] {cfg.name} d_model={cfg.d_model} d_inner={d_inner} SSM "
          f"H={H} P={m.head_dim} N={m.d_state} chunk={m.chunk_size} "
          f"d_conv={m.d_conv} vocab={cfg.vocab_size} layers={cfg.n_layers} "
          f"(all): {n_params / 1e9:.3f} B parameters, "
          f"{n_params * 4 / 1e9:.2f} GB fp32, drawn on the card in "
          f"{t_init:.2f} s ({held / 2**30:.2f} GiB held before)", flush=True)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, LM_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}

    def prefill(impl, b=batch):
        return _timed(lambda: transformer.prefill(cfg, params, b, impl=impl))

    prefill("cuda")                        # warm-up: cuBLAS, first launches
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits, t_main = prefill("cuda")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(not any(launches.values()),
          f"the SSM prefill launched {launches}: no kernel is on its path")
    check(tuple(logits.shape) == (1, LM_SEQ, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "bad prefill logits")
    with SSDCapture(cfg.n_layers // 2) as cap:
        again, t2 = prefill("cuda")
    same = bool(torch.equal(logits, again))
    plain, t_plain = prefill("torch")
    same_impls = bool(torch.equal(logits, plain))
    del again, plain
    times = [t_main, t2, prefill("cuda")[1]]
    nc = LM_SEQ // m.chunk_size
    print(f"[lm] {cfg.name} prefill B=1 S={LM_SEQ}: latency "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms (p50 "
          f"{statistics.median(times) * 1e3:.2f} ms), "
          f"{LM_SEQ / statistics.median(times):.0f} tokens/s, peak device "
          f"memory {peak / 2**30:.2f} GiB, launches {launches}; two "
          f"prefills bitwise equal {same}; impl=torch (the same plain SSD) "
          f"bitwise equal {same_impls}, {t_plain * 1e3:.2f} ms "
          f"{'ok' if same and same_impls else 'FAIL'} [{label}]",
          flush=True)
    check(same and same_impls, "two SSM prefills differ")
    prof = _profile(lambda: prefill("cuda"), label,
                    f"one {cfg.name} prefill", top=12)
    per_layer = prof["ops"] / cfg.n_layers
    print(f"[lm] {cfg.name} prefill: {prof['ops']} kernels and copies, "
          f"{per_layer:.1f} a layer (predicted {SSM_OPS[0]}-{SSM_OPS[1]}, "
          f"of which the chunk loop's {nc} addcmuls), busy "
          f"{prof['busy']:.1%} [{label}]", flush=True)

    # the chunked SSD against the float64 recurrence on layer L/2's inputs
    x, dt, A, B, C, chunk = cap.args
    check(tuple(x.shape) == (1, LM_SEQ, H, m.head_dim) and chunk ==
          m.chunk_size, f"captured SSD inputs {tuple(x.shape)}, {chunk}")
    # x arrives in bf16 (the compute type): given in fp32 (exact; the
    # chunked SSD widens it first anyway) so that y is not rounded to bf16
    x = x.float()
    y, st = mamba_mod.ssd_chunked(x, dt, A, B, C, chunk)
    y64, st64 = mamba_mod.ssd_reference(
        *(t.double() for t in (x, dt, A, B, C)), dtype=torch.float64,
        return_state=True)
    rel_y = float((y.double() - y64).abs().max() / y64.abs().max())
    rel_s = float((st.double() - st64).abs().max() / st64.abs().max())
    ok = rel_y <= SSD_TOL and rel_s <= SSD_TOL
    print(f"[lm] {cfg.name} ssd_chunked (fp32) vs the float64 recurrence on "
          f"layer {cfg.n_layers // 2}'s inputs (H={H} P={m.head_dim} "
          f"N={m.d_state} S={LM_SEQ}, {nc} chunks): max abs err / max |y| "
          f"{rel_y:.3e}, final state {rel_s:.3e} (tolerance {SSD_TOL}) "
          f"{'ok' if ok else 'FAIL'} [{label}]", flush=True)
    check(ok, "ssd_chunked disagrees with the float64 recurrence")
    ssd_ms = cuda_ms(lambda: mamba_mod.ssd_chunked(x, dt, A, B, C, chunk),
                     iters=5, warmup=1)
    print(f"[lm] {cfg.name} ssd_chunked alone at that shape: {ssd_ms:.3f} "
          f"ms a layer (CUDA events) [{label}]", flush=True)
    del x, dt, A, B, C, y, y64, st, st64, cap, logits

    head = {"tokens": batch["tokens"][:, :LM_DECODE]}
    dec, step_times, cache, _ = _decode_run(cfg, params, batch["tokens"],
                                            LM_DECODE)
    check(tuple(dec.shape) == (1, LM_DECODE, cfg.vocab_size)
          and bool(torch.isfinite(dec).all()), "bad decode logits")
    rel64, top64 = _agreement(dec, prefill("cuda", head)[0])
    p50 = statistics.median(step_times[1:])
    prof = _profile(lambda: transformer.decode_step(
        cfg, params, cache, batch["tokens"][:, LM_DECODE - 1:LM_DECODE],
        LM_DECODE - 1), label, f"one {cfg.name} decode step")
    print(f"[lm] {cfg.name} decode {LM_DECODE} steps at all {cfg.n_layers} "
          f"layers: step latency p50 {p50 * 1e3:.2f} ms (first "
          f"{step_times[0] * 1e3:.2f} ms), {1 / p50:.1f} tokens/s at B=1, "
          f"busy {prof['busy']:.1%}, {prof['ops']} kernels and copies a "
          f"step; vs prefill of the same tokens (not held: see "
          f"SSM_DECODE_LAYERS) max abs err / max |logit| {rel64:.3e}, top-1 "
          f"{top64:.4f} [{label}]", flush=True)
    # held: the same params' first SSM_DECODE_LAYERS layers (views)
    cut = dataclasses.replace(cfg, n_layers=SSM_DECODE_LAYERS)
    first = dict(params, blocks=tree_map(lambda v: v[:SSM_DECODE_LAYERS],
                                         params["blocks"]))
    dec, _, _, _ = _decode_run(cut, first, batch["tokens"], LM_DECODE)
    ref = transformer.prefill(cut, first, head, impl="cuda")
    rel, top1 = _agreement(dec, ref)
    ok = rel <= DECODE_TOL["rel"] and top1 >= DECODE_TOL["top1"]
    print(f"[lm] {cfg.name} decode {LM_DECODE} steps from an empty cache vs "
          f"prefill of the same tokens at its first {SSM_DECODE_LAYERS} "
          f"layers: max abs err / max |logit| {rel:.3e}, top-1 agreement "
          f"{top1:.4f} (tolerance {DECODE_TOL}) {'ok' if ok else 'FAIL'} "
          f"[{label}]", flush=True)
    check(ok, "the SSM decode disagrees with prefill")
    return launches


# -- phase 20: the hybrid family: one Jamba period, prefill and decode ------


def hybrid_lm_phase(label):
    """Serves one period of jamba-1.5-large-398b (8 layers at full width,
    4 of its 16 experts) through prefill and decode; returns the main
    path's launch counts (flash_attention once a period)."""
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    full = get_config(HYBRID_ARCH)
    per = full.hybrid_attn_period
    cfg = dataclasses.replace(full, n_layers=per, moe=dataclasses.replace(
        full.moe, num_experts=HYBRID_EXPERTS))
    params, t_init = _timed(lambda: transformer.init_params(
        cfg, seed=0, device="cuda"))
    n_params = param_count(params)
    _, H, _ = mamba_mod.dims(cfg.d_model, cfg.ssm)
    m = cfg.moe
    kinds = transformer._period(cfg)
    print(f"[lm] {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} "
          f"d_ff={cfg.d_ff} expert ff {m.d_ff_expert} SSM H={H} "
          f"P={cfg.ssm.head_dim} N={cfg.ssm.d_state} vocab={cfg.vocab_size}"
          f"; layers {[f'{a}+{f}' for a, f in kinds]}; CUT: one period of "
          f"{per} layers (of {full.n_layers}), experts "
          f"{full.moe.num_experts} -> {m.num_experts} (top-{m.top_k} kept, "
          f"every width kept): {n_params / 1e9:.3f} B parameters, "
          f"{n_params * 2 / 1e9:.2f} GB bf16, drawn on the card in "
          f"{t_init:.2f} s ({held / 2**30:.2f} GiB held before)", flush=True)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, LM_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    short = {"tokens": batch["tokens"][:, :HYBRID_SHORT]}
    n_moe = sum(f == "moe" for _, f in kinds)

    def prefill(impl, b=batch):
        return _timed(lambda: transformer.prefill(cfg, params, b, impl=impl))

    # impl="cuda" against impl="torch" on the short prompt
    prefill("cuda", short)
    before = ops.launch_counts()
    with RouteLog() as routes:
        logits, _ = prefill("cuda", short)
    check(ops.launch_counts()["flash_attention"]
          == before["flash_attention"] + 1, "the short prefill did not "
          "launch flash_attention once")
    before = ops.launch_counts()
    with RouteLog() as plain_routes:
        plain, t_plain = prefill("torch", short)
    check(ops.launch_counts() == before, "impl='torch' launched a kernel")
    agree = [_route_agreement(x, y)
             for x, y in zip(routes.seen, plain_routes.seen)]
    rel0, top10 = _agreement(logits, plain)
    del plain
    with RouteLog(pin=routes.seen) as pinned:
        plain, _ = prefill("torch", short)
    check(not pinned.pin, "pinned routing left unused")
    rel, top1 = _agreement(logits, plain)
    ok = (len(agree) == n_moe and rel <= LM_TOL["rel"]
          and top1 >= LM_TOL["top1"] and min(agree) >= MOE_ROUTE_AGREE)
    print(f"[lm] {cfg.name} prefill S={HYBRID_SHORT} impl=cuda vs "
          f"impl=torch: routing agreement by MoE layer "
          f"{[round(x, 5) for x in agree]} (at least {MOE_ROUTE_AGREE}); as "
          f"routed, max abs err / max |logit| {rel0:.3e}, top-1 "
          f"{top10:.4f}; with impl=torch routed as impl=cuda, max abs err / "
          f"max |logit| {rel:.3e} (max |logit| "
          f"{float(plain.abs().max()):.3f}), top-1 agreement {top1:.4f} "
          f"(tolerance {LM_TOL}); impl=torch latency {t_plain * 1e3:.2f} ms "
          f"{'ok' if ok else 'FAIL'} [{label}]", flush=True)
    check(ok, "the hybrid prefill through the kernel disagrees with the "
              "plain path")
    del logits, plain

    # the timed prefill at full length on impl="cuda"
    prefill("cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with RouteLog() as routes:
        logits, t_main = prefill("cuda")
    launches = ops.launch_counts()
    variants = dict(flash_kernels.variant_launches)
    peak = torch.cuda.max_memory_allocated()
    _prefill_launch_checks(cfg.name, launches, variants,
                           cfg.n_layers // per)
    check(tuple(logits.shape) == (1, LM_SEQ, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "bad prefill logits")
    check(len(routes.seen) == n_moe, f"{len(routes.seen)} MoE layers "
                                     f"routed, expected {n_moe}")
    drops = [_drops(e, cfg, LM_SEQ) for e in routes.seen]
    again, t2 = prefill("cuda")
    same = bool(torch.equal(logits, again))
    del again, logits
    times = [t_main, t2, prefill("cuda")[1]]
    print(f"[lm] {cfg.name} prefill impl=cuda B=1 S={LM_SEQ}: latency "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms (p50 "
          f"{statistics.median(times) * 1e3:.2f} ms), "
          f"{LM_SEQ / statistics.median(times):.0f} tokens/s, peak device "
          f"memory {peak / 2**30:.2f} GiB, launches {launches} (flash by "
          f"kernel {variants}); capacity {drops[0][1]} a layer, dropped "
          f"assignments by MoE layer {[d for d, _ in drops]} of "
          f"{LM_SEQ * m.top_k}; two prefills bitwise equal {same} "
          f"{'ok' if same else 'FAIL'} [{label}]", flush=True)
    check(same, "two impl='cuda' hybrid prefills differ")
    prof = _profile(lambda: prefill("cuda"), label,
                    f"one {cfg.name} period prefill", top=12)

    # decode against the prefill of the same 16 tokens (4 experts of
    # capacity 16 cannot overflow: each token sends one assignment to at
    # most each expert), routed as that prefill
    head = {"tokens": batch["tokens"][:, :LM_DECODE]}
    with RouteLog() as short_routes:
        ref, _ = prefill("cuda", head)
    check(sum(_drops(e, cfg, LM_DECODE)[0] for e in short_routes.seen) == 0,
          "the 16-token prefill dropped an assignment")
    dec, step_times, cache, log = _decode_run(cfg, params, batch["tokens"],
                                              LM_DECODE)
    check(tuple(dec.shape) == (1, LM_DECODE, cfg.vocab_size)
          and bool(torch.isfinite(dec).all()), "bad decode logits")
    by_layer = [torch.cat(log.seen[l::n_moe]) for l in range(n_moe)]
    dagree = [_route_agreement(x, y)
              for x, y in zip(short_routes.seen, by_layer)]
    rel0, top10 = _agreement(dec, ref)
    pin = [short_routes.seen[l][p:p + 1] for p in range(LM_DECODE)
           for l in range(n_moe)]
    dec, _, _, _ = _decode_run(cfg, params, batch["tokens"], LM_DECODE, pin)
    rel, top1 = _agreement(dec, ref)
    ok = rel <= DECODE_TOL["rel"] and top1 >= DECODE_TOL["top1"]
    p50 = statistics.median(step_times[1:])
    dprof = _profile(lambda: transformer.decode_step(
        cfg, params, cache, batch["tokens"][:, LM_DECODE - 1:LM_DECODE],
        LM_DECODE - 1), label, f"one {cfg.name} period decode step")
    print(f"[lm] {cfg.name} decode {LM_DECODE} steps from an empty cache vs "
          f"prefill of the same tokens: routing agreement by MoE layer "
          f"{[round(x, 4) for x in dagree]}; as routed, max abs err / max "
          f"|logit| {rel0:.3e}, top-1 {top10:.4f}; routed as the prefill, "
          f"max abs err / max |logit| {rel:.3e}, top-1 agreement "
          f"{top1:.4f} (tolerance {DECODE_TOL}); step latency p50 "
          f"{p50 * 1e3:.2f} ms (first {step_times[0] * 1e3:.2f} ms), "
          f"{1 / p50:.1f} tokens/s at B=1, busy {dprof['busy']:.1%}; "
          f"prefill busy {prof['busy']:.1%} {'ok' if ok else 'FAIL'} "
          f"[{label}]", flush=True)
    check(ok, "the hybrid decode disagrees with prefill")
    return launches


class FlashLog:
    """Records the ``causal`` flag of each ``flash_attention`` call the
    attention layers make (it only observes: the wrapper counts the
    launches), so a prefill's launches split into whisper's encoder
    (non-causal) and decoder (causal) layers."""

    def __enter__(self):
        self._real = attn_mod.flash_attention
        self.causal = []

        def observed(q, k, v, *, causal=True):
            self.causal.append(bool(causal))
            return self._real(q, k, v, causal=causal)
        attn_mod.flash_attention = observed
        return self

    def __exit__(self, *exc):
        attn_mod.flash_attention = self._real
        return False


def _prefill_launch_checks(name, launches, variants, n_flash):
    want = {k: (n_flash if k == "flash_attention" else 0) for k in launches}
    check(launches == want, f"{name} prefill launches {launches}, expected "
                            f"{want}")
    check(variants == {"wgmma": n_flash, "cuda_core": 0},
          f"{name} prefill's flash_attention launches by kernel {variants}, "
          f"expected all {n_flash} on the wgmma kernel")


def _serve_checks(cfg, params, batch, label, n_flash, what=""):
    """The checks each [lm] serving phase makes on its prefill: a warm-up,
    then the main path's impl="cuda" prefill with its launches read (all
    ``n_flash`` on the wgmma kernel, each call's ``causal`` flag logged),
    finite fp32 logits [B, S, V], two more prefills timed, the second
    bitwise equal to the first, the profile, and impl="torch" at
    ``LM_TOL``. Returns (logits, launches, the causal flags)."""
    B, S = batch["tokens"].shape

    def prefill(impl):
        return _timed(lambda: transformer.prefill(cfg, params, batch,
                                                  impl=impl))

    prefill("cuda")                        # warm-up: cuBLAS, first launches
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with FlashLog() as flog:
        logits, t_main = prefill("cuda")
    launches = ops.launch_counts()
    variants = dict(flash_kernels.variant_launches)
    peak = torch.cuda.max_memory_allocated()
    _prefill_launch_checks(cfg.name, launches, variants, n_flash)
    check(tuple(logits.shape) == (B, S, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "bad prefill logits")
    again, t2 = prefill("cuda")
    same = bool(torch.equal(logits, again))
    del again
    times = [t_main, t2, prefill("cuda")[1]]
    p50 = statistics.median(times)
    prof = _profile(lambda: prefill("cuda"), label,
                    f"one {cfg.name} prefill", top=10)
    n_causal = flog.causal.count(True)
    print(f"[lm] {cfg.name} prefill impl=cuda B={B} S={S}{what}: latency "
          f"{', '.join(f'{t * 1e3:.3f}' for t in times)} ms (p50 "
          f"{p50 * 1e3:.3f} ms), {B * S / p50:.0f} tokens/s, peak device "
          f"memory {peak / 2**30:.3f} GiB, busy {prof['busy']:.1%}, "
          f"launches {launches} (flash by kernel {variants}; "
          f"{len(flog.causal) - n_causal} non-causal, {n_causal} causal); "
          f"two prefills bitwise equal {same} {'ok' if same else 'FAIL'} "
          f"[{label}]", flush=True)
    check(same, f"two impl='cuda' {cfg.name} prefills differ")

    before = ops.launch_counts()
    plain, t_plain = prefill("torch")
    check(ops.launch_counts() == before, "impl='torch' launched a kernel")
    rel, top1 = _agreement(logits, plain)
    ok = rel <= LM_TOL["rel"] and top1 >= LM_TOL["top1"]
    print(f"[lm] {cfg.name} prefill impl=cuda vs impl=torch: max abs err / "
          f"max |logit| {rel:.3e} (max |logit| {float(plain.abs().max()):.3f}"
          f"), top-1 agreement {top1:.4f} over {B * S} positions (tolerance "
          f"{LM_TOL}); impl=torch latency {t_plain * 1e3:.2f} ms "
          f"{'ok' if ok else 'FAIL'} [{label}]", flush=True)
    check(ok, f"the {cfg.name} prefill through the kernel disagrees with "
              f"the plain path")
    return logits, launches, flog.causal


def _fill_cross_cache(cfg, params, cache, frames):
    """Writes the encoder's keys and values into ``cache``'s cross_k /
    cross_v, layer by layer (``cross_kv`` of ``_encode``'s output, the
    layer cast to the compute type, then to the cache's bf16): what the
    prefill computes inside its decoder layers."""
    enc = transformer._encode(cfg, params, frames, impl="cuda")
    for l in range(cfg.n_layers):
        bp = cast_tree(transformer._layer(params["blocks"], l),
                       transformer._cdt(cfg))
        k, v = attn_mod.cross_kv(bp["cross"], enc, n_kv=cfg.n_kv_heads,
                                 head_dim=cfg.resolved_head_dim)
        cache["cross_k"][l] = k.to(transformer.CACHE_DTYPE)
        cache["cross_v"][l] = v.to(transformer.CACHE_DTYPE)
    return cache


def audio_lm_phase(label):
    """Serves whisper-tiny (full width and depth) through prefill (16 clips
    of 1500 frames, a 448-token prompt) and 16 decode steps over the cross
    cache; returns the main path's launch counts and the flash launches of
    the encoder and of the decoder."""
    torch.cuda.empty_cache()
    cfg = get_config(AUDIO_ARCH)
    params, t_init = _timed(lambda: transformer.init_params(
        cfg, seed=0, device="cuda", max_seq=AUDIO_SEQ))
    n_params = param_count(params)
    enc = cfg.encoder
    print(f"[lm] {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} (GELU) "
          f"vocab={cfg.vocab_size} encoder {enc.n_layers} layers over "
          f"{enc.n_frames} frames, decoder {cfg.n_layers} layers: "
          f"{n_params / 1e9:.4f} B parameters, {n_params * 4 / 1e9:.3f} GB "
          f"fp32 (whole model), drawn on the card in {t_init:.2f} s",
          flush=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size,
                          (AUDIO_B, AUDIO_SEQ)).astype(np.int32)
    frames = rng.standard_normal(
        (AUDIO_B, enc.n_frames, cfg.d_model)).astype(np.float32)
    batch = {"tokens": torch.from_numpy(tokens).cuda(),
             "frames": torch.from_numpy(frames).cuda()}

    logits, launches, causal = _serve_checks(
        cfg, params, batch, label, enc.n_layers + cfg.n_layers,
        f" (+{enc.n_frames} frames a clip)")
    n_enc, n_dec = causal.count(False), causal.count(True)
    check((n_enc, n_dec) == (enc.n_layers, cfg.n_layers),
          f"flash launches encoder {n_enc}, decoder {n_dec}")
    ref = logits[:, :LM_DECODE].clone()
    del logits

    cache = _fill_cross_cache(cfg, params, transformer.init_cache(
        cfg, AUDIO_B, LM_DECODE, device="cuda"), batch["frames"])
    steps, step_times = [], []
    for pos in range(LM_DECODE):
        (lg, cache), t = _timed(lambda: transformer.decode_step(
            cfg, params, cache, batch["tokens"][:, pos:pos + 1], pos))
        steps.append(lg[:, 0])
        step_times.append(t)
    dec = torch.stack(steps, dim=1)
    check(tuple(dec.shape) == (AUDIO_B, LM_DECODE, cfg.vocab_size)
          and bool(torch.isfinite(dec).all()), "bad decode logits")
    rel, top1 = _agreement(dec, ref)
    ok = rel <= DECODE_TOL["rel"] and top1 >= DECODE_TOL["top1"]
    d50 = statistics.median(step_times[1:])
    dprof = _profile(lambda: transformer.decode_step(
        cfg, params, cache, batch["tokens"][:, LM_DECODE - 1:LM_DECODE],
        LM_DECODE - 1), label, f"one {cfg.name} decode step")
    print(f"[lm] {cfg.name} decode {LM_DECODE} steps over the filled cross "
          f"cache vs the prefill's first {LM_DECODE} positions: max abs err "
          f"/ max |logit| {rel:.3e}, top-1 agreement {top1:.4f} (tolerance "
          f"{DECODE_TOL}); step latency p50 {d50 * 1e3:.3f} ms (first "
          f"{step_times[0] * 1e3:.2f} ms), {AUDIO_B / d50:.1f} tokens/s at "
          f"B={AUDIO_B}, busy {dprof['busy']:.1%} "
          f"{'ok' if ok else 'FAIL'} [{label}]", flush=True)
    check(ok, f"the {cfg.name} decode disagrees with prefill")
    return launches, n_enc, n_dec


def vlm_lm_phase(label):
    """Serves pixtral-12b (8 layers at full width) through prefill with
    256 random patch embeddings spliced and 16 decode steps; returns the
    main path's launch counts."""
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    params, t_init = _timed(lambda: transformer.init_params(
        cfg, seed=0, device="cuda"))
    n_params = param_count(params)
    P = cfg.vision.n_patches
    print(f"[lm] {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} patches={P}; CUT: "
          f"layers {cfg.n_layers} (of {full.n_layers}): "
          f"{n_params / 1e9:.3f} B parameters, {n_params * 4 / 1e9:.2f} GB "
          f"fp32, drawn on the card in {t_init:.2f} s "
          f"({held / 2**30:.2f} GiB held before)", flush=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (1, LM_SEQ)).astype(np.int32)
    patches = rng.standard_normal((1, P, cfg.d_model)).astype(np.float32)
    batch = {"tokens": torch.from_numpy(tokens).cuda(),
             "patch_embeds": torch.from_numpy(patches).cuda()}

    logits, launches, _ = _serve_checks(cfg, params, batch, label,
                                        cfg.n_layers,
                                        f" ({P} patches spliced)")
    del logits

    # the identity splice (the prompt's own first P token embeddings)
    # against the same params served as the dense family
    own = params["embed"][batch["tokens"][:, :P].long()]
    ident = transformer.prefill(cfg, params, {
        "tokens": batch["tokens"], "patch_embeds": own}, impl="cuda")
    dense_cfg = dataclasses.replace(cfg, family="dense", vision=None)
    dense = transformer.prefill(dense_cfg, params,
                                {"tokens": batch["tokens"]}, impl="cuda")
    same = bool(torch.equal(ident, dense))
    ref = ident[:, :LM_DECODE].clone()
    del ident, dense
    print(f"[lm] {cfg.name} identity splice vs the dense family's prefill "
          f"of the same params: bitwise equal {same} "
          f"{'ok' if same else 'FAIL'} [{label}]", flush=True)
    check(same, "the identity splice differs from the dense prefill")

    dec, step_times, cache, _ = _decode_run(cfg, params, batch["tokens"],
                                            LM_DECODE)
    check(tuple(dec.shape) == (1, LM_DECODE, cfg.vocab_size)
          and bool(torch.isfinite(dec).all()), "bad decode logits")
    rel, top1 = _agreement(dec, ref)
    ok = rel <= DECODE_TOL["rel"] and top1 >= DECODE_TOL["top1"]
    d50 = statistics.median(step_times[1:])
    dprof = _profile(lambda: transformer.decode_step(
        cfg, params, cache, batch["tokens"][:, LM_DECODE - 1:LM_DECODE],
        LM_DECODE - 1), label, f"one {cfg.name} decode step")
    print(f"[lm] {cfg.name} decode {LM_DECODE} steps from an empty cache vs "
          f"the identity-splice prefill's first {LM_DECODE} positions: max "
          f"abs err / max |logit| {rel:.3e}, top-1 agreement {top1:.4f} "
          f"(tolerance {DECODE_TOL}); step latency p50 {d50 * 1e3:.2f} ms "
          f"(first {step_times[0] * 1e3:.2f} ms), {1 / d50:.1f} tokens/s at "
          f"B=1, busy {dprof['busy']:.1%} {'ok' if ok else 'FAIL'} "
          f"[{label}]", flush=True)
    check(ok, f"the {cfg.name} decode disagrees with prefill")
    return launches


class MoEInput:
    """Keeps the input of the first ``moe_ffn_gather`` call (detached)."""

    def __enter__(self):
        self._real = moe_mod.moe_ffn_gather
        self.x = None

        def kept(params, x, moe, *, act="silu"):
            if self.x is None:
                self.x = x.detach().clone()
            return self._real(params, x, moe, act=act)
        moe_mod.moe_ffn_gather = kept
        return self

    def __exit__(self, *exc):
        moe_mod.moe_ffn_gather = self._real
        return False


def _moe_grad64(params, x, moe, g):
    """(output, input gradient of sum(y * g)) of one MoE layer in float64,
    through whatever ``routed_dispatch`` / ``routed_combine`` are."""
    xx = x.double().requires_grad_(True)
    with torch.enable_grad():
        y, _ = moe_mod.moe_ffn_gather(params, xx, moe)
        (gx,) = torch.autograd.grad((y * g).sum(), xx)
    return y.detach(), gx


def lm_train_phase(label):
    """whisper-tiny trained through ``train.loop.train`` (30 steps, killed
    at 20 and resumed), then one deepseek-v2-lite step (2 layers, gather
    dispatch) with its MoE pair's gradient held in float64; returns the
    kernels' launches during training (all 0)."""
    torch.cuda.empty_cache()
    shutil.rmtree(LM_TRAIN_DIR, ignore_errors=True)
    LM_TRAIN_DIR.mkdir(parents=True)
    t = TRAIN_LM
    cfg = get_config(t["arch"])
    opt = AdamWConfig(lr=t["lr"], moment_dtype=cfg.dtype.opt_dtype)

    def job(name):
        return lm_loop.TrainJobConfig(
            steps=t["steps"], ckpt_every=t["ckpt_every"],
            ckpt_dir=str(LM_TRAIN_DIR / name), seq_len=t["seq"],
            global_batch=t["batch"],
            log_path=str(LM_TRAIN_DIR / f"{name}.jsonl"))

    print(f"[lm-train] {cfg.name} (full width and depth) through "
          f"train.loop.train: B={t['batch']} S={t['seq']} lr={t['lr']} "
          f"{t['steps']} steps, a checkpoint every {t['ckpt_every']}",
          flush=True)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    _, _, full = lm_loop.train(cfg, job("full"), opt, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in full]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    ok = bool(np.isfinite(losses).all()) and last < first
    dev_ms = statistics.median(h["step_time_s"] for h in full[1:]) * 1e3
    host_ms = statistics.median(h["data_time_s"] for h in full[1:]) * 1e3
    print(f"[lm-train] {cfg.name} losses {[round(x, 4) for x in losses]}; "
          f"mean of the first 5 {first:.4f}, of the last 5 {last:.4f}; "
          f"ms a step p50: host (batch) {host_ms:.3f} + device (forward, "
          f"backward, AdamW, to the loss read back) {dev_ms:.3f} (first step "
          f"{full[0]['step_time_s'] * 1e3:.1f}); peak device memory "
          f"{peak / 2**30:.3f} GiB {'ok' if ok else 'FAIL'} [{label}]",
          flush=True)
    check(ok, f"{cfg.name} training: the loss is not finite or did not "
              f"fall")
    try:
        lm_loop.train(cfg, job("killed"), opt, fail_at_step=t["fail_at"],
                      device="cuda")
        killed = False
    except RuntimeError as e:
        killed = "injected failure" in str(e)
        if not killed:
            raise
    check(killed, "fail_at_step did not stop the run")
    committed = ckpt_mod.committed_steps(str(LM_TRAIN_DIR / "killed"))
    _, _, resumed = lm_loop.train(cfg, job("killed"), opt, device="cuda")
    with open(LM_TRAIN_DIR / "killed.jsonl") as f:
        log = [json.loads(line) for line in f]
    ref = {h["step"]: h["loss"] for h in full}
    worst = max(abs(h["loss"] - ref[h["step"]]) / abs(ref[h["step"]])
                for h in log)
    ok = (committed[-1] == t["fail_at"] and resumed[0]["step"]
          == t["fail_at"] + 1 and [h["step"] for h in log]
          == list(range(1, t["steps"] + 1)) and worst <= t["rtol"])
    print(f"[lm-train] {cfg.name} killed at step {t['fail_at']} "
          f"(committed checkpoints {committed}) and resumed from step "
          f"{resumed[0]['step']}: every logged loss against the "
          f"uninterrupted run's, largest relative difference {worst:.3e} "
          f"(rtol {t['rtol']}) {'ok' if ok else 'FAIL'} [{label}]",
          flush=True)
    check(ok, "the resumed run does not continue the uninterrupted run's "
              "loss curve")

    # one MoE step at full width
    torch.cuda.empty_cache()
    full_cfg = get_config(MOE_ARCH)
    mcfg = dataclasses.replace(full_cfg, n_layers=MOE_TRAIN_LAYERS,
                               moe=dataclasses.replace(full_cfg.moe,
                                                       dispatch="gather"))
    params = transformer.init_params(mcfg, seed=0, device="cuda")
    n_params = param_count(params)
    mopt = AdamWConfig(lr=t["lr"], moment_dtype=mcfg.dtype.opt_dtype)
    state = init_opt(params, mopt)
    step = make_train_step(mcfg, mopt)
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [], []
    for s in range(2):
        t0 = time.perf_counter()
        batch = synthetic_batch(TokenPipelineConfig(
            vocab_size=mcfg.vocab_size, seq_len=MOE_TRAIN_SEQ,
            global_batch=1, seed=0), s)
        t1 = time.perf_counter()
        with MoEInput() as cap:
            params, state, m = step(params, state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        metrics.append((loss, gn, float(m["aux"])))
        times.append((t1 - t0, time.perf_counter() - t1))
    peak = torch.cuda.max_memory_allocated()
    ok = all(np.isfinite(m[:2]).all() and m[1] > 0 for m in metrics)
    print(f"[lm-train] {mcfg.name} d_model={mcfg.d_model} CUT: "
          f"{mcfg.n_layers} layers (of {full_cfg.n_layers}: the dense first "
          f"layer and one MoE layer, {mcfg.moe.num_experts} experts top-"
          f"{mcfg.moe.top_k}, dispatch gather): {n_params / 1e9:.3f} B "
          f"parameters; B=1 S={MOE_TRAIN_SEQ}; steps (loss, grad_norm, aux) "
          f"{[tuple(round(v, 5) for v in m) for m in metrics]}; ms a step: "
          f"host {[round(a * 1e3, 3) for a, _ in times]} + device "
          f"{[round(b * 1e3, 2) for _, b in times]}; peak device memory "
          f"{peak / 2**30:.2f} GiB {'ok' if ok else 'FAIL'} [{label}]",
          flush=True)
    check(ok, "the MoE train step is not finite or has no gradient")

    # the MoE layer's input gradient: the autograd pair against autograd
    # through plain indexing of the same forward, float64 on the card
    layer = {k: (v[0] if not isinstance(v, dict)
                 else {kk: vv[0] for kk, vv in v.items()})
             for k, v in params["blocks"]["ffn"].items()}
    p64 = tree_map(lambda p: p.detach().double(), layer)
    x = cap.x
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = torch.randn(x.shape, generator=gen, device="cuda",
                    dtype=torch.float64)
    y_pair, g_pair = _moe_grad64(p64, x, mcfg.moe, g)
    real = (moe_mod.routed_dispatch, moe_mod.routed_combine)
    moe_mod.routed_dispatch = lambda x2d, st, dt, k: \
        moe_mod._dispatch_gather(x2d, st)
    moe_mod.routed_combine = lambda f, dt, sp: moe_mod._combine_gather(f, dt)
    try:
        y_plain, g_plain = _moe_grad64(p64, x, mcfg.moe, g)
    finally:
        moe_mod.routed_dispatch, moe_mod.routed_combine = real
    err = float((g_pair - g_plain).abs().max() / g_plain.abs().max())
    same_y = bool(torch.equal(y_pair, y_plain))
    ok = same_y and err <= GRAD64_TOL
    print(f"[lm-train] {mcfg.name} MoE layer input gradient, float64 on the "
          f"card (x {tuple(x.shape)}): the gather pair vs autograd through "
          f"plain indexing: forward bitwise equal {same_y}, max |diff| / max "
          f"|g| {err:.3e} (at most {GRAD64_TOL}) {'ok' if ok else 'FAIL'} "
          f"[{label}]", flush=True)
    check(ok, "the MoE dispatch pair's gradient disagrees with autograd "
              "through plain indexing")
    return ops.launch_counts()


def flash_row(dev, label, what, B, H, KH, S, D, causal, seed):
    """``flash_attention`` at one model's attention shape (bf16, q [B,H,S,D],
    k/v [B,KH,S,D]) on the wgmma kernel: checked, timed beside its plain
    version and in turns with SDPA (``enable_gqa`` where KH < H) through
    the host and in a CUDA graph (``turns``), with the bound from the
    operations and bytes; returns its record."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v = rnd(B, H, S, D), rnd(B, KH, S, D), rnd(B, KH, S, D)
    tag = (f"B={B} H={H} Kh={KH} S={S} D={D} bf16 "
           f"{'causal' if causal else 'non-causal'}")
    r = flash_wgmma_check(f"flash wgmma {tag} ({what})", q, k, v, causal)
    call = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=causal, enable_gqa=KH < H)
    t = turns({"kernel": call, "sdpa": sdpa}, iters=50 if S > 4096 else 200)
    ms, lib = (statistics.median(t[n]["host"]) for n in ("kernel", "sdpa"))
    dev_ms, lib_dev = (statistics.median(t[n]["graph"])
                       for n in ("kernel", "sdpa"))
    host = host_us(call)
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal),
                    iters=3, warmup=1)
    flops = flash_cost(B, H, S, S, D, causal=causal)["flops"]
    moved = 2 * nbytes(q) + nbytes(k, v)
    bnd, by = bound_ms(moved, flops, PEAK_BF16_FLOPS)
    sd = f"scaled_dot_product_attention{', enable_gqa' if KH < H else ''}"
    print(f"  flash wgmma {tag} ({what}): medians [min-max] of 5 rounds in "
          f"turns; through the host: kernel {spread(t['kernel']['host'])} "
          f"ms through flash_attention ({host:.1f} us of host time a call),"
          f" library {spread(t['sdpa']['host'])} ms ({sd}), kernel / "
          f"library {ms / lib:.3f}; on the device (CUDA graph): kernel "
          f"{spread(t['kernel']['graph'])} ms ({flops / dev_ms / 1e9:.1f} "
          f"TFLOP/s), library {spread(t['sdpa']['graph'])} ms, kernel / "
          f"library {dev_ms / lib_dev:.3f}; no slower than the library both "
          f"ways: {ms <= lib and dev_ms <= lib_dev}; plain {plain:.4f} ms, "
          f"bound {bnd:.4f} ms ({by}; {flops:.4g} operations, {moved:.4g} "
          f"bytes) [{label}]", flush=True)
    return dict(variant="wgmma", shape=tag, max_abs_err=r["max_abs_err"],
                ms=ms, graph_ms=dev_ms, host_us=host, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=lib,
                library_graph_ms=lib_dev)


def flash_audio_vlm_rows(dev, label):
    """``flash_attention`` at whisper's encoder shape (B=16, H=6, S=1500,
    D=64, non-causal: ragged, the last KV tile masked with no diagonal),
    its decoder's self-attention (B=16, H=6, S=448, D=64, causal) and
    pixtral's (B=1, H=32, Kh=8, S=8192, D=128, causal)."""
    print("[kernels] flash_attention at whisper's encoder and decoder and "
          "pixtral's shapes", flush=True)
    return [flash_row(dev, label, "whisper encoder", AUDIO_B, 6, 6, 1500, 64,
                      False, 3),
            flash_row(dev, label, "whisper decoder", AUDIO_B, 6, 6,
                      AUDIO_SEQ, 64, True, 5),
            flash_row(dev, label, "pixtral", 1, 32, 8, LM_SEQ, 128, True, 4)]


def flash_mla_phase(dev, label):
    """``flash_attention`` at MLA prefill's shape (q/k 192, v 128) on the
    wgmma kernel, v at its own width: checked (``flash_wgmma_check``),
    timed beside its plain version, SDPA (q/k 192, v 128) and, in the
    same run, the cuda_core kernel on v zero-padded to 192 (the route
    before the (192, 128) wgmma kernel; checked too); returns the wgmma
    record with the padded kernel's time as ``cuda_core_padded_ms``."""
    B, H, S, D, DV = 1, 16, LM_SEQ, 192, 128
    print("[kernels] flash_attention at the MLA prefill shape", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v = rnd(B, H, S, D), rnd(B, H, S, D), rnd(B, H, S, DV)
    tag = f"B={B} H={H} S={S} q/k {D} v {DV} bf16 causal"
    r = flash_wgmma_check(f"flash wgmma {tag}", q, k, v)
    vp = F.pad(v, (0, D - DV))
    check(flash_variant(q.dtype, D, D) == "cuda_core", "(192, 192) variant")
    before = flash_kernels.variant_launches["cuda_core"]
    out = flash_attention(q, k, vp)
    again = flash_attention(q, k, vp)
    torch.cuda.synchronize()
    check(flash_kernels.variant_launches["cuda_core"] == before + 2,
          "the cuda_core kernel was not launched")
    want = flash_attention_ref(q.float(), k.float(), vp.float())
    rp = flash_bf16_check(out, again, want, flash_bf16_tol(q, k, vp))
    pad_zero = bool((out[..., DV:] == 0).all())
    del want, again, out
    ptag = f"B={B} H={H} S={S} D={D} (v {DV} padded to {D}) bf16 causal"
    print(f"  flash cuda_core {ptag}: max_abs_err={rp['max_abs_err']:.3e}, "
          f"worst {rp['worst']:.3f} of flash_bf16_tol, mean signed error "
          f"{rp['bias_ulp']:+.4f} ulp, repeatable {rp['repeatable']}, "
          f"padded columns zero {pad_zero} "
          f"{'ok' if rp['ok'] and pad_zero else 'FAIL'}", flush=True)
    check(rp["ok"] and pad_zero, f"flash {ptag} disagrees with its plain "
                                 f"version")
    ms = cuda_ms(lambda: flash_attention(q, k, v), iters=20)
    padded = cuda_ms(lambda: flash_attention(q, k, vp), iters=5, warmup=1)
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v), iters=3,
                    warmup=1)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=20)
    # the function's work: Q.K^T at 192 and P.V at 128 over the causal
    # half; q, k, v and the 128-wide output each moved once
    c = flash_cost(B, H, S, S, D, causal=True, v_dim=DV)
    flops, moved = c["flops"], c["hbm_bytes"]
    bnd, by = bound_ms(moved, flops, PEAK_BF16_FLOPS)
    print(f"  flash wgmma {tag}: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), cuda_core on v padded to {D} "
          f"{padded:.4f} ms ({padded / ms:.1f}x), plain {plain:.4f} ms, "
          f"library {lib:.4f} ms (scaled_dot_product_attention, v {DV}), "
          f"bound {bnd:.4f} ms ({by}; {flops:.4g} operations, "
          f"{moved:.4g} bytes): {ms / bnd:.2f}x the bound [{label}]",
          flush=True)
    return dict(variant="wgmma", shape=tag, max_abs_err=r["max_abs_err"],
                ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, cuda_core_padded_ms=padded)


def serving_batch():
    """The Flickr-sized graph, the Zipf targets of every measured batch,
    and the first batch as the engine plans it (SubgraphBatch)."""
    t0 = time.perf_counter()
    graph = get_graph("flickr", scale=1.0)
    targets = zipf_traffic(graph, N_BATCHES * C, seed=0)
    print(f"[data] flickr V={graph.num_vertices} E={graph.num_edges} "
          f"f_in={graph.feature_dim} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    # both layouts of one batch (an engine's Pack makes only those its
    # program reads), its edges in default_edge_pad's slots: the fixed
    # shape the kernel rows have been timed at (Pack's layout follows each
    # batch's largest subgraph instead; sg_served_rows times that)
    sb = batch_from_node_lists(
        graph, targets[:C], ini_batch(graph, targets[:C], N, 0.15, 1e-4, 8),
        N, default_edge_pad(graph, N))
    print(f"[data] batch C={C} N={N} e_pad={default_edge_pad(graph, N)} "
          f"edge slots {sb.edge_src.shape[1]} mean real edges "
          f"{sb.n_edges.mean():.1f}", flush=True)
    return graph, targets, sb


# -- phase 23: the launch analysis ----------------------------------------

LAUNCH_SURVEY = (["--arch", "phi3-medium-14b", "--shape", "prefill_32k"],
                 ["--arch", "deepseek-v2-lite-16b", "--shape", "train_4k"],
                 ["--arch", "whisper-tiny", "--shape", "decode_32k"],
                 ["--gnn-only"])
LAUNCH_DIR = ROOT / "build" / "dryrun_torch"
# the SSD archs' train cells on the (2, 4) fake mesh: their backward
# reaches cumsum's flip, which DTensor has no strategy for in some torch
# releases (models.common.cumsum runs it on local shards)
LAUNCH_TRAIN = ["--arch", "mamba2-2.7b,jamba-1.5-large-398b", "--shape",
                "train_4k", "--test-mesh", "2,4", "--reduced"]
LAUNCH_TRAIN_DIR = ROOT / "build" / "dryrun_torch_train"
LAUNCH_GNN_C = 4096 // 256       # GNN_SERVE_BATCH over the 16x16 mesh
LAUNCH_SHARE_MAX = 1.05
LAUNCH_RUNS = 21


def launch_survey(label):
    """(a): the survey's four dry-runs and the SSD archs' train cells at
    once, each in its own process (one fake process group a process);
    prints the roofline table of the survey and the train cells' counts."""
    runs = [["--mesh", "single", "--out", str(LAUNCH_DIR), *a]
            for a in LAUNCH_SURVEY]
    runs.append([*LAUNCH_TRAIN, "--out", str(LAUNCH_TRAIN_DIR)])
    for d in (LAUNCH_DIR, LAUNCH_TRAIN_DIR):
        shutil.rmtree(d, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *a], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a in runs]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for a, p, log in zip(runs, procs, logs):
        for line in log.splitlines():
            if line.startswith(("[cell]", "  ok", "  FAIL", "done")):
                print(f"[launch] {line}", flush=True)
        check(p.returncode == 0, f"the dry-run {' '.join(a)} failed:\n"
                                 f"{log[-3000:]}")
    rows = roofline.load_rows(str(LAUNCH_DIR))
    print(f"[launch] survey: {len(rows)} cells on the 16x16 fake mesh in "
          f"{time.perf_counter() - t0:.2f} s (host), roofline per card at "
          f"the H100 SXM's published peaks:", flush=True)
    for line in roofline.render_md(rows).splitlines():
        print(f"[launch] {line}", flush=True)
    check(len(rows) == 8, f"the survey recorded {len(rows)} cells, not 8")
    for arch in LAUNCH_TRAIN[1].split(","):
        with open(LAUNCH_TRAIN_DIR / f"{arch}__train_4k__2x4.json") as f:
            rec = json.load(f)
        print(f"[launch] {arch} train_4k reduced on the (2, 4) fake mesh "
              f"(torch {torch.__version__}): ok {rec['ok']}, "
              f"{rec.get('hlo', {}).get('flops', 0):.6g} FLOP and "
              f"{rec.get('hlo', {}).get('collective_link_bytes', 0):.6g} "
              f"link bytes a device {'ok' if rec['ok'] else 'FAIL'} "
              f"[{label}]", flush=True)
        check(rec["ok"], f"the {arch} train cell failed: {rec.get('error')}")


def _event_ms(fn, runs: int = LAUNCH_RUNS) -> float:
    """p50 of ``runs`` single calls, each between two CUDA events after a
    warm-up (the host's launch gaps inside a call count: a GNN step at 16
    targets is host-bound)."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def launch_cell(name, fn_meta, args_meta, make_fn, args_card, label,
                close):
    """One measured cell: the meta count, the card's impl="torch" and
    impl="cuda" counts, the p50 of impl="cuda", its bound and share, the
    memory and the launches. ``make_fn(impl)`` gives the cell's function
    on the card; ``close(got, want)`` holds impl="cuda" to impl="torch".
    Returns the launches by kernel."""
    meta = launch_dryrun.run_cell(fn_meta, args_meta, 1)
    torch.cuda.synchronize()
    plain = launch_dryrun.run_cell(make_fn("torch"), args_card, 1)
    ops.reset_launch_counts()
    cuda = launch_dryrun.run_cell(make_fn("cuda"), args_card, 1)
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    h = cuda["hlo"]
    counted = {k: v["launches"] for k, v in h["kernels"].items()}
    check(counted == {k: n for k, n in launched.items() if n},
          f"{name}: the kernels' notes {counted} disagree with their "
          f"launches {launched}")
    ok_out, text = close(make_fn("cuda")(*args_card),
                         make_fn("torch")(*args_card))
    card_args = launch_analysis.local_bytes(args_card)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn = make_fn("cuda")
    ms = _event_ms(lambda: fn(*args_card))
    peak = torch.cuda.max_memory_allocated() - base + card_args
    t_c, t_m, t_l = roofline.terms(h)
    bound = max(t_c, t_m, t_l) * 1e3
    by = max((("compute", t_c), ("memory", t_m), ("collective", t_l)),
             key=lambda kv: kv[1])[0]
    share = bound / ms
    est = cuda["memory"]["peak_bytes_est"]
    flops_ok = plain["hlo"]["flops"] == meta["hlo"]["flops"]
    args_ok = card_args == meta["memory"]["argument_bytes"]
    print(f"[launch] {name}: meta (impl=torch) {meta['hlo']['flops']:.6g} "
          f"FLOP, {meta['hlo']['hbm_bytes']:.6g} B; card impl=torch "
          f"{plain['hlo']['flops']:.6g} FLOP (equal {flops_ok}); card "
          f"impl=cuda {h['flops']:.6g} FLOP {h['flops_by_dtype']}, "
          f"{h['hbm_bytes']:.6g} B, kernels {counted}; argument bytes card "
          f"{card_args} meta {meta['memory']['argument_bytes']} (equal "
          f"{args_ok}); p50 {ms:.4f} ms (cuda_ms, {LAUNCH_RUNS} calls), "
          f"bound {bound:.4f} ms ({by}), bound_share {share:.4f}; peak "
          f"memory card {peak / 2**30:.3f} GiB vs estimate "
          f"{est / 2**30:.3f} GiB (impl=torch on meta "
          f"{meta['memory']['peak_bytes_est'] / 2**30:.3f} GiB); impl=cuda "
          f"vs impl=torch {text} "
          f"[{label}]", flush=True)
    check(flops_ok, f"{name}: the card's impl='torch' FLOPs differ from "
                    f"the meta count")
    check(args_ok, f"{name}: argument bytes differ from the meta count")
    check(share <= LAUNCH_SHARE_MAX, f"{name}: bound_share {share:.4f} > "
                                     f"{LAUNCH_SHARE_MAX}: a count is wrong")
    check(ok_out, f"{name}: impl='cuda' disagrees with impl='torch'")
    return launched


def launch_gnn_cells(graph, targets, label):
    """(b), GNN: each survey GNN cell at 16 targets on a real batch."""
    from repro_torch.launch.dryrun import GNN_CELLS
    dev = torch.device("cuda")
    total = {}
    for cfg in GNN_CELLS:
        with DecoupledEngine(graph, dataclasses.replace(cfg, f_in=F_IN),
                             config=ServingConfig(
                                 device="cuda", batch_size=LAUNCH_GNN_C,
                                 mode="dense")) as eng:
            sb = eng.plan(targets[:LAUNCH_GNN_C]).sb
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, dtype=np.float32)).to(dev)
        batch = {"feats": t(np.pad(sb.feats, ((0, 0), (0, 0),
                                             (0, cfg.f_in - F_IN)))),
                 "adj": t(sb.adj), "adj_mean": t(sb.adj_mean),
                 "mask": t(sb.mask)}
        params = init_gnn(cfg, seed=0, device="cuda")
        fn_meta, args_meta = build_gnn_cell(cfg, None, C=LAUNCH_GNN_C)

        def make_fn(impl, cfg=cfg):
            return build_gnn_cell(cfg, None, C=LAUNCH_GNN_C, impl=impl,
                                  params=params, batch=batch)[0]

        def close(got, want):
            err = compare(f"[launch] {cfg.display}", got, want, ENGINE_TOL)
            return True, f"max abs err {err:.3e} (ENGINE_TOL)"

        launched = launch_cell(
            f"{cfg.display} C={LAUNCH_GNN_C} dense", fn_meta, args_meta,
            make_fn, (params, batch), label, close)
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n
    return total


def launch_lm_cell(label):
    """(b), LM: phi3-medium-14b's prefill at [lm]'s shape."""
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    shape = ShapeConfig("prefill_8k", LM_SEQ, 1, "prefill")
    fn_meta, args_meta = build_cell(cfg, shape, None)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    batch = launch_specs.specs_for(cfg, shape, mode="random", seed=0,
                                   device="cuda")

    def make_fn(impl):
        return lambda p, b: transformer.prefill(cfg, p, b, impl=impl)

    def close(got, want):
        rel, top1 = _agreement(got, want)
        ok = rel <= LM_TOL["rel"] and top1 >= LM_TOL["top1"]
        return ok, (f"max abs err / max |logit| {rel:.3e}, top-1 {top1:.4f}"
                    f" (LM_TOL)")

    launched = launch_cell(f"{cfg.name} prefill B=1 S={LM_SEQ} "
                           f"{LM_LAYERS} layers", fn_meta, args_meta,
                           make_fn, (params, batch), label, close)
    check(launched["flash_attention"] == LM_LAYERS,
          f"phi3's cell launched flash_attention "
          f"{launched['flash_attention']} times, not {LM_LAYERS}")
    return launched


def launch_phase(graph, targets, label):
    """[launch]: the survey, then the measured cells; returns the
    launches by kernel of the measured cells' impl="cuda" runs."""
    t0 = time.perf_counter()
    launch_survey(label)
    ops.reset_launch_counts()
    launched = launch_gnn_cells(graph, targets, label)
    for k, n in launch_lm_cell(label).items():
        launched[k] = launched.get(k, 0) + n
    for k in ("fused_gnn_layer", "gat_attention", "flash_attention"):
        check(launched.get(k, 0) > 0, f"[launch] never launched {k}")
    print(f"[launch] phase {time.perf_counter() - t0:.2f} s, launches "
          f"{launched}", flush=True)
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name_power = card()
    label = name_power
    print(f"[env] {name_power}", flush=True)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    reports = build.build()
    print(f"[build] {len(reports)} libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for k, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line or "C7518" in line:
                print(f"[build] {k}: {line.strip()}", flush=True)
    graph, targets, sb = serving_batch()
    dev = torch.device("cuda")
    x = gnn_inputs(sb, dev)
    rec = kernel_phase(x, dev, label)
    variants = variant_phase(graph, targets, x, dev, label)
    variants["scatter_gather_aggregate"][:0] = [
        dict(r, variant="sort") for r in rec.pop("softmax")]
    variants["gat_attention"][:0] = rec.pop("gat_attention_layer")
    del x
    rec["flash_attention"] = flash_phase(dev, label)
    t0 = time.perf_counter()
    variants["flash_attention"] = [flash_mla_phase(dev, label)]
    print(f"[kernels] flash_attention at the MLA shape: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print("[kernels] flash_attention at Jamba's attention shape", flush=True)
    variants["flash_attention"].append(
        flash_row(dev, label, "Jamba", 1, 64, 8, LM_SEQ, 128, True, 2))
    variants["flash_attention"] += flash_audio_vlm_rows(dev, label)
    launches = engine_phase(graph, targets, label)
    # the main path's gat_attention launches are all of the fused form
    variants["gat_attention"][0]["launches"] = launches.pop(
        "gat_attention_fused")
    # gat/sg's softmax sums, launched by the engine phase's gat/sg engine
    # alone (the counts were zeroed as the phase began)
    sg_softmax_sums = sg_kernels.caller_launches.get(SG_SOFTMAX_SUMS, 0)
    print(f"[engine] gat/sg's softmax sums: {sg_softmax_sums} "
          f"scatter_gather_aggregate launches ({N_BATCHES + 1} batches x "
          f"{LAYERS} layers) [{label}]", flush=True)
    for row in variants["scatter_gather_aggregate"]:
        if row["shape"].startswith("gat sg softmax sums"):
            row["launches"] = sg_softmax_sums
    profile_phase(graph, targets, label)
    served = serve_phase(graph, label)
    repeatability_phase(graph, targets, label)
    dispatched = dispatch_phase(graph, label)
    sharded = shard_phase(graph, targets, label)
    print("[kernels] scatter_gather_aggregate at the offline chunk shape",
          flush=True)
    variants["scatter_gather_aggregate"] += offline_chunk_phase(graph, label)
    precomputed = precompute_phase(graph, label)
    remote = rpc_phase(graph, targets, label)
    metered = telemetry_phase(graph, label)
    t0 = time.perf_counter()
    trained = train_phase(graph, label)
    print(f"[train] phase {time.perf_counter() - t0:.2f} s", flush=True)
    launches["flash_attention"] = lm_phase(label)["flash_attention"]
    t0 = time.perf_counter()
    moe_launches = moe_lm_phase(label)["flash_attention"]
    print(f"[lm] {MOE_ARCH} phase {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches["flash_attention"] += moe_launches
    variants["flash_attention"][0]["launches"] = moe_launches
    t0 = time.perf_counter()
    ssm_launches = ssm_lm_phase(label)
    print(f"[lm] {SSM_ARCH} phase {time.perf_counter() - t0:.2f} s",
          flush=True)
    check(not any(ssm_launches.values()), "the SSM path launched a kernel")
    t0 = time.perf_counter()
    hybrid_launches = hybrid_lm_phase(label)["flash_attention"]
    print(f"[lm] {HYBRID_ARCH} phase {time.perf_counter() - t0:.2f} s",
          flush=True)
    check(hybrid_launches > 0, "the hybrid prefill never launched "
                               "flash_attention")
    launches["flash_attention"] += hybrid_launches
    variants["flash_attention"][1]["launches"] = hybrid_launches
    t0 = time.perf_counter()
    audio_launches, enc_launches, dec_launches = audio_lm_phase(label)
    print(f"[lm] {AUDIO_ARCH} phase {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches["flash_attention"] += audio_launches["flash_attention"]
    variants["flash_attention"][2]["launches"] = enc_launches
    variants["flash_attention"][3]["launches"] = dec_launches
    t0 = time.perf_counter()
    vlm_launches = vlm_lm_phase(label)["flash_attention"]
    print(f"[lm] {VLM_ARCH} phase {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches["flash_attention"] += vlm_launches
    variants["flash_attention"][4]["launches"] = vlm_launches
    t0 = time.perf_counter()
    lm_trained = lm_train_phase(label)
    print(f"[lm-train] phase {time.perf_counter() - t0:.2f} s", flush=True)
    check(not any(lm_trained.values()), "LM training launched a kernel")
    analysed = launch_phase(graph, targets, label)
    check(not any(trained.values()), "training launched a kernel")
    for k in REPLACES:
        check(launches[k] > 0, f"{k} was never launched on the main path")
    for k in KERNELS_BY_NAME:
        check(served[k] > 0, f"{k} was never launched on the server path")
        check(dispatched[k] > 0,
              f"{k} was never launched on the dispatch path")
        check(sharded[k] > 0, f"{k} was never launched behind the sharded "
                              f"store")
        check(remote[k] > 0, f"{k} was never launched behind the graph "
                             f"hosts")
        check(metered[k] > 0, f"{k} was never launched by the metered "
                              f"server")
    check(precomputed["scatter_gather_aggregate"] > 0,
          "scatter_gather_aggregate was never launched by the tier")
    kernels = []
    for k, (source, replaces) in REPLACES.items():
        kernels.append(dict(name=k, route="cuda", source=source,
                            replaces=replaces,
                            launches=launches[k] + served.get(k, 0)
                            + dispatched.get(k, 0) + sharded.get(k, 0)
                            + precomputed.get(k, 0) + remote.get(k, 0)
                            + metered.get(k, 0) + analysed.get(k, 0),
                            **rec[k], variants=variants.get(k, [])))
    print(name_power, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
