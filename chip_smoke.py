#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of SAFE on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero, and there is
no CPU fallback):

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. the build of every kernel from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, exactly
   (``torch.equal``), at V in {1, 5, 129, 100_001, 2^24}, counter bases 0
   and 2^32 - 5, aligned and misaligned rows, pads that start at odd and
   even stream words, S in {1, 8, 36} rows, and m in {1, 2, 36, 300} BON
   keys with mixed signs; then the host time a call through the kernels'
   custom ops (``torch.ops.repro_torch``) adds to the wrapper's;
4. the main paths, through the entry points a user calls, each with every
   kernel's launch count reset just before and read just after: one SAFE
   round (``make_aggregator("safe", 36).aggregate``) on f32[36, 2^24]; the
   multi-session engine at n = 36, S = 8, V = 2^20; the BON round
   (``make_aggregator("bon", 36)``) and the pipelined round
   (``pipelined=True``) on the same values; a hierarchical round
   (``pod_axis="pod"``) on f32[2, 36, 2^24]; after those paths' tensors are
   freed, the wire paths: ``wire engine``, the port's ``net.SafeBroker`` in
   this process's event loop in front of an ``AggregationEngine`` on the
   card (n = 36, S = 8, V = 2^20), with ten ``WireClient`` tenants that
   upload the engine path's ten sessions (144 MiB each) with
   ``submit_session_chunked`` and collect them with ``wait_session``; and
   ``wire round``, host only: ``run_safe_round_net`` at n = 36, V = 10,000
   clean and with ranks {13} and {0} dead, and ``run_bon_round_net`` clean;
   then the FedAvg path: three rounds of
   ``make_federated_round`` on internlm2-1.8b at full width (1 of its 24
   layers), n = 4 learners of 4 local AdamW steps on 2 x 256 tokens each,
   the deltas (P = 252,450,816 words) averaged by weighted SAFE; then the
   train-step path: three steps of ``make_train_step`` on the same model at
   4 layers (n = 4, 2 x 256 tokens a learner, one repeated batch), each learner's
   gradient a row of f32[4, padded_size] averaged by SAFE, then FlatAdamW
   on the f32 master vector, counters from ``reserve_round``; then the
   rest of the zoo through the same step, three steps each at full width:
   qwen3-moe-235b-a22b (1 of 94 layers, vocabulary cut to 18,992) by expert
   parallelism over the 4 learners (the experts' summed gradients updated
   outside the SAFE chain), zamba2-2.7b (6 of 54 layers: Mamba2 and the
   shared attention block) and rwkv6-1.6b (1 of 24 layers); then the wire
   FedAvg path: ``make_wire_federated``'s callables at the smoke size of
   internlm2-1.8b (n = 4, k = 2) on the card, their deltas through the
   port's broker on 127.0.0.1, a clean round and one with node 3 failed; then
   ``python -m repro_torch.launch.train --smoke`` as subprocesses on the
   card (two uninterrupted runs, one resumed from its checkpoint,
   ``--federated``); then ``net.run_engine_load`` against the port's broker
   in front of an engine on the card (n = 36, V = 2^20, 4 tenants); then
   the port's five examples (``repro_torch.examples``), each ``main`` in
   this process on the card at the SAFE_SMOKE size, the failover and
   kernel demos again on the CPU, line for line the card's; then
   serving: internlm2-1.8b at full width and 6 of its 24 layers (bf16, random
   weights from seed 0) through ``ServeEngine``, traffic A (the reference
   launcher's defaults: 8 requests of 4-31 tokens, 4 slots of 256, 32 new
   tokens each, greedy) and traffic B (16 requests of 1024-3072 tokens, 8
   slots of 4096, 64 new tokens, two waves), and ``python -m
   repro_torch.launch.serve --arch internlm2-1.8b`` as a subprocess on the
   card; no SAFE kernel runs there, and its launch line says so; last, the
   dry run (``repro_torch.launch.dryrun.measure``, meta tensors): the
   train-step path's step at 4 and 24 layers and one decode step of
   traffic B at 24, the most layers of that step that fit the card, then
   that 4-layer step, that decode step and the step at the most layers
   that fit, each for real; then the dist path, one learner a process:
   four ranks spawned by ``repro_torch.dist.spawn`` share the card over
   gloo, each CUDA tensor staged through pinned host buffers
   (``transport="host"``: NCCL refuses two ranks on one card, and the
   script first shows ``init_world`` refusing nccl for more ranks than
   cards), and run, each on its own row through ``aggregate_rank``, the
   sequential round (rotated, one learner dead), the pipelined, BON, INSEC
   and weighted rounds at V = 2^24 a rank; then two train steps of
   internlm2-1.8b at full width and 1 layer (the second with learner 1
   dead; ZeRO-1, each rank holding its quarter of the master vector and
   moments) and one weighted FedAvg round, through the per-rank
   ``make_train_step``/``make_federated_round``; the launch counts are
   summed over the ranks; then the rest of the reference's manual mesh
   axes across ranks: ``moe_dist``, qwen3-moe at the zoo path's cut (1
   layer, vocabulary 18,992, published widths) by expert parallelism over
   four ranks sharing the card, 32 of the 128 experts a rank
   (``Model(cfg, ep_world=world)``, the experts' two all-to-alls), two
   train steps (learner 1 dead in the second), after the same ranks the
   one-card EP step from the same seed and tokens; ``pod_ep``, expert
   parallelism with pods: the same model with 24 of its 128 experts, 2
   pods x 3 learners = 6 ranks, 8 experts a rank, each rank's expert
   gradients summed over its pod group after the exchange, two train steps
   (learner 1 of each pod dead in the second, each pod's learners on
   tokens of their own) against the one-process pod EP step; ``pod_rounds``, 2 pods x
   4 learners = 8 ranks on a ('pod', 'data') mesh, the rounds above at
   2^24 words a rank with the pod mean across ranks; ``rank_engine``, the
   multi-session engine one learner a rank on each pod's four ranks (ten
   sessions through 8 slots of 2^20 words a rank); ``rank_broker``, pod
   0's four ranks serving the same ten sessions over the wire: rank 0's
   ``SafeBroker`` in front of an ``EngineLead``, one ``WireClient`` a
   tenant on 127.0.0.1 (session 0 over the chunk plane), ranks 1-3 running
   ``follow``; ``pod_steps``, 2 pods x
   3 learners = 6 ranks (SAFE's rings need three), two pod train steps and
   a weighted FedAvg round of internlm2-1.8b at full width and 1 layer;
   ``tp_dist``, the 'model' axis across ranks in the reference launcher's
   default layout, 4 learners x 2 model shards = 8 ranks sharing the card
   (``dist.grid_worlds``: rank l·2 + j is learner l's shard j): the rounds
   above on each model rank's chunk of 2^23 words (``aggregate_rank(...,
   model_world=)``), then internlm2-1.8b at full width and 1 layer with
   Megatron tensor parallelism over each learner's two ranks (``Model(cfg,
   tp_world=)``), two train steps and a weighted FedAvg round; ``tp_zoo``,
   the same layout for the other block kinds: zamba2-2.7b (one unit, f32),
   rwkv6-1.6b (one layer) and qwen3-moe (one layer, vocabulary 18,992, its
   experts over the learners' rings: ``Model(cfg, tp_world=,
   ep_world=ring)``), two train steps each and a weighted FedAvg round for
   rwkv6 (the pipelined chain); ``pod_tp``, the ('pod', 'data',
   'model') grid, 2 pods x 3 learners x 2 model shards = 12 ranks
   (``dist.grid``: rank (p·3 + l)·2 + j), internlm2-1.8b at full width and
   1 layer: two train steps (learner 1 of each pod dead in the second) and
   a weighted FedAvg round, each pod's ring j on chunk j and the pods'
   chunks meeting over the pod group; ``serve_dist``, decode and prefill
   across 4 data x 2 model ranks: (a) internlm2-1.8b at 6 layers, 8 of
   traffic B's prompts (2 a data rank) prefilled into caches of 4096 and 16
   decode steps teacher-forced on the one-process run's tokens through
   ``make_serve_step(model, grid)``; (b) gemma3-12b at one unit (6 layers)
   in f32 with long_500k's caches (524,288 slots) split by slot over the
   data ranks, seeded random k and v, pos in data rank 2's slots and at a
   full cache, 8 decode steps through ``make_serve_step(model, grid,
   seq_axis="data")`` (no SAFE kernel runs there); ``tp_heads``, whole
   units split unevenly over 'model': internvl2-1b at full width and 1
   layer, text only, 3 learners x 4 model shards = 12 ranks sharing the
   card, its 14 q heads 4, 4, 3 and 3 a model rank (rank 1's reading both
   kv heads, which every rank holds), two train steps (learner 1 dead in
   the second), a weighted FedAvg round and 3 of traffic B's prompts, one a
   data rank, prefilled and decoded 8 steps through
   ``make_serve_step(model, grid)`` teacher-forced on seeded tokens; in
   every TP path (tp_dist, tp_zoo, pod_tp, tp_heads) each checkpointed
   block saves its input as the rank's share of the token rows
   (``models/transformer.py::sliced_checkpoint``); ``prefill_flash``, after
   serving: internlm2-1.8b at full width and 4 layers, B = 1 and an
   8192-token prompt into the global cache ``Model.prefill`` makes, through
   the blockwise attention;
5. the answers: sequential clean, failover (dead ranks including the
   elected initiator, NaN in their rows), weighted and rotated; BON clean
   and failover; pipelined clean, failover, weighted and two subgroups;
   hierarchical — each within the fixed-point bound of a float64 mean of
   the survivors and bit-identical to the port's CPU path on [36, 2^16];
   every engine session-round bit-identical to a single-session round;
   every wire-engine result bit-identical to the in-process engine path's,
   no engine step failed and no wait timed out; each wire round's average
   bit-identical to the port's simulation, its messages at the closed form;
   FedAvg: the loss falls over the three rounds; each round's published
   delta, as ``round_fn`` returns it, and that of a failover round (one
   learner dead, its row NaN) are within the weighted fixed-point bound of
   a float64 weighted mean of the survivors' rows of the deltas the round
   aggregated, and bit-identical to the CPU path on [4, 2^16]; mask_add
   and chain_combine at the path's own V = P + 1, on an aligned and an
   odd-word row of the real weighted payload, ``torch.equal`` to their
   plain versions (compared 2^26 words at a time); the train step: the
   loss falls over three steps; each step's published gradient mean, as
   the aggregator handed it back to ``step_fn``, within the fixed-point
   bound of a float64 mean of the rows it aggregated, with the step's
   counter and rotation; the card against the CPU path on [4, 2^16];
   mask_add and chain_combine at V = padded_size against their plain
   versions; a step with learner 1 dead (its row NaN), then
   ``reserve_round`` refusing the step after the last that fits the key
   set (the tenth at full width: each counter pads two words) and a step
   with rank 0 dead on rotated keys; a SAFE and an INSEC step from one
   state at 2 layers; for each zoo path the same checks (falling loss,
   each step's mean, card == CPU, the kernels at its V = padded_size) and
   every parameter leaf moved (sampled words of the f32 master, and of the
   expert leaves themselves), the leaves with a zero gradient by
   construction named; FlatAdamW on the card equal to its CPU path word for
   word (2^20 words, three steps); each wire FedAvg round's published delta
   and applied parameters bit-identical to ``round_fn``'s on the card at
   the same counter, weights and alive bitmap; the launcher's losses
   finite (falling for the
   train step), its resumed run against an uninterrupted one beside two
   uninterrupted runs; every ``run_engine_load`` session bit-identical to
   a single round; serving: every request returns max_new tokens and every
   logit is finite; prefill then 16 teacher-forced decode steps of two of
   traffic B's prompts within 2e-2 of max |logit| of ``Model.apply``'s full
   forward, and each of the ten smoke configurations' prefill then decode
   within 2e-2 of its own full forward (bf16) and within 1e-3 of the port's
   CPU path (f32); the dry run's peak within 1% of
   ``torch.cuda.max_memory_allocated`` over each real call, its verdict
   that 4 layers of the train step fit the card and 24 do not, the step at
   the most layers it says fit running on the card, and the card holding at
   least ``dryrun.H100_USABLE_BYTES`` for a process to allocate; the
   dist path: every rank's mean, parameters and published delta equal to
   the other ranks' and to the same work in this process on the card
   (sha256 of the words), each rank's master vector padded_size / 4 words,
   and each kernel equal to its plain version at the shapes the dist path
   gives it (V = 2^24 and 2^24 + 1, padded_size, P + 1, the pipelined
   round's one-row hops and bon_mask's key sets); moe_dist: the ranks'
   losses equal, within EP_LOSS_RTOL of the one-card EP step's, the change
   of the SAFE partition's f32 master and of the bf16 expert shards within
   EP_MASTER_REL and EP_EXPERT_REL of one card's (relative L2), and each
   step's gradient rows of the four ranks, aggregated on one card, giving
   every rank's published mean word for word; pod_ep: each pod's expert
   shards and their AdamW m and v equal (sha256) to pod 0's after each
   step, the ranks' losses equal, the losses and the change of the SAFE
   master and of the expert shards within the EP bounds of the one-process
   pod EP step, rank 0's first-step peak within DRY_TOL of the dry run's
   (``--per-rank`` with 2 pods), mask_add and chain_combine at its
   padded_size equal to their plain versions; pod_rounds, rank_engine and
   pod_steps: every rank's means, sessions, parameters and published delta
   equal to the same work in this process on the card (sha256);
   rank_broker: every tenant's ``wait_session`` results and every
   follower's sessions equal to the one-card engine's (sha256), no engine
   step failed, and mask_add and chain_combine_batched launched on each of
   its ranks; the
   kernels at those paths' shapes (their padded_size and P + 1,
   chain_combine_batched on [8, 2^20] with per-row keys and bases);
   tp_dist: every ring's chunk equal to its words of the one-card mean
   (sha256), the ZeRO-1 parts after two steps word for word the one-card
   FlatAdamW of the whole master vector on the published means and rank
   0's shards their cast; the losses, the parameters' change, FedAvg's
   loss, published delta and change within TP_LOSS_RTOL and TP_CHANGE_REL
   of the one-card port's on the same weights; rank 0's first-step peak
   within DRY_TOL of the dry run's ``--per-rank --model-shards 2``; each
   kernel at the path's chunk lengths and start words (the counter base
   moved by start / 2) equal to its plain version; tp_zoo: for each model
   each ring's published chunk of the second step equal (sha256) to the
   one-card round of the ring's own gradient rows, every rank's ZeRO-1
   part FlatAdamW of its words of the published chunks, the float math
   within tp_dist's bounds (the MoE within moe_dist's), rank 0's first-step
   peak within DRY_TOL of the dry run's, the bytes the forward holds for
   the backward with the sliced saves less than with the whole inputs
   saved (``torch.utils.checkpoint``, the form before them) by blocks x
   (1 - 1/m) x B x S x d x the element size, within DRY_TOL, and each
   kernel at the path's chunks equal to its plain version; prefill_flash:
   each attention layer beside the dense form on the same input and a copy
   of the cache, its cache words ``torch.equal`` and its output within
   PF_TOL of its largest |word|, the peak within DRY_TOL of the dry run's;
   pod_tp: every published chunk of the
   second step equal (sha256) to the one-card ``pod_rounds`` of its rows
   (each pod's ring round on the ring's head, then the pods' ``pod_mean``),
   every ZeRO-1 part FlatAdamW of its words of the published chunks, the
   float math within tp_dist's bounds of the one-card pod step and FedAvg
   round, rank 0's first-step peak within DRY_TOL of the dry run's
   (``--per-rank --model-shards 2`` with 2 pods), the kernels at the path's
   chunks equal to their plain versions; serve_dist: (a)'s logits within
   SERVE_TOL of the one-process decode's, (b)'s within SD_B_TOL of one
   process's dense decode of the whole cache, the ranks holding a row (in
   (b) every rank) agreeing bit for bit, rank 0's peak over a decode step
   within DRY_TOL of the dry run's for each layout; tp_heads: the model
   ranks' q heads 4, 4, 3, 3, every published chunk of the second step
   equal (sha256) to the one-card round of its rows, every ZeRO-1 part
   FlatAdamW of its words of the published chunks, the float math within
   tp_dist's bounds of the one-card step and FedAvg round, prefill and
   decode within SERVE_TOL of one process, rank 0's first-step peak within
   DRY_TOL of the dry run's (``--per-rank --model-shards 4``), the kernels at
   the path's chunks equal to their plain versions;
6. timings at the main paths' shapes: each kernel (CUDA events) beside its
   plain version, its least possible time on the card and what bounds it;
   wall time per round of every path and per engine step, the device's
   busy time in the SAFE, BON and pipelined rounds and an engine step
   under torch.profiler, and the BON/SAFE ratio of the round; the wire
   engine path's wall split into upload, engine steps and download, its
   socket rates and, in a second run under torch.profiler, its device busy
   time; the wire rounds' walls; the host's numpy keystream rate; the last
   FedAvg round's wall time split into local steps, aggregation and apply
   by CUDA events inside that ``round_fn`` call, one local step's tokens
   per second and model-FLOPs share, and the aggregation against its
   bytes bound; the last train step's wall split by CUDA events inside
   ``step_fn`` into the learners' forward and backward, flatten and pad,
   SAFE aggregation, FlatAdamW and rebuild, each against its bytes bound,
   the SAFE share, tokens per second, peak memory and, under
   torch.profiler, the device's idle share; the same for each zoo path,
   with the expert AdamW beside its bound and mask_add and chain_combine
   timed at the path's V; each wire FedAvg round's wall split into the
   learners' local steps and the wire round; ``run_engine_load``'s
   ``LoadReport``; for each serving traffic the time to first token
   (prefill ms a request: median and max), the decode step's ms against its
   bytes bound (the weights and the whole KV cache read once), decode and
   end-to-end tokens per second, requests per second, peak memory, and the
   device's idle share over a few decode steps under torch.profiler;
   prefill_flash's prefill wall and peak beside the dense form's (the
   parent's path), each once under torch.profiler; the dry run's peaks by
   category and matrix-product FLOPs beside the card's;
   the dist path's walls per round and per step, the seconds each rank
   spent in collectives (the transport's share), each rank's peak memory,
   and each kernel timed by CUDA events in each rank, one rank at a time;
   the same walls, transport shares and peaks for moe_dist, pod_ep, the pod rounds,
   the per-rank engine's steps, the pod steps, tp_dist, tp_zoo (with
   each tp_zoo rank's seconds by part), pod_tp and tp_heads (with its
   decode step); serve_dist's prefill and
   decode step walls and peaks a rank, and the bytes the dry run counts its
   collectives sending by op.

The second-to-last line is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --nccl4

on a host with four cards instead runs the dist rounds over NCCL, a card a
rank, each against one process's on the rank's card; the pod rounds that
two learners a pod allow (BON, INSEC) at 2 pods x 2 learners, the per-rank
engine, the same sessions served over the wire by rank 0's broker in front
of an ``EngineLead`` (the rows scattered over NCCL) and two BON pod train
steps of internlm2-1.8b at 4 layers, each against one process's; qwen3-moe with its full vocabulary through the
launcher at the most layers the dry run's per-rank step says fit a card,
and the smoke MoE resumed from a full-E checkpoint; then the training
launcher under ``torch.distributed.run`` with internlm2-1.8b at all 24
layers, a card a rank, and prints each rank's peak memory and the steps'
walls. Its MoE part, which ``--nccl4-moe`` runs alone, begins with expert
parallelism with pods: qwen3-moe at the zoo path's cut with all 128
experts, 2 pods x 2 learners a card a rank (64 experts a rank), two BON
steps on one batch, the pods' expert state equal word for word after each,
the losses falling and each rank's peak within DRY_TOL of the dry run's.
``--nccl4-tp`` runs the
launcher at 2 learners x 2 model shards, a card a rank, internlm2-1.8b at
24 layers with BON and INSEC, zamba2-2.7b and rwkv6-1.6b with BON at the
depth the dry run fits, each rank's steps' peak against the dry run's, and
a smoke run resumed from its checkpoint word for word. None of
these is part of the one-card run. Nor is

    python3 chip_smoke.py --dist-depth 5 6 7

which sizes the dist path's depth on one card: its four ranks alone at
each depth in turn, up to the first that does not fit, with each rank's
peak memory.
"""
import asyncio
import atexit
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
LIMIT_S = 1200              # the whole script's time limit, the kernels' build included
N = 36                      # learners: the paper's headline size
V_MAIN = 1 << 24            # words per learner in the round (64 MiB f32)
S_ENGINE, V_ENGINE = 8, 1 << 20
V_CPU = 1 << 16             # the CPU-path cross-check's width
STEP = 2.0 ** -16           # one fixed-point step at scale_bits = 16
PODS = 2                    # pods of the hierarchical round
DEAD = [0, 13, 35]          # failover: rank 0 is the elected initiator at rotate 0

# H100 SXM peaks (NVIDIA data sheet, 700 W): 3.35 TB/s of HBM3, and 67
# TFLOP/s of FP32 = 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz. An SM issues
# at most one instruction per lane per clock on its 128 lanes (4 schedulers
# x 32); integer adds issue on the FMA pipe (as IMAD) as well as on the 64
# INT32 lanes, so the issue rate, not the INT32 pipe alone, bounds integer
# work.
HBM_BYTES_PER_S = 3.35e12
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
# Operations per output word: a 20-round Threefry-2x32 evaluation is 72
# (20 x add/rotate/xor + 12 key-injection adds) and yields 2 words; the
# encode is a multiply and a conversion. mask_add adds one ring add; a hop
# evaluates two pads and does three ring adds; bon_mask evaluates m pads
# and adds or subtracts each.
OPS = {"mask_add": lambda m: 36 + 2 + 1, "chain_combine": lambda m: 72 + 2 + 3,
       "chain_combine_batched": lambda m: 72 + 2 + 3,
       "bon_mask": lambda m: 36 * m + m + 2}
M_BON = N                   # keys per BON masking launch: n - 1 pairs + the self-mask
REPLACES = {
    "mask_add": ("src/repro_torch/csrc/mask_add.cu",
                 "src/repro/kernels/threefry_mask_add.py:93"),
    "chain_combine": ("src/repro_torch/csrc/chain_combine.cu",
                      "src/repro/kernels/chain_combine.py:49"),
    "chain_combine_batched": ("src/repro_torch/csrc/chain_combine.cu",
                              "src/repro/kernels/chain_combine.py:110"),
    "bon_mask": ("src/repro_torch/csrc/bon_mask.cu", "src/repro/kernels/bon_mask.py:49"),
}
# The kernels each main path must launch.
PATH_KERNELS = {"round": {"mask_add", "chain_combine"},
                "engine": {"mask_add", "chain_combine_batched"},
                "bon": {"bon_mask"},
                "pipelined": {"mask_add", "chain_combine_batched"},
                "hierarchical": {"mask_add", "chain_combine"},
                "wire_engine": {"mask_add", "chain_combine_batched"},
                "fedavg": {"mask_add", "chain_combine"},
                "train_step": {"mask_add", "chain_combine"},
                "moe": {"mask_add", "chain_combine"},
                "zamba2": {"mask_add", "chain_combine"},
                "rwkv6": {"mask_add", "chain_combine"},
                "engine_load": {"mask_add", "chain_combine_batched"},
                "dryrun_train": {"mask_add", "chain_combine"},
                "moe_dist": {"mask_add", "chain_combine"},
                "pod_rounds": {"mask_add", "chain_combine", "chain_combine_batched", "bon_mask"},
                "rank_engine": {"mask_add", "chain_combine_batched"},
                "rank_broker": {"mask_add", "chain_combine_batched"},
                "examples": {"mask_add", "chain_combine"},
                "pod_steps": {"mask_add", "chain_combine"},
                "pod_ep": {"mask_add", "chain_combine"},
                "tp_zoo": {"mask_add", "chain_combine", "chain_combine_batched"},
                "pod_tp": {"mask_add", "chain_combine"},
                "tp_heads": {"mask_add", "chain_combine"}}

# The FedAvg path: internlm2-1.8b at full width, cut to 1 of its 24 layers
# (at 24 the learners' f32 deltas, the weighted payload and the chain's
# ciphertexts need more than the card's 80 GB; 12 until the script's time
# limit needed the room for pod_tp and serve_dist, 2 until tp_heads: its
# float64 checks follow P), with the reference launcher's traffic (src/repro/launch/train.py: 4
# learners, batch 2 of 256 tokens, 4 local steps, lr 1e-3).
FED_ARCH, FED_LAYERS = "internlm2-1.8b", 1
FED_N, FED_B, FED_S, FED_K, FED_LR, FED_ROUNDS = 4, 2, 256, 4, 1e-3, 3
FED_DEAD = 1                # the failover check's dead learner
CHUNK = 1 << 26             # words per pass of the float64 reference mean
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 peak (NVIDIA data sheet)

# The train-step path: the same model at 4 layers (12 until the script's time
# limit needed the room for tp_heads, 6 until pod_ep), with the reference
# launcher's train-step traffic (src/repro/launch/train.py: 4 learners, batch 2
# of 256 tokens, lr 1e-3) on one repeated batch, as tests/test_train.py trains;
# the SAFE-against-INSEC comparison runs at TS_CMP_LAYERS layers, so that its
# two states fit beside each other.
TS_ARCH, TS_LAYERS, TS_CMP_LAYERS = FED_ARCH, 4, 2
TS_N, TS_B, TS_S, TS_LR, TS_STEPS = 4, 2, 256, 1e-3, 3
# The rest of the zoo through the same train step, with the same traffic, each
# at the published widths of its configuration and cut in depth (or in
# vocabulary) to fit one card: qwen3-moe-235b-a22b at one of its 94 layers by
# expert parallelism over the 4 learners, its vocabulary an eighth (the
# embedding and head one of 8 vocabulary-parallel cards would hold); zamba2-2.7b
# at 6 of 54 layers (one unit of 5 Mamba2 blocks and the shared attention
# block); rwkv6-1.6b at 1 of 24 layers. (18 and 8 layers until the script's
# time limit needed the room for tp_zoo, rwkv6 4 until pod_tp and serve_dist
# and 2 until tp_heads: both steps are host-bound chunk loops whose time
# follows the depth; PERF.md §4.)
ZOO_PATHS = {
    "moe": ("qwen3-moe-235b-a22b", dict(n_layers=1, vocab=18_992, ep_axis="data",
                                        ep_ranks=TS_N)),
    "zamba2": ("zamba2-2.7b", dict(n_layers=6)),
    "rwkv6": ("rwkv6-1.6b", dict(n_layers=1)),
}
ZOO_STEPS = 3
# The wire FedAvg path: the smoke configuration (the learners mask with host
# numpy Threefry, so a full-width pad would take seconds of one core).
WIRE_FED_ARCH, WIRE_FED_K = "internlm2-1.8b", 2
# The launcher at the smoke size (subprocesses), and run_engine_load.
LAUNCH_STEPS, LAUNCH_TIMEOUT_S = 4, 300
LOAD_TENANTS, LOAD_ROUNDS = 4, 2
# The port's examples, each through its main() on the card at the SAFE_SMOKE size;
# the deterministic two again on the CPU (their plain kernels), line for line.
EXAMPLES = ("quickstart", "failover_demo", "federated_training", "serving", "kernels_demo")
EXAMPLES_ON_CPU = ("failover_demo", "kernels_demo")

# The serving path: internlm2-1.8b at its published widths and SERVE_LAYERS of
# its 24 layers (all 24 until the script's time limit needed the room for
# tp_heads, 12 until pod_ep; at 24, 3.40 GB of bf16 weights and a 3.22 GB KV
# cache at 8 slots x 4096 fit), random weights from seed 0. Traffic A is the reference
# launcher's defaults (src/repro/launch/serve.py:14-19, 37-41); traffic B is
# long context, two waves through the slots. A traffic: (requests, slots,
# max_seq, max_new, prompt seed, prompt lengths [lo, hi)).
SERVE_ARCH, SERVE_LAYERS = "internlm2-1.8b", 6
SERVE_TRAFFIC = {"A": (8, 4, 256, 32, 0, 4, 32),
                 "B": (16, 8, 4096, 64, 1, 1024, 3073)}
SERVE_GATE_REQUESTS, SERVE_GATE_STEPS = 2, 16   # traffic B's, against the full forward
SERVE_TOL = 2e-2            # of max |logit|: the reference's own decode bound (bf16)
SERVE_CARD_TOL = 1e-3       # card vs CPU in f32, of max |logit| (tests/test_torch_cuda.py)
SERVE_PROFILE_STEPS = 4
SERVE_LAUNCH_TIMEOUT_S = 300
# A prefill into a cache above FLASH_THRESHOLD (prefill_flash): SERVE_ARCH at
# full width and PF_LAYERS (at 12 layers the path took 16.6 s on an H100
# 80GB HBM3 at 700 W, 10.2 s of it the dry run's blockwise loops on meta
# tensors; 6 until pod_ep), B = 1 and a PF_S-token prompt (random tokens
# from seed SEED) into the global cache of PF_S slots Model.prefill makes,
# through the blockwise attention (4 q blocks of 2048 x 8 k blocks of 1024 a
# layer). Each attention layer again beside the dense form (the reference's
# path, and the port's until the prefill with a cache went blockwise) on the
# same input and a copy of the same cache: the cache words torch.equal (they
# are written before the attention) and the layer's output within PF_TOL of
# its largest |word|. bf16: the dense form rounds its probabilities to bf16
# before they meet v (2^-9 of each at worst), the blockwise form keeps f32, so
# the two differ by about that share of |v|. The peak within DRY_TOL of the
# dry run's prefill of the same shape.
PF_LAYERS, PF_S, PF_TOL = 4, 8192, 2e-2

# The wire paths. The engine's tenants upload over 127.0.0.1 in chunks of
# the codec's default width (a session is 144 MiB, over one 64 MiB frame).
# The wire rounds run at the paper's largest feature count
# (benchmarks/feature_scalability.py:16); learner ids on the wire are
# rank + 1, so the dead sets are ranks {13} and {0}, the elected initiator.
WIRE_CHUNK = 1 << 20
WIRE_WAIT_S = 300.0         # a tenant's wait_session timeout
WIRE_V = 10_000
WIRE_DEAD = {"clean": (), "rank 13 dead": (14,), "rank 0 dead": (1,)}
WIRE_AGG_TIMEOUT = 3.0      # the §5.4 re-election timeout of the wire rounds
KEYSTREAM_WORDS = 1 << 22   # the host keystream rate's pad

# The dry run against the card: its peak within DRY_TOL of the allocator's
# over the same real call; the custom ops' host cost over DISPATCH_CALLS calls.
DRY_TOL = 0.01
DISPATCH_CALLS = 2000

# The dist path: one learner a process, DIST_N ranks sharing the one card over
# gloo, each CUDA tensor staged through pinned host buffers (transport="host";
# NCCL refuses two ranks on one card). The rounds at V_MAIN words a rank:
# name -> (aggregator kwargs, round kwargs; "w" stands for the weights). Then
# internlm2-1.8b at full width and DIST_LAYERS of its 24 layers (6 are the
# most for which four ranks fit the card beside each other; 4 left the
# script's time limit room for tp_zoo, 1 for pod_tp and serve_dist): two
# train steps, the
# second with learner DIST_DEAD dead, and one weighted FedAvg round of DIST_K
# local steps with the same learner dead; the launcher's traffic (2 x 256
# tokens a learner, lr 1e-3). Each rank's allocator maps its blocks into
# segments that grow (DIST_ALLOC_CONF): with fixed segments the FedAvg round
# reserved twice what it allocated, and four ranks did not fit 3 layers; with
# them a rank peaks at 17.15-19.41 GB allocated at 6 layers and 7 do not fit.
DIST_N, DIST_LAYERS, DIST_K, DIST_DEAD = 4, 1, 2, 1
DIST_ALLOC_CONF = "expandable_segments:True"
DIST_ROUNDS = {
    "sequential": (dict(mode="safe"), dict(rotate=3, alive="dead")),
    "pipelined": (dict(mode="safe", pipelined=True), {}),
    "bon": (dict(mode="bon"), dict(alive="dead")),
    "insec": (dict(mode="insec"), dict(weights="w")),
    "weighted": (dict(mode="safe", weighted=True), dict(weights="w")),
}
DIST_WEIGHTS = np.asarray([1000, 1500, 2000, 2500], np.float32)
DIST_KERNELS = ("mask_add", "chain_combine", "chain_combine_batched", "bon_mask")
DIST_TIMING_ITERS = 10
NCCL_STEPS = 4              # ``--nccl4``: the launcher's steps at 24 layers, a card a rank
NCCL_MOE_TIMEOUT_S = 240    # ``--nccl4``: the MoE launcher's time a depth (a hang ends there)
# The MoE across ranks (moe_dist): the zoo's MoE path (qwen3-moe-235b-a22b at its
# published widths, n_layers 94 -> 1, vocab 151,936 -> 18,992) with DIST_N ranks
# sharing the card, E/n = 32 experts a rank; EP_STEPS steps of the launcher's
# traffic, the second with learner DIST_DEAD dead, against the one-card EP step
# from the same seed and tokens. The float math (bf16) differs from one card's:
# one expert product over n·C rows against each learner's C, summed in f32.
# Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): the losses 3.3e-4 relative, the
# change over the two steps of the SAFE partition's f32 master 8.5e-2 and of
# the bf16 expert shards 6.3e-2 relative L2 (AdamW's first steps move a word
# by about lr whatever its gradient's size, so a near-zero gradient that
# rounds the other way moves it the other way); the bounds sit ~3x above.
EP_ARCH, EP_CUT = ZOO_PATHS["moe"]
EP_STEPS = 2
EP_LOSS_RTOL, EP_MASTER_REL, EP_EXPERT_REL = 1e-3, 0.25, 0.2
# Pods across ranks: the rounds at POD_P pods x DIST_N learners (8 ranks, V_MAIN
# words a rank) and the per-rank engine on each pod's DIST_N learners (S_ENGINE
# slots x V_ENGINE words a rank); the steps at POD_P x POD_STEP_N (6 ranks: SAFE's
# rings need three members) of internlm2-1.8b at POD_LAYERS layers, the depth at
# which six ranks fit the card (the dry run's --per-rank: 8.58 GB a rank at 1
# layer, 10.72 at 2, before FedAvg's local copy and six CUDA contexts).
POD_P, POD_STEP_N, POD_LAYERS = 2, 3, 1
# Expert parallelism with pods (pod_ep): the EP path's model (qwen3-moe-235b-a22b
# at its published widths, heads and top_k, EP_CUT: 1 of 94 layers, vocab
# 151,936 -> 18,992) on the pod steps' grid, POD_P pods x POD_STEP_N learners =
# 6 ranks sharing the card, each with its E/n experts, which it sums over its
# pod group after the exchange. One more cut, num_experts 128 -> POD_EP_EXPERTS
# (8 a rank): the two pods' copies of 128 experts at one layer hold
# 2 x 2.416e9 words x 12 B (bf16 weight and gradient, f32 m and v) ~ 58 GB,
# before the SAFE matrix, six CUDA contexts and the one-process comparison. Two
# SAFE train steps (learner DIST_DEAD of each pod dead in the second), each
# pod's learners on tokens of their own, a new batch a step, against the one-process pod EP step
# (every expert local, the f32 sum of the P·n learners' expert gradients)
# within moe_dist's bounds; each pod's expert shards and their m and v word
# for word equal across the pods after each step; rank 0's first-step peak
# within DRY_TOL of the dry run's --per-rank record of the layout.
POD_EP_EXPERTS = 24
# ``--nccl4-moe``'s pods: POD_P x NCCL_PE_N ranks, a card each, every expert of the
# EP path's model (64 a rank: ~14.5 GB of bf16 weights and gradients and f32
# moments)
NCCL_PE_N = 2
ENGINE_RANK_ROUNDS = 2
# The broker in front of the per-rank engine (rank_broker): pod 0's DIST_N ranks
# serve the rank engine's sessions over 127.0.0.1, session BROKER_CHUNKED (two
# rounds) uploaded over the chunk plane in WIRE_CHUNK words, the others in one
# frame each.
BROKER_CHUNKED = 0
# The 'model' axis across ranks (tp_dist): the reference launcher's default
# layout, TP_N learners x TP_M model shards = 8 ranks sharing the card (rank
# l·m + j is learner l's model shard j): the dist rounds at V_MAIN words a
# learner, each model rank's ring on its chunk of V_MAIN / TP_M words; then
# internlm2-1.8b at full width and TP_LAYERS of its 24 layers (the dry run's
# --per-rank --model-shards: 4.17 GB a rank at 1 layer before FedAvg's local
# copy and eight CUDA contexts), Megatron tensor parallelism over each
# learner's two ranks, two train steps and a weighted FedAvg round. The
# float math (bf16) is not one card's: each row-parallel product is two
# bf16 partial sums added, and AdamW's first steps move a word by about lr
# whatever its gradient's size. Measured on an H100 80GB HBM3 at 700 W
# (PERF.md §6) against the one-card step on the same weights: the
# losses 3.4e-5 relative, the parameters' change over the two steps 5.3e-2
# relative L2, FedAvg's local loss 1.5e-6, its published delta 4.7e-2 and its
# parameters' change 5.0e-2; the bounds sit ~3x above.
TP_N, TP_M, TP_LAYERS = 4, 2, 1
TP_LOSS_RTOL, TP_CHANGE_REL = 1e-4, 0.15
# The rest of the zoo on the same grid (tp_zoo): TP_N x TP_M ranks sharing the
# card, each configuration at its published widths, seed SEED, the launcher's
# traffic, cut in depth (and the MoE in vocabulary, as the zoo's path) so that
# eight ranks fit one card: zamba2-2.7b at one unit (five Mamba2 blocks and the
# shared block), rwkv6-1.6b at one layer, qwen3-moe at one layer with its 128
# experts over the four learners' rings (E/n = 32 experts of f/m = 768 columns
# a rank). rwkv6 and qwen3-moe in bf16; zamba2 in f32: the random 6-layer
# zamba2's loss is ~20 and its bf16 gradients carry the logits' rounding
# (~25-30% from f32 ones in either package), so in bf16 the TP step read 0.378
# relative L2 from the one-card step's change on an H100 80GB HBM3 at 700 W
# (PERF.md §6) and the comparison says nothing about the split; f32 adds 0.4
# GB a rank (the dry run: 6.76 GB against 6.37). Two train steps (learner DIST_DEAD dead
# in the second) against the one-card step on the same weights and tokens;
# a weighted FedAvg round for rwkv6 (the pipelined chain; zamba2's, on the
# sequential chain, took 26.5 s of the script's limit on a slow host, and
# runs in the CPU tests, as tp_dist's round runs that chain). The MoE's
# FedAvg round carries every expert on every rank (no expert parallelism in
# FedAvg): ~26 GB a rank at one layer, which
# eight ranks cannot share one card with, so it runs in the CPU tests only
# (tests/test_torch_dist_tp_zoo.py). Bounds: zamba2 and rwkv6 tp_dist's,
# qwen3-moe the moe_dist path's (its expert sums already run in another order).
TP_ZOO = {
    "zamba2": ("zamba2-2.7b", dict(n_layers=6, dtype="float32")),
    "rwkv6": ("rwkv6-1.6b", dict(n_layers=1)),
    "moe": (EP_ARCH, dict(EP_CUT, ep_ranks=TP_N)),
}
TP_ZOO_FED = {"rwkv6": True}   # name -> the FedAvg round pipelined
# ``--nccl4-tp``: the newly split kinds through the launcher at 2 x 2, BON
NCCL_TP_ZOO = ("zamba2-2.7b", "rwkv6-1.6b")
# Pods with model shards (pod_tp): the ('pod', 'data', 'model') grid, POD_P
# pods x POD_STEP_N learners x TP_M model shards = 12 ranks sharing the card
# (dist.grid: rank (p·n + l)·m + j). SAFE's rings need three learners, so a
# pod holds three; internlm2-1.8b at full width and POD_LAYERS layer (the dry
# run's --per-rank --model-shards 2 with 2 pods: 4.29 GB a rank at one layer,
# 5.36 at two, before FedAvg's local copy and twelve CUDA contexts). Two train
# steps (learner DIST_DEAD of each pod dead in the second) and a weighted
# FedAvg round against the one-card pod step, within tp_dist's bounds.
PT_WEIGHTS = DIST_WEIGHTS[:POD_STEP_N]
# Serving across ranks (serve_dist): SD_DATA data x TP_M model ranks sharing
# the card. (a) the decode_32k layout: internlm2-1.8b at SERVE_LAYERS (all 24
# until tp_heads), the
# first SD_A_ROWS of traffic B's prompts (1024-3072 tokens), SD_A_ROWS /
# SD_DATA a data rank, each prefilled alone into a cache of SD_A_MAX, then
# SD_A_STEPS decode steps teacher-forced on the one-process run's greedy
# tokens, within SERVE_TOL of its logits. (b) long_500k's layout: gemma3-12b
# at one unit (SD_B_LAYERS: 5 local layers, window 1024, and a global one),
# batch 1, every attention cache's slots split over the data ranks (the
# global cache's SD_B_SEQ, 131,072 a rank), filled with seeded random k and
# v, pos in the middle of data rank 2's global slots and at a full cache,
# SD_B_STEPS decode steps against one process's dense decode of the whole
# cache, in f32 (the bf16 cache's words upcast; in bf16 the dense path rounds
# its probabilities to bf16 before they meet v, where the merge keeps f32, and
# that rounding, not the split, would set the distance): within SD_B_TOL of
# max |logit|, the card-against-CPU f32 gate.
SD_DATA = 4
SD_A_ROWS, SD_A_MAX, SD_A_STEPS = 8, 4096, 16
SD_B_ARCH, SD_B_LAYERS, SD_B_SEQ, SD_B_STEPS = "gemma3-12b", 6, 524_288, 8
SD_B_POS = (327_680, 524_288)
SD_B_TOL = SERVE_CARD_TOL
# Whole-unit uneven splits over the 'model' axis (tp_heads): internvl2-1b at its
# published widths (d_model 896, 14 q heads of 64, 2 kv heads, d_ff 4864; its
# vocabulary of 151,655, which 4 does not divide, split 37,914, 37,914,
# 37,914 and 37,913 words, where the reference's sanitize_spec replicates
# it), text only, TH_N learners x TH_M model
# shards = 12 ranks sharing the card (dist.grid: rank l·4 + j). m = 4 is the
# smallest model axis at which the reference's GSPMD cuts one of its heads (896
# columns divide by 4, 14 heads do not); the port's ranks hold 4, 4, 3 and 3
# whole q heads, rank 1's q heads 4-7 reading kv heads 0 and 1, the 2 kv
# heads on every rank. Depth TH_LAYERS of 24 (the embedding alone is 136 M
# words on every rank). Two SAFE train steps (learner DIST_DEAD dead in the
# second) and a weighted FedAvg round against the one-card port within
# tp_dist's bounds; then TH_N of traffic B's prompts, one a data rank,
# prefilled into caches of SD_A_MAX and TH_SERVE_STEPS decode steps
# teacher-forced on seeded tokens, within SERVE_TOL of one process.
# Text only (prefix_embeds 256 -> 0): the FedAvg round, the port's as the
# reference's, takes no prefix, and its loss would then drop the first 256
# text positions.
TH_ARCH, TH_N, TH_M, TH_LAYERS, TH_SERVE_STEPS = "internvl2-1b", 3, 4, 1, 8
TH_WEIGHTS = DIST_WEIGHTS[:TH_N]
# Rank 0's peak in the dry run of the same layouts before the loss became
# vocabulary-parallel (every rank gathered the whole vocabulary's f32 logits
# and took the loss over them; tp_heads' vocabulary replicated): the bytes the
# dry run's tp_dryrun, tpz_dryrun, pt_dryrun and th_dryrun gave on meta
# tensors at that commit. The TP paths print them beside the regenerated
# dry run's prediction and the card's reading.
GATHERED_HEAD_PEAK = {"tp_dist": 4165452800, "tp_zoo zamba2": 6760297472,
                      "tp_zoo rwkv6": 5571486720, "tp_zoo moe": 7376900096,
                      "pod_tp": 4291678208, "tp_heads": 1674726912}
# serve_dist (c): MoE serving across ranks routed over the global batch, as the
# reference's GSPMD routes decode. qwen3-moe-235b-a22b at full width (128
# experts, top 8, capacity factor 1.25), one unit, in f32 (so that the router's
# top 8 of 128 are the one-process run's: a bf16 word that the ranks' split
# products round the other way would move a near tie), SD_DATA data x TP_M
# model ranks: SD_C_ROWS rows (SD_C_ROWS / SD_DATA a data rank), a cache of
# SD_C_MAX slots of seeded random k and v at pos SD_C_POS, SD_C_STEPS decode
# steps of seeded tokens through make_serve_step(model, grid). The global
# capacity is max(8, ceil(64 * 8 / 128 * 1.25)) = 8 a step, so experts drop
# tokens; the ranks' logits within SERVE_TOL of one process's decode of the
# whole batch, and each expert's kept tokens, summed over the data ranks,
# equal to one process's (``models/moe.py::route_stats``).
SD_C_ROWS, SD_C_MAX, SD_C_POS, SD_C_STEPS = 64, 4096, 3000, 4


def say(*parts):
    print(*parts, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sync():
    torch.cuda.synchronize()


def u32_diff(a, b):
    """Largest |a - b| of two uint32 tensors, as integers."""
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


SPIN_CYCLES = 50_000_000    # ~25 ms at 1.98 GHz: longer than queueing 50 launches


def cuda_ms(fn, iters, warmup=3, queued=True):
    """Mean time of ``fn`` over ``iters`` back-to-back calls, from CUDA
    events. With ``queued`` the calls wait behind a spin kernel while the
    host queues them, so the device runs them back to back and the time is
    the device's alone; without it the host's launch cost shows too."""
    for _ in range(warmup):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


# ---- phase 3: kernels vs plain versions ---------------------------------------

def check_kernels(dev, ops_cuda, ref):
    tma, cc, bm = ops_cuda
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    err = {k: 0 for k in OPS}
    checks = 0
    for V in (1, 5, 129, 100_001, V_MAIN):
        x = torch.rand(V + 1, generator=g, device=dev) * 200 - 100
        c = torch.randint(-2**31, 2**31, (V + 1,), generator=g, device=dev,
                          dtype=torch.int32).view(torch.uint32)
        for base in (0, 2**32 - 5):
            key, kin, kout = [V, 0xDEADBEEF], [3, base], [base, 7]
            # an 8-byte aligned vector, then views that start on an odd word
            for xs, cs in ((x[:V], c[:V]), (x[1:], c[1:])):
                # pads from stream word 0, then mid-block and on a block
                for offset in (0, 1, 466_034, 466_035):
                    got = tma.mask_add(xs, key, base, offset=offset)
                    want = ref.mask_add_ref(xs, key, base, offset=offset)
                    err["mask_add"] = max(err["mask_add"], u32_diff(got, want))
                got = cc.chain_combine(cs, xs, kin, kout, base)
                want = ref.chain_combine_ref(cs, xs, kin, kout, base)
                err["chain_combine"] = max(err["chain_combine"], u32_diff(got, want))
                # 300 keys below the main width only: the plain version
                # at 2^24 words took ~12 s of the script (the main path's
                # BON has m = 36)
                ms = (1, 2, 36, 300) if V < V_MAIN else (1, 2, 36)
                for m in ms:
                    keys = rng.randint(0, 2**32, (m, 2), dtype=np.uint64).astype(np.uint32)
                    signs = rng.choice([-1, 1], m)
                    got = bm.bon_mask(xs, keys, signs, base)
                    want = ref.bon_mask_ref(xs, keys, signs, base)
                    err["bon_mask"] = max(err["bon_mask"], u32_diff(got, want))
                checks += 6 + len(ms)
    for S in (1, 8, N):
        for V in (1, 5, 129, 100_001, V_MAIN):
            if S == N and V == V_MAIN:
                continue  # 36 rows are checked below at the pipelined step's width
            cipher = torch.randint(-2**31, 2**31, (S, V), generator=g, device=dev,
                                   dtype=torch.int32).view(torch.uint32)
            x = torch.rand((S, V), generator=g, device=dev) * 100 - 50
            kin = rng.randint(0, 2**32, (S, 2), dtype=np.uint64).astype(np.uint32)
            kout = rng.randint(0, 2**32, (S, 2), dtype=np.uint64).astype(np.uint32)
            # start words s * (2V + 1): every other row starts mid-block
            for bases, starts in (
                    (np.zeros(S, np.uint32), None),
                    (np.full(S, 2**32 - 5, np.uint32) - np.arange(S, dtype=np.uint32), None),
                    (np.full(S, 2**32 - 5, np.uint32), np.arange(S) * (2 * V + 1))):
                got = cc.chain_combine_batched(cipher, x, kin, kout, bases, starts=starts)
                want = ref.chain_combine_batched_ref(cipher, x, kin, kout, bases,
                                                     starts=starts)
                e = u32_diff(got, want)
                if starts is None:
                    for s in range(S):  # row s is a standalone hop
                        e = max(e, u32_diff(got[s], cc.chain_combine(
                            cipher[s].contiguous(), x[s].contiguous(), kin[s], kout[s],
                            int(bases[s]))))
                err["chain_combine_batched"] = max(err["chain_combine_batched"], e)
                checks += 1
    # the pipelined step at the main path's shape: 36 rows of seg words,
    # row s's pads from word s * seg (seg odd)
    seg = -(-V_MAIN // N)
    cipher = torch.randint(-2**31, 2**31, (N, seg), generator=g, device=dev,
                           dtype=torch.int32).view(torch.uint32)
    x = torch.rand((N, seg), generator=g, device=dev) * 100 - 50
    kin = rng.randint(0, 2**32, (N, 2), dtype=np.uint64).astype(np.uint32)
    kout = rng.randint(0, 2**32, (N, 2), dtype=np.uint64).astype(np.uint32)
    bases, starts = np.full(N, 2**32 - 5, np.uint32), np.arange(N) * seg
    got = cc.chain_combine_batched(cipher, x, kin, kout, bases, starts=starts)
    want = ref.chain_combine_batched_ref(cipher, x, kin, kout, bases, starts=starts)
    err["chain_combine_batched"] = max(err["chain_combine_batched"], u32_diff(got, want))
    checks += 1
    sync()
    if any(err.values()):
        fail(f"kernel differs from its plain version: {err}")
    return err, checks


# ---- phase 5: answers ---------------------------------------------------------

def survivor_mean64(values, alive, weights=None, subgroups=1):
    """float64 mean of the survivors' rows of [n, V], per subgroup ring and
    then over the rings; of [P, n, V], the mean over pods of each pod's."""
    if values.dim() == 3:
        return sum(survivor_mean64(v, alive, weights, subgroups)
                   for v in values) / values.shape[0]
    m = values.shape[0] // subgroups
    means = []
    for grp in range(subgroups):
        acc = torch.zeros(values.shape[1], dtype=torch.float64, device=values.device)
        den = 0.0
        for r in range(grp * m, (grp + 1) * m):
            if alive[r] > 0:
                w = 1.0 if weights is None else float(weights[r])
                acc += values[r].double() * w
                den += w
        means.append(acc / den)
    return sum(means) / subgroups


def round_cases(rng):
    """name -> (mode, aggregator kwargs, aggregate kwargs)."""
    alive = np.ones(N, np.float32)
    alive[DEAD] = 0.0
    w = rng.uniform(1, 10, N).astype(np.float32)
    pipe = dict(pipelined=True)
    return {
        "clean": ("safe", dict(), dict()),
        "failover": ("safe", dict(), dict(alive=alive)),
        "weighted": ("safe", dict(weighted=True), dict(weights=w)),
        "rotate7": ("safe", dict(), dict(rotate=7)),
        "rotate7-failover": ("safe", dict(), dict(rotate=7, alive=np.where(
            np.arange(N) == 7, 0.0, 1.0).astype(np.float32))),
        "bon": ("bon", dict(), dict()),
        "bon-failover": ("bon", dict(), dict(alive=alive)),
        "pipelined": ("safe", pipe, dict()),
        "pipelined-failover": ("safe", pipe, dict(alive=alive)),
        "pipelined-weighted": ("safe", dict(pipe, weighted=True), dict(weights=w)),
        "pipelined-subgroups2": ("safe", dict(pipe, subgroups=2), dict()),
        "hierarchical": ("safe", dict(pod_axis="pod"), dict()),
    }


def weighted_tol(n, xmax, wsum):
    """The weighted round's fixed-point bound: n encode roundings (plus the
    f32 product value * weight) of values up to ``xmax`` over the
    survivors' sum of weights, plus the f32 result's rounding."""
    return n * (0.5 * STEP + 2.0 ** -20) * (1 + xmax) / wsum + STEP


def check_rounds(values, hvalues, make_aggregator, outs):
    """Each case on the card against a float64 mean of the survivors, and
    bit-identical to the port's CPU path at width V_CPU. ``outs`` holds
    the main paths' outputs of the clean cases."""
    rng = np.random.RandomState(SEED + 1)
    xmax = float(values.abs().max())
    lines = []
    for name, (mode, akw, kw) in round_cases(rng).items():
        vals = hvalues if "pod_axis" in akw else values
        if "alive" in kw:  # a dead rank's NaN must never reach the sum
            vals = vals.clone()
            vals[..., np.flatnonzero(kw["alive"] == 0).tolist(), :] = float("nan")
        out = outs.get(name)
        if out is None:
            out = make_aggregator(mode, N, **akw).aggregate(vals, **kw)
        if out.shape != (V_MAIN,) or out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
            fail(f"round {name}: bad output {out.shape} {out.dtype}")
        alive = kw.get("alive", np.ones(N, np.float32))
        weights = kw.get("weights") if akw.get("weighted") else None
        want = survivor_mean64(vals, alive, weights, akw.get("subgroups", 1))
        err = float((out.double() - want).abs().max())
        if weights is not None:
            tol = weighted_tol(N, xmax, float(weights[alive > 0].sum()))
        else:  # the mean of encode roundings, plus the f32 result's
            tol = STEP
        if err > tol:
            fail(f"round {name}: max |err| {err} > {tol}")
        narrow = vals[..., :V_CPU].contiguous()
        got = make_aggregator(mode, N, **akw).aggregate(narrow, **kw)
        cpu = make_aggregator(mode, N, device="cpu", **akw).aggregate(narrow.cpu(), **kw)
        if not torch.equal(got.cpu(), cpu):
            fail(f"round {name}: card and CPU path differ at [{N}, {V_CPU}]")
        lines.append(f"{name} err={err:.3e} tol={tol:.3e}")
    return lines


# ---- phase 4/5: the engine -----------------------------------------------------

def engine_sessions(dev):
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    out = []
    for s in range(10):  # ten sessions through eight slots
        alive = np.ones(N, np.float32)
        if s == 2:
            alive[[0, 5]] = 0.0            # the default initiator is dead
        if s == 5:
            alive[[9, 10, 30]] = 0.0
        vals = torch.rand((N, V_ENGINE), generator=g, device=dev) * 4 - 2
        out.append(dict(values=vals, rounds=3 if s == 0 else 1,
                        provisioning_seed=0xC0FFEE + s, learner_master=0x5EED + 17 * s,
                        alive=alive, rotate0=7 * s))
    return out


def check_engine(sessions, make_aggregator):
    for spec, sess in sessions:
        single = make_aggregator("safe", N, provisioning_seed=spec["provisioning_seed"],
                                 learner_master=spec["learner_master"])
        if len(sess.results) != spec["rounds"]:
            fail(f"session {sess.sid}: {len(sess.results)} rounds of {spec['rounds']}")
        for r, got in enumerate(sess.results):
            want = single.aggregate(spec["values"], r * V_ENGINE, alive=spec["alive"],
                                    rotate=spec["rotate0"] + r)
            if not torch.equal(got, want):
                fail(f"engine session {sess.sid} round {r} differs from a single run")
        mean = survivor_mean64(spec["values"], spec["alive"])
        if float((sess.results[0].double() - mean).abs().max()) > STEP:
            fail(f"engine session {sess.sid}: mean off by more than {STEP}")


# ---- phase 6: timings -----------------------------------------------------------

def time_kernels(dev, values, tma, cc, bm, ref):
    rng = np.random.RandomState(SEED + 3)
    x = values[1]
    cipher = tma.mask_add(values[0], [1, 2], 0)
    xb = values[:S_ENGINE, :V_ENGINE].contiguous()
    cb = torch.stack([tma.mask_add(xb[s], [s, 9], 0) for s in range(S_ENGINE)])
    kin = rng.randint(0, 2**32, (S_ENGINE, 2), dtype=np.uint64).astype(np.uint32)
    kout = rng.randint(0, 2**32, (S_ENGINE, 2), dtype=np.uint64).astype(np.uint32)
    bases = np.arange(S_ENGINE, dtype=np.uint32) * V_ENGINE
    bkeys = rng.randint(0, 2**32, (M_BON, 2), dtype=np.uint64).astype(np.uint32)
    bsigns = np.where(np.arange(M_BON) < M_BON // 2, -1, 1)  # learner 18's signs
    runs = {
        "mask_add": (lambda: tma.mask_add(x, [5, 6], 0),
                     lambda: ref.mask_add_ref(x, [5, 6], 0), V_MAIN, 8 * V_MAIN, 1),
        "chain_combine": (lambda: cc.chain_combine(cipher, x, [3, 4], [5, 6], 0),
                          lambda: ref.chain_combine_ref(cipher, x, [3, 4], [5, 6], 0),
                          V_MAIN, 12 * V_MAIN, 1),
        "chain_combine_batched": (
            lambda: cc.chain_combine_batched(cb, xb, kin, kout, bases),
            lambda: ref.chain_combine_batched_ref(cb, xb, kin, kout, bases),
            S_ENGINE * V_ENGINE, 12 * S_ENGINE * V_ENGINE + 24 * S_ENGINE, 1),
        "bon_mask": (lambda: bm.bon_mask(x, bkeys, bsigns, 0),
                     lambda: ref.bon_mask_ref(x, bkeys, bsigns, 0),
                     V_MAIN, 8 * V_MAIN + 12 * M_BON, M_BON),
    }
    out = {}
    for name, (kern, plain, words, nbytes, m) in runs.items():
        ms = cuda_ms(kern, iters=50 if name != "bon_mask" else 20)
        issue_ms = cuda_ms(kern, iters=50 if name != "bon_mask" else 20, queued=False)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS[name](m) * words / ISSUE_OPS_PER_S * 1e3
        out[name] = dict(ms=ms, issue_ms=issue_ms, plain_ms=plain_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                         bytes_ms=bytes_ms, ops_ms=ops_ms,
                         gbytes_per_s=nbytes / ms / 1e6, words=words, m=m)
    return out


PROFILE_TOP = 8             # device entries listed per profiled call


def profile_ms(fn):
    """(wall ms, device busy ms, top kernels) of one call of ``fn`` under
    torch.profiler, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only: a CPU op's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:PROFILE_TOP]
    return wall, busy, ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                                 f" x{e.count}" for e in top)


# ---- the FedAvg path: phases 4, 5 and 6 ------------------------------------------

class WatchedAggregator:
    """The FedAvg round's or the train step's aggregator, watched from
    outside: each call of ``aggregate`` keeps what the caller handed it and
    what it published (``seen``) so that the round's own published mean can
    be checked against the rows it aggregated, and CUDA events mark the
    call's start and end so that the round that is checked is the round
    that is timed. ``nan_rows`` are set to NaN on the way in: a dead
    learner's row must never reach the sum."""

    def __init__(self, agg):
        self.agg, self.cfg = agg, agg.cfg
        self.nan_rows, self.seen = [], None
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def reserve_round(self, nwords):
        return self.agg.reserve_round(nwords)

    def aggregate(self, values, counter_base=0, alive=None, weights=None, domain=0, rotate=0):
        self.seen = None  # the last call's values may go before this call's peak
        values[self.nan_rows] = float("nan")
        self.start.record()
        out = self.agg.aggregate(values, counter_base, alive=alive, weights=weights,
                                 domain=domain, rotate=rotate)
        self.end.record()
        self.seen = dict(values=values, counter=counter_base, alive=alive, weights=weights,
                         rotate=rotate, out=out)
        return out


def fed_setup(dev, cfg):
    """(model, watched aggregator, bundle, tokens [n, k, B, S] on dev,
    weights) of the FedAvg path. Every round trains on the same tokens, as
    the reference's FedAvg test does; the weights are the stream's sample
    counts (1000, 1500, 2000, 2500)."""
    from repro_torch.core import make_aggregator
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    from repro_torch.train import make_federated_round
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    stream = make_federated_batches(cfg, FED_N, FED_B, FED_S, seed=SEED)
    toks = np.stack([np.stack([stream.learner_batch(l, k)["tokens"] for k in range(FED_K)])
                     for l in range(FED_N)])
    agg = WatchedAggregator(make_aggregator("safe", FED_N, weighted=True, device=dev))
    bundle = make_federated_round(model, agg, local_steps=FED_K, local_lr=FED_LR,
                                  return_delta=True)
    return model, agg, bundle, torch.from_numpy(toks).to(dev), stream.global_batch(0)["weights"]


def check_published(name, m, agg, weights, alive, counter):
    """round_fn's own published delta (``m["avg_delta"]``) against a
    float64 weighted mean of the survivors' rows of the deltas it
    aggregated, CHUNK words at a time (a float64 [n, P] would not fit),
    within the weighted fixed-point bound; ``weights`` and ``alive`` are
    the caller's, not what round_fn passed on. Returns a report line."""
    seen, avg = agg.seen, m["avg_delta"]
    deltas = seen["values"]
    if int(seen["counter"]) != counter:
        fail(f"fedavg {name}: round_fn passed counter {seen['counter']}, not {counter}")
    if avg.shape != (deltas.shape[1],) or not bool(torch.isfinite(avg).all()):
        fail(f"fedavg {name}: bad published delta {avg.shape} {avg.dtype}")
    w = [float(weights[r]) if alive[r] > 0 else 0.0 for r in range(FED_N)]
    err, xmax = 0.0, 0.0
    for s in range(0, deltas.shape[1], CHUNK):
        e = min(deltas.shape[1], s + CHUNK)
        acc = torch.zeros(e - s, dtype=torch.float64, device=deltas.device)
        for r, wr in enumerate(w):
            if wr > 0:
                acc += deltas[r, s:e].double() * wr
                xmax = max(xmax, float(deltas[r, s:e].abs().max()))
        err = max(err, float((avg[s:e].double() - acc / sum(w)).abs().max()))
    tol = weighted_tol(FED_N, xmax, sum(w))
    if err > tol:
        fail(f"fedavg {name}: max |err| {err} > {tol}")
    return f"{name}: round_fn's avg_delta err={err:.3e} tol={tol:.3e} (float64 weighted mean)"


def check_cpu_path(name, agg, alive, weights, counter, rotate=0, path="fedavg"):
    """The aggregation of the seen rows' first V_CPU words on the card is
    bit-identical to the port's CPU path (the same mode, keys, counter,
    alive, weights and rotation)."""
    from repro_torch.core import SecureAggregator
    inner = agg.agg
    cpu = SecureAggregator(inner.cfg, inner.provisioning_seed, inner.learner_master, "cpu")
    narrow = agg.seen["values"][:, :V_CPU].contiguous()
    got = inner.aggregate(narrow, counter, alive=alive, weights=weights, rotate=rotate)
    if not torch.equal(got.cpu(), cpu.aggregate(narrow.cpu(), counter, alive=alive,
                                               weights=weights, rotate=rotate)):
        fail(f"{path} {name}: card and CPU path differ at [{narrow.shape[0]}, {V_CPU}]")


def chunked_diff(got, want):
    """Largest |got - want| of a uint32 vector against ``want(s, e)``, its
    plain version's words [s, e), CHUNK words at a time."""
    V = got.shape[0]
    return max((u32_diff(got[s:min(V, s + CHUNK)], want(s, min(V, s + CHUNK)))
                for s in range(0, V, CHUNK)), default=0)


def hop_diff(x, key, kin, kout, base):
    """mask_add of ``x`` and chain_combine of that ciphertext against their
    plain versions, CHUNK words at a time (the plain pads start at the
    chunk's word): {kernel: max |err|}."""
    from repro_torch.kernels import chain_combine as cc
    from repro_torch.kernels import ref
    from repro_torch.kernels import threefry_mask_add as tma
    masked = tma.mask_add(x, key, base)
    hop = cc.chain_combine(masked, x, kin, kout, base)
    return {"mask_add": chunked_diff(
                masked, lambda s, e: ref.mask_add_ref(x[s:e], key, base, offset=s)),
            "chain_combine": chunked_diff(
                hop, lambda s, e: ref.chain_combine_ref(masked[s:e], x[s:e], kin, kout, base,
                                                        offset=s))}


def check_full_length(agg, weights, base, err):
    """mask_add and chain_combine at a path's own length — FedAvg's V = P + 1
    words, the train step's V = padded_size — on rows of the real payload
    built from the seen rows: row 0 starts on an aligned word, row 1 on an
    odd one when V is odd (P + 1 is).
    Each output is held ``torch.equal`` to the plain version, CHUNK words
    at a time (the plain pads start at the chunk's word). Folds the
    differences into ``err``; the seen deltas are freed."""
    from repro_torch.core.chain import _payload
    payload = _payload(agg.seen["values"], agg.cfg, weights)
    agg.seen = None
    V = payload.shape[1]
    key, kin, kout = [0x5EED, 13], [3, 0xC0FFEE], [0xDEADBEEF, 7]
    full = {"mask_add": 0, "chain_combine": 0}
    for row in (0, 1):
        e = hop_diff(payload[row], key, kin, kout, base)
        full = {k: max(full[k], e[k]) for k in full}
    sync()
    for k, v in full.items():
        err[k] = max(err[k], v)
    if any(full.values()):
        fail(f"a kernel differs from its plain version at V = {V}: {full}")
    return (f"kernels at V = {V}: mask_add and chain_combine on payload rows 0 (aligned) "
            f"and 1 ({'aligned' if V % 2 == 0 else 'odd word'}), counter base {base}, "
            f"== plain in {-(-V // CHUNK)} chunks a row: max |err| {full}")


def fedavg_paths(dev, launches, err, smi):
    """Phases 4-6 of the FedAvg path; adds its launches to ``launches`` and
    its full-length kernel checks to ``err``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.train import tree_size

    cfg = dataclasses.replace(get_config(FED_ARCH), n_layers=FED_LAYERS)
    model, agg, bundle, tokens, weights = fed_setup(dev, cfg)
    params = bundle.init_state_fn(model.tree())
    P = tree_size(params)
    words = P + 1  # counter words a weighted round consumes: the stride between rounds
    everyone = np.ones(FED_N, np.float32)
    begin, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    sync()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, walls, checks = [], [], [], []
    for r in range(FED_ROUNDS):
        t0 = time.perf_counter()
        begin.record()
        params, m = bundle.round_fn(params, tokens, weights=weights, counter=r * words)
        done.record()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        # the round's parts: deltas_fn, the aggregation, apply and metrics
        split = (begin.elapsed_time(agg.start), agg.start.elapsed_time(agg.end),
                 agg.end.elapsed_time(done))
        losses.append(float(m["local_loss"]))
        norms.append(float(m["delta_norm"]))
        checks.append(check_published(f"round {r + 1}", m, agg, weights, everyone, r * words))
        if r + 1 < FED_ROUNDS:
            agg.seen = None
        del m
    counts = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 4 main path fedavg: {sum(walls) / 1e3:.2f} s for {FED_ROUNDS} rounds of "
        f"round_fn; {FED_ARCH} at full width, {FED_LAYERS} of 24 layers, P={P}, n={FED_N}, "
        f"k={FED_K}, tokens [{FED_B}, {FED_S}]; peak memory {peak / 1e9:.2f} GB; "
        f"local_loss {[round(x, 4) for x in losses]}; launches {counts}")
    missing = sorted(k for k in PATH_KERNELS["fedavg"] if counts[k] <= 0)
    if missing:
        fail(f"path fedavg never launched {missing}: {counts}")
    for k, c in counts.items():
        launches[k] += c

    if not losses[-1] < losses[0]:
        fail(f"fedavg: the loss did not fall over {FED_ROUNDS} rounds: {losses}")
    if not min(norms) > 0:
        fail(f"fedavg: a published delta is zero: norms {norms}")
    say(f"phase 5 fedavg: local_loss round 1 {losses[0]:.4f} > round {FED_ROUNDS} "
        f"{losses[-1]:.4f}; delta_norm {[round(x, 5) for x in norms]}; every avg_delta finite")
    for line in checks:
        say(f"phase 5 fedavg {line}")
    last = (FED_ROUNDS - 1) * words
    check_cpu_path(f"round {FED_ROUNDS}", agg, everyone, weights, last)
    say(f"phase 5 fedavg {check_full_length(agg, weights, last, err)}")
    torch.cuda.empty_cache()

    # a failover round: learner FED_DEAD dead, its row NaN
    dead = everyone.copy()
    dead[FED_DEAD] = 0.0
    agg.nan_rows = [FED_DEAD]
    _, m = bundle.round_fn(params, tokens, weights=weights, counter=FED_ROUNDS * words,
                           alive=dead)
    agg.nan_rows = []
    say(f"phase 5 fedavg {check_published('failover', m, agg, weights, dead, FED_ROUNDS * words)}")
    check_cpu_path("failover", agg, dead, weights, FED_ROUNDS * words)
    say(f"phase 5 fedavg: card == CPU path on [{FED_N}, {V_CPU}], clean and failover")
    agg.seen = None
    del m

    local_ms, agg_ms, apply_ms = split  # round FED_ROUNDS, from its own events
    round_ms = walls[-1]
    step_ms = local_ms / (FED_N * FED_K)
    tokens_per_step = FED_B * FED_S
    mfu = 6 * P * tokens_per_step / (step_ms / 1e3) / BF16_FLOPS_PER_S
    # 3 mask_add (8 bytes a word) and 3 chain_combine (12) at V = P + 1; the
    # payload build reads [n, P] and writes [n, P + 1] f32
    kern_ms = (3 * 8 + 3 * 12) * words / HBM_BYTES_PER_S * 1e3
    payload_ms = 2 * 4 * FED_N * words / HBM_BYTES_PER_S * 1e3
    say(f"phase 6 fedavg round {FED_ROUNDS}: {round_ms:.1f} ms wall = local steps "
        f"{local_ms:.1f} + SAFE aggregation {agg_ms:.2f} + apply {apply_ms:.2f} ms "
        f"(device events inside round_fn); SAFE share "
        f"{agg_ms / (local_ms + agg_ms + apply_ms):.2%} | {smi}")
    say(f"phase 6 fedavg local step: {step_ms:.2f} ms ({FED_N * FED_K} steps, each "
        f"learner's copy and delta included), {tokens_per_step / step_ms * 1e3:.0f} tokens/s, "
        f"model-FLOPs share 6PT/t = {mfu:.2%} of 989 TFLOP/s (mfu, information) | {smi}")
    say(f"phase 6 fedavg aggregation: {agg_ms:.2f} ms on [{FED_N}, {words}] against a bytes "
        f"bound of {kern_ms:.2f} ms for the 6 kernels + {payload_ms:.2f} ms for the "
        f"payload build = {kern_ms + payload_ms:.2f} ms ({(kern_ms + payload_ms) / agg_ms:.0%}) | {smi}")
    # the profiled calls reuse counter 0: their outputs are dropped
    say_profile("fedavg round", lambda: bundle.round_fn(params, tokens, weights=weights,
                                                        counter=0))
    agg.seen = None
    deltas, _ = bundle.deltas_fn(params, tokens)  # only now: 15 GB beside a round's peak
    say_profile("fedavg aggregation", lambda: agg.aggregate(deltas, 0, weights=weights))


# ---- the train-step path: phases 4, 5 and 6 ---------------------------------------

class StepMarks:
    """``step_fn``'s ``mark``: a CUDA event at the end of each part of a step,
    so the step's device time splits into its parts."""

    def __init__(self):
        self.begin = torch.cuda.Event(enable_timing=True)
        self.events = []

    def start(self):
        self.events = []
        self.begin.record()

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def parts(self, done):
        """ms per part name (summed over learners), to the ``done`` event."""
        out, prev = {}, self.begin
        for name, ev in self.events + [("metrics", done)]:
            out[name] = out.get(name, 0.0) + prev.elapsed_time(ev)
            prev = ev
        return out


def check_step_mean(name, agg, alive, counter):
    """The step's own published gradient mean (what the aggregator handed
    back to ``step_fn``) against a float64 mean of the survivors' rows of
    the [n, padded_size] matrix it aggregated, CHUNK words at a time,
    within the fixed-point bound STEP; and the counter and rotation the
    step passed. Returns a report line."""
    seen = agg.seen
    vals, out = seen["values"], seen["out"]
    n = vals.shape[0]
    if int(seen["counter"]) != counter or int(seen["rotate"]) != counter % (2 * n + 1):
        fail(f"train step {name}: step_fn passed counter {seen['counter']} and rotate "
             f"{seen['rotate']}, not {counter} and {counter % (2 * n + 1)}")
    if out.shape != (vals.shape[1],) or not bool(torch.isfinite(out).all()):
        fail(f"train step {name}: bad published mean {out.shape} {out.dtype}")
    live = [r for r in range(n) if alive[r] > 0]
    err = 0.0
    for s in range(0, vals.shape[1], CHUNK):
        e = min(vals.shape[1], s + CHUNK)
        acc = torch.zeros(e - s, dtype=torch.float64, device=vals.device)
        for r in live:
            acc += vals[r, s:e].double()
        err = max(err, float((out[s:e].double() - acc / len(live)).abs().max()))
    if err > STEP:
        fail(f"train step {name}: max |err| {err} > {STEP}")
    return (f"{name}: step_fn's published mean err={err:.3e} tol={STEP:.3e} (float64 mean "
            f"of survivors {live}), counter {counter}, rotate {counter % (2 * n + 1)}")


def run_steps(name, bundle, agg, state, tokens, steps, marks, done):
    """``steps`` steps of ``bundle.step_fn`` on one repeated batch, each with
    fresh counters from ``reserve_round(padded_size + 2)``, timed by its
    CUDA events, each step's published mean checked (``check_step_mean``).
    Returns (state, losses, grad scales, walls ms, the last step's parts,
    the checks' lines, counters)."""
    W = bundle.padded_size + 2
    everyone = np.ones(TS_N, np.float32)
    losses, scales, walls, checks, counters = [], [], [], [], []
    for i in range(steps):
        counters.append(agg.reserve_round(W))
        t0 = time.perf_counter()
        marks.start()
        state, m = bundle.step_fn(state, tokens, counter=counters[-1], mark=marks)
        done.record()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        parts = marks.parts(done)
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
        checks.append(check_step_mean(f"{name}step {i + 1}", agg, everyone, counters[-1]))
        if i + 1 < steps:
            agg.seen = None
        del m
    return state, losses, scales, walls, parts, checks, counters


def train_step_setup(dev, cfg):
    """(model, watched SAFE aggregator, bundle, tokens [n, B, S] on dev) of
    the train-step path: the reference launcher's first global batch,
    repeated every step as the reference's training test does."""
    from repro_torch.core import make_aggregator
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    from repro_torch.train import make_train_step
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    stream = make_federated_batches(cfg, TS_N, TS_B, TS_S, seed=SEED)
    tokens = torch.from_numpy(stream.global_batch(0)["tokens"]).to(dev)
    agg = WatchedAggregator(make_aggregator("safe", TS_N, device=dev))
    return model, agg, make_train_step(model, agg, lr=TS_LR), tokens


def train_step_paths(dev, launches, err, smi):
    """Phases 4-6 of the train-step path; adds its launches to ``launches``
    and its full-length kernel checks to ``err``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import make_aggregator
    from repro_torch.kernels import build
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(get_config(TS_ARCH), n_layers=TS_LAYERS)
    model, agg, bundle, tokens = train_step_setup(dev, cfg)
    W = bundle.padded_size + 2  # the words one step pads (reserve_round takes words)
    state = bundle.init_state_fn(model.tree())
    everyone = np.ones(TS_N, np.float32)
    marks, done = StepMarks(), torch.cuda.Event(enable_timing=True)

    sync()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state, losses, scales, walls, parts, checks, counters = run_steps(
        "", bundle, agg, state, tokens, TS_STEPS, marks, done)
    counts = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 4 main path train step: {sum(walls) / 1e3:.2f} s for {TS_STEPS} steps of "
        f"step_fn; {TS_ARCH} at full width, {TS_LAYERS} of 24 layers, sec_size "
        f"{bundle.sec_size}, padded_size {bundle.padded_size}, n={TS_N}, tokens [{TS_B}, "
        f"{TS_S}] a learner, counters {counters} (reserve_round({W})); peak memory "
        f"{peak / 1e9:.2f} GB; loss {[round(x, 4) for x in losses]}; launches {counts}")
    missing = sorted(k for k in PATH_KERNELS["train_step"] if counts[k] <= 0)
    if missing:
        fail(f"path train step never launched {missing}: {counts}")
    for k, c in counts.items():
        launches[k] += c

    if not losses[-1] < losses[0]:
        fail(f"train step: the loss did not fall over {TS_STEPS} steps: {losses}")
    say(f"phase 5 train step: loss step 1 {losses[0]:.4f} > step {TS_STEPS} {losses[-1]:.4f}; "
        f"grad_scale {[round(x, 5) for x in scales]}")
    for line in checks:
        say(f"phase 5 train step {line}")
    last = counters[-1]
    check_cpu_path(f"step {TS_STEPS}", agg, everyone, None, last, rotate=last % (2 * TS_N + 1),
                   path="train step")
    say(f"phase 5 train step {check_full_length(agg, None, last, err)}")
    torch.cuda.empty_cache()

    # one key set's 2^32 counters hold 2^32 // ceil(W / 2) steps (9 at full
    # width: each counter pads two words): the learner-1-dead step takes the
    # next; once the set's ranges are spent, reserve_round refuses and the
    # keys rotate
    fit = 2**32 // agg.agg.round_counters(W)
    failover = []
    for name, dead, who in (("learner 1 dead", 1, agg), ("rank 0 dead", 0, None)):
        if who is None:
            for _ in range(fit - TS_STEPS - 1):
                agg.reserve_round(W)
            try:
                agg.reserve_round(W)
            except OverflowError as e:
                refusal = str(e)
            else:
                fail(f"train step: reserve_round did not refuse step {fit + 1} of a key set")
            # a Round-0 key rotation: fresh keys, fresh counter space
            who = WatchedAggregator(make_aggregator("safe", TS_N, device=dev,
                                                    provisioning_seed=0xC0FFEE + 1,
                                                    learner_master=0x5EED + 1))
            rekeyed = make_train_step(model, who, lr=TS_LR)
            say(f"phase 5 train step: key set 1 refused step {fit + 1} ({refusal}); keys "
                f"rotated")
        alive = everyone.copy()
        alive[dead] = 0.0
        who.nan_rows = [dead]
        counter = who.reserve_round(W)
        step_fn = bundle.step_fn if who is agg else rekeyed.step_fn
        state, m = step_fn(state, tokens, counter=counter, alive=alive)
        who.nan_rows = []
        if not np.isfinite(float(m["loss"])):
            fail(f"train step {name}: loss {float(m['loss'])}")
        failover.append(f"{check_step_mean(name, who, alive, counter)}; loss {float(m['loss']):.4f}")
        check_cpu_path(name, who, alive, None, counter, rotate=counter % (2 * TS_N + 1),
                       path="train step")
        who.seen = None
        del m
    for line in failover:
        say(f"phase 5 train step {line}; card == CPU path on [{TS_N}, {V_CPU}]")

    # phase 6: step TS_STEPS, split by its own CUDA events
    P, V = bundle.sec_size, bundle.padded_size
    step_ms = walls[-1]
    dev_ms = sum(parts.values())
    fb, flat, agg_ms = parts["forward_backward"], parts["flatten"], parts["aggregate"]
    opt_ms, rebuild_ms = parts["optimizer"], parts["rebuild"]
    tokens_per_step = TS_N * TS_B * TS_S
    mfu = 6 * P * tokens_per_step / (fb / 1e3) / BF16_FLOPS_PER_S
    opt_bound = 7 * 4 * V / HBM_BYTES_PER_S * 1e3      # read g, m, v, p; write m, v, p
    agg_bound = (3 * 8 + 3 * 12) * V / HBM_BYTES_PER_S * 1e3  # 3 mask_add, 3 chain_combine
    flat_bound = TS_N * (2 + 4) * P / HBM_BYTES_PER_S * 1e3   # bf16 grads in, f32 rows out
    rebuild_bound = (4 + 2) * P / HBM_BYTES_PER_S * 1e3
    say(f"phase 6 train step {TS_STEPS} ({smi}): {step_ms:.1f} ms wall, {dev_ms:.1f} ms from "
        f"its CUDA events = learners' forward and backward {fb:.1f} + flatten and pad "
        f"{flat:.2f} + SAFE aggregation {agg_ms:.2f} + FlatAdamW {opt_ms:.2f} + rebuild "
        f"{rebuild_ms:.2f} + metrics {parts['metrics']:.2f} ms; SAFE share "
        f"{agg_ms / dev_ms:.2%}; {tokens_per_step / step_ms * 1e3:.0f} tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    say(f"phase 6 train step bounds ({smi}): SAFE aggregation {agg_ms:.2f} ms against "
        f"{agg_bound:.2f} ms for its 6 kernels' bytes ({agg_bound / agg_ms:.0%}); FlatAdamW "
        f"{opt_ms:.2f} ms against a bytes bound of {opt_bound:.2f} ms ({opt_bound / opt_ms:.0%}) "
        f"on {V} words; flatten {flat:.2f} ms against {flat_bound:.2f} ms; rebuild "
        f"{rebuild_ms:.2f} ms against {rebuild_bound:.2f} ms; forward and backward "
        f"{fb / TS_N:.1f} ms a learner, model-FLOPs share 6PT/t = {mfu:.2%} of 989 TFLOP/s "
        f"(information)")

    holder = {"state": state}

    def one_step():
        holder["state"], _ = rekeyed.step_fn(holder["state"], tokens,
                                              counter=who.reserve_round(W))
        who.seen = None
    busy = say_profile("train step", one_step)
    if busy > 0:
        say(f"phase 6 train step idle share ({smi}): device busy {busy:.2f} ms of the "
            f"unprofiled step {TS_STEPS}'s {step_ms:.1f} ms wall: idle {1 - busy / step_ms:.0%}")
    # the peak of a step whose aggregator is not watched (the watcher keeps
    # the gradient matrix alive through the optimizer), part by part: the
    # allocator's peak since the last mark (host-side counters, no sync);
    # the key set's last range
    plain = make_train_step(model, who.agg, lr=TS_LR)
    peaks = {}

    def peak_mark(name):
        peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    sync()
    torch.cuda.reset_peak_memory_stats()
    holder["state"], _ = plain.step_fn(holder["state"], tokens, counter=who.reserve_round(W),
                                       mark=peak_mark)
    sync()
    say(f"phase 6 train step peak memory ({smi}): {max(peaks.values()) / 1e9:.2f} GB in a step "
        f"with its aggregator unwatched ({peak / 1e9:.2f} GB watched); peak by part: "
        + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in peaks.items()))
    del holder, state, model, bundle, rekeyed, plain, agg, who, tokens
    torch.cuda.empty_cache()
    safe_vs_insec(dev, cfg)


def safe_vs_insec(dev, cfg):
    """A SAFE step and an INSEC step from one state, at TS_CMP_LAYERS
    layers (full width): the same loss, published gradients within the
    fixed-point bound, parameters within the first AdamW step's 2·lr of
    each other, and the next forward's losses within 5e-3
    (tests/test_train.py's bound)."""
    import dataclasses

    from repro_torch.core import make_aggregator
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(cfg, n_layers=TS_CMP_LAYERS)
    model, safe, _, tokens = train_step_setup(dev, cfg)
    insec = WatchedAggregator(make_aggregator("insec", TS_N, device=dev))
    bs = make_train_step(model, safe, lr=TS_LR, donate=False)
    bi = make_train_step(model, insec, lr=TS_LR, donate=False)
    state = bs.init_state_fn(model.tree())
    W = bs.padded_size + 2
    s_safe, m_safe = bs.step_fn(state, tokens, counter=safe.reserve_round(W))
    s_insec, m_insec = bi.step_fn(state, tokens, counter=insec.reserve_round(W))
    gerr = float((safe.seen["out"] - insec.seen["out"]).abs().max())
    dtheta = (s_safe["master"] - s_insec["master"]).abs()
    dmax, moved = float(dtheta.max()), float((dtheta > 0).float().mean())
    l_safe, l_insec = float(m_safe["loss"]), float(m_insec["loss"])
    safe.seen = insec.seen = None
    _, n_safe = bs.step_fn(s_safe, tokens, counter=safe.reserve_round(W))
    _, n_insec = bi.step_fn(s_insec, tokens, counter=insec.reserve_round(W))
    nxt = abs(float(n_safe["loss"]) - float(n_insec["loss"]))
    bound = 2 * TS_LR + 1e-6
    if abs(l_safe - l_insec) > 1e-6 * abs(l_insec) or gerr > STEP or dmax > bound or nxt > 5e-3:
        fail(f"train step SAFE vs INSEC: loss {l_safe} vs {l_insec}, published gradients "
             f"{gerr} apart (bound {STEP}), parameters {dmax} apart (bound {bound}), next "
             f"losses {nxt} apart (bound 5e-3)")
    say(f"phase 5 train step SAFE vs INSEC at {TS_CMP_LAYERS} layers (full width), one step "
        f"from one state: loss {l_safe:.6f} and {l_insec:.6f}; published gradients max "
        f"|diff| {gerr:.3e} <= {STEP:.3e}; parameters max |diff| {dmax:.3e} <= 2 lr "
        f"({moved:.3%} of {bs.padded_size} words differ); next losses {nxt:.2e} apart "
        f"(<= 5e-3)")
    del model, state, s_safe, s_insec, tokens
    torch.cuda.empty_cache()


# ---- the rest of the zoo through the train step: phases 4, 5 and 6 -----------------

def leaf_samples(params, dev):
    """(path, word indices, initial values) of up to 4096 words of every
    leaf, to tell afterwards whether a step moved the leaf."""
    from repro_torch.train.flatten import leaves_with_paths
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = []
    for path, leaf in leaves_with_paths(params):
        n = leaf.numel()
        idx = torch.randint(0, n, (min(n, 4096),), generator=g, device=dev)
        out.append((path, idx, leaf.detach().reshape(-1)[idx].float().clone()))
    return out


def unmoved_leaves(state, samples):
    """Paths of the leaves none of whose sampled words moved: a SAFE-partition
    leaf's words read from the f32 master vector (a bf16 leaf can round a
    step's change away), an expert leaf's from the leaf itself."""
    from repro_torch.train.flatten import is_expert_path, leaves_with_paths
    now = dict(leaves_with_paths(state["params"]))
    out, off = [], 0
    for path, idx, before in samples:
        leaf = now[path]
        if is_expert_path(path):
            after = leaf.detach().reshape(-1)[idx].float()
        else:
            after = state["master"][off + idx]
            off += leaf.numel()
        if torch.equal(after, before):
            out.append(path)
    return out


def zoo_path(dev, name, launches, err, smi):
    """Phases 4-6 of one of ZOO_PATHS: the train step of its configuration at
    full width, as the internlm2 train-step path runs it; adds its launches
    to ``launches`` and its full-length kernel checks to ``err``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import chain_combine as cc
    from repro_torch.kernels import threefry_mask_add as tma
    from repro_torch.train import tree_size
    from repro_torch.train.flatten import is_expert_path, leaves_with_paths

    arch, cut = ZOO_PATHS[name]
    cfg = dataclasses.replace(get_config(arch), **cut)
    t0 = time.perf_counter()
    model, agg, bundle, tokens = train_step_setup(dev, cfg)
    state = bundle.init_state_fn(model.tree())
    samples = leaf_samples(state["params"], dev)
    P = tree_size(state["params"])
    ep_words = sum(t.numel() for p, t in leaves_with_paths(state["params"]) if is_expert_path(p))
    sync()
    setup_s = time.perf_counter() - t0
    marks, done = StepMarks(), torch.cuda.Event(enable_timing=True)
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state, losses, scales, walls, parts, checks, counters = run_steps(
        f"{name} train step ", bundle, agg, state, tokens, ZOO_STEPS, marks, done)
    counts = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    reduced = ", ".join(f"{k} {getattr(get_config(arch), k)} -> {v}" for k, v in cut.items()
                        if k in ("n_layers", "vocab"))
    say(f"phase 4 main path {name} train step: {sum(walls) / 1e3:.2f} s for {ZOO_STEPS} steps "
        f"of step_fn; {arch} at full width (d_model {cfg.d_model}), reduced: {reduced}; "
        f"{P} parameters, sec_size {bundle.sec_size}, padded_size {bundle.padded_size}, "
        f"expert words {ep_words}, n={TS_N}, tokens [{TS_B}, {TS_S}] a learner, counters "
        f"{counters}; setup {setup_s:.1f} s; peak memory {peak / 1e9:.2f} GB; loss "
        f"{[round(x, 4) for x in losses]}; launches {counts}")
    missing = sorted(k for k in PATH_KERNELS[name] if counts[k] <= 0)
    if missing:
        fail(f"path {name} never launched {missing}: {counts}")
    for k, c in counts.items():
        launches[k] += c

    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"{name} train step: the loss did not fall over {ZOO_STEPS} steps: {losses}")
    say(f"phase 5 {name} train step: loss step 1 {losses[0]:.4f} > step {ZOO_STEPS} "
        f"{losses[-1]:.4f}; grad_scale {[round(x, 5) for x in scales]}")
    for line in checks:
        say(f"phase 5 {line}")
    last = counters[-1]
    check_cpu_path(f"step {ZOO_STEPS}", agg, np.ones(TS_N, np.float32), None, last,
                   rotate=last % (2 * TS_N + 1), path=f"{name} train step")
    # a leaf whose gradient is zero by construction stays where it is: the
    # shared block's placeholder, and the unused ln2 of recurrent blocks
    # without an MLP (zamba2)
    exempt = [p for p, _, _ in samples if p.endswith("_shared") or (
        not cfg.recurrent_mlp and p.endswith("ln2/scale") and not p.startswith("shared_attn"))]
    unmoved = [p for p in unmoved_leaves(state, samples) if p not in exempt]
    if unmoved:
        fail(f"{name} train step: leaves unchanged after {ZOO_STEPS} steps: {unmoved}")
    experts = [p for p, _, _ in samples if is_expert_path(p)]
    say(f"phase 5 {name} train step: card == CPU path on [{TS_N}, {V_CPU}]; all "
        f"{len(samples) - len(exempt)} leaves moved ({len(experts)} expert leaves among them"
        f"{': ' + ', '.join(experts) if experts else ''}); unmoved by construction: "
        f"{exempt or 'none'}")
    say(f"phase 5 {name} train step {check_full_length(agg, None, last, err)}")
    torch.cuda.empty_cache()

    # phase 6: the last step split by its own CUDA events
    V, S_ = bundle.padded_size, bundle.sec_size
    step_ms, dev_ms = walls[-1], sum(parts.values())
    fb, flat, agg_ms = parts["forward_backward"], parts["flatten"], parts["aggregate"]
    opt_ms, ep_ms = parts["optimizer"], parts.get("expert_optimizer", 0.0)
    agg_bound = (3 * 8 + 3 * 12) * V / HBM_BYTES_PER_S * 1e3
    opt_bound = 7 * 4 * V / HBM_BYTES_PER_S * 1e3
    # the experts: read the f32 gradient sum, m, v and the bf16 parameter,
    # write m, v and the parameter
    ep_bound = (4 + 4 + 4 + 2 + 4 + 4 + 2) * ep_words / HBM_BYTES_PER_S * 1e3
    tokens_per_step = TS_N * TS_B * TS_S
    say(f"phase 6 {name} train step {ZOO_STEPS} ({smi}): {step_ms:.1f} ms wall, {dev_ms:.1f} "
        f"ms from its CUDA events = learners' forward and backward {fb:.1f} + flatten and "
        f"pad{' and the expert sum' if ep_words else ''} {flat:.2f} + SAFE aggregation "
        f"{agg_ms:.2f} + FlatAdamW {opt_ms:.2f}"
        f"{f' + expert AdamW {ep_ms:.2f}' if ep_words else ''} + rebuild "
        f"{parts['rebuild']:.2f} + metrics {parts['metrics']:.2f} ms; SAFE share "
        f"{agg_ms / dev_ms:.2%}; {tokens_per_step / step_ms * 1e3:.0f} tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    x = torch.rand(V, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    cipher = tma.mask_add(x, [1, 2], 0)
    ma = cuda_ms(lambda: tma.mask_add(x, [5, 6], 0), iters=5, warmup=1)
    ch = cuda_ms(lambda: cc.chain_combine(cipher, x, [3, 4], [5, 6], 0), iters=5, warmup=1)
    del x, cipher
    # at every V both kernels' operations bound is below their bytes bound
    # (49% and 64% of it; phase 6's kernel lines print the two): bytes bound them
    ma_bound = 8 * V / HBM_BYTES_PER_S * 1e3
    ch_bound = 12 * V / HBM_BYTES_PER_S * 1e3
    say(f"phase 6 {name} train step bounds ({smi}): SAFE aggregation {agg_ms:.2f} ms against "
        f"{agg_bound:.2f} ms for its 6 kernels' bytes ({agg_bound / agg_ms:.0%}); kernels at "
        f"V = {V}: mask_add {ma:.3f} ms against {ma_bound:.3f} ({ma_bound / ma:.0%}), "
        f"chain_combine {ch:.3f} ms against {ch_bound:.3f} ({ch_bound / ch:.0%}); FlatAdamW "
        f"{opt_ms:.2f} ms against {opt_bound:.2f} ms on {V} words"
        + (f"; expert AdamW {ep_ms:.2f} ms against {ep_bound:.2f} ms on {ep_words} words "
           f"({ep_bound / ep_ms:.0%})" if ep_words else "")
        + f"; forward and backward {fb / TS_N:.1f} ms a learner, {S_} SAFE words")
    if ep_words:
        routed = TS_B * TS_S * cfg.moe.top_k / cfg.moe.num_experts
        say(f"phase 6 {name} train step: about {routed:.0f} routed tokens an expert a learner "
            f"(top-{cfg.moe.top_k} of {cfg.moe.num_experts} over {TS_B * TS_S} tokens), far "
            f"below a deployment's batch")
    holder = {"state": state}

    def one_step():
        holder["state"], _ = bundle.step_fn(holder["state"], tokens,
                                             counter=agg.reserve_round(bundle.padded_size + 2))
        agg.seen = None
    busy = say_profile(f"{name} train step", one_step)
    if busy > 0:
        say(f"phase 6 {name} train step idle share ({smi}): device busy {busy:.2f} ms of the "
            f"unprofiled step {ZOO_STEPS}'s {step_ms:.1f} ms wall: idle {1 - busy / step_ms:.0%}")
    del holder, state, model, bundle, agg, tokens, samples
    torch.cuda.empty_cache()


def flat_adamw_check(dev):
    """Phase 5: FlatAdamW on the card against its CPU path (which equals the
    JAX package's word for word), three steps on 2^20 random words whose
    gradients span 1e-6 to 10, some exactly zero."""
    from repro_torch.optim import FlatAdamW
    rng = np.random.RandomState(SEED)
    n = 1 << 20
    param = rng.standard_normal(n).astype(np.float32)
    opt = FlatAdamW(lr=TS_LR, weight_decay=0.1)
    cs, cp = opt.init(n, device="cpu"), torch.from_numpy(param.copy())
    gs, gp = opt.init(n, device=dev), torch.from_numpy(param).to(dev)
    worst = 0
    for i in range(3):
        g = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 1, n)).astype(np.float32)
        if i == 1:
            g[:100] = 0.0
        cp, cs = opt.update(torch.from_numpy(g), cs, cp)
        gp, gs = opt.update(torch.from_numpy(g).to(dev), gs, gp, inplace=True)
        for a, b in ((gp, cp), (gs.m, cs.m), (gs.v, cs.v)):
            ulps = (a.cpu().view(torch.int32).long() - b.view(torch.int32).long()).abs()
            worst = max(worst, int(ulps.max()))
    if worst:
        fail(f"FlatAdamW on the card differs from the CPU path by {worst} ulps")
    say(f"phase 5 FlatAdamW: the card (in place) == the CPU path word for word on {n} words, "
        f"3 steps: parameters, m and v, max 0 ulps")


def wire_fedavg_path(dev, smi):
    """The wire FedAvg path: ``make_wire_federated``'s callables run their
    local steps on the card; ``net.run_federated_round_net`` ships their
    deltas through the port's broker on 127.0.0.1 (host numpy masking, as
    the paper's learners); one clean round and one with node 3 failed. Each
    published delta must equal the in-process ``round_fn``'s on the card,
    bit for bit, at the same counter, weights and alive bitmap."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_aggregator
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    from repro_torch.net import SafeBroker, run_federated_round_net
    from repro_torch.train import make_federated_round, make_wire_federated, tree_to_flat

    cfg = get_smoke_config(WIRE_FED_ARCH)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    stream = make_federated_batches(cfg, FED_N, FED_B, FED_S, seed=SEED)
    toks = np.stack([np.stack([stream.learner_batch(l, k)["tokens"] for k in range(WIRE_FED_K)])
                     for l in range(FED_N)])
    weights = stream.global_batch(0)["weights"]
    agg = make_aggregator("safe", FED_N, weighted=True, device=dev)
    bundle = make_federated_round(model, agg, local_steps=WIRE_FED_K, local_lr=FED_LR,
                                  return_delta=True)
    wf = make_wire_federated(model, {l + 1: toks[l] for l in range(FED_N)},
                             local_steps=WIRE_FED_K, local_lr=FED_LR)
    spent = {}

    def timed(node, fn):
        def run(params):
            t0 = time.perf_counter()
            out = fn(params)
            spent[node] = (time.perf_counter() - t0) * 1e3
            return out
        return run
    local_fns = {node: timed(node, fn) for node, fn in wf.local_fns.items()}
    params = model.tree()
    W = wf.words_per_round(weighted=True)
    for name, failed in (("clean", ()), ("node 3 failed", (3,))):
        alive = np.array([0.0 if l + 1 in failed else 1.0 for l in range(FED_N)], np.float32)
        counter = agg.reserve_round(W)
        new, m = bundle.round_fn(params, torch.from_numpy(toks).to(dev), weights=weights,
                                 counter=counter, alive=alive)
        want = m["avg_delta"].cpu().numpy()
        spent.clear()

        async def go():
            broker = SafeBroker(progress_timeout=0.4, monitor_interval=0.1)
            addr = await broker.start()
            try:
                t0 = time.perf_counter()
                out = await asyncio.wait_for(run_federated_round_net(
                    params, local_fns, wf.apply_fn, addr, weights=weights, counter=counter,
                    failed_nodes=failed), WIRE_WAIT_S)
                return out, (time.perf_counter() - t0) * 1e3
            finally:
                await broker.stop()
        (got, res), wall = asyncio.run(go())
        sync()
        if res.average is None or not np.array_equal(res.average.view(np.uint32),
                                                     want.view(np.uint32)):
            fail(f"wire fedavg {name}: the published delta differs from round_fn's")
        if not torch.equal(tree_to_flat(got), tree_to_flat(new)):
            fail(f"wire fedavg {name}: the applied parameters differ from round_fn's")
        local_ms = sum(spent.values())
        say(f"phase 5 wire fedavg {name}: published delta ({W - 1} words) == round_fn's on the "
            f"card, bit for bit, and so are the applied parameters; counter {counter}; losses "
            + ", ".join(f"node {k} {v:.4f}" for k, v in sorted(wf.last_losses.items())
                        if k in spent))
        say(f"phase 6 wire fedavg {name} ({smi}): {wall:.1f} ms wall = local steps "
            f"{local_ms:.1f} ms ({len(spent)} learners one after another, {WIRE_FED_K} steps "
            f"each, on the card) + the wire round {wall - local_ms:.1f} ms (host numpy masking, "
            f"127.0.0.1)")
    del model, bundle, params
    torch.cuda.empty_cache()


# ---- the launcher and the load harness, on the card ----------------------------------

def launcher_paths(smi):
    """``python -m repro_torch.launch.train`` at the smoke size on the card,
    as subprocesses: two uninterrupted runs of LAUNCH_STEPS steps, a run
    of half as many resumed from its checkpoint, and a FedAvg run. Reports
    how far the resumed run's final state is from an uninterrupted run's
    beside how far the two uninterrupted runs are from each other."""
    import tempfile

    from repro_torch.ckpt import latest_step, restore_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_aggregator
    from repro_torch.models import Model
    from repro_torch.train import make_train_step

    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TS_ARCH, "--smoke",
            "--learners", str(TS_N)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    half = str(LAUNCH_STEPS // 2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        def launch(name, *extra):
            return subprocess.Popen(base + ["--metrics", f"{tmp}/{name}.jsonl", *extra],
                                    env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)

        def finish(procs):
            out = {}
            for name, p in procs.items():
                try:
                    stdout, stderr = p.communicate(timeout=LAUNCH_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.communicate()
                    fail(f"launcher {name}: no end within {LAUNCH_TIMEOUT_S} s")
                if p.returncode != 0:
                    fail(f"launcher {name}: exit {p.returncode}: {stderr[-2000:]}")
                out[name] = stdout.splitlines()
            return out

        def losses(name, key):
            with open(f"{tmp}/{name}.jsonl") as f:
                return [json.loads(line)[key] for line in f if line.strip()]

        steps = str(LAUNCH_STEPS)
        t0 = time.perf_counter()
        out = finish({
            "whole_a": launch("whole_a", "--steps", steps, "--ckpt-dir", f"{tmp}/a",
                              "--ckpt-every", steps),
            "whole_b": launch("whole_b", "--steps", steps, "--ckpt-dir", f"{tmp}/b",
                              "--ckpt-every", steps),
            "half": launch("half", "--steps", half, "--ckpt-dir", f"{tmp}/r",
                           "--ckpt-every", half)})
        out.update(finish({
            "resumed": launch("resumed", "--steps", steps, "--ckpt-dir", f"{tmp}/r",
                              "--ckpt-every", half),
            "federated": launch("federated", "--steps", steps, "--federated")}))
        wall = time.perf_counter() - t0
        for name, lines in out.items():
            if "model axis is 1 on one card" not in lines[0] or "on cuda" not in lines[0]:
                fail(f"launcher {name}: first line {lines[0]!r}")
        if f"resumed from step {half}" not in out["resumed"]:
            fail(f"launcher resumed: did not resume: {out['resumed']}")
        run_losses = {k: losses(k, "loss") for k in ("whole_a", "whole_b", "half", "resumed")}
        fed = losses("federated", "local_loss")
        joined = run_losses["half"] + run_losses["resumed"]
        # each step and round trains on the stream's next batch, so only the
        # train step's losses (lr 1e-3 from random weights) must fall
        for name, ls in (("whole_a", run_losses["whole_a"]), ("whole_b", run_losses["whole_b"]),
                         ("resumed", joined), ("federated", fed)):
            if len(ls) != LAUNCH_STEPS or not np.isfinite(ls).all() or (
                    name != "federated" and not ls[-1] < ls[0]):
                fail(f"launcher {name}: losses {ls}")

        cfg = get_smoke_config(TS_ARCH)
        model = Model(cfg, device="cpu")
        skel = make_train_step(model, make_aggregator("safe", TS_N, device="cpu")
                               ).init_state_fn(model.tree())
        final = {}
        for name in ("a", "b", "r"):
            d = f"{tmp}/{name}"
            if latest_step(d) != LAUNCH_STEPS:
                fail(f"launcher: no checkpoint at step {LAUNCH_STEPS} in run {name}")
            final[name], _ = restore_checkpoint(d, LAUNCH_STEPS, skel)

    def apart(x, y):
        a, b = x["master"], y["master"]
        return float((a - b).abs().max()), int((a != b).sum())

    ra, ab = apart(final["r"], final["a"]), apart(final["a"], final["b"])
    la = max(abs(x - y) for x, y in zip(joined, run_losses["whole_a"]))
    lb = max(abs(x - y) for x, y in zip(run_losses["whole_b"], run_losses["whole_a"]))
    say(f"phase 4 launcher ({smi}): 5 runs of repro_torch.launch.train --smoke on the card "
        f"in {wall:.1f} s; train-step losses {[round(x, 4) for x in run_losses['whole_a']]}, "
        f"federated {[round(x, 4) for x in fed]}")
    say(f"phase 5 launcher: resumed ({half} + {half} steps) against uninterrupted: losses "
        f"max |diff| {la:.3e}, final master vector max |diff| {ra[0]:.3e} on {ra[1]} words; "
        f"two uninterrupted runs: losses {lb:.3e}, master {ab[0]:.3e} on {ab[1]} words "
        f"(of {final['a']['master'].numel()})")


def run_example(name, device):
    """``repro_torch.examples.<name>.main`` at the SAFE_SMOKE size on
    ``device``: (its output lines, seconds to a synchronise)."""
    import importlib
    import io
    main = importlib.import_module(f"repro_torch.examples.{name}").main
    before = os.environ.get("SAFE_SMOKE")
    os.environ["SAFE_SMOKE"] = "1"
    buf = io.StringIO()
    try:
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(["--device", device])
        sync()
        secs = time.perf_counter() - t0
    finally:
        if before is None:
            del os.environ["SAFE_SMOKE"]
        else:
            os.environ["SAFE_SMOKE"] = before
    return buf.getvalue().splitlines(), secs


def examples_path(dev, launches, smi):
    """The port's five examples, each through its ``main`` in this process on
    the card at the SAFE_SMOKE size, their output checked: the quickstart's
    loss falls, the failover demo's device rounds equal its simulation's,
    every wire FedAvg round publishes, the requests are served, and the
    kernel demo's chain is within the fixed-point resolution; the failover
    and kernel demos print the same lines with ``--device cpu`` (their
    plain kernels). Adds the examples' launches to ``launches``."""
    from repro_torch.kernels import build
    build.reset_launches()
    out, secs = {}, {}
    for name in EXAMPLES:
        out[name], secs[name] = run_example(name, "cuda")
    counts = dict(build.launches)
    for name in EXAMPLES:
        for line in out[name]:
            say(f"  example {name}: {line}")
    say(f"phase 4 main path examples (python -m repro_torch.examples.<name>, SAFE_SMOKE=1, "
        f"main() in this process on the card): launches {counts}")
    missing = sorted(k for k in PATH_KERNELS["examples"] if counts[k] <= 0)
    if missing:
        fail(f"path examples never launched {missing}: {counts}")
    for k, c in counts.items():
        launches[k] += c

    first = float(out["quickstart"][0].split("loss=")[1].split()[0])
    final = float(out["quickstart"][-1].split("final loss:")[1])
    if not (math.isfinite(final) and final < first):
        fail(f"example quickstart: the loss went from {first} to {final}")
    plane = out["failover_demo"][out["failover_demo"].index(
        "=== the same rounds on the device data plane (cuda) ==="):]
    if len(plane) != 5 or not all(line.endswith(": True") for line in plane[1:]):
        fail(f"example failover_demo: the device rounds differ from the simulation: {plane}")
    rounds = [line for line in out["federated_training"] if line.startswith("round")]
    if len(rounds) != 3 or "org 3 DOWN" not in rounds[-1]:
        fail(f"example federated_training: {rounds}")
    if not out["serving"] or not out["serving"][-1].startswith("served 3 requests"):
        fail(f"example serving: {out['serving']}")
    for name in EXAMPLES_ON_CPU:
        lines = run_example(name, "cpu")[0]
        card = [line.replace("(cuda)", "(cpu)") for line in out[name]]
        if lines != card:
            fail(f"example {name}: the card's lines differ from the CPU's:\n{card}\n{lines}")
    say(f"phase 5 examples: the quickstart's loss {first:.4f} -> {final:.4f}; the failover "
        f"demo's four device rounds bit for bit its simulation's; 3 wire FedAvg rounds, the "
        f"last with org 3 down; {out['kernels_demo'][-1]}; {list(EXAMPLES_ON_CPU)} print the "
        f"same lines on the CPU")
    say(f"phase 6 examples ({smi}): seconds by example on the card "
        f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}")


def engine_load_path(dev, launches, smi):
    """``net.run_engine_load`` against the port's broker in front of an
    ``AggregationEngine`` on the card, at the engine path's shape (n = 36,
    V = 2^20, chunked uploads and downloads); every session's answer
    bit-identical to a single round on the card."""
    from repro_torch.core import make_aggregator
    from repro_torch.kernels import build
    from repro_torch.net import SafeBroker, run_engine_load
    from repro_torch.serve import AggregationEngine

    sessions = []

    class Recording(AggregationEngine):  # the broker owns the completion hook
        def submit(self, values, **kw):
            sessions.append(super().submit(values, **kw))
            return sessions[-1]

    engine = Recording(make_aggregator("safe", N).cfg, slots=S_ENGINE, payload_words=V_ENGINE)

    async def go():
        broker = SafeBroker(engine=engine)
        addr = await broker.start()
        try:
            rep = await run_engine_load(addr, tenants=LOAD_TENANTS, rounds_per_tenant=LOAD_ROUNDS,
                                        n=N, V=V_ENGINE, seed=SEED, timeout=WIRE_WAIT_S,
                                        chunk_words=WIRE_CHUNK)
            return rep, broker.engine_errors
        finally:
            await broker.stop()

    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    rep, errors = asyncio.run(go())
    wall = time.perf_counter() - t0
    counts = dict(build.launches)
    say(f"phase 4 main path engine load: {wall:.2f} s; launches {counts}")
    missing = sorted(k for k in PATH_KERNELS["engine_load"] if counts[k] <= 0)
    if missing:
        fail(f"path engine load never launched {missing}: {counts}")
    for k, c in counts.items():
        launches[k] += c
    if errors:
        fail(f"engine load: {errors} engine steps raised")
    if rep.rounds != LOAD_TENANTS * LOAD_ROUNDS or len(sessions) != rep.rounds + 1:
        fail(f"engine load: {rep.rounds} rounds, {len(sessions)} sessions")
    for sess in sessions:
        want = make_aggregator("safe", N, provisioning_seed=sess.provisioning_seed,
                               learner_master=sess.learner_master).aggregate(
            sess.values, 0, rotate=sess.rotate0)
        if not torch.equal(sess.results[0], want):
            fail(f"engine load session {sess.sid} differs from a single round")
    say(f"phase 5 engine load: {len(sessions)} sessions (the warm-up's too) bit-identical to "
        f"single rounds on the card; every tenant's check inside run_engine_load passed")
    say(f"phase 6 engine load ({smi}): LoadReport {json.dumps(rep.row())}")
    del engine, sessions
    torch.cuda.empty_cache()


# ---- the serving path: phases 4, 5 and 6 -----------------------------------------

def serve_requests(cfg, name):
    from repro_torch.serve import Request
    n, _, _, max_new, seed, lo, hi = SERVE_TRAFFIC[name]
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        plen = int(rng.randint(lo, hi))
        out.append(Request(rid=i, prompt=rng.randint(0, cfg.vocab, plen).astype(np.int32),
                           max_new=max_new))
    return out


def serve_traffic(model, params, name):
    """One traffic through ``ServeEngine`` on the card, each prefill and
    decode step timed (a synchronise after each: the engine's argmax waits
    for the card there anyway). Returns the engine, its requests and the
    readings."""
    from repro_torch.serve import ServeEngine
    _, slots, max_seq, _, _, _, _ = SERVE_TRAFFIC[name]
    reqs = serve_requests(model.cfg, name)
    eng = ServeEngine(model, params, batch_slots=slots, max_seq=max_seq)
    prefill_ms, decode_ms, finite = [], [], []
    prefill, decode = model.prefill, model.decode_step

    def timed(fn, into):
        def call(*a, **kw):
            sync()
            t = time.perf_counter()
            logits, cache = fn(*a, **kw)
            sync()
            into.append((time.perf_counter() - t) * 1e3)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return call

    model.prefill, model.decode_step = timed(prefill, prefill_ms), timed(decode, decode_ms)
    try:
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        sync()
        wall = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step
    return eng, reqs, dict(wall=wall, prefill_ms=prefill_ms, decode_ms=decode_ms,
                           finite=bool(torch.stack(finite).all()),
                           peak=torch.cuda.max_memory_allocated())


def serve_gate_full_width(model, params, reqs):
    """Prefill then teacher-forced decode against ``Model.apply``'s full
    forward, on the first SERVE_GATE_REQUESTS prompts of traffic B with
    SERVE_GATE_STEPS further tokens: the worst |error| / max |logit|."""
    rng = np.random.RandomState(SEED + 7)
    dev = model.embed.device
    worst = 0.0
    with torch.inference_mode():
        for r in reqs[:SERVE_GATE_REQUESTS]:
            Sp = len(r.prompt)
            extra = rng.randint(0, model.cfg.vocab, SERVE_GATE_STEPS)
            toks = torch.as_tensor(np.concatenate([r.prompt, extra])[None], device=dev)
            full = model.apply(params, toks)[0][0]  # [S, vocab] f32
            cache = model.init_cache(1, Sp + SERVE_GATE_STEPS, prefilled=False)
            logits, cache = model.prefill(params, toks[:, :Sp], cache=cache)
            errs = [(logits[0] - full[Sp - 1]).abs().max()]
            for t in range(SERVE_GATE_STEPS):
                logits, cache = model.decode_step(params, toks[:, Sp + t], cache)
                errs.append((logits[0] - full[Sp + t]).abs().max())
            worst = max(worst, float(torch.stack(errs).max() / full.abs().max()))
            del full, cache
    return worst


def serve_gate_smoke(dev):
    """Each smoke configuration, prefill of 8 tokens then decode to 16 on the
    card: bf16 against its own full forward (the reference's bound), and f32
    against the port's CPU path. Returns {arch: (bf16 rel, f32 card vs CPU
    rel)}."""
    import dataclasses

    from repro_torch.configs import ALIASES, get_smoke_config
    from repro_torch.models import Model

    def run(m, toks, prefix):
        P = m.cfg.prefix_embeds
        full = m(toks, prefix)[0]
        logits, cache = m.prefill(m.tree(), toks[:, :8], prefix,
                                  cache=m.init_cache(2, P + 16, prefilled=False))
        rows = [logits]
        for t in range(8, 16):
            logits, cache = m.decode_step(m.tree(), toks[:, t], cache)
            rows.append(logits)
        return full[:, P + 7:P + 16], torch.stack(rows, 1)

    out = {}
    with torch.inference_mode():
        for arch in sorted(ALIASES):
            cfg = get_smoke_config(arch)
            shape = (2, 16, cfg.num_codebooks) if cfg.num_codebooks > 1 else (2, 16)
            rng = np.random.RandomState(SEED)
            toks = torch.as_tensor(rng.randint(0, cfg.vocab, shape))
            prefix = (torch.as_tensor(rng.randn(2, cfg.prefix_embeds, cfg.d_model)
                                      .astype(np.float32)) if cfg.prefix_embeds else None)
            move = lambda t, d: None if t is None else t.to(d)  # noqa: E731
            full, dec = run(Model(cfg, device=dev), toks.to(dev), move(prefix, dev))
            bf16 = float((dec - full).abs().max() / full.abs().max())
            f32 = dataclasses.replace(cfg, dtype="float32")
            cpu = Model(f32, device="cpu", generator=torch.Generator().manual_seed(SEED))
            card = Model(f32, device=dev)
            card.load_state_dict(cpu.state_dict())
            _, want = run(cpu, toks, prefix)
            _, got = run(card, toks.to(dev), move(prefix, dev))
            out[arch] = (bf16, float((got.cpu() - want).abs().max() / want.abs().max()))
    return out


def serve_config():
    """The serving paths' configuration: SERVE_ARCH at SERVE_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)


def serve_paths(dev, launches, smi):
    """Phases 4-6 of serving: SERVE_ARCH at full width and SERVE_LAYERS through
    ``ServeEngine`` with traffics A and B, and the serving launcher as a
    subprocess; the consistency gates; the timings."""
    import re

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine, make_serve_step

    cfg = serve_config()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)  # random weights from seed 0
    params = model.tree()
    weight_bytes = sum(t.numel() * t.element_size() for t in model.parameters())
    n_params = sum(t.numel() for t in model.parameters())
    torch.cuda.empty_cache()
    say(f"phase 4 serve setup: {SERVE_ARCH} at full width, {cfg.n_layers} layers, "
        f"{n_params} parameters ({weight_bytes / 1e9:.2f} GB {cfg.dtype}), "
        f"{time.perf_counter() - t0:.1f} s")

    # a warm-up request (the card's first products load their libraries)
    warm = ServeEngine(model, params, batch_slots=1, max_seq=64)
    warm.submit(serve_requests(cfg, "A")[0])
    warm.run_until_done()
    del warm

    sync()
    build.reset_launches()
    runs = {}
    for name in SERVE_TRAFFIC:
        eng, reqs, rd = serve_traffic(model, params, name)
        runs[name] = (eng, reqs, rd)
        n, slots, max_seq, max_new, _, lo, hi = SERVE_TRAFFIC[name]
        say(f"phase 4 main path serve {name}: {n} requests (prompts {lo}-{hi - 1} tokens) "
            f"through {slots} slots of {max_seq}, max_new {max_new}, greedy: {rd['wall']:.2f} s, "
            f"{eng.steps} decode steps, {len(rd['prefill_ms'])} prefills")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           SERVE_ARCH], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=SERVE_LAUNCH_TIMEOUT_S)
    sync()
    counts = dict(build.launches)
    if proc.returncode != 0:
        fail(f"serve launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    if not re.fullmatch(r"served 8 requests / 256 tokens in [0-9.]+s \([0-9.]+ tok/s, \d+ "
                        r"decode steps, batch efficiency [0-9.]+\)", line):
        fail(f"serve launcher printed {line!r}")
    say(f"phase 4 main path serve launcher (python -m repro_torch.launch.serve --arch "
        f"{SERVE_ARCH}, the smoke config, on the card): {line}")
    say(f"phase 4 main path serve: launches {counts} (no SAFE kernel is on the serving path; "
        f"the reference's prefill and decode are jnp, no Pallas call)")
    if any(counts.values()):
        fail(f"the serving path launched SAFE kernels: {counts}")
    for k, c in counts.items():
        launches[k] += c

    # phase 5: the answers
    for name, (eng, reqs, rd) in runs.items():
        short = [r.rid for r in reqs if len(r.generated) != r.max_new or not r.done]
        if short or not rd["finite"] or eng.queue or any(eng.slot_req):
            fail(f"serve {name}: requests {short} short of max_new, finite {rd['finite']}")
    say(f"phase 5 serve sanity: every request of traffics {list(runs)} returned max_new "
        f"tokens; every prefill and decode logit finite")
    worst = serve_gate_full_width(model, params, runs["B"][1])
    say(f"phase 5 serve full width: prefill then {SERVE_GATE_STEPS} teacher-forced decode "
        f"steps of traffic B's first {SERVE_GATE_REQUESTS} prompts against Model.apply's full "
        f"forward: max |error| {worst:.3e} of max |logit| (bound {SERVE_TOL})")
    if not worst <= SERVE_TOL:
        fail(f"serve full width: {worst} > {SERVE_TOL}")
    smoke = serve_gate_smoke(dev)
    say(f"phase 5 serve smoke configs: prefill then decode, bf16 against the full forward "
        f"(bound {SERVE_TOL}) and f32 card against CPU (bound {SERVE_CARD_TOL}), of max "
        f"|logit|: " + ", ".join(f"{a} {b:.2e} / {c:.2e}" for a, (b, c) in smoke.items()))
    bad = {a: v for a, v in smoke.items() if not (v[0] <= SERVE_TOL and v[1] <= SERVE_CARD_TOL)}
    if bad:
        fail(f"serve smoke configs out of bounds: {bad}")

    # phase 6: the timings
    step = make_serve_step(model)
    for name, (eng, reqs, rd) in runs.items():
        n, slots, max_seq, max_new, _, _, _ = SERVE_TRAFFIC[name]
        pre, dec = np.array(rd["prefill_ms"]), np.array(rd["decode_ms"])
        cache_bytes = sum(v.numel() * v.element_size() for c in eng.cache
                          for k, v in c.items() if k in ("k", "v"))
        out_bytes = slots * cfg.vocab * 4
        bound = (weight_bytes + cache_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        decode_tokens = n * (max_new - 1)  # the first token of each comes from its prefill
        say(f"phase 6 serve {name} ({smi}): time to first token (prefill ms a request once "
            f"admitted) median {np.median(pre):.2f}, max {pre.max():.2f}; decode step "
            f"{dec.mean():.2f} ms mean, {np.median(dec):.2f} median over {len(dec)} steps, "
            f"against its bytes bound {bound:.3f} ms (weights {weight_bytes / 1e9:.3f} GB + KV "
            f"cache {cache_bytes / 1e9:.3f} GB read at 3.35 TB/s: {bound / dec.mean():.1%}); "
            f"decode {decode_tokens / dec.sum() * 1e3:.1f} tokens/s; "
            f"{n * max_new / rd['wall']:.1f} tokens/s and {n / rd['wall']:.3f} requests/s "
            f"end to end; peak memory {rd['peak'] / 1e9:.2f} GB")
        holder = {"cache": eng.cache}
        toks = torch.zeros(slots, dtype=torch.int32, device=dev)

        def decode_steps():
            for _ in range(SERVE_PROFILE_STEPS):
                logits, holder["cache"] = step(params, toks, holder["cache"])
            logits.argmax(-1).cpu()

        busy = say_profile(f"serve {name} decode x{SERVE_PROFILE_STEPS}", decode_steps)
        if busy > 0:
            per = busy / SERVE_PROFILE_STEPS
            say(f"phase 6 serve {name} idle share ({smi}): device busy {per:.2f} ms a decode "
                f"step of the unprofiled {dec.mean():.2f} ms: idle {1 - per / dec.mean():.0%}")
        del holder
    del runs, model, params, step
    torch.cuda.empty_cache()


def prefill_flash_path(dev, launches, smi):
    """A prefill into a cache above FLASH_THRESHOLD (PF_S tokens, B = 1):
    the peak against the dry run's, each attention layer's cache words and
    output against the dense form's on the same input, and the prefill's
    wall. No SAFE kernel is on this path (serving)."""
    import dataclasses

    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.models import Model, layers, transformer

    cfg = dataclasses.replace(serve_config(), n_layers=PF_LAYERS)
    t0 = time.perf_counter()
    pred = dryrun.measure(cfg, "prefill_32k", shape=dict(seq_len=PF_S, global_batch=1,
                                                          kind="prefill"))
    dry_s = time.perf_counter() - t0
    warm_cublas(dev)
    sync()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    toks = torch.from_numpy(np.random.RandomState(SEED).randint(0, cfg.vocab, (1, PF_S))
                            .astype(np.int32)).to(dev)
    model = Model(cfg, device=dev)  # random weights from seed 0
    params = model.tree()
    sync()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        logits, cache = model.prefill(params, toks)
    sync()
    peak = torch.cuda.max_memory_allocated(dev) - base
    counts = dict(build.launches)
    if any(counts.values()):
        fail(f"prefill_flash launched SAFE kernels: {counts}")
    for k, c in counts.items():
        launches[k] += c
    if not bool(torch.isfinite(logits).all()):
        fail("prefill_flash: non-finite logits")
    del logits, cache
    apply, flash = transformer.attention_apply, layers._flash_attention

    def dense(qg, k_all, v_all, q_pos, k_pos, cfg, base_kind):
        return layers._dense_attention(qg, k_all, v_all, q_pos, k_pos, None, cfg, base_kind)

    def blockwise_prefill():
        with torch.inference_mode():
            model.prefill(params, toks)

    def dense_prefill():  # the parent's path: the dense form in every layer
        layers._flash_attention = dense
        try:
            blockwise_prefill()
        finally:
            layers._flash_attention = flash

    def walls_of(fn):
        out = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    walls = walls_of(blockwise_prefill)
    dense_prefill()  # its first call
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    dense_prefill()
    sync()
    dense_peak = torch.cuda.max_memory_allocated(dev) - base
    dense_walls = walls_of(dense_prefill)
    busy = {"blockwise": say_profile("prefill_flash blockwise", blockwise_prefill),
            "dense": say_profile("prefill_flash dense (the parent's path)", dense_prefill)}
    say(f"phase 6 prefill_flash against the parent's dense path ({smi}): blockwise "
        f"{walls[-1]:.1f} ms, dense {dense_walls[-1]:.1f} ms a prefill (runs "
        f"{[round(w, 1) for w in walls]} and {[round(w, 1) for w in dense_walls]} ms); "
        f"device busy {busy['blockwise']:.1f} and {busy['dense']:.1f} ms; peak "
        f"{peak / 1e9:.3f} and {dense_peak / 1e9:.3f} GB")

    # each attention layer beside the dense form on the same input
    checked = []

    def beside_dense(params, x, cfg, kind="global", positions=None, cache=None, tp=None,
                     seq=None):
        copy = {k: v.clone() for k, v in cache.items()}
        layers._flash_attention = dense
        try:
            want, wc = apply(params, x, cfg, kind, positions, copy, tp, seq)
        finally:
            layers._flash_attention = flash
        got, gc = apply(params, x, cfg, kind, positions, cache, tp, seq)
        checked.append((all(torch.equal(gc[k], wc[k]) for k in ("k", "v", "pos")),
                        float((got.float() - want.float()).abs().max()
                              / want.float().abs().max())))
        return got, gc

    transformer.attention_apply = beside_dense
    try:
        with torch.inference_mode():
            model.prefill(params, toks)
    finally:
        transformer.attention_apply = apply
    sync()
    del model, params, toks
    torch.cuda.empty_cache()

    p = pred["peak_bytes"]
    dry = (f"dry run {p / 1e9:.3f} GB against max_memory_allocated {peak / 1e9:.3f} GB, off "
           f"by {abs(p - peak) / peak:.2%} ({dry_s:.1f} s on meta tensors)")
    worst = max(e for _, e in checked)
    say(f"phase 4 main path prefill_flash ({smi}): {SERVE_ARCH} at full width, "
        f"{cfg.n_layers} layers, B = 1, a {PF_S}-token prompt into a global cache of {PF_S} "
        f"slots through the blockwise attention: {walls[-1]:.1f} ms a prefill (runs "
        f"{[round(w, 1) for w in walls]} ms after the first); launches {counts}")
    if len(checked) != cfg.n_layers or not all(c for c, _ in checked):
        fail(f"prefill_flash: the cache words differ from the dense form's: {checked}")
    if worst > PF_TOL:
        fail(f"prefill_flash: an attention layer {worst:.3e} of its largest |word| from the "
             f"dense form's, over {PF_TOL}")
    say(f"phase 5 prefill_flash: every one of the {len(checked)} attention layers' cache "
        f"words torch.equal to the dense form's on the same input, its output within "
        f"{worst:.3e} of its largest |word| (bound {PF_TOL}; by layer "
        f"{[f'{e:.1e}' for _, e in checked]})")
    if abs(p - peak) / peak > DRY_TOL:
        fail(f"prefill_flash {dry}, over {DRY_TOL:.0%}")
    say(f"phase 5 prefill_flash peak: {dry} (<= {DRY_TOL:.0%}; GB by category "
        f"{json.dumps({k: round(v / 1e9, 3) for k, v in pred['peak_by_category'].items()})})")


def say_profile(label, fn):
    """Print one profiled call of ``fn``; returns its device busy ms."""
    wall, busy, top = profile_ms(fn)
    seen = (f"device busy {busy:.2f} ms (idle {1 - busy / wall:.0%}); top: {top}"
            if busy > 0 else "device time not measured (the profiler saw none)")
    say(f"phase 6 profile {label}: wall {wall:.2f} ms under the profiler, {seen}")
    return busy


def aggregation_paths(dev):
    """Phases 4-6 of the aggregation paths; returns the launches over
    them, the kernels' timings and, on the host, what the engine path
    published for each of ``engine_sessions``. Their tensors are freed on
    return."""
    from repro_torch.core import make_aggregator
    from repro_torch.kernels import bon_mask as bm
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import chain_combine as cc
    from repro_torch.kernels import threefry_mask_add as tma
    from repro_torch.serve import AggregationEngine

    g = torch.Generator(device=dev).manual_seed(SEED)
    values = torch.rand((N, V_MAIN), generator=g, device=dev) * 4 - 2
    hvalues = torch.rand((PODS, N, V_MAIN), generator=g, device=dev) * 4 - 2
    specs = engine_sessions(dev)
    agg = make_aggregator("safe", N)
    bon = make_aggregator("bon", N)
    pipe = make_aggregator("safe", N, pipelined=True)
    hier = make_aggregator("safe", N, pod_axis="pod")
    engine = AggregationEngine(agg.cfg, slots=S_ENGINE, payload_words=V_ENGINE)
    outs, launches = {}, {k: 0 for k in build.launches}

    def run_engine():
        sessions = [(spec, engine.submit(**spec)) for spec in specs]
        engine.run_until_done()
        return sessions

    paths = {"round": ("clean", lambda: agg.aggregate(values)),
             "engine": ("sessions", run_engine),
             "bon": ("bon", lambda: bon.aggregate(values)),
             "pipelined": ("pipelined", lambda: pipe.aggregate(values)),
             "hierarchical": ("hierarchical", lambda: hier.aggregate(hvalues))}
    for path, (key, fn) in paths.items():
        sync()
        build.reset_launches()
        t0 = time.perf_counter()
        outs[key] = fn()
        sync()
        counts = dict(build.launches)
        say(f"phase 4 main path {path}: {time.perf_counter() - t0:.2f} s; launches {counts}")
        missing = sorted(k for k in PATH_KERNELS[path] if counts[k] <= 0)
        if missing:
            fail(f"path {path} never launched {missing}: {counts}")
        for k, c in counts.items():
            launches[k] += c
    sessions = outs.pop("sessions")
    say(f"phase 4 engine: {len(specs)} sessions, {engine.rounds_completed} session-rounds "
        f"in {engine.steps} steps; launches over all paths {launches}")

    for line in check_rounds(values, hvalues, make_aggregator, outs):
        say(f"phase 5 round {line}")
    check_engine(sessions, make_aggregator)
    say(f"phase 5 engine: {engine.rounds_completed} session-rounds bit-identical to single runs")
    published = [[r.cpu().numpy() for r in sess.results] for _, sess in sessions]

    times = time_kernels(dev, values, tma, cc, bm, ref)
    for name, t in times.items():
        say(f"phase 6 {name}: {t['ms']:.4f} ms on the device ({t['gbytes_per_s']:.0f} GB/s), "
            f"{t['issue_ms']:.4f} ms a call back to back from the host, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"(bytes {t['bytes_ms']:.4f} ms, ops {t['ops_ms']:.4f} ms; V={t['words']}, m={t['m']})")
    walls = {"round": wall_ms(lambda: agg.aggregate(values), iters=5),
             "bon": wall_ms(lambda: bon.aggregate(values), iters=3),
             "pipelined": wall_ms(lambda: pipe.aggregate(values), iters=5),
             "hierarchical": wall_ms(lambda: hier.aggregate(hvalues), iters=3)}
    wengine = AggregationEngine(agg.cfg, slots=S_ENGINE, payload_words=V_ENGINE)

    def engine_step():
        for spec in specs[:S_ENGINE]:
            wengine.submit(spec["values"], alive=spec["alive"], rotate0=spec["rotate0"])
        wengine.step()
    step_ms = wall_ms(engine_step, iters=3)
    say(f"phase 6 wall: round [{N}, {V_MAIN}] {walls['round']:.2f} ms "
        f"({3 + N - 1} launches: 3 mask_add + {N - 1} chain_combine); engine step "
        f"S={S_ENGINE} [{N}, {V_ENGINE}] {step_ms:.2f} ms ({3 * S_ENGINE} mask_add + "
        f"{N - 1} chain_combine_batched)")
    say(f"phase 6 wall: bon [{N}, {V_MAIN}] {walls['bon']:.2f} ms ({2 * N} bon_mask); "
        f"pipelined {walls['pipelined']:.2f} ms ({3 * N} mask_add + {N - 1} "
        f"chain_combine_batched); hierarchical [{PODS}, {N}, {V_MAIN}] "
        f"{walls['hierarchical']:.2f} ms ({PODS} sequential rounds)")
    busy = {label: say_profile(label, fn)
            for label, fn in (("round", lambda: agg.aggregate(values)),
                              ("bon", lambda: bon.aggregate(values)),
                              ("pipelined", lambda: pipe.aggregate(values)),
                              ("engine step", engine_step))}
    ratio_busy = (f"{busy['bon'] / busy['round']:.2f}" if busy["round"] > 0
                  else "not measured")
    say(f"phase 6 BON/SAFE at n={N}, V={V_MAIN}: wall {walls['bon'] / walls['round']:.2f}x, "
        f"device busy {ratio_busy}x (information, not a claim)")
    return launches, times, published


# ---- the dry run against the card: phases 4, 5 and 6 --------------------------------

def dispatch_cost(dev, smi):
    """The host time a custom-op call adds: each kernel's op against its
    wrapper called directly, at one word (the launch itself included in
    both), over DISPATCH_CALLS calls each, in turns."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import threefry_mask_add as tma
    x = torch.zeros(1, device=dev)
    direct = lambda: tma.mask_add(x, [1, 2], 0)  # noqa: E731
    op = lambda: ops.mask_add(x, [1, 2], 0)  # noqa: E731
    per = {"direct": [], "op": []}
    for name, fn in (("direct", direct), ("op", op), ("op", op), ("direct", direct)):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        sync()
        per[name].append((time.perf_counter() - t0) / DISPATCH_CALLS * 1e6)
    extra = min(per["op"]) - min(per["direct"])
    say(f"phase 6 custom-op dispatch ({smi}): mask_add at one word {min(per['op']):.1f} us a "
        f"call through torch.ops.repro_torch against {min(per['direct']):.1f} us through its "
        f"wrapper ({extra:.1f} us more; turns {json.dumps(per)}); the SAFE round at "
        f"n={N} makes {3 + N - 1} calls: {extra * (3 + N - 1) / 1e3:.3f} ms")


def dryrun_paths(dev, launches, smi):
    """Phases 4-6 of the dry run (``repro_torch.launch.dryrun``, meta
    tensors) against the card's own allocator over the same calls run for
    real: (a) one train step at the train-step path's size, (b) one decode
    step of serving traffic B at all 24 layers, each peak within DRY_TOL of
    ``max_memory_allocated`` (above what the card held before the call);
    (c) for (a)'s traffic the dry run says TS_LAYERS layers fit the card
    and 24 do not; (d) the step at the most layers the dry run says fit
    runs on the card, within DRY_TOL too, and the card has at least
    ``dryrun.H100_USABLE_BYTES`` for a process to allocate: its free bytes
    with what this process holds free, less what the caching allocator
    reserved beyond what it allocated in (d), where memory runs short
    (with room to spare, as in (a), it keeps gigabytes more cached)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import make_aggregator
    from repro_torch.data import make_federated_batches
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    from repro_torch.train import make_train_step

    cap, cap_from = dryrun.capacity()
    _, slots, max_seq = SERVE_TRAFFIC["B"][:3]
    serve_cfg = get_config(SERVE_ARCH)
    ts_shape = dict(seq_len=TS_S, global_batch=TS_N * TS_B, kind="train")
    before = dict(build.launches)
    t0 = time.perf_counter()
    pred = {layers: dryrun.measure(
        dataclasses.replace(get_config(TS_ARCH), n_layers=layers), "train_4k",
        shape=ts_shape, learners=TS_N, batch=TS_B) for layers in (TS_LAYERS, 24)}
    pred["decode"] = dryrun.measure(
        serve_cfg, "decode_32k", shape=dict(seq_len=max_seq, global_batch=slots, kind="decode"))
    most = dryrun.max_units_that_fit(
        dataclasses.replace(get_config(TS_ARCH), n_layers=24), "train_4k", cap,
        pred[24]["peak_bytes"], shape=ts_shape, learners=TS_N, batch=TS_B)
    edge = most["max_layers_that_fit"]
    pred["edge"] = {"peak_bytes": most["peak_bytes_by_units"][str(most["max_units_that_fit"])]}
    dry_s = time.perf_counter() - t0
    if build.launches != before:
        fail(f"the dry run launched kernels: {build.launches}, {before} before")
    say(f"phase 4 dry run ({smi}): {dry_s:.1f} s on meta tensors for {TS_ARCH} train steps at "
        f"{TS_LAYERS} and 24 layers (n={TS_N}, [{TS_B}, {TS_S}] tokens a learner), a "
        f"decode step at {serve_cfg.n_layers} layers ({slots} slots of {max_seq}) and the most "
        f"layers of that train step that fit {cap / 1e9:.3f} GB: {edge} (predicted "
        f"{most['predicted_units']}, peaks by units {json.dumps(most['peak_bytes_by_units'])}); "
        f"the SAFE kernels' shape functions at {TS_LAYERS} layers "
        f"{json.dumps(pred[TS_LAYERS]['kernels'])}, no launch")

    real, slack = {}, {}

    def measured(key, run):
        """``run()``'s peak above what the card held before it, and the
        caching allocator's reserved-over-allocated peak there."""
        sync()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        out = run()
        real[key] = torch.cuda.max_memory_allocated() - base
        slack[key] = torch.cuda.max_memory_reserved() - torch.cuda.max_memory_allocated()
        return out

    def train_step(layers):
        """(a)'s traffic, one step for real: the model, its state and the step."""
        cfg = dataclasses.replace(get_config(TS_ARCH), n_layers=layers)
        model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
        agg = make_aggregator("safe", TS_N, device=dev)
        bundle = make_train_step(model, agg, lr=TS_LR)
        tokens = torch.from_numpy(make_federated_batches(cfg, TS_N, TS_B, TS_S, seed=SEED)
                                  .global_batch(0)["tokens"]).to(dev)
        state = bundle.init_state_fn(model.tree())
        sync()
        build.reset_launches()
        torch.cuda.empty_cache()  # the set-up's freed blocks: the step's own reserve only
        torch.cuda.reset_peak_memory_stats()
        state, m = bundle.step_fn(state, tokens,
                                  counter=agg.reserve_round(bundle.padded_size + 2))
        sync()
        loss = float(m["loss"])
        counts = dict(build.launches)
        say(f"phase 4 main path dry run train step: one step_fn of {TS_ARCH} at {layers} "
            f"layers for real, loss {loss:.4f}; launches {counts}")
        missing = sorted(k for k in PATH_KERNELS["dryrun_train"] if counts[k] <= 0)
        if missing:
            fail(f"the dry run's real train step never launched {missing}: {counts}")
        if not math.isfinite(loss):
            fail(f"dry run train step at {layers} layers: loss {loss}")
        for k, c in counts.items():
            launches[k] += c

    def decode_step():
        """(b): one decode step of traffic B at all 24 layers, for real."""
        model = Model(serve_cfg, device=dev)  # random weights from seed 0
        cache = model.init_cache(slots, max_seq, prefilled=True)
        toks = torch.zeros(slots, dtype=torch.int32, device=dev)
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            logits, cache = model.decode_step(model.tree(), toks, cache)
        sync()
        if not bool(torch.isfinite(logits).all()):
            fail("dry run decode step: non-finite logits")

    measured(TS_LAYERS, lambda: train_step(TS_LAYERS))
    measured("decode", decode_step)
    measured("edge", lambda: train_step(edge))
    sync()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    room = free + torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    usable = room - slack["edge"]

    lines = {}
    for key, what in ((TS_LAYERS, f"(a) train step at {TS_LAYERS} layers"),
                      ("decode", f"(b) decode step, traffic B, {serve_cfg.n_layers} layers"),
                      ("edge", f"(d) train step at {edge} layers, the most that fit")):
        p, r = pred[key]["peak_bytes"], real[key]
        err = abs(p - r) / r
        cats = {k: round(v / 1e9, 3) for k, v in pred[key].get("peak_by_category", {}).items()}
        lines[key] = (f"{what}: dry run {p / 1e9:.3f} GB"
                      + (f" (GB by category {json.dumps(cats)})" if cats else "")
                      + f" against max_memory_allocated {r / 1e9:.3f} GB, off by {err:.2%}; "
                      f"reserved beyond allocated {slack[key] / 1e9:.3f} GB")
        if err > DRY_TOL:
            fail(f"dry run {lines[key]}, over {DRY_TOL:.0%}")
        say(f"phase 5 dry run {lines[key]} (<= {DRY_TOL:.0%})")
    fits = {layers: pred[layers]["peak_bytes"] <= cap for layers in (TS_LAYERS, 24)}
    verdict = (f"(c) {TS_ARCH} train step, n={TS_N}, [{TS_B}, {TS_S}] tokens a learner: "
               f"{TS_LAYERS} layers {pred[TS_LAYERS]['peak_bytes'] / 1e9:.2f} GB "
               f"{'fits' if fits[TS_LAYERS] else 'does not fit'}, 24 layers "
               f"{pred[24]['peak_bytes'] / 1e9:.2f} GB {'fits' if fits[24] else 'does not fit'} "
               f"in {cap / 1e9:.3f} GB ({cap_from})")
    if not fits[TS_LAYERS] or fits[24]:
        fail(f"dry run {verdict}: expected {TS_LAYERS} layers to fit and 24 not to")
    say(f"phase 5 dry run {verdict}")
    card = (f"(d) the card's room for a process: {free} B free of {total} + "
            f"{torch.cuda.memory_reserved() - torch.cuda.memory_allocated()} B this process "
            f"holds free = {room} B, less (d)'s reserved beyond allocated "
            f"{slack['edge']} B = {usable} B usable, against H100_USABLE_BYTES {cap} B")
    if cap > usable:
        fail(f"dry run {card}: the card holds less than the dry run sizes for")
    say(f"phase 5 dry run {card}")
    say(f"phase 6 dry run ({smi}): {lines[TS_LAYERS]}; {lines['decode']}; {lines['edge']}; "
        f"usable {usable / 1e9:.3f} GB; matmul FLOPs of the train step "
        f"{pred[TS_LAYERS]['matmul_flops'] / 1e12:.3f} TFLOP, of the decode step "
        f"{pred['decode']['matmul_flops'] / 1e9:.3f} GFLOP; dry run wall {dry_s:.1f} s")


# ---- the wire paths: phases 4, 5 and 6 ---------------------------------------------

async def serve_engine_tenants(engine, specs, chunked=None):
    """One broker in this event loop in front of ``engine``; one client per
    spec submits it (all at once): over the chunk plane in WIRE_CHUNK words
    those whose index is in ``chunked`` (all by default), the others in one
    frame; then all wait for their results. Returns the acks, the
    responses, the clock at start, at the last submission's ack and at the
    last result, the bytes the clients sent, and the broker."""
    from repro_torch.net import SafeBroker, WireClient

    broker = SafeBroker(engine=engine)
    addr = await broker.start()
    try:
        clients = [await WireClient(*addr, node=t).connect() for t in range(len(specs))]
        t0 = time.perf_counter()
        subs = await asyncio.gather(*(
            c.submit_session_chunked(spec, chunk_words=WIRE_CHUNK)
            if chunked is None or t in chunked else c.request("submit_session", spec)
            for t, (c, spec) in enumerate(zip(clients, specs))))
        t_up = time.perf_counter()
        sent = sum(c.bytes_sent for c in clients)
        res = await asyncio.gather(*(
            c.request("wait_session", {"sid": sub["sid"], "timeout": WIRE_WAIT_S})
            for c, sub in zip(clients, subs)))
        t_end = time.perf_counter()
        for c in clients:
            await c.close()
        return subs, res, (t0, t_up, t_end), sent, broker
    finally:
        await broker.stop()


def overlap(spans, lo, hi):
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in spans)


async def wire_round(run, values, **kw):
    from repro_torch.net import SafeBroker

    broker = SafeBroker(progress_timeout=1.0, monitor_interval=0.25,
                        aggregation_timeout=WIRE_AGG_TIMEOUT)
    addr = await broker.start()
    try:
        return await run(values, addr, **kw)
    finally:
        await broker.stop()


def wire_paths(dev, launches, published, smi):
    """Phases 4-6 of the wire plane. ``wire engine``: the port's broker in
    front of the port's engine on the card, ten networked tenants (the
    engine path's sessions, values copied to the host) uploading chunked
    and collecting their results; each must equal what the in-process
    engine path ``published``. ``wire round``: SAFE and BON rounds over
    127.0.0.1 at n = 36, V = 10,000, held to the port's simulation and the
    closed forms; host only. Launches of the engine path go into
    ``launches``."""
    from repro_torch.core import make_aggregator
    from repro_torch.core.bon_protocol import bon_expected_messages, run_bon_round
    from repro_torch.core.protocol import run_safe_round
    from repro_torch.crypto.np_impl import keystream_pair_lanes_np
    from repro_torch.kernels import build
    from repro_torch.net import run_bon_round_net, run_safe_round_net
    from repro_torch.serve import AggregationEngine

    class TimedEngine(AggregationEngine):
        """Each step timed on the host clock up to a synchronise, so the
        path's wall splits into its parts."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.step_spans = []

        def step(self):
            t0 = time.perf_counter()
            done = super().step()
            sync()
            self.step_spans.append((t0, time.perf_counter()))
            return done

    specs = [dict(spec, values=spec["values"].cpu().numpy()) for spec in engine_sessions(dev)]
    torch.cuda.empty_cache()
    cfg = make_aggregator("safe", N).cfg

    sync()
    build.reset_launches()
    engine = TimedEngine(cfg, slots=S_ENGINE, payload_words=V_ENGINE)
    _, res, (t0, t_up, t_end), sent, broker = asyncio.run(serve_engine_tenants(engine, specs))
    counts = dict(build.launches)
    say(f"phase 4 main path wire engine: {t_end - t0:.2f} s; launches {counts}")
    missing = sorted(k for k in PATH_KERNELS["wire_engine"] if counts[k] <= 0)
    if missing:
        fail(f"path wire engine never launched {missing}: {counts}")
    for k, c in counts.items():
        launches[k] += c
    say(f"phase 4 wire engine: {len(specs)} tenants, {engine.rounds_completed} session-rounds "
        f"in {engine.steps} steps, {broker.engine_chunk_frames_in} upload chunks")

    if broker.engine_errors:
        fail(f"wire engine: {broker.engine_errors} engine steps raised")
    down = 0
    for i, (spec, r) in enumerate(zip(specs, res)):
        if r.get("status") != "done" or r["rounds"] != spec["rounds"]:
            fail(f"wire engine tenant {i}: {r.get('status')} after "
                 f"{r.get('rounds')} of {spec['rounds']} rounds")
        for k, (got, want) in enumerate(zip(r["results"], published[i])):
            if not (got.dtype == np.float32 and np.array_equal(got.view(np.uint32),
                                                               want.view(np.uint32))):
                fail(f"wire engine tenant {i} round {k} differs from the in-process engine")
            down += got.nbytes
    say(f"phase 5 wire engine: {engine.rounds_completed} session-rounds bit-identical to the "
        f"in-process engine path, engine_errors 0, no wait timed out")

    spans = engine.step_spans
    steps = sum(b - a for a, b in spans)
    up = (t_up - t0) - overlap(spans, t0, t_up)
    dl = (t_end - t_up) - overlap(spans, t_up, t_end)
    say(f"phase 6 wire engine ({smi}): wall {t_end - t0:.3f} s = upload {up:.3f} s "
        f"({sent / up / 1e9:.3f} GB/s of {sent / 1e9:.3f} GB sent) + engine steps "
        f"{steps:.3f} s ({len(spans)} steps, each to a synchronise) + download {dl:.3f} s "
        f"({down / dl / 1e9:.3f} GB/s of {down / 1e6:.1f} MB of results)")
    del engine, broker, res

    def profiled():
        return asyncio.run(serve_engine_tenants(
            TimedEngine(cfg, slots=S_ENGINE, payload_words=V_ENGINE), specs))
    say_profile("wire engine", profiled)
    torch.cuda.empty_cache()

    sync()
    build.reset_launches()
    rng = np.random.RandomState(SEED + 5)
    values = rng.uniform(-1, 1, (N, WIRE_V)).astype(np.float32)
    walls, rounds = {}, {}
    for name, dead in WIRE_DEAD.items():
        t = time.perf_counter()
        rounds[name] = asyncio.run(wire_round(run_safe_round_net, values, failed_nodes=dead,
                                              aggregation_timeout=WIRE_AGG_TIMEOUT))
        walls[name] = time.perf_counter() - t
    t = time.perf_counter()
    bon = asyncio.run(wire_round(run_bon_round_net, values))
    walls["bon"] = time.perf_counter() - t
    counts = dict(build.launches)
    say(f"phase 4 main path wire round: {sum(walls.values()):.2f} s; launches {counts}")
    if any(counts.values()):
        fail(f"the wire rounds are host code but launched kernels: {counts}")

    for name, dead in WIRE_DEAD.items():
        got = rounds[name]
        sim = run_safe_round(values, failed_nodes=list(dead),
                             aggregation_timeout=WIRE_AGG_TIMEOUT)
        f = len(dead)
        # §5.3: 4(n - f) + 2f; a dead initiator adds one should_initiate
        # per survivor before the §5.4 election
        closed = 4 * (N - f) + 2 * f + (N - f if 1 in dead else 0)
        ops = ("post_aggregate", "check_aggregate", "get_aggregate", "post_average",
               "get_average", "should_initiate")
        if not np.array_equal(got.average.view(np.uint32), sim.average.view(np.uint32)):
            fail(f"wire round {name}: average differs from the simulation")
        if (got.stats["aggregation_total"] != closed or sim.stats.aggregation_total != closed
                or any(got.stats[op] != getattr(sim.stats, op) for op in ops)):
            fail(f"wire round {name}: messages {got.stats} against the closed form {closed} "
                 f"and the simulation's {sim.stats}")
        say(f"phase 5 wire round {name}: average bit-identical to the simulation, "
            f"{closed} messages (closed form), reposts {got.monitor_reposts}, "
            f"elections {got.initiator_elections}")
    sim = run_bon_round(values)
    if not np.array_equal(bon.average.view(np.uint32), sim.average.view(np.uint32)):
        fail("wire round bon: average differs from the simulation")
    if not bon.messages == bon.expected_messages == sim.messages == bon_expected_messages(N):
        fail(f"wire round bon: {bon.messages} messages, closed form {bon_expected_messages(N)}")
    say(f"phase 5 wire round bon: average bit-identical to the simulation, "
        f"{bon.messages} messages (closed form)")
    say(f"phase 6 wire rounds ({smi}): n={N}, V={WIRE_V}: " + ", ".join(
        f"{name} {w:.3f} s" for name, w in walls.items()))

    key = np.array([0x9E3779B9, 0x7F4A7C15], np.uint32)
    best = min(wall_ms(lambda: keystream_pair_lanes_np(key, KEYSTREAM_WORDS), iters=1)
               for _ in range(3))
    say(f"phase 6 host keystream ({smi}): keystream_pair_lanes_np on {KEYSTREAM_WORDS} words "
        f"{best:.1f} ms, {KEYSTREAM_WORDS / best / 1e3:.2f} M words/s on one host core "
        f"(os.cpu_count() {os.cpu_count()})")


# ---- the dist path: one learner a process ---------------------------------------

def digest(*tensors):
    """sha256 of the tensors' bytes, in order: equal digests are equal
    words."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dist_alive():
    a = np.ones(DIST_N, np.float32)
    a[DIST_DEAD] = 0.0
    return a


def dist_row(dev, rank):
    """Learner ``rank``'s f32[V_MAIN] row of the dist rounds (NaN when it is
    the dead learner: it must never reach the sum)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1 + rank)
    return torch.rand(V_MAIN, generator=g, device=dev) * 4 - 2


def dist_round_args(name, rank=None):
    """(mode, aggregator kwargs, round kwargs, whether ``rank``'s row is
    NaN) of a dist round; the weights are every learner's f32[n], or
    ``rank``'s scalar."""
    akw, kw = DIST_ROUNDS[name]
    akw, kw = dict(akw), dict(kw)
    dead = False
    if kw.get("alive") == "dead":
        kw["alive"] = dist_alive()
        dead = rank is not None and kw["alive"][rank] == 0
    if kw.get("weights") == "w":
        kw["weights"] = DIST_WEIGHTS if rank is None else float(DIST_WEIGHTS[rank])
    return akw.pop("mode"), akw, kw, dead


def dist_model(dev, layers):
    """internlm2-1.8b at full width, ``layers`` layers, seed SEED; the
    train step's tokens [2, n, B, S] and the FedAvg round's [n, k, B, S]."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(TS_ARCH), n_layers=layers)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    stream = make_federated_batches(cfg, DIST_N, TS_B, TS_S, seed=SEED)
    steps = np.stack([stream.global_batch(i)["tokens"] for i in range(2)])
    fed = np.stack([np.stack([stream.learner_batch(l, 10 + k)["tokens"] for k in range(DIST_K)])
                    for l in range(DIST_N)])
    return model, steps, fed


def dist_train(model, steps, world=None, on_step=None):
    """Two SAFE train steps, the second with DIST_DEAD dead: on one card
    (``world`` None, tokens [n, B, S]) or this rank's (its [B, S]).
    Returns (digest of the parameters, losses)."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import make_train_step
    from repro_torch.train.flatten import leaves
    dev = leaves(model.tree())[0].device
    agg = make_aggregator("safe", DIST_N, device=dev)
    bundle = make_train_step(model, agg, world, lr=TS_LR)
    state = bundle.init_state_fn(model.tree())
    losses = []
    for i, alive in enumerate((np.ones(DIST_N, np.float32), dist_alive())):
        toks = torch.from_numpy(steps[i] if world is None else steps[i][world.rank]).to(dev)
        counter = agg.reserve_round(bundle.padded_size + 2)
        if on_step:
            on_step("start", i, bundle, state)
        state, m = bundle.step_fn(state, toks, counter=counter, alive=alive)
        losses.append(float(m["loss"]))
        if on_step:
            on_step("end", i, bundle, state)
    return digest(*leaves(state["params"])), losses


def dist_fedavg(model, fed, world=None):
    """One weighted FedAvg round, DIST_DEAD dead: (digest of the published
    delta, digest of the new parameters, local loss)."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import make_federated_round, tree_size
    from repro_torch.train.flatten import leaves
    dev = leaves(model.tree())[0].device
    agg = make_aggregator("safe", DIST_N, weighted=True, device=dev)
    bundle = make_federated_round(model, agg, world, local_steps=DIST_K, local_lr=FED_LR,
                                  return_delta=True)
    toks = torch.from_numpy(fed if world is None else fed[world.rank]).to(dev)
    counter = agg.reserve_round(tree_size(model.tree()) + 1)
    params, m = bundle.round_fn(model.tree(), toks, weights=DIST_WEIGHTS, counter=counter,
                                alive=dist_alive())
    return digest(m["avg_delta"]), digest(*leaves(params)), float(m["local_loss"])


def _dist_rank(world, layers):
    """One rank of the dist path (spawned): the rounds, the train step and
    the FedAvg round (the model at ``layers`` layers) through the per-rank
    entry points, then, the launch counts read, its kernels' times by CUDA
    events, rank after rank. The rounds and the train steps time their
    collectives; the FedAvg round runs untimed."""
    import torch.distributed as dist

    from repro_torch.core import make_aggregator
    from repro_torch.dist import collectives
    from repro_torch.kernels import build, ops
    dev, r = world.device, world.rank
    out = {"rounds": {}, "round_ms": {}, "round_transport_ms": {}, "step_ms": [],
           "step_transport_ms": [], "hop_ms": None}
    build.reset_launches()
    x = dist_row(dev, r)
    for name in DIST_ROUNDS:
        mode, akw, kw, dead = dist_round_args(name, r)
        agg = make_aggregator(mode, world.size, device=dev, **akw)
        row = torch.full_like(x, float("nan")) if dead else x
        w = kw.pop("weights", None)
        dist.barrier()
        sync()
        collectives.reset_stats(timed=True)
        t0 = time.perf_counter()
        mean = agg.aggregate_rank(row, 2**32 - 5, weights=w, world=world, **kw)
        sync()
        out["round_ms"][name] = (time.perf_counter() - t0) * 1e3
        out["round_transport_ms"][name] = collectives.stats["seconds"] * 1e3
        out["rounds"][name] = digest(mean)
        del mean
    del x
    torch.cuda.empty_cache()

    model, steps, fed = dist_model(dev, layers)
    torch.cuda.reset_peak_memory_stats(dev)
    clock = {}

    def on_step(when, i, bundle, state):
        sync()
        if when == "start":
            collectives.reset_stats(timed=True)
            clock["t0"] = time.perf_counter()
        else:
            out["step_ms"].append((time.perf_counter() - clock["t0"]) * 1e3)
            out["step_transport_ms"].append(collectives.stats["seconds"] * 1e3)
            out["padded_size"], out["master_words"] = bundle.padded_size, state["master"].numel()
    out["train"] = dist_train(model, steps, world, on_step)
    collectives.reset_stats()
    out["train_peak"] = torch.cuda.max_memory_allocated(dev)
    out["train_reserved"] = torch.cuda.max_memory_reserved(dev)
    del model
    torch.cuda.empty_cache()
    model = dist_model(dev, layers)[0]
    torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = time.perf_counter()
    out["fedavg"] = dist_fedavg(model, fed, world)
    sync()
    out["fedavg_ms"] = (time.perf_counter() - t0) * 1e3
    out["fedavg_peak"] = torch.cuda.max_memory_allocated(dev)
    out["fedavg_reserved"] = torch.cuda.max_memory_reserved(dev)
    del model
    torch.cuda.empty_cache()
    out["launches"] = dict(build.launches)

    # this rank's kernels at the dist path's shapes, while the other ranks wait
    g = torch.Generator(device=dev).manual_seed(SEED + 100 + r)
    xv = torch.rand(V_MAIN, generator=g, device=dev)
    cv = torch.randint(-2**31, 2**31, (V_MAIN,), generator=g, device=dev,
                       dtype=torch.int32).view(torch.uint32)
    seg = V_MAIN // world.size
    keys = [[r + 1, 7]] * world.size
    calls = {
        "mask_add": lambda: ops.mask_add(xv, [r, 5], 0),
        "chain_combine": lambda: ops.chain_combine(cv, xv, [1, 2], [3, 4], 0),
        "chain_combine_batched": lambda: ops.chain_combine_batched(
            cv[None, :seg], xv[None, :seg], [[1, 2]], [[3, 4]], [0], starts=[seg * r + 1]),
        "bon_mask": lambda: ops.bon_mask(xv, keys, [1] * world.size, 0),
    }
    out["kernel_ms"] = {}
    for turn in range(world.size):
        dist.barrier()
        if turn == r:
            out["kernel_ms"] = {k: cuda_ms(f, DIST_TIMING_ITERS) for k, f in calls.items()}
    dist.barrier()
    return out


@contextlib.contextmanager
def _alloc_env():
    """The environment a rank starts in: this process's, its allocator set
    to DIST_ALLOC_CONF (read when a rank's allocator starts; this process's
    has started)."""
    before = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = DIST_ALLOC_CONF
    try:
        yield
    finally:
        if before is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = before


#: the rank pool ``spawn_ranks`` keeps for its next call of the same rank
#: count (None between pools), and each closed pool's (ranks, start-up s,
#: paths run)
POOL = {"pool": None, "done": []}


def close_pool():
    pool = POOL["pool"]
    if pool is not None:
        pool.close()
        POOL["done"].append((pool.size, round(pool.start_s, 1), pool.jobs_run))
        POOL["pool"] = None


atexit.register(close_pool)


def spawn_ranks(fn, ranks, args=()):
    """``ranks`` ranks of ``fn`` sharing the card over the host transport,
    each rank's allocator set to DIST_ALLOC_CONF: their results, in rank
    order. The ranks are a ``repro_torch.dist.RankPool``'s, kept for the
    next call of the same count (a call of another count, or the script's
    exit, stops them): only a pool's first path pays the ranks' start-up.
    Each path's rank function resets its own launch counts and reads
    memory against its own start."""
    from repro_torch.dist import RankPool
    if POOL["pool"] is not None and (POOL["pool"].size != ranks or POOL["pool"].closed):
        close_pool()
    if POOL["pool"] is None:
        with _alloc_env():
            POOL["pool"] = RankPool(ranks, "cuda", transport="host")
    return [r["result"] for r in POOL["pool"].run(fn, args)]


def spawn_dist_ranks(layers):
    """DIST_N ranks of ``_dist_rank`` sharing the card: their results."""
    return spawn_ranks(_dist_rank, DIST_N, (layers,))


def dist_depth(depths):
    """``python3 chip_smoke.py --dist-depth 5 6 7``, on one card: the dist
    path's ranks alone at each depth in turn, up to the first that does not
    fit four ranks; each rank's peaks, allocated and reserved. It sizes
    DIST_LAYERS and is not part of the smoke run."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only on a GPU")
    from repro_torch.kernels import build
    build.build()  # once, before the ranks
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    say(smi)
    fits = []
    for layers in depths:
        t0 = time.perf_counter()
        try:
            ranks = spawn_dist_ranks(layers)
        except Exception as e:  # noqa: BLE001 - a depth that does not fit ends the sizing
            say(f"dist depth {layers}: does not fit four ranks on one card ({smi}) after "
                f"{time.perf_counter() - t0:.1f} s: {type(e).__name__}: {str(e)[-600:]}")
            break
        gb = {k: [round(r[k] / 1e9, 3) for r in ranks]
              for k in ("train_peak", "train_reserved", "fedavg_peak", "fedavg_reserved")}
        say(f"dist depth {layers}: fits four ranks on one card ({smi}), {DIST_ALLOC_CONF}, "
            f"{time.perf_counter() - t0:.1f} s; padded_size {ranks[0]['padded_size']}; GB a "
            f"rank {json.dumps(gb)}")
        fits.append(layers)
    if not fits:
        fail(f"dist depth: none of {depths} fits")
    say(f"dist depth: the most layers that fit of {depths}: {max(fits)}")


def check_dist_kernels(dev, lengths, err, rounds=True, engine=None):
    """Each kernel at the shapes the dist path gives it, against its plain
    version on the same inputs: mask_add and chain_combine at each of
    ``lengths`` (CHUNK words at a time), mask_add on the pipelined round's
    seg words with pads from word l·seg, chain_combine_batched as that
    round's one row of seg words from word s·seg, and bon_mask with each
    live rank's keys — its 3 peers' and its own, signed as ``bon_rank``
    signs them — and its correction (its own key and the dead learner's).
    ``rounds`` False leaves out the rounds' segment and key-set shapes;
    ``engine`` (S, V) adds chain_combine_batched on S rows of V words with
    per-row keys and counter bases, as the per-rank engine's hop launches
    them. Folds the differences into ``err``; returns ({kernel: max |err|},
    comparisons)."""
    from repro_torch.kernels import bon_mask as bm
    from repro_torch.kernels import chain_combine as cc
    from repro_torch.kernels import ref
    from repro_torch.kernels import threefry_mask_add as tma
    g = torch.Generator(device=dev).manual_seed(SEED + 200)
    rng = np.random.RandomState(SEED + 200)
    base = 2**32 - 5

    def keys(m):
        return rng.randint(0, 2**32, (m, 2), dtype=np.uint64).astype(np.uint32)

    got = {k: 0 for k in DIST_KERNELS}
    checks = 0
    for V in lengths:
        x = torch.rand(V, generator=g, device=dev) * 4 - 2
        e = hop_diff(x, keys(1)[0], keys(1)[0], keys(1)[0], base)
        got = {k: max(got[k], e.get(k, 0)) for k in got}
        checks += 2
        del x
    if engine is not None:
        S, V = engine
        x = torch.rand((S, V), generator=g, device=dev) * 4 - 2
        c = torch.randint(-2**31, 2**31, (S, V), generator=g, device=dev,
                          dtype=torch.int32).view(torch.uint32)
        kin, kout, bases = keys(S), keys(S), [base - 3 * s for s in range(S)]
        got["chain_combine_batched"] = max(got["chain_combine_batched"], u32_diff(
            cc.chain_combine_batched(c, x, kin, kout, bases),
            ref.chain_combine_batched_ref(c, x, kin, kout, bases)))
        checks += 1
        del x, c
    if rounds:
        seg = -(-V_MAIN // DIST_N)
        x = torch.rand(seg, generator=g, device=dev) * 4 - 2
        c = torch.randint(-2**31, 2**31, (seg,), generator=g, device=dev,
                          dtype=torch.int32).view(torch.uint32)
        for s in range(DIST_N):
            key, kin, kout = keys(1)[0], keys(1), keys(1)
            got["mask_add"] = max(got["mask_add"], u32_diff(
                tma.mask_add(x, key, base, offset=s * seg),
                ref.mask_add_ref(x, key, base, offset=s * seg)))
            got["chain_combine_batched"] = max(got["chain_combine_batched"], u32_diff(
                cc.chain_combine_batched(c[None], x[None], kin, kout, [base], starts=[s * seg]),
                ref.chain_combine_batched_ref(c[None], x[None], kin, kout, [base],
                                              starts=[s * seg])))
            checks += 2
        x = torch.rand(V_MAIN, generator=g, device=dev) * 4 - 2
        zero = torch.zeros_like(x)
        alive = dist_alive()
        dead = [v for v in range(DIST_N) if alive[v] == 0]
        for u in range(DIST_N):
            if alive[u] == 0:
                continue
            peers = [v for v in range(DIST_N) if v != u]
            for xs, signs in ((x, [1 if u < v else -1 for v in peers] + [1]),
                              (zero, [1] + [1 if u < v else -1 for v in dead])):
                k = keys(len(signs))
                got["bon_mask"] = max(got["bon_mask"], u32_diff(
                    bm.bon_mask(xs, k, signs, base), ref.bon_mask_ref(xs, k, signs, base)))
                checks += 1
    sync()
    for k, v in got.items():
        err[k] = max(err[k], v)
    if any(got.values()):
        fail(f"a kernel differs from its plain version at a dist path's shapes: {got}")
    return got, checks


def dist_paths(dev, launches, err, smi):
    """The dist path: DIST_N spawned ranks sharing the card (``transport=
    "host"``, each rank's allocator set to DIST_ALLOC_CONF), one learner
    each, against the same work in this process on the card; adds the
    ranks' launches (summed) to ``launches`` and the kernels' checks at
    the path's shapes to ``err``."""
    import torch.distributed as dist

    from repro_torch.core import make_aggregator
    from repro_torch.dist import init_world
    from repro_torch.train import tree_size

    # nccl with fewer cards than ranks is refused, not swapped for gloo
    try:
        init_world(0, torch.cuda.device_count() + 1, dist.HashStore(), device="cuda")
    except RuntimeError as e:
        say(f"phase 5 dist: nccl refused for {torch.cuda.device_count() + 1} ranks on "
            f"{torch.cuda.device_count()} card(s): {e}")
    else:
        fail("dist: nccl with fewer cards than ranks did not raise")
    if dist.is_initialized():
        fail("dist: a process group was left running")

    # the same work in this process, on the card
    t0 = time.perf_counter()
    values = torch.stack([dist_row(dev, r) for r in range(DIST_N)])
    want = {}
    for name in DIST_ROUNDS:
        mode, akw, kw, _ = dist_round_args(name)
        v = values.clone()
        if "alive" in kw:
            v[torch.from_numpy(kw["alive"] == 0).to(dev)] = float("nan")
        want[name] = digest(make_aggregator(mode, DIST_N, device=dev, **akw)
                            .aggregate(v, 2**32 - 5, **kw))
        del v
    del values
    model, steps, fed = dist_model(dev, DIST_LAYERS)
    P = tree_size(model.tree())
    want["train"] = dist_train(model, steps)
    del model
    torch.cuda.empty_cache()
    want["fedavg"] = dist_fedavg(dist_model(dev, DIST_LAYERS)[0], fed)
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0

    held = (torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev))
    t0 = time.perf_counter()
    ranks = spawn_dist_ranks(DIST_LAYERS)
    ranks_s = time.perf_counter() - t0
    how = (f"{DIST_N} ranks sharing {torch.cuda.device_count()} card ({smi}), gloo through "
           f"pinned host buffers")
    counts = {k: sum(r["launches"][k] for r in ranks) for k in DIST_KERNELS}
    padded = ranks[0]["padded_size"]
    t1 = time.perf_counter()
    kerr, checks = check_dist_kernels(dev, (V_MAIN, V_MAIN + 1, padded, P + 1), err)
    say(f"phase 4 main path dist ({how}): rounds {list(DIST_ROUNDS)} at [{DIST_N} ranks x "
        f"{V_MAIN}], {DIST_LAYERS}-layer {TS_ARCH} train step x2 and FedAvg round; "
        f"{ranks_s:.1f} s spawned, {one_s:.1f} s for the same in one process; launches summed "
        f"over the ranks {counts}; the kernels at the path's shapes (V = {V_MAIN}, "
        f"{V_MAIN + 1}, padded_size {padded}, P + 1 = {P + 1}; seg {V_MAIN // DIST_N} from "
        f"words s*seg; bon_mask with 4 keys and 2) == plain: {checks} comparisons in "
        f"{time.perf_counter() - t1:.1f} s, max |err| {kerr}")
    missing = sorted(k for k in DIST_KERNELS if counts[k] <= 0)
    if missing:
        fail(f"path dist never launched {missing} in its ranks: {counts}")
    for k, c in counts.items():
        launches[k] += c

    # phase 5: every rank's answer equal to the others' and to one process's
    for key in list(DIST_ROUNDS) + ["train", "fedavg"]:
        got = [r["rounds"][key] if key in DIST_ROUNDS else r[key] for r in ranks]
        if any(g != want[key] for g in got):
            fail(f"dist {key}: the ranks' results differ from one process's on the card "
                 f"(ranks {got}, one process {want[key]})")
    say(f"phase 5 dist: every rank's mean of {list(DIST_ROUNDS)} torch.equal to the others' "
        f"and to make_aggregator(...).aggregate of the stacked rows on the card (sha256 "
        f"{ {k: want[k][:12] for k in DIST_ROUNDS} })")
    say(f"phase 5 dist train step: every rank's parameters after 2 steps (learner "
        f"{DIST_DEAD} dead in the second) word for word the one-process make_train_step's "
        f"(sha256 {want['train'][0][:12]}); losses {[round(x, 4) for x in want['train'][1]]}; "
        f"ZeRO-1 master {ranks[0]['master_words']} words a rank of padded_size "
        f"{ranks[0]['padded_size']}")
    say(f"phase 5 dist fedavg: every rank's published delta and parameters word for word the "
        f"one-process round_fn's (sha256 {want['fedavg'][0][:12]}, {want['fedavg'][1][:12]}); "
        f"local loss {want['fedavg'][2]:.4f}")
    if any(r["master_words"] * DIST_N != r["padded_size"] for r in ranks):
        fail("dist train step: a rank's master vector is not padded_size / n words")

    # phase 6: walls, the transport's share, peaks and per-rank kernel times
    for name in DIST_ROUNDS:
        walls = [r["round_ms"][name] for r in ranks]
        tr = [r["round_transport_ms"][name] for r in ranks]
        say(f"phase 6 dist round {name} ({how}): wall {max(walls):.1f} ms (ranks "
            f"{[round(w, 1) for w in walls]}); in collectives {[round(t, 1) for t in tr]} ms")
    for i in range(2):
        walls = [r["step_ms"][i] for r in ranks]
        tr = [r["step_transport_ms"][i] for r in ranks]
        say(f"phase 6 dist train step {i + 1} ({how}): wall {max(walls):.1f} ms; in "
            f"collectives {[round(t, 1) for t in tr]} ms, transport share "
            f"{[f'{t / w:.0%}' for t, w in zip(tr, walls)]}")
    say(f"phase 6 dist fedavg ({how}): round wall {max(r['fedavg_ms'] for r in ranks):.1f} ms")
    say(f"phase 6 dist peak memory ({how}): train step "
        f"{[round(r['train_peak'] / 1e9, 2) for r in ranks]} GB a rank, FedAvg "
        f"{[round(r['fedavg_peak'] / 1e9, 2) for r in ranks]} GB a rank (allocated; the "
        f"allocator's reserve {[round(r['train_reserved'] / 1e9, 2) for r in ranks]} and "
        f"{[round(r['fedavg_reserved'] / 1e9, 2) for r in ranks]} GB, {DIST_ALLOC_CONF}); "
        f"this process held {held[0] / 1e9:.2f} GB allocated, {held[1] / 1e9:.2f} GB "
        f"reserved while they ran")
    for k in DIST_KERNELS:
        say(f"phase 6 dist kernel {k} ({how}): CUDA events, one rank at a time, ms "
            f"{[round(r['kernel_ms'][k], 4) for r in ranks]} by rank")


# ---- the experts' all-to-all, pods and the engine across ranks ------------------

def ep_config():
    """The EP path's configuration: the zoo's MoE path (qwen3-moe at its
    published widths, cut to ZOO_PATHS["moe"]), ep_ranks = DIST_N."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(EP_ARCH), **EP_CUT)


def ep_run(dev, world=None, capture=None, on_step=None, on_init=None):
    """EP_STEPS SAFE train steps of the EP path's model from seed SEED, the
    second with DIST_DEAD dead, on the launcher's traffic: on one card (the
    learners as dim 0, every expert local) or, with ``world``, this rank's
    step on its E/n experts, its tokens exchanged with the others'.
    ``capture`` (a list) receives each round's (this rank's gradient row
    and published mean in host memory, counter, alive, rotate);
    ``on_init(state)`` sees the initial state. Returns (losses, state,
    bundle)."""
    from repro_torch.core import make_aggregator
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    from repro_torch.train import make_train_step
    cfg = ep_config()
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED),
                  ep_world=world)
    agg = make_aggregator("safe", DIST_N, device=dev)
    if capture is not None:
        inner = agg.aggregate_rank

        def watched(values, counter_base=0, **kw):
            out = inner(values, counter_base, **kw)
            capture.append((values.cpu(), out.cpu(), counter_base, kw["alive"], kw["rotate"]))
            return out
        agg.aggregate_rank = watched
    bundle = make_train_step(model, agg, world, lr=TS_LR)
    state = bundle.init_state_fn(model.tree())
    del model
    if on_init:
        on_init(state)
    stream = make_federated_batches(cfg, DIST_N, TS_B, TS_S, seed=SEED)
    losses = []
    for i, alive in enumerate((np.ones(DIST_N, np.float32), dist_alive())[:EP_STEPS]):
        toks = stream.global_batch(i)["tokens"]
        toks = torch.from_numpy(toks if world is None else toks[world.rank]).to(dev)
        counter = agg.reserve_round(bundle.padded_size + 2)
        if on_step:
            on_step("start", i)
        state, m = bundle.step_fn(state, toks, counter=counter, alive=alive)
        losses.append(float(m["loss"]))
        if on_step:
            on_step("end", i)
    return losses, state, bundle


def ep_experts(state):
    """The expert leaves of a train state's parameters, in leaf order."""
    from repro_torch.train.flatten import is_expert_path, leaves_with_paths
    return [t for p, t in leaves_with_paths(state["params"]) if is_expert_path(p)]


def _ep_rank(world, out_dir):
    """One rank of the EP path: its two steps with collectives timed, its
    master slice and expert shard written to ``out_dir`` for the parent,
    then the SAFE call checked on rank 0: every rank's captured gradient
    rows, gathered there, through the one-card aggregate must give the
    rank's published mean word for word."""
    import torch.distributed as dist

    from repro_torch.core import make_aggregator
    from repro_torch.dist import collectives
    from repro_torch.kernels import build
    dev, r = world.device, world.rank
    out = {"step_ms": [], "step_transport_ms": []}
    clock, capture = {}, []

    def on_step(when, i):
        sync()
        if when == "start":
            dist.barrier()
            collectives.reset_stats(timed=True)
            clock["t0"] = time.perf_counter()
        else:
            out["step_ms"].append((time.perf_counter() - clock["t0"]) * 1e3)
            out["step_transport_ms"].append(collectives.stats["seconds"] * 1e3)
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    out["losses"], state, bundle = ep_run(dev, world, capture, on_step)
    collectives.reset_stats()
    out["launches"] = dict(build.launches)
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["reserved"] = torch.cuda.max_memory_reserved(dev)
    out["padded_size"], out["master_words"] = bundle.padded_size, state["master"].numel()
    out["expert_shape"] = [tuple(t.shape) for t in ep_experts(state)]
    torch.save({"master": state["master"].cpu(), "experts": [t.cpu() for t in ep_experts(state)]},
               os.path.join(out_dir, f"ep_rank{r}.pt"))
    del state, bundle
    torch.cuda.empty_cache()
    out["safe_exact"] = []
    for row, mean, counter, alive, rotate in capture:
        rows = collectives.gather_to_host(row[None], 0, world)
        if r == 0:
            want = make_aggregator("safe", DIST_N, device=dev).aggregate(
                rows.to(dev), counter, alive=alive, rotate=rotate)
            out["safe_exact"].append(bool(torch.equal(want.cpu(), mean)))
            del want
        del rows
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _rel(a, b, base, dev=None):
    """||a - b|| / ||b - base|| over lists of tensors, in float64 pieces (on
    ``dev`` when given: a host leaf list of billions of words takes minutes
    of the host's float64)."""
    num = den = 0.0
    for x, y, z in zip(a, b, base):
        for lo in range(0, x.numel(), CHUNK):
            xs, ys, zs = (t.reshape(-1)[lo:lo + CHUNK] for t in (x, y, z))
            if dev is not None:
                xs, ys, zs = xs.to(dev), ys.to(dev), zs.to(dev)
            xs, ys, zs = xs.double(), ys.double(), zs.double()
            num += float(((xs - ys) ** 2).sum())
            den += float(((ys - zs) ** 2).sum())
    return math.sqrt(num / den)


def ep_dist_path(dev, launches, err, smi):
    """The MoE across ranks: DIST_N spawned ranks sharing the card, each
    with its E/n experts, against the one-card EP step from the same seed
    and tokens; adds the ranks' launches to ``launches``."""
    import tempfile

    from repro_torch.train import tree_size
    how = (f"{DIST_N} ranks sharing {torch.cuda.device_count()} card ({smi}), gloo through "
           f"pinned host buffers")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep_") as tmp:
        t0 = time.perf_counter()
        ranks = spawn_ranks(_ep_rank, DIST_N, (tmp,))
        ranks_s = time.perf_counter() - t0
        # the one-card EP step, its initial SAFE master and experts kept
        t0 = time.perf_counter()
        keep = {}

        def first(state):
            keep["master0"] = state["master"].clone()
            keep["experts0"] = [t.clone() for t in ep_experts(state)]
        losses, state, bundle = ep_run(dev, on_init=first)
        one_s = time.perf_counter() - t0
        P = tree_size(state["params"])
        n_loc = ranks[0]["expert_shape"][0][1]
        L = bundle.padded_size // DIST_N
        got_m, got_e, want_m, want_e, base_m, base_e = [], [], [], [], [], []
        for r in range(DIST_N):
            part = torch.load(os.path.join(tmp, f"ep_rank{r}.pt"))
            got_m.append(part["master"].to(dev))
            want_m.append(state["master"][r * L:(r + 1) * L])
            base_m.append(keep["master0"][r * L:(r + 1) * L])
            for x, y, z in zip(part["experts"], ep_experts(state), keep["experts0"]):
                got_e.append(x.to(dev))
                want_e.append(y[:, r * n_loc:(r + 1) * n_loc])
                base_e.append(z[:, r * n_loc:(r + 1) * n_loc])
            del part
        e_master = _rel(got_m, want_m, base_m)
        e_experts = _rel(got_e, want_e, base_e)
        del got_m, got_e, want_m, want_e, base_m, base_e, keep, state, bundle
        torch.cuda.empty_cache()
    counts = {k: sum(r["launches"][k] for r in ranks) for k in DIST_KERNELS}
    padded = ranks[0]["padded_size"]
    kerr, checks = check_dist_kernels(dev, (padded,), err, rounds=False)
    from repro_torch.configs import get_config
    cut = ", ".join(f"{k} {getattr(get_config(EP_ARCH), k)} -> {v}" for k, v in EP_CUT.items()
                    if k in ("n_layers", "vocab"))
    say(f"phase 4 main path moe_dist ({how}): {EP_ARCH} at full width, reduced: {cut}; "
        f"{P} parameters, padded_size {padded}, {n_loc} of {n_loc * DIST_N} experts a rank "
        f"(shapes {ranks[0]['expert_shape']}); {EP_STEPS} EP train steps (learner "
        f"{DIST_DEAD} dead in the second), {TS_B} x {TS_S} tokens a learner; {ranks_s:.1f} s "
        f"spawned, {one_s:.1f} s for the one-card EP step; launches summed over the ranks "
        f"{counts}; the kernels at V = padded_size == plain: {checks} comparisons, max |err| "
        f"{kerr}")
    missing = sorted(k for k in PATH_KERNELS["moe_dist"] if counts[k] <= 0)
    if missing:
        fail(f"path moe_dist never launched {missing} in its ranks: {counts}")
    for k, c in counts.items():
        launches[k] += c

    rank_losses = ranks[0]["losses"]
    if any(r["losses"] != rank_losses for r in ranks):
        fail(f"moe_dist: the ranks' losses differ: {[r['losses'] for r in ranks]}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(rank_losses, losses))
    if not all(ranks[0]["safe_exact"]) or len(ranks[0]["safe_exact"]) != EP_STEPS:
        fail(f"moe_dist: SAFE on the ranks' own gradients differs from one card's: "
             f"{ranks[0]['safe_exact']}")
    if not (np.isfinite(rank_losses).all() and loss_err <= EP_LOSS_RTOL
            and e_master <= EP_MASTER_REL and e_experts <= EP_EXPERT_REL):
        fail(f"moe_dist: against the one-card EP step: losses {rank_losses} vs {losses} "
             f"({loss_err:.3g} > {EP_LOSS_RTOL}?), the SAFE master's change {e_master:.3g} "
             f"(bound {EP_MASTER_REL}), the experts' change {e_experts:.3g} (bound "
             f"{EP_EXPERT_REL})")
    if any(r["master_words"] * DIST_N != padded for r in ranks):
        fail("moe_dist: a rank's master vector is not padded_size / n words")
    say(f"phase 5 moe_dist: SAFE on each step's gradient rows of the {DIST_N} ranks, "
        f"aggregated on one card, == every rank's published mean word for word "
        f"({ranks[0]['safe_exact']}); losses {[round(x, 5) for x in rank_losses]} against the "
        f"one-card EP step's {[round(x, 5) for x in losses]} (relative {loss_err:.3g}, bound "
        f"{EP_LOSS_RTOL}); relative L2 of the change over {EP_STEPS} steps against one card's: "
        f"the SAFE partition's f32 master {e_master:.3g} (bound {EP_MASTER_REL}), the bf16 "
        f"expert shards {e_experts:.3g} (bound {EP_EXPERT_REL})")
    for i in range(EP_STEPS):
        walls = [r["step_ms"][i] for r in ranks]
        tr = [r["step_transport_ms"][i] for r in ranks]
        say(f"phase 6 moe_dist train step {i + 1} ({how}): wall {max(walls):.1f} ms; in "
            f"collectives {[round(t, 1) for t in tr]} ms, transport share "
            f"{[f'{t / w:.0%}' for t, w in zip(tr, walls)]}")
    say(f"phase 6 moe_dist peak memory ({how}): {[round(r['peak'] / 1e9, 2) for r in ranks]} "
        f"GB a rank allocated, {[round(r['reserved'] / 1e9, 2) for r in ranks]} GB reserved "
        f"({DIST_ALLOC_CONF})")


def pod_weights():
    """The pod rounds' f32[P, n] weights."""
    return np.stack([DIST_WEIGHTS, DIST_WEIGHTS[::-1] * 1.5]).astype(np.float32)


def pod_round_args(name):
    """(mode, aggregator kwargs with the pod axis, round kwargs with the
    alive bitmap and the [P, n] weights) of a pod round."""
    akw, kw = DIST_ROUNDS[name]
    akw, kw = dict(akw, pod_axis="pod"), dict(kw)
    if kw.get("alive") == "dead":
        kw["alive"] = dist_alive()
    if kw.get("weights") == "w":
        kw["weights"] = pod_weights()
    return akw.pop("mode"), akw, kw


def rank_engine_sessions():
    """The per-rank engine's sessions (n = DIST_N, V_ENGINE words a rank):
    ten through S_ENGINE slots, some of several rounds, learner DIST_DEAD
    or the default initiator dead in two, every one rotated."""
    out = []
    for s in range(10):
        alive = np.ones(DIST_N, np.float32)
        if s == 2:
            alive[0] = 0.0
        if s == 5:
            alive[DIST_DEAD] = 0.0
        out.append(dict(seed=SEED + 300 + s, rounds=ENGINE_RANK_ROUNDS if s % 3 == 0 else 1,
                        provisioning_seed=0xC0FFEE + s, learner_master=0x5EED + 17 * s,
                        alive=alive, rotate0=3 * s))
    return out


def session_values(dev, spec):
    g = torch.Generator(device=dev).manual_seed(spec["seed"])
    return torch.rand((DIST_N, V_ENGINE), generator=g, device=dev) * 4 - 2


def run_engine(dev, world=None):
    """The rank engine's sessions through an ``AggregationEngine`` of
    S_ENGINE slots: on one card, or this rank's rows over ``world``.
    Returns (each session's digest of its published means, steps, wall ms)."""
    from repro_torch.core.types import ChainConfig
    from repro_torch.serve.agg_engine import AggregationEngine
    eng = AggregationEngine(ChainConfig(num_learners=DIST_N, mode="safe"), S_ENGINE, V_ENGINE,
                            device=dev, world=world)
    sess = []
    for spec in rank_engine_sessions():
        v = session_values(dev, spec)
        sess.append(eng.submit(v if world is None else v[world.rank], rounds=spec["rounds"],
                               provisioning_seed=spec["provisioning_seed"],
                               learner_master=spec["learner_master"], alive=spec["alive"],
                               rotate0=spec["rotate0"]))
    sync()
    t0 = time.perf_counter()
    eng.run_until_done()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    return [digest(*s.results) for s in sess], eng.steps, ms


def serve_rank_engine(dev, world):
    """The rank engine's sessions over the wire, one learner a rank of
    ``world``: rank 0 serves them through an ``EngineLead`` (each step
    timed to a synchronise), the others ``follow``. Returns, on rank 0, each
    tenant's digest of its results, its session id and the phase's clocks;
    on the others, the digest of each session they finished, by id."""
    from repro_torch.core.types import ChainConfig
    from repro_torch.serve import AggregationEngine, EngineLead, follow

    class TimedLead(EngineLead):
        def __init__(self, engine):
            super().__init__(engine)
            self.spans = []

        def step(self):
            t0 = time.perf_counter()
            done = super().step()
            sync()
            self.spans.append((t0, time.perf_counter()))
            return done

    eng = AggregationEngine(ChainConfig(num_learners=DIST_N, mode="safe"), S_ENGINE, V_ENGINE,
                            device=dev, world=world)
    if world.rank:
        done = {}
        eng.on_complete = lambda sess: done.setdefault(sess.sid, digest(*sess.results))
        follow(eng)
        return {"digests": done, "steps": eng.steps}
    specs = []
    for spec in rank_engine_sessions():
        spec = dict(spec, values=session_values(dev, spec).cpu().numpy())
        del spec["seed"]
        specs.append(spec)
    lead = TimedLead(eng)
    subs, res, clocks, sent, broker = asyncio.run(serve_engine_tenants(
        lead, specs, chunked={BROKER_CHUNKED}))
    digests = []
    for t, (spec, r) in enumerate(zip(specs, res)):
        if r.get("status") != "done" or r["rounds"] != spec["rounds"]:
            fail(f"rank broker tenant {t}: {r.get('status')} after {r.get('rounds')} of "
                 f"{spec['rounds']} rounds")
        digests.append(digest(*(torch.from_numpy(np.array(x, np.float32)) for x in r["results"])))
    return {"digests": digests, "sids": [r["sid"] for r in subs], "steps": eng.steps,
            "clocks": clocks, "sent": sent, "errors": broker.engine_errors,
            "spans": lead.spans}


def _pod_round_rank(world):
    """One of POD_P x DIST_N ranks: the pod rounds of DIST_ROUNDS at V_MAIN
    words a rank (its row that of global rank p·n + l), then the per-rank
    engine over its pod's DIST_N learners (both pods run it), each with its
    launches and walls."""
    import torch.distributed as dist

    from repro_torch.core import make_aggregator
    from repro_torch.dist import collectives, rank_world
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_pod_mesh
    dev = world.device
    mesh = make_pod_mesh(POD_P, DIST_N)
    data, pod = rank_world(mesh, "data"), rank_world(mesh, "pod")
    out = {"rounds": {}, "round_ms": {}, "round_transport_ms": {}}
    x = dist_row(dev, world.rank)
    build.reset_launches()
    for name in DIST_ROUNDS:
        mode, akw, kw = pod_round_args(name)
        agg = make_aggregator(mode, DIST_N, device=dev, **akw)
        dead = "alive" in kw and kw["alive"][data.rank] == 0
        row = torch.full_like(x, float("nan")) if dead else x
        dist.barrier()
        sync()
        collectives.reset_stats(timed=True)
        t0 = time.perf_counter()
        mean = agg.aggregate_rank(row, 2**32 - 5, world=data, pod_world=pod, **kw)
        sync()
        out["round_ms"][name] = (time.perf_counter() - t0) * 1e3
        out["round_transport_ms"][name] = collectives.stats["seconds"] * 1e3
        out["rounds"][name] = digest(mean)
        del mean
    collectives.reset_stats()
    out["round_launches"] = dict(build.launches)
    del x
    torch.cuda.empty_cache()
    build.reset_launches()
    dist.barrier()
    out["engine"], out["engine_steps"], out["engine_ms"] = run_engine(dev, data)
    out["engine_launches"] = dict(build.launches)
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    if pod.rank == 0:  # pod 0's ranks serve the same sessions over the wire
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        build.reset_launches()
        out["broker"] = serve_rank_engine(dev, data)
        out["broker_launches"] = dict(build.launches)
        out["broker_peak"] = torch.cuda.max_memory_allocated(dev)
    return out


def pod_model(dev, layers, n=POD_STEP_N):
    """internlm2-1.8b at full width and ``layers`` layers, seed SEED; the
    pod steps' tokens [2, P·n, B, S] and FedAvg's [P·n, k, B, S]."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(TS_ARCH), n_layers=layers)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    rows = POD_P * n
    stream = make_federated_batches(cfg, rows, TS_B, TS_S, seed=SEED)
    steps = np.stack([stream.global_batch(i)["tokens"] for i in range(2)])
    fed = np.stack([np.stack([stream.learner_batch(l, 10 + k)["tokens"] for k in range(DIST_K)])
                    for l in range(rows)])
    return model, steps, fed


def pod_alive(n=POD_STEP_N):
    a = np.ones(n, np.float32)
    a[DIST_DEAD] = 0.0
    return a


def pod_train(model, steps, mesh=None, rank=None, on_step=None, n=POD_STEP_N, mode="safe"):
    """Two pod train steps of ``mode`` (the second with learner DIST_DEAD
    dead in every pod): one card on [P·n, B, S], or global rank ``rank``'s
    over the ('pod', 'data') ``mesh``. Returns (digest of the parameters,
    losses)."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import make_train_step
    from repro_torch.train.flatten import leaves
    dev = leaves(model.tree())[0].device
    agg = make_aggregator(mode, n, pod_axis="pod", device=dev)
    bundle = make_train_step(model, agg, mesh, lr=TS_LR, pod_axis="pod")
    state = bundle.init_state_fn(model.tree())
    losses = []
    for i, alive in enumerate((np.ones(n, np.float32), pod_alive(n))):
        toks = torch.from_numpy(steps[i] if rank is None else steps[i][rank]).to(dev)
        counter = agg.reserve_round(bundle.padded_size + 2)
        if on_step:
            on_step("start", i, bundle, state)
        state, m = bundle.step_fn(state, toks, counter=counter, alive=alive)
        losses.append(float(m["loss"]))
        if on_step:
            on_step("end", i, bundle, state)
    return digest(*leaves(state["params"])), losses


def pod_fedavg(model, fed, mesh=None, rank=None):
    """One weighted FedAvg round with pods (learner DIST_DEAD dead, learner
    l weighted DIST_WEIGHTS[l] in every pod): (digest of the published
    delta, digest of the new parameters, local loss)."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import make_federated_round, tree_size
    from repro_torch.train.flatten import leaves
    dev = leaves(model.tree())[0].device
    agg = make_aggregator("safe", POD_STEP_N, weighted=True, pod_axis="pod", device=dev)
    bundle = make_federated_round(model, agg, mesh, local_steps=DIST_K, local_lr=FED_LR,
                                  pod_axis="pod", return_delta=True)
    toks = torch.from_numpy(fed if rank is None else fed[rank]).to(dev)
    counter = agg.reserve_round(tree_size(model.tree()) + 1)
    params, m = bundle.round_fn(model.tree(), toks, weights=DIST_WEIGHTS[:POD_STEP_N],
                                counter=counter, alive=pod_alive())
    return digest(m["avg_delta"]), digest(*leaves(params)), float(m["local_loss"])


def _pod_step_rank(world, layers):
    """One of POD_P x POD_STEP_N ranks: the pod train steps and FedAvg round
    of internlm2-1.8b at ``layers`` layers over the ('pod', 'data') mesh."""
    from repro_torch.dist import collectives
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_pod_mesh
    dev = world.device
    mesh = make_pod_mesh(POD_P, POD_STEP_N)
    out = {"step_ms": [], "step_transport_ms": []}
    clock = {}

    def on_step(when, i, bundle, state):
        sync()
        if when == "start":
            collectives.reset_stats(timed=True)
            clock["t0"] = time.perf_counter()
        else:
            out["step_ms"].append((time.perf_counter() - clock["t0"]) * 1e3)
            out["step_transport_ms"].append(collectives.stats["seconds"] * 1e3)
            out["padded_size"] = bundle.padded_size
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    model, steps, fed = pod_model(dev, layers)
    out["train"] = pod_train(model, steps, mesh, world.rank, on_step)
    collectives.reset_stats()
    out["train_peak"] = torch.cuda.max_memory_allocated(dev)
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = pod_model(dev, layers)[0]
    sync()
    t0 = time.perf_counter()
    out["fedavg"] = pod_fedavg(model, fed, mesh, world.rank)
    sync()
    out["fedavg_ms"] = (time.perf_counter() - t0) * 1e3
    out["fedavg_peak"] = torch.cuda.max_memory_allocated(dev)
    out["launches"] = dict(build.launches)
    return out


def pod_dist_paths(dev, launches, err, smi):
    """Pods as a second mesh dimension across ranks and the engine one
    learner a rank: POD_P x DIST_N spawned ranks run the pod rounds and the
    per-rank engine, then POD_P x POD_STEP_N ranks the pod train step and
    FedAvg round, each against the same work in this process on the card;
    adds the ranks' launches to ``launches``."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import tree_size

    # the same work in this process, on the card
    t0 = time.perf_counter()
    values = torch.stack([dist_row(dev, g) for g in range(POD_P * DIST_N)]).view(
        POD_P, DIST_N, V_MAIN)
    want = {}
    for name in DIST_ROUNDS:
        mode, akw, kw = pod_round_args(name)
        v = values.clone()
        if "alive" in kw:
            v[:, torch.from_numpy(kw["alive"] == 0).to(dev)] = float("nan")
        want[name] = digest(make_aggregator(mode, DIST_N, device=dev, **akw)
                            .aggregate(v, 2**32 - 5, **kw))
        del v
    del values
    want_engine, one_steps, one_engine_ms = run_engine(dev)
    model, steps, fed = pod_model(dev, POD_LAYERS)
    P = tree_size(model.tree())
    want["train"] = pod_train(model, steps)
    del model
    torch.cuda.empty_cache()
    want["fedavg"] = pod_fedavg(pod_model(dev, POD_LAYERS)[0], fed)
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0

    how = f"sharing {torch.cuda.device_count()} card ({smi}), gloo through pinned host buffers"
    t0 = time.perf_counter()  # the steps' 6 ranks first: the next paths reuse the rounds' 8
    steps_ = spawn_ranks(_pod_step_rank, POD_P * POD_STEP_N, (POD_LAYERS,))
    steps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rounds = spawn_ranks(_pod_round_rank, POD_P * DIST_N)
    rounds_s = time.perf_counter() - t0
    served = [r for r in rounds if "broker" in r]     # pod 0's ranks, in rank order
    if len(served) != DIST_N:
        fail(f"rank broker: {len(served)} ranks served the sessions, not pod 0's {DIST_N}")
    lead = served[0]["broker"]
    paths = {"pod_rounds": [r["round_launches"] for r in rounds],
             "rank_engine": [r["engine_launches"] for r in rounds],
             "rank_broker": [r["broker_launches"] for r in served],
             "pod_steps": [r["launches"] for r in steps_]}
    counts = {p: {k: sum(c[k] for c in cs) for k in DIST_KERNELS} for p, cs in paths.items()}
    padded = steps_[0]["padded_size"]
    t1 = time.perf_counter()
    kerr, checks = check_dist_kernels(dev, (padded, P + 1), err, rounds=False,
                                      engine=(S_ENGINE, V_ENGINE))
    say(f"phase 4 main path pod_rounds ({POD_P} pods x {DIST_N} learners = "
        f"{POD_P * DIST_N} ranks {how}): rounds {list(DIST_ROUNDS)} at [{POD_P}, {DIST_N}, "
        f"{V_MAIN}], the pod mean all-gathered over each learner's pod World; launches summed "
        f"over the ranks {counts['pod_rounds']}")
    say(f"phase 4 main path rank_engine (each pod's {DIST_N} ranks {how}): {len(want_engine)} "
        f"sessions through {S_ENGINE} slots at {V_ENGINE} words a rank, "
        f"{rounds[0]['engine_steps']} steps ({one_steps} on one card); launches summed over "
        f"the {POD_P * DIST_N} ranks {counts['rank_engine']}; {rounds_s:.1f} s spawned with "
        f"the pod rounds")
    t0_, t_up, t_end = lead["clocks"]
    say(f"phase 4 main path rank_broker (pod 0's {DIST_N} ranks {how}): rank 0's SafeBroker "
        f"in front of an EngineLead, {len(want_engine)} WireClient tenants on 127.0.0.1 "
        f"(session {BROKER_CHUNKED} over the chunk plane in {WIRE_CHUNK}-word chunks), ranks "
        f"1-{DIST_N - 1} following; {lead['steps']} steps on every rank "
        f"({[r['broker']['steps'] for r in served]}); launches by rank "
        f"{[{k: c[k] for k in PATH_KERNELS['rank_broker']} for c in paths['rank_broker']]}, "
        f"summed {counts['rank_broker']}")
    say(f"phase 4 main path pod_steps ({POD_P} pods x {POD_STEP_N} learners = "
        f"{POD_P * POD_STEP_N} ranks {how}; three a pod: SAFE's rings need three members): "
        f"{TS_ARCH} at full width, reduced: n_layers 24 -> {POD_LAYERS}; 2 train steps and a "
        f"weighted FedAvg round of {DIST_K} local steps; padded_size {padded}, P {P}; "
        f"{steps_s:.1f} s spawned, {one_s:.1f} s for every pod path's work in one process; "
        f"launches summed over the ranks {counts['pod_steps']}; the kernels at the pod paths' "
        f"shapes (V = padded_size, P + 1, chain_combine_batched [{S_ENGINE}, {V_ENGINE}]) == "
        f"plain: {checks} comparisons in {time.perf_counter() - t1:.1f} s, max |err| {kerr}")
    for path, c in counts.items():
        missing = sorted(k for k in PATH_KERNELS[path] if c[k] <= 0)
        if missing:
            fail(f"path {path} never launched {missing} in its ranks: {c}")
        for k, v in c.items():
            launches[k] += v

    for name in DIST_ROUNDS:
        got = [r["rounds"][name] for r in rounds]
        if any(g != want[name] for g in got):
            fail(f"pod round {name}: the ranks' means differ from one process's [2, 4, V] "
                 f"(ranks {got}, one process {want[name]})")
    for r, res in enumerate(rounds):
        if res["engine"] != want_engine:
            fail(f"rank engine: rank {r}'s sessions differ from the one-card engine's")
    if lead["errors"]:
        fail(f"rank broker: {lead['errors']} engine steps raised")
    for r, res in enumerate(served):
        got = res["broker"]["digests"]
        if r:  # a follower's sessions by id, in the tenants' order
            got = [got.get(sid) for sid in lead["sids"]]
        if got != want_engine:
            fail(f"rank broker: rank {r}'s {'tenant results' if r == 0 else 'sessions'} "
                 f"differ from the one-card engine's")
        missing = sorted(k for k in PATH_KERNELS["rank_broker"]
                         if res["broker_launches"][k] <= 0)
        if missing:
            fail(f"rank broker: rank {r} never launched {missing}: {res['broker_launches']}")
    for key in ("train", "fedavg"):
        got = [r[key] for r in steps_]
        if any(g != want[key] for g in got):
            fail(f"pod {key}: the ranks' results differ from one process's (ranks {got}, one "
                 f"process {want[key]})")
    say(f"phase 5 pod_rounds: every rank's mean of {list(DIST_ROUNDS)} torch.equal to "
        f"make_aggregator(..., pod_axis='pod').aggregate of the [{POD_P}, {DIST_N}, {V_MAIN}] "
        f"rows on the card (sha256 {({k: want[k][:12] for k in DIST_ROUNDS})})")
    say(f"phase 5 rank_engine: every session's published means on each of the "
        f"{POD_P * DIST_N} ranks torch.equal to the one-card engine's "
        f"({len(want_engine)} sessions)")
    say(f"phase 5 rank_broker: every tenant's wait_session results on rank 0 and every "
        f"follower's sessions torch.equal (sha256) to the one-card engine's "
        f"({len(want_engine)} sessions); engine_errors 0")
    say(f"phase 5 pod_steps: every rank's parameters after 2 pod steps (learner {DIST_DEAD} "
        f"dead in the second) word for word the one-process pod step's (sha256 "
        f"{want['train'][0][:12]}; losses {[round(x, 4) for x in want['train'][1]]}); the "
        f"FedAvg round's delta and parameters word for word (sha256 {want['fedavg'][0][:12]}, "
        f"{want['fedavg'][1][:12]}; local loss, pod 0's, {want['fedavg'][2]:.4f})")

    for name in DIST_ROUNDS:
        walls = [r["round_ms"][name] for r in rounds]
        tr = [r["round_transport_ms"][name] for r in rounds]
        say(f"phase 6 pod round {name} ({POD_P * DIST_N} ranks {how}): wall {max(walls):.1f} "
            f"ms; in collectives {[round(t, 1) for t in tr]} ms")
    say(f"phase 6 rank_engine ({POD_P} x {DIST_N} ranks {how}): "
        f"{max(r['engine_ms'] for r in rounds):.1f} ms for {rounds[0]['engine_steps']} steps "
        f"({max(r['engine_ms'] for r in rounds) / rounds[0]['engine_steps']:.2f} ms a step); "
        f"the one-card engine {one_engine_ms:.1f} ms for {one_steps}; peaks "
        f"{[round(r['peak'] / 1e9, 2) for r in rounds]} GB a rank")
    spans = lead["spans"]
    step_s = sum(b - a for a, b in spans)
    say(f"phase 6 rank_broker ({DIST_N} ranks {how}): wall {t_end - t0_:.3f} s = upload "
        f"{(t_up - t0_) - overlap(spans, t0_, t_up):.3f} s of {lead['sent'] / 1e9:.3f} GB "
        f"sent + {len(spans)} lead steps {step_s:.3f} s ({step_s / len(spans) * 1e3:.1f} ms a "
        f"step: metadata broadcast, rows scattered, engine step, each to a synchronise) + "
        f"the rest {(t_end - t0_) - (t_up - t0_) - overlap(spans, t_up, t_end):.3f} s "
        f"(download and waits); peaks {[round(r['broker_peak'] / 1e9, 3) for r in served]} GB "
        f"a rank (rank 0 first)")
    for i in range(2):
        walls = [r["step_ms"][i] for r in steps_]
        tr = [r["step_transport_ms"][i] for r in steps_]
        say(f"phase 6 pod train step {i + 1} ({POD_P * POD_STEP_N} ranks {how}): wall "
            f"{max(walls):.1f} ms; in collectives {[round(t, 1) for t in tr]} ms, transport "
            f"share {[f'{t / w:.0%}' for t, w in zip(tr, walls)]}")
    say(f"phase 6 pod fedavg ({POD_P * POD_STEP_N} ranks {how}): round wall "
        f"{max(r['fedavg_ms'] for r in steps_):.1f} ms; peaks train step "
        f"{[round(r['train_peak'] / 1e9, 2) for r in steps_]} GB a rank, FedAvg "
        f"{[round(r['fedavg_peak'] / 1e9, 2) for r in steps_]} GB")


def pe_config(experts=POD_EP_EXPERTS, n=POD_STEP_N):
    """pod_ep's configuration: the EP path's, its experts over ``n``
    learners, ``experts`` of them."""
    import dataclasses
    cfg = ep_config()
    return dataclasses.replace(cfg, ep_ranks=n,
                               moe=dataclasses.replace(cfg.moe, num_experts=experts))


def pe_run(dev, cfg, mesh=None, rank=None, on_step=None, on_init=None, mode="safe",
           repeat=False):
    """Two pod EP train steps of ``cfg`` from seed SEED (learner DIST_DEAD
    of each pod dead in the second), each pod's learners on tokens of
    their own, a new batch a step as moe_dist's or, with ``repeat``, the
    first step's again (the losses then fall, as the train-step path's
    do): on one card (``mesh`` None: tokens [P·n, B, S], every expert
    local) or global rank ``rank``'s step over the ('pod', 'data')
    ``mesh`` on its E/n experts. ``on_init(state)`` sees the initial state and
    ``on_step(when, i, state)`` each step's start and end. Returns
    (losses, state, bundle)."""
    from repro_torch.core import make_aggregator
    from repro_torch.data import make_federated_batches
    from repro_torch.dist import rank_world
    from repro_torch.models import Model
    from repro_torch.train import make_train_step
    n, rows = cfg.ep_ranks, POD_P * cfg.ep_ranks
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED),
                  ep_world=None if mesh is None else rank_world(mesh, "data"))
    agg = make_aggregator(mode, n, pod_axis="pod", device=dev)
    bundle = make_train_step(model, agg, mesh, lr=TS_LR, pod_axis="pod")
    state = bundle.init_state_fn(model.tree())
    del model
    if on_init:
        on_init(state)
    stream = make_federated_batches(cfg, rows, TS_B, TS_S, seed=SEED)
    losses = []
    for i, alive in enumerate((np.ones(n, np.float32), pod_alive(n))):
        toks = stream.global_batch(0 if repeat else i)["tokens"]
        toks = torch.from_numpy(toks if mesh is None else toks[rank]).to(dev)
        counter = agg.reserve_round(bundle.padded_size + 2)
        if on_step:
            on_step("start", i, state)
        state, m = bundle.step_fn(state, toks, counter=counter, alive=alive)
        losses.append(float(m["loss"]))
        if on_step:
            on_step("end", i, state)
    return losses, state, bundle


def pe_state_digest(state):
    """sha256 of a train state's expert leaves and their AdamW m and v."""
    from repro_torch.train.flatten import leaves
    return digest(*ep_experts(state), *leaves(state["ep_opt"].m), *leaves(state["ep_opt"].v))


def _pod_ep_rank(world, out_dir):
    """One of pod_ep's POD_P x POD_STEP_N ranks: its two steps with their
    collectives timed and, after each, the digest of its expert shards and
    their m and v; pod 0's ranks write their master slice and expert shards
    to ``out_dir`` for the parent."""
    import torch.distributed as dist

    from repro_torch.dist import collectives, rank_world
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_pod_mesh
    dev = world.device
    mesh = make_pod_mesh(POD_P, POD_STEP_N)
    pod = rank_world(mesh, "pod")
    out = {"step_ms": [], "step_transport_ms": [], "digests": []}
    clock = {}

    def on_step(when, i, state):
        sync()
        if when == "start":
            dist.barrier()
            collectives.reset_stats(timed=True)
            clock["t0"] = time.perf_counter()
            return
        out["step_ms"].append((time.perf_counter() - clock["t0"]) * 1e3)
        out["step_transport_ms"].append(collectives.stats["seconds"] * 1e3)
        if i == 0:
            out["step1_peak"] = torch.cuda.max_memory_allocated(dev) - base
        out["digests"].append(pe_state_digest(state))
    build.reset_launches()
    warm_cublas(dev)  # cuBLAS's workspaces
    sync()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out["losses"], state, bundle = pe_run(dev, pe_config(), mesh, world.rank, on_step)
    collectives.reset_stats()
    out["launches"] = dict(build.launches)
    out["peak"] = torch.cuda.max_memory_allocated(dev) - base
    out["padded_size"], out["master_words"] = bundle.padded_size, state["master"].numel()
    out["expert_shape"] = [tuple(t.shape) for t in ep_experts(state)]
    if pod.rank == 0:
        torch.save({"master": state["master"].cpu(),
                    "experts": [t.cpu() for t in ep_experts(state)]},
                   os.path.join(out_dir, f"pe_rank{world.rank}.pt"))
    del state, bundle
    sync()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def pe_dryrun(cfg=None, mode="safe"):
    """The dry run's rank 0 of pod_ep's layout (meta tensors), or of
    ``cfg``'s (its ``ep_ranks`` learners a pod): its record."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    cfg = cfg or pe_config()
    n = cfg.ep_ranks
    try:
        return dryrun.measure(cfg, "train_4k", shape=dict(
            seq_len=TS_S, global_batch=POD_P * n * TS_B, kind="train"),
            learners=n, batch=TS_B, per_rank=True, pods=POD_P, aggregator_mode=mode)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def pod_ep_path(dev, launches, err, smi):
    """Expert parallelism with pods (pod_ep): POD_P x POD_STEP_N spawned
    ranks sharing the card, each with its E/n experts summed over its pod
    group, against the one-process pod EP step from the same seed and
    tokens; the pods' expert state word for word equal; rank 0's peak
    against the dry run's; adds the ranks' launches to ``launches``."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.train import tree_size
    t0 = time.perf_counter()
    pred = pe_dryrun()
    dry_s = time.perf_counter() - t0
    cfg = pe_config()
    size = POD_P * POD_STEP_N
    how = (f"{POD_P} pods x {POD_STEP_N} learners = {size} ranks sharing "
           f"{torch.cuda.device_count()} card ({smi}), gloo through pinned host buffers")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pe_") as tmp:
        t0 = time.perf_counter()
        keep = {}

        def first(state):
            keep["master0"] = state["master"].to("cpu", copy=True)
            keep["experts0"] = [t.to("cpu", copy=True) for t in ep_experts(state)]
        losses, state, bundle = pe_run(dev, cfg, on_init=first)
        master0, experts0 = keep.pop("master0"), keep.pop("experts0")
        one_s = time.perf_counter() - t0
        P = tree_size(state["params"])
        want_m = state["master"].to("cpu", copy=True)
        want_e = [t.to("cpu", copy=True) for t in ep_experts(state)]
        del state, bundle
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks(_pod_ep_rank, size, (tmp,))
        ranks_s = time.perf_counter() - t0
        n_loc = ranks[0]["expert_shape"][0][1]
        L = ranks[0]["padded_size"] // POD_STEP_N
        got_m, got_e, ref_m, ref_e, base_m, base_e = [], [], [], [], [], []
        for r in range(POD_STEP_N):  # pod 0's ranks
            part = torch.load(os.path.join(tmp, f"pe_rank{r}.pt"))
            got_m.append(part["master"])
            ref_m.append(want_m[r * L:(r + 1) * L])
            base_m.append(master0[r * L:(r + 1) * L])
            for x, y, z in zip(part["experts"], want_e, experts0):
                got_e.append(x)
                ref_e.append(y[:, r * n_loc:(r + 1) * n_loc])
                base_e.append(z[:, r * n_loc:(r + 1) * n_loc])
            del part
        e_master = _rel(got_m, ref_m, base_m, dev)
        e_experts = _rel(got_e, ref_e, base_e, dev)
        del got_m, got_e, ref_m, ref_e, base_m, base_e, want_m, want_e, master0, experts0
        torch.cuda.empty_cache()
    counts = {k: sum(r["launches"][k] for r in ranks) for k in DIST_KERNELS}
    padded = ranks[0]["padded_size"]
    t1 = time.perf_counter()
    kerr, checks = check_dist_kernels(dev, (padded,), err, rounds=False)
    full = get_config(EP_ARCH)
    cut = ", ".join(f"{k} {getattr(full, k)} -> {v}" for k, v in EP_CUT.items()
                    if k in ("n_layers", "vocab"))
    say(f"phase 4 main path pod_ep ({how}): {EP_ARCH} at full width, reduced: {cut}, "
        f"num_experts {full.moe.num_experts} -> {cfg.moe.num_experts} (two pods' copies of "
        f"{full.moe.num_experts} experts do not fit one card beside the rest); {P} parameters, "
        f"padded_size {padded}, {n_loc} of {cfg.moe.num_experts} experts a rank (shapes "
        f"{ranks[0]['expert_shape']}), their gradients summed over the pod group; 2 EP train "
        f"steps (learner {DIST_DEAD} of each pod dead in the second), {TS_B} x {TS_S} tokens a "
        f"learner a step, each pod's its own; {ranks_s:.1f} s spawned, {one_s:.1f} s for the "
        f"one-process pod EP step; launches summed over the ranks {counts}; the kernels at V = "
        f"padded_size == plain: {checks} comparisons in {time.perf_counter() - t1:.1f} s, max "
        f"|err| {kerr}")
    missing = sorted(k for k in PATH_KERNELS["pod_ep"] if counts[k] <= 0)
    if missing:
        fail(f"path pod_ep never launched {missing} in its ranks: {counts}")
    for k, c in counts.items():
        launches[k] += c

    problems = []
    rank_losses = ranks[0]["losses"]
    if any(r["losses"] != rank_losses for r in ranks):
        problems.append(f"pod_ep: the ranks' losses differ: {[r['losses'] for r in ranks]}")
    same = [all(ranks[l]["digests"][i] == ranks[p * POD_STEP_N + l]["digests"][i]
                for l in range(POD_STEP_N) for p in range(1, POD_P)) for i in range(2)]
    if not all(same):
        problems.append(f"pod_ep: a pod's expert shards or their m and v differ from pod 0's "
                        f"(after each step: {same})")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(rank_losses, losses))
    floats = (f"losses {[round(x, 5) for x in rank_losses]} against the one-process pod EP "
              f"step's {[round(x, 5) for x in losses]} (relative {loss_err:.3g}, bound "
              f"{EP_LOSS_RTOL}); relative L2 of the change over 2 steps: the SAFE partition's "
              f"f32 master {e_master:.3g} (bound {EP_MASTER_REL}), the bf16 expert shards "
              f"{e_experts:.3g} (bound {EP_EXPERT_REL})")
    if not (np.isfinite(rank_losses).all() and loss_err <= EP_LOSS_RTOL
            and e_master <= EP_MASTER_REL and e_experts <= EP_EXPERT_REL):
        problems.append(f"pod_ep: against the one-process pod EP step: {floats}")
    if any(r["master_words"] * POD_STEP_N != padded for r in ranks):
        problems.append("pod_ep: a rank's master vector is not padded_size / n words")
    p, r = pred["peak_bytes"], ranks[0]["step1_peak"]
    dry = (f"rank 0's first step: dry run (--per-rank, {POD_P} pods) {p / 1e9:.3f} GB against "
           f"max_memory_allocated {r / 1e9:.3f} GB, off by {abs(p - r) / r:.2%}")
    if abs(p - r) / r > DRY_TOL:
        problems.append(f"pod_ep {dry}, over {DRY_TOL:.0%}")
    say(f"phase 5 pod_ep: each pod's expert shards and their AdamW m and v torch.equal (sha256) "
        f"to pod 0's after each step: {same}; {floats}; {dry} (bound {DRY_TOL:.0%}, "
        f"{dry_s:.1f} s on meta tensors)")
    for i in range(2):
        walls = [x["step_ms"][i] for x in ranks]
        tr = [x["step_transport_ms"][i] for x in ranks]
        say(f"phase 6 pod_ep train step {i + 1} ({how}): wall {max(walls):.1f} ms; in "
            f"collectives {[round(t, 1) for t in tr]} ms, transport share "
            f"{[f'{t / w:.0%}' for t, w in zip(tr, walls)]}")
    say(f"phase 6 pod_ep peak memory ({how}): {[round(x['peak'] / 1e9, 2) for x in ranks]} GB a "
        f"rank allocated (the dry run's rank 0 {p / 1e9:.2f} GB, by category "
        f"{json.dumps({k: round(v / 1e9, 3) for k, v in pred['peak_by_category'].items()})})")
    if problems:
        fail(" | ".join(problems))


def nccl_rounds_rank():
    """One rank of ``--nccl4``'s rounds under ``torch.distributed.run``, a
    card each over NCCL: each round of DIST_ROUNDS through
    ``aggregate_rank`` against one process's ``aggregate`` of the stacked
    rows on this rank's card."""
    import torch.distributed as dist

    from repro_torch.core import make_aggregator
    from repro_torch.dist import close_world, collectives, init_world
    world = init_world()
    dev, r = world.device, world.rank
    values = torch.stack([dist_row(dev, q) for q in range(world.size)])
    for name in DIST_ROUNDS:
        mode, akw, kw, dead = dist_round_args(name, r)
        row = torch.full_like(values[0], float("nan")) if dead else values[r]
        w = kw.pop("weights", None)
        agg = make_aggregator(mode, world.size, device=dev, **akw)
        dist.barrier()
        sync()
        collectives.reset_stats(timed=True)
        t0 = time.perf_counter()
        got = agg.aggregate_rank(row, 2**32 - 5, weights=w, world=world, **kw)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        mode, akw, kw, _ = dist_round_args(name)
        v = values.clone()
        if "alive" in kw:
            v[torch.from_numpy(kw["alive"] == 0).to(dev)] = float("nan")
        want = make_aggregator(mode, world.size, device=dev, **akw).aggregate(v, 2**32 - 5, **kw)
        if not torch.equal(got, want):
            fail(f"rank {r}: the nccl round {name} differs from one process's")
        say(f"nccl rank {r} round {name}: torch.equal to one process's; wall {ms:.2f} ms, in "
            f"collectives {collectives.stats['seconds'] * 1e3:.2f} ms")
    close_world()


def nccl_pod_rank():
    """One rank of ``--nccl4``'s pod and engine checks under
    ``torch.distributed.run``, a card each over NCCL, each against one
    process's on this rank's card: the pod rounds of the modes whose rings
    take two learners (BON, INSEC) at 2 pods x 2 learners and V_MAIN words
    a rank; the per-rank engine over the four ranks, then its sessions over
    the wire (``serve_rank_engine``: rank 0's broker in front of an
    ``EngineLead``, the rows scattered over NCCL); and two BON pod train
    steps of internlm2-1.8b at DIST_LAYERS layers."""
    import torch.distributed as dist

    from repro_torch.core import make_aggregator
    from repro_torch.dist import close_world, collectives, init_world, rank_world
    from repro_torch.launch.mesh import make_pod_mesh
    world = init_world()
    dev, r, n = world.device, world.rank, 2
    mesh = make_pod_mesh(POD_P, n)
    data, pod = rank_world(mesh, "data"), rank_world(mesh, "pod")
    values = torch.stack([dist_row(dev, g) for g in range(POD_P * n)]).view(POD_P, n, V_MAIN)
    for name, akw, kw in (("bon", {}, {}), ("insec", {}, {"weights": pod_weights()[:, :n]})):
        agg = make_aggregator(name, n, pod_axis="pod", device=dev, **akw)
        dist.barrier()
        sync()
        collectives.reset_stats(timed=True)
        t0 = time.perf_counter()
        got = agg.aggregate_rank(values[pod.rank, data.rank], 2**32 - 5, world=data,
                                 pod_world=pod, **kw)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        want = agg.aggregate(values, 2**32 - 5, **kw)
        if not torch.equal(got, want):
            fail(f"rank {r}: the nccl pod round {name} differs from one process's")
        say(f"nccl rank {r} pod round {name} (2 x 2): torch.equal to one process's [2, 2, V]; "
            f"wall {ms:.2f} ms, in collectives {collectives.stats['seconds'] * 1e3:.2f} ms")
    collectives.reset_stats()
    del values
    got, steps_, ms = run_engine(dev, world)
    want = run_engine(dev)[0]
    if got != want:
        fail(f"rank {r}: the nccl per-rank engine differs from one process's")
    say(f"nccl rank {r} engine: {len(got)} sessions torch.equal to the one-card engine's; "
        f"{ms:.1f} ms for {steps_} steps")
    res = serve_rank_engine(dev, world)
    box = [res.get("sids")]
    dist.broadcast_object_list(box, src=0)   # rank 0's session id of each tenant
    if r == 0 and (res["errors"] or res["digests"] != want):
        fail(f"rank 0: the nccl broker's tenants differ from the one-card engine's, or a step "
             f"raised ({res['errors']})")
    if r and [res["digests"].get(sid) for sid in box[0]] != want:
        fail(f"rank {r}: the sessions it followed, by rank 0's session ids, differ from the "
             f"one-card engine's")
    say(f"nccl rank {r} broker: {len(want)} sessions served over the wire through the "
        f"EngineLead, {'the tenants' if r == 0 else 'the sessions followed, by id,'} "
        f"torch.equal to the one-card engine's; {res['steps']} steps")
    model, steps, _ = pod_model(dev, DIST_LAYERS, n)
    t0 = time.perf_counter()
    got = pod_train(model, steps, mesh, r, n=n, mode="bon")
    ms = (time.perf_counter() - t0) * 1e3
    del model
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev)
    want = pod_train(pod_model(dev, DIST_LAYERS, n)[0], steps, n=n, mode="bon")
    if got != want:
        fail(f"rank {r}: the nccl pod train step differs from one process's")
    say(f"nccl rank {r} pod train step (BON, 2 x 2, {DIST_LAYERS} layers): parameters word for "
        f"word one process's; losses {[round(x, 4) for x in got[1]]}; 2 steps in {ms:.1f} ms "
        f"with set-up; peak {peak / 1e9:.2f} GB")
    close_world()


def nccl_pod_ep_rank():
    """One rank of ``--nccl4-moe``'s expert parallelism with pods under
    ``torch.distributed.run``, a card each over NCCL: POD_P pods x
    NCCL_PE_N learners, BON (a ring of two learners runs no SAFE), the EP
    path's model with all its experts (E/n a rank), two steps on the
    first step's tokens (learner DIST_DEAD of each pod dead in the
    second). Prints one JSON line: the losses, the digest of its expert
    shards and their m and v after each step, its peaks and step walls."""
    import torch.distributed as dist

    from repro_torch.dist import close_world, init_world
    from repro_torch.launch.mesh import make_pod_mesh
    world = init_world()
    dev, r = world.device, world.rank
    mesh = make_pod_mesh(POD_P, NCCL_PE_N)
    out = {"rank": r, "step_ms": [], "digests": []}
    clock = {}

    def on_step(when, i, state):
        sync()
        if when == "start":
            dist.barrier()
            clock["t0"] = time.perf_counter()
            return
        out["step_ms"].append(round((time.perf_counter() - clock["t0"]) * 1e3, 1))
        if i == 0:
            out["step1_peak"] = torch.cuda.max_memory_allocated(dev) - base
        out["digests"].append(pe_state_digest(state))
    warm_cublas(dev)  # cuBLAS's workspaces
    sync()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = pe_config(ep_config().moe.num_experts, NCCL_PE_N)
    out["losses"], state, _ = pe_run(dev, cfg, mesh, r, on_step, mode="bon", repeat=True)
    out["peak"] = torch.cuda.max_memory_allocated(dev) - base
    out["expert_shape"] = [tuple(t.shape) for t in ep_experts(state)]
    del state
    say("nccl pod ep rank " + json.dumps(out))
    close_world()


def nccl_pod_ep(run, env, smi, cards):
    """``--nccl4-moe``'s expert parallelism with pods: ``nccl_pod_ep_rank``
    on four cards; the pods' expert state word for word equal after each
    step, the losses falling, each rank's first-step peak within DRY_TOL
    of the dry run's record of the layout."""
    t0 = time.perf_counter()
    cfg = pe_config(ep_config().moe.num_experts, NCCL_PE_N)
    pred = pe_dryrun(cfg, "bon")
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(run + [os.path.join(ROOT, "chip_smoke.py"), "--nccl-pod-ep-rank"],
                          env=dict(env, PYTORCH_CUDA_ALLOC_CONF=DIST_ALLOC_CONF),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"nccl pod ep: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    tag = "nccl pod ep rank "
    ranks = sorted((json.loads(line[len(tag):]) for line in proc.stdout.splitlines()
                    if line.startswith(tag)), key=lambda x: x["rank"])
    if len(ranks) != POD_P * NCCL_PE_N:
        fail(f"nccl pod ep: {len(ranks)} ranks reported")
    same = [all(ranks[l]["digests"][i] == ranks[p * NCCL_PE_N + l]["digests"][i]
                for l in range(NCCL_PE_N) for p in range(1, POD_P)) for i in range(2)]
    losses = ranks[0]["losses"]
    p = pred["peak_bytes"]
    off = [abs(p - x["step1_peak"]) / x["step1_peak"] for x in ranks]
    line = (f"nccl pod ep ({smi.splitlines()[0]} x{cards}, nccl, a card a rank): {EP_ARCH} at "
            f"full width, {cfg.n_layers} layer, vocab {cfg.vocab}, all {cfg.moe.num_experts} "
            f"experts ({ranks[0]['expert_shape'][0][1]} a rank, shapes "
            f"{ranks[0]['expert_shape']}), BON, {POD_P} pods x {NCCL_PE_N} learners, 2 steps on "
            f"one batch (learner {DIST_DEAD} of each pod dead in the second) in {wall:.1f} s "
            f"with start-up; step walls {[x['step_ms'] for x in ranks]} ms; losses "
            f"{[round(x, 5) for x in losses]}; the pods' expert shards and their m and v "
            f"torch.equal (sha256) after each step: {same}; first-step peaks "
            f"{[round(x['step1_peak'] / 1e9, 3) for x in ranks]} GB a rank against the dry "
            f"run's rank 0 {p / 1e9:.3f} GB ({dry_s:.1f} s on meta tensors), off by "
            f"{[f'{o:.2%}' for o in off]}; peaks {[round(x['peak'] / 1e9, 2) for x in ranks]} GB")
    say(line)
    if any(x["losses"] != losses for x in ranks):
        fail(f"nccl pod ep: the ranks' losses differ: {[x['losses'] for x in ranks]}")
    if not all(same) or not losses[1] < losses[0] or not np.isfinite(losses).all():
        fail(f"nccl pod ep: the pods' expert state differs, or the losses do not fall: {line}")
    if max(off) > DRY_TOL:
        fail(f"nccl pod ep: a rank's peak is off the dry run's by more than {DRY_TOL:.0%}")


def nccl_moe_layers():
    """The most layers of qwen3-moe (full vocabulary) whose per-rank step the
    dry run says fits a card, one learner a rank of DIST_N: (layers, the
    record)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_config(EP_ARCH), ep_axis="data", ep_ranks=DIST_N)
    shape = dict(seq_len=TS_S, global_batch=DIST_N * TS_B, kind="train")
    kw = dict(shape=shape, learners=DIST_N, batch=TS_B, per_rank=True)
    full = dryrun.measure(cfg, "train_4k", **kw)["peak_bytes"]
    fit = dryrun.max_units_that_fit(cfg, "train_4k", dryrun.H100_USABLE_BYTES, full, **kw)
    return fit["max_layers_that_fit"], fit


def nccl_setup():
    """(cards, nvidia-smi lines, environment, torch.distributed.run command)
    of a four-card run, the kernels built once before the ranks."""
    cards = torch.cuda.device_count()
    if cards < 4:
        fail(f"--nccl4 needs four cards, torch sees {cards}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(smi.replace("\n", " | "))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4"]
    from repro_torch.kernels import build
    build.build()
    return cards, smi, env, run


def nccl_paths():
    """``python3 chip_smoke.py --nccl4``, on a host with four cards: the
    dist rounds over NCCL, a card a rank, the pod rounds, engine, the engine
    behind the broker and pod step, then the training launcher under ``torch.distributed.run`` at
    internlm2-1.8b's full 24 layers (a card a rank, NCCL_STEPS steps) and
    the MoE (``nccl_moe``); each rank's peak memory and the steps' walls."""
    import tempfile
    cards, smi, env, run = nccl_setup()
    t0 = time.perf_counter()
    proc = subprocess.run(run + [os.path.join(ROOT, "chip_smoke.py"), "--nccl-rank"], env=env,
                          capture_output=True, text=True, timeout=600)
    say("\n".join(line for line in proc.stdout.splitlines() if line.startswith("nccl rank")))
    if proc.returncode != 0:
        fail(f"nccl rounds: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    say(f"nccl rounds: {time.perf_counter() - t0:.1f} s ({smi.splitlines()[0]} x{cards})")
    t0 = time.perf_counter()
    proc = subprocess.run(run + [os.path.join(ROOT, "chip_smoke.py"), "--nccl-pod-rank"], env=env,
                          capture_output=True, text=True, timeout=900)
    say("\n".join(line for line in proc.stdout.splitlines() if line.startswith("nccl rank")))
    if proc.returncode != 0:
        fail(f"nccl pods and engine: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    say(f"nccl pods and engine: {time.perf_counter() - t0:.1f} s ({smi.splitlines()[0]} x{cards})")
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "m.jsonl")
        t0 = time.perf_counter()
        proc = subprocess.run(run + ["-m", "repro_torch.launch.train", "--arch", TS_ARCH,
                                     "--steps", str(NCCL_STEPS), "--model-shards", "1",
                                     "--metrics", metrics],
                              env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        say("\n".join(line for line in lines if "rank" in line or line.startswith("done")))
        if proc.returncode != 0:
            fail(f"nccl launcher: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        recs = [json.loads(line) for line in open(metrics) if line.strip()]
    times = [r["time"] for r in recs]
    steps = [round((b - a) * 1e3, 1) for a, b in zip(times, times[1:])]
    say(f"nccl launcher ({smi.splitlines()[0]} x{cards}, nccl, a card a rank): {TS_ARCH} at 24 "
        f"layers, {NCCL_STEPS} steps in {wall:.1f} s with start-up; losses "
        f"{[round(r['loss'], 4) for r in recs]}; steps 2.. wall {steps} ms (rank 0's metrics)")
    nccl_moe(run, env, smi, cards)


def nccl_moe(run, env, smi, cards):
    """``--nccl4``'s MoE: expert parallelism with pods (``nccl_pod_ep``);
    the smoke MoE through the launcher with a
    checkpoint every step and a run resumed from step 1, whose step-2
    checkpoint must equal the uninterrupted run's word for word; then
    qwen3-moe with its full vocabulary, a card a rank, at the most layers
    the dry run's per-rank step says fit a card (expert parallelism over the
    four ranks, E/4 experts each), a layer less should that not run."""
    import gzip
    import shutil
    import tempfile

    from repro_torch.launch.dryrun import H100_USABLE_BYTES
    nccl_pod_ep(run, env, smi, cards)
    with tempfile.TemporaryDirectory() as tmp:
        smoke = ["-m", "repro_torch.launch.train", "--arch", EP_ARCH, "--smoke", "--steps", "2",
                 "--model-shards", "1", "--ckpt-every", "1", "--ckpt-dir"]
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        for where, before in ((a, None), (b, a)):
            if before:
                shutil.copytree(before, where)
                shutil.rmtree(os.path.join(where, "step_00000002"))
            proc = subprocess.run(run + smoke + [where], env=env, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                fail(f"nccl moe resume: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        same = all(gzip.open(os.path.join(a, "step_00000002", f)).read()
                   == gzip.open(os.path.join(b, "step_00000002", f)).read()
                   for f in ("buffers.bin.gz", "manifest.msgpack.gz"))
        if "resumed from step 1" not in proc.stdout or not same:
            fail("nccl moe resume: the resumed run's step 2 differs from the uninterrupted run's")
        say("nccl moe resume (smoke, nccl): the run resumed from step 1 wrote step 2 word for "
            "word as the uninterrupted run did (full-E checkpoint)")

        t0 = time.perf_counter()
        layers, fit = nccl_moe_layers()
        say(f"nccl moe dry run: {EP_ARCH} (full vocabulary) one learner a rank of {DIST_N}, "
            f"rank 0's step: {fit['bytes_at_1_unit'] / 1e9:.2f} GB at 1 layer + "
            f"{fit['bytes_per_unit'] / 1e9:.2f} GB a layer; {layers} layers fit "
            f"{H100_USABLE_BYTES / 1e9:.1f} GB ({time.perf_counter() - t0:.1f} s)")
        metrics = os.path.join(tmp, "m.jsonl")
        env = dict(env, PYTORCH_CUDA_ALLOC_CONF=DIST_ALLOC_CONF)
        for attempt in range(2):  # should the dry run's verdict not hold, say so, a layer less
            t0 = time.perf_counter()
            # its own session, so that a hang ends with every rank of it
            proc = subprocess.Popen(
                run + ["-m", "repro_torch.launch.train", "--arch", EP_ARCH, "--n-layers",
                       str(layers), "--steps", str(NCCL_STEPS), "--model-shards", "1",
                       "--metrics", metrics],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                start_new_session=True)
            try:
                out, err_text = proc.communicate(timeout=NCCL_MOE_TIMEOUT_S)
                rc = proc.returncode
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)
                out, err_text = proc.communicate()
                rc = "timeout"
            wall = time.perf_counter() - t0
            say("\n".join(line for line in out.splitlines()
                          if "rank" in line or line.startswith("done")))
            if rc == 0:
                break
            why = sorted({line.strip()[-300:] for line in err_text.splitlines()
                          if "Error" in line or "out of memory" in line})[:8]
            say(f"nccl moe launcher: {layers} layers did not run on a card a rank against the "
                f"dry run's verdict (rc {rc} after {wall:.1f} s): {why}; {err_text[-800:]}")
            layers -= 1
        if rc != 0 or layers < 1:
            fail(f"nccl moe launcher: rc {rc}")
        recs = [json.loads(line) for line in open(metrics) if line.strip()]
    times = [r["time"] for r in recs]
    steps = [round((b - a) * 1e3, 1) for a, b in zip(times, times[1:])]
    say(f"nccl moe launcher ({smi.splitlines()[0]} x{cards}, nccl, a card a rank): {EP_ARCH} at "
        f"{layers} layers, full vocabulary, {NCCL_STEPS} steps in {wall:.1f} s with start-up; "
        f"losses {[round(r['loss'], 4) for r in recs]}; steps 2.. wall {steps} ms (rank 0's "
        "metrics)")



# ---- the 'model' axis across ranks: tensor parallelism and sharded chains ---------

def tp_model(dev, layers, tp=None):
    """internlm2-1.8b at full width and ``layers`` layers from seed SEED (the
    one-card model, or model rank tp.rank's shards of it: the same
    generator draws), and the tp path's tokens: the train steps' [2, n, B,
    S] and the FedAvg round's [n, k, B, S]."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(TS_ARCH), n_layers=layers)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED),
                  tp_world=tp)
    stream = make_federated_batches(cfg, TP_N, TS_B, TS_S, seed=SEED)
    steps = np.stack([stream.global_batch(i)["tokens"] for i in range(2)])
    fed = np.stack([np.stack([stream.learner_batch(l, 10 + k)["tokens"] for k in range(DIST_K)])
                    for l in range(TP_N)])
    return model, steps, fed


def tp_shape():
    return dict(seq_len=TS_S, global_batch=TP_N * TS_B, kind="train")


def _tp_rank(world, layers):
    """One rank of the tp_dist path (spawned), learner l's model shard j of
    the TP_N x TP_M grid: the rounds on chunk j of learner l's row; two
    TP train steps of the model at ``layers`` layers (learner DIST_DEAD dead
    in the second) and a weighted FedAvg round, through the entry points;
    the launch counts read after them. Then, outside the timed parts, the
    ZeRO-1 check's gathers to global rank 0: the published means, the
    initial and final master vector and moments (rank 0 runs the one-card
    FlatAdamW on them) and the full leaves."""
    import torch.distributed as dist

    from repro_torch.core import make_aggregator
    from repro_torch.dist import collectives, grid_worlds
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import AdamState, FlatAdamW
    from repro_torch.train import make_federated_round, make_train_step
    from repro_torch.train.flatten import leaves
    dev = world.device
    ring, tp = grid_worlds(world, TP_M)
    l, j = ring.rank, tp.rank
    out = {"rounds": {}, "round_ms": {}, "round_transport_ms": {}, "step_ms": [],
           "step_transport_ms": [], "losses": []}
    build.reset_launches()
    L = V_MAIN // TP_M
    x = dist_row(dev, l)[j * L:(j + 1) * L].clone()
    for name in DIST_ROUNDS:
        mode, akw, kw, dead = dist_round_args(name, l)
        agg = make_aggregator(mode, TP_N, device=dev, **akw)
        row = torch.full_like(x, float("nan")) if dead else x
        w = kw.pop("weights", None)
        dist.barrier()
        sync()
        collectives.reset_stats(timed=True)
        t0 = time.perf_counter()
        mean = agg.aggregate_rank(row, 2**32 - 5, weights=w, world=ring, model_world=tp, **kw)
        sync()
        out["round_ms"][name] = (time.perf_counter() - t0) * 1e3
        out["round_transport_ms"][name] = collectives.stats["seconds"] * 1e3
        out["rounds"][name] = digest(mean)
        del mean
    collectives.reset_stats()
    del x, row
    torch.cuda.empty_cache()

    # the train steps; the memory above what the rank held before the model,
    # cuBLAS's workspaces already allocated (the dry run does not count them)
    warm_cublas(dev)
    sync()
    base = torch.cuda.memory_allocated(dev)
    model, steps, fed = tp_model(dev, layers, tp)
    agg = make_aggregator("safe", TP_N, device=dev)
    published = []
    aggregate_rank = agg.aggregate_rank

    def record(*args, **kw):  # the published chunk, to the host (learner 0's ranks)
        mean = aggregate_rank(*args, **kw)
        if l == 0:
            published.append(mean.to("cpu", copy=True))
        return mean

    agg.aggregate_rank = record
    bundle = make_train_step(model, agg, ring, lr=TS_LR)
    state = bundle.init_state_fn(model.tree())
    layout = model.shard_layout()
    master0 = state["master"].to("cpu", copy=True)
    out["padded_size"], out["sec_size"] = bundle.padded_size, bundle.sec_size
    out["master_words"] = state["master"].numel()
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    for i, alive in enumerate((np.ones(TP_N, np.float32), dist_alive())):
        toks = torch.from_numpy(steps[i][l]).to(dev)
        counter = agg.reserve_round(bundle.padded_size + 2)
        dist.barrier()
        sync()
        collectives.reset_stats(timed=True)
        t0 = time.perf_counter()
        state, m = bundle.step_fn(state, toks, counter=counter, alive=alive)
        sync()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["step_transport_ms"].append(collectives.stats["seconds"] * 1e3)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["step1_peak"] = torch.cuda.max_memory_allocated(dev) - base
    collectives.reset_stats()
    out["train_peak"] = torch.cuda.max_memory_allocated(dev) - base
    out["train_reserved"] = torch.cuda.max_memory_reserved(dev)
    launches = dict(build.launches)

    # ZeRO-1 word for word: the one-card FlatAdamW on the published means
    gathered = {k: collectives.gather_to_host(state[k], 0, world) for k in ("master", "fm", "fv")}
    gathered["master0"] = collectives.gather_to_host(master0.to(dev), 0, world)
    means = [collectives.gather_to_host(p.to(dev), 0, tp) for p in published] if l == 0 else []
    out["train_leaves"] = tp_full_leaves(state["params"], model, ring, tp)
    if world.rank == 0:
        flat = {k: v.view(TP_N, TP_M, -1).transpose(0, 1).reshape(-1)
                for k, v in gathered.items()}
        master = flat["master0"].to(dev)
        zero = torch.zeros_like(master)
        opt, st = FlatAdamW(lr=TS_LR, weight_decay=0.1), AdamState(0, zero, zero.clone())
        for mean in means:
            master, st = opt.update(mean.to(dev), st, master, inplace=True)
        out["zero1"] = (digest(master, st.m, st.v),
                        digest(*(flat[k].to(dev) for k in ("master", "fm", "fv"))))
        out["rebuild"] = all(torch.equal(sh.of(master).to(p.dtype), p)
                             for sh, p in zip(layout, leaves(state["params"])))
        del master, zero, st
    del gathered, means, published, model, state
    torch.cuda.empty_cache()

    # the FedAvg round
    model = tp_model(dev, layers, tp)[0]
    agg = make_aggregator("safe", TP_N, weighted=True, device=dev)
    bundle = make_federated_round(model, agg, ring, local_steps=DIST_K, local_lr=FED_LR,
                                  return_delta=True)
    counter = agg.reserve_round(bundle.padded_size + 1)
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    params, m = bundle.round_fn(model.tree(), torch.from_numpy(fed[l]).to(dev),
                                weights=DIST_WEIGHTS, counter=counter, alive=dist_alive())
    sync()
    out["fedavg_ms"] = (time.perf_counter() - t0) * 1e3
    out["fedavg_peak"] = torch.cuda.max_memory_allocated(dev) - base
    out["fed_padded"] = bundle.padded_size
    out["launches"] = {k: launches[k] + build.launches[k] for k in launches}
    out["fed_loss"] = float(m["local_loss"])
    out["fed_delta"] = m["avg_delta"].cpu() if world.rank == 0 else None
    out["fed_leaves"] = tp_full_leaves(params, model, ring, tp)
    dist.barrier()
    return out


def warm_cublas(dev):
    """Allocate cuBLAS's workspaces before a peak is read: this thread's
    handle's, and that of the autograd engine's device thread, which runs a
    backward's products (the dry run counts neither: 32 MiB each on the H100)."""
    a = torch.ones(8, 8, device=dev, requires_grad=True)
    (a @ a).sum().backward()


def gathered_head(name):
    """The dry run's figure for layout ``name`` before the vocabulary-parallel
    loss, as a phrase."""
    return (f"the dry run with the gathered head (before the vocabulary-parallel loss) "
            f"{GATHERED_HEAD_PEAK[name] / 1e9:.3f} GB")


def tp_dryrun(layers, n, m, mode, arch=TS_ARCH):
    """The dry run's rank 0 of the n x m grid (meta tensors) for ``arch`` at
    ``layers`` layers: its record, the fake group it starts destroyed
    afterwards."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    try:
        return dryrun.measure(cfg, "train_4k", shape=dict(seq_len=TS_S, global_batch=n * TS_B,
                                                          kind="train"),
                              learners=n, batch=TS_B, per_rank=True, model_shards=m,
                              aggregator_mode=mode)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def check_tp_kernels(dev, chunks, err):
    """Each kernel at the tp path's chunks, against its plain version: for
    each (length, start word) mask_add and chain_combine at the counter
    base moved by start / 2 (== the pads from that word, ``offset``),
    bon_mask the same, and chain_combine_batched on the pipelined chunk's
    rows of seg words from start + s·seg. Folds the differences into
    ``err``; returns ({kernel: max |err|}, comparisons)."""
    from repro_torch.kernels import bon_mask as bm
    from repro_torch.kernels import chain_combine as cc
    from repro_torch.kernels import ref
    from repro_torch.kernels import threefry_mask_add as tma
    g = torch.Generator(device=dev).manual_seed(SEED + 300)
    rng = np.random.RandomState(SEED + 300)
    base = 2**32 - 5

    def keys(m):
        return rng.randint(0, 2**32, (m, 2), dtype=np.uint64).astype(np.uint32)

    got = {k: 0 for k in DIST_KERNELS}
    checks = 0
    for V, start in chunks:
        moved = (base + start // 2) & 0xFFFFFFFF
        x = torch.rand(V, generator=g, device=dev) * 4 - 2
        c = torch.randint(-2**31, 2**31, (V,), generator=g, device=dev,
                          dtype=torch.int32).view(torch.uint32)
        key, kin, kout = keys(1)[0], keys(1)[0], keys(1)[0]
        got["mask_add"] = max(got["mask_add"], u32_diff(
            tma.mask_add(x, key, moved), ref.mask_add_ref(x, key, base, offset=start)))
        got["chain_combine"] = max(got["chain_combine"], u32_diff(
            cc.chain_combine(c, x, kin, kout, moved),
            ref.chain_combine_ref(c, x, kin, kout, base, offset=start)))
        k = keys(TP_N)
        signs = [1, -1, 1, 1][:TP_N]
        got["bon_mask"] = max(got["bon_mask"], u32_diff(
            bm.bon_mask(x, k, signs, moved), ref.bon_mask_ref(x, k, signs, moved)))
        seg = -(-V // TP_N)
        for s in range(TP_N):
            n = min(seg, V - s * seg)
            if n <= 0:
                continue
            kin, kout = keys(1), keys(1)
            got["chain_combine_batched"] = max(got["chain_combine_batched"], u32_diff(
                cc.chain_combine_batched(c[None, :n], x[None, :n], kin, kout, [moved],
                                         starts=[s * seg]),
                ref.chain_combine_batched_ref(c[None, :n], x[None, :n], kin, kout, [moved],
                                              starts=[s * seg])))
        checks += 3 + TP_N
        del x, c
    sync()
    for k, v in got.items():
        err[k] = max(err[k], v)
    if any(got.values()):
        fail(f"a kernel differs from its plain version at the tp path's chunks: {got}")
    return got, checks


def tp_dist_path(dev, launches, err, smi):
    """The tp_dist path: the reference launcher's layout, TP_N learners x
    TP_M model shards = 8 spawned ranks sharing the card (``transport=
    "host"``), internlm2-1.8b at full width and TP_LAYERS layers, against
    the same work in this process on the card: the rounds' chunks and the
    ZeRO-1 update exactly, the TP steps' and the FedAvg round's float math
    within bounds; the dry run's rank 0 against the ranks' peaks; adds the
    ranks' launches to ``launches`` and the kernels' checks at the path's
    chunks to ``err``."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import make_federated_round, make_train_step
    from repro_torch.train.flatten import leaves

    t0 = time.perf_counter()
    pred = tp_dryrun(TP_LAYERS, TP_N, TP_M, "safe")
    dry_s = time.perf_counter() - t0

    # the same work in one process, on the card
    t0 = time.perf_counter()
    L = V_MAIN // TP_M
    values = torch.stack([dist_row(dev, r) for r in range(TP_N)])
    want = {}
    for name in DIST_ROUNDS:
        mode, akw, kw, _ = dist_round_args(name)
        v = values.clone()
        if "alive" in kw:
            v[torch.from_numpy(kw["alive"] == 0).to(dev)] = float("nan")
        mean = make_aggregator(mode, TP_N, device=dev, **akw).aggregate(v, 2**32 - 5, **kw)
        want[name] = [digest(mean[j * L:(j + 1) * L]) for j in range(TP_M)]
        del v, mean
    del values
    model, steps, fed = tp_model(dev, TP_LAYERS)
    init = [p.detach().to("cpu", copy=True) for p in leaves(model.tree())]
    agg = make_aggregator("safe", TP_N, device=dev)
    bundle = make_train_step(model, agg, lr=TS_LR)
    state = bundle.init_state_fn(model.tree())
    one_losses = []
    for i, alive in enumerate((np.ones(TP_N, np.float32), dist_alive())):
        state, m = bundle.step_fn(state, torch.from_numpy(steps[i]).to(dev),
                                  counter=agg.reserve_round(bundle.padded_size + 2),
                                  alive=alive)
        one_losses.append(float(m["loss"]))
    one_train = [p.detach().cpu() for p in leaves(state["params"])]
    del model, state, bundle
    torch.cuda.empty_cache()
    model = tp_model(dev, TP_LAYERS)[0]
    agg = make_aggregator("safe", TP_N, weighted=True, device=dev)
    fb = make_federated_round(model, agg, local_steps=DIST_K, local_lr=FED_LR,
                              return_delta=True)
    params, m = fb.round_fn(model.tree(), torch.from_numpy(fed).to(dev), weights=DIST_WEIGHTS,
                            counter=agg.reserve_round(tree_size_of(model) + 1),
                            alive=dist_alive())
    one_fed = ([p.detach().cpu() for p in leaves(params)], m["avg_delta"].cpu(),
               float(m["local_loss"]))
    P = m["avg_delta"].numel()
    del model, params, m, fb
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0

    held = (torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev))
    t0 = time.perf_counter()
    ranks = spawn_ranks(_tp_rank, TP_N * TP_M, (TP_LAYERS,))
    ranks_s = time.perf_counter() - t0
    how = (f"{TP_N} learners x {TP_M} model shards = {TP_N * TP_M} ranks sharing "
           f"{torch.cuda.device_count()} card ({smi}), gloo through pinned host buffers")
    counts = {k: sum(r["launches"][k] for r in ranks) for k in DIST_KERNELS}
    padded, fed_padded = ranks[0]["padded_size"], ranks[0]["fed_padded"]
    chunks = [(L, j * L) for j in range(TP_M)] + [(L + 1, (TP_M - 1) * L)]
    chunks += [(padded // TP_M, j * padded // TP_M) for j in range(TP_M)]
    chunks += [(fed_padded // TP_M + (j == TP_M - 1), j * fed_padded // TP_M)
               for j in range(TP_M)]
    t1 = time.perf_counter()
    kerr, checks = check_tp_kernels(dev, chunks, err)
    say(f"phase 4 main path tp_dist ({how}): rounds {list(DIST_ROUNDS)} on chunks of "
        f"{L} words (V = {V_MAIN} over {TP_M} model ranks, one ring a model rank), "
        f"{TS_ARCH} at full width, reduced: n_layers 24 -> {TP_LAYERS}, Megatron tensor "
        f"parallelism over the model ranks: two train steps (learner {DIST_DEAD} dead in the "
        f"second) and a weighted FedAvg round of {DIST_K} local steps; padded_size {padded} "
        f"(chunks of {padded // TP_M}), the FedAvg round's {fed_padded}; {ranks_s:.1f} s "
        f"spawned, {one_s:.1f} s for the same in one process; launches summed over the ranks "
        f"{counts}; the kernels at the path's chunks (length, start word) {chunks} == plain: "
        f"{checks} comparisons in {time.perf_counter() - t1:.1f} s, max |err| {kerr}")
    missing = sorted(k for k in DIST_KERNELS if counts[k] <= 0)
    if missing:
        fail(f"path tp_dist never launched {missing} in its ranks: {counts}")
    for k, c in counts.items():
        launches[k] += c

    # phase 5: the exact checks
    for name in DIST_ROUNDS:
        for r, res in enumerate(ranks):
            if res["rounds"][name] != want[name][r % TP_M]:
                fail(f"tp round {name}: rank {r}'s chunk differs from words of the one-card "
                     f"aggregate ({res['rounds'][name]} vs {want[name][r % TP_M]})")
    zero1 = ranks[0]["zero1"]
    if zero1[0] != zero1[1] or not ranks[0]["rebuild"]:
        fail(f"tp train step: ZeRO-1 is not the one-card FlatAdamW on the published means "
             f"(sha256 {zero1}, rebuild {ranks[0]['rebuild']})")
    say(f"phase 5 tp_dist rounds: every ring's published chunk torch.equal to words "
        f"[j*{L}, (j+1)*{L}) of make_aggregator(...).aggregate of the stacked rows on the card "
        f"(sha256 {({k: [d[:12] for d in v] for k, v in want.items()})})")
    say(f"phase 5 tp_dist ZeRO-1: the {TP_N * TP_M} ranks' master parts ({ranks[0]['master_words']} "
        f"words a rank of padded_size {padded}) after two steps word for word the one-card "
        f"FlatAdamW of the whole master vector on the published means (sha256 "
        f"{zero1[0][:12]}), rank 0's shards the cast of its words")
    # the float math against one card's
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        fail(f"tp train step: the ranks' losses differ: {[r['losses'] for r in ranks]}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], one_losses))
    change = _rel(ranks[0]["train_leaves"], one_train, init, dev)
    fed_loss_rel = abs(ranks[0]["fed_loss"] - one_fed[2]) / abs(one_fed[2])
    d1, d2 = ranks[0]["fed_delta"][:P].double(), one_fed[1].double()
    delta_rel = float(torch.linalg.vector_norm(d1 - d2) / torch.linalg.vector_norm(d2))
    fed_change = _rel(ranks[0]["fed_leaves"], one_fed[0], init, dev)
    floats = (f"losses {[round(x, 5) for x in ranks[0]['losses']]} vs one card's "
              f"{[round(x, 5) for x in one_losses]} ({loss_rel:.2e} relative, bound "
              f"{TP_LOSS_RTOL}); the parameters' change over two steps {change:.3e} relative "
              f"L2 (bound {TP_CHANGE_REL}); FedAvg: local loss {fed_loss_rel:.2e} relative, the "
              f"published delta {delta_rel:.3e} and the parameters' change {fed_change:.3e} "
              f"relative L2 (bound {TP_CHANGE_REL})")
    if (loss_rel > TP_LOSS_RTOL or change > TP_CHANGE_REL or fed_loss_rel > TP_LOSS_RTOL
            or delta_rel > TP_CHANGE_REL or fed_change > TP_CHANGE_REL):
        fail(f"tp_dist: the float math left its bounds: {floats}")
    say(f"phase 5 tp_dist against the one-card port's step on the same weights (bf16): {floats}")
    p, r = pred["peak_bytes"], ranks[0]["step1_peak"]
    dry = (f"rank 0's first step: dry run (--per-rank --model-shards {TP_M}) {p / 1e9:.3f} GB "
           f"against max_memory_allocated {r / 1e9:.3f} GB, off by {abs(p - r) / r:.2%}")
    if abs(p - r) / r > DRY_TOL:
        fail(f"tp_dist {dry}, over {DRY_TOL:.0%}")
    say(f"phase 5 tp_dist dry run {dry} (<= {DRY_TOL:.0%}; {dry_s:.1f} s on meta tensors); "
        f"{gathered_head('tp_dist')}")

    # phase 6: walls, the transport's share, peaks
    for name in DIST_ROUNDS:
        walls = [r["round_ms"][name] for r in ranks]
        tr = [r["round_transport_ms"][name] for r in ranks]
        say(f"phase 6 tp round {name} ({how}): wall {max(walls):.1f} ms; in collectives "
            f"{[round(t, 1) for t in tr]} ms")
    for i in range(2):
        walls = [r["step_ms"][i] for r in ranks]
        tr = [r["step_transport_ms"][i] for r in ranks]
        say(f"phase 6 tp train step {i + 1} ({how}): wall {max(walls):.1f} ms; in collectives "
            f"{[round(t, 1) for t in tr]} ms, transport share "
            f"{[f'{t / w:.0%}' for t, w in zip(tr, walls)]}")
    say(f"phase 6 tp fedavg ({how}): round wall {max(r['fedavg_ms'] for r in ranks):.1f} ms")
    say(f"phase 6 tp peak memory ({how}): train steps "
        f"{[round(r['train_peak'] / 1e9, 2) for r in ranks]} GB a rank (the dry run's rank 0 "
        f"{p / 1e9:.2f} GB, by category {json.dumps({k: round(v / 1e9, 3) for k, v in pred['peak_by_category'].items()})}), "
        f"FedAvg {[round(r['fedavg_peak'] / 1e9, 2) for r in ranks]} GB a rank (allocated "
        f"above the rank's start; reserved {[round(r['train_reserved'] / 1e9, 2) for r in ranks]}"
        f" GB, {DIST_ALLOC_CONF}); this process held {held[0] / 1e9:.2f} GB allocated, "
        f"{held[1] / 1e9:.2f} GB reserved while they ran")


def tpz_config(name, fed=False):
    """tp_zoo's configuration ``name`` (TP_ZOO), for its FedAvg round
    without expert parallelism."""
    import dataclasses

    from repro_torch.configs import get_config
    arch, cut = TP_ZOO[name]
    cfg = dataclasses.replace(get_config(arch), **cut)
    return dataclasses.replace(cfg, ep_axis=None, ep_ranks=1) if fed else cfg


def cfg_dtype(name):
    return "f32" if tpz_config(name).dtype == "float32" else "bf16"


def tpz_model(dev, name, tp=None, ring=None, fed=False):
    """tp_zoo's model ``name`` from seed SEED (the one-card model, or model
    rank tp.rank's shards of it and, with expert parallelism, ring rank's
    experts: the same generator draws), the train steps' tokens [2, n, B,
    S] and the FedAvg round's [n, k, B, S]."""
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    cfg = tpz_config(name, fed)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED),
                  tp_world=tp, ep_world=ring if cfg.ep_axis is not None else None)
    stream = make_federated_batches(cfg, TP_N, TS_B, TS_S, seed=SEED)
    steps = np.stack([stream.global_batch(i)["tokens"] for i in range(2)])
    fed_toks = np.stack([np.stack([stream.learner_batch(l, 10 + k)["tokens"]
                                   for k in range(DIST_K)]) for l in range(TP_N)])
    return model, steps, fed_toks


def tp_full_leaves(params, model, ring, tp):
    """The full leaves of a model-sharded rank's ``params`` on global rank 0
    (host memory; ``ckpt.checkpoint.gather_full_leaf``, an expert leaf over
    the learners too), None on the other ranks. Every rank calls it."""
    from repro_torch.ckpt.checkpoint import gather_full_leaf
    from repro_torch.train.flatten import is_expert_path, leaves_with_paths
    ep = model.ep_world is not None
    out = [gather_full_leaf(x, sh, ring, tp, ep and is_expert_path(path))
           for (path, x), sh in zip(leaves_with_paths(params), model.shard_layout())]
    return out if ring.rank == 0 and tp.rank == 0 else None


def _tp_zoo_rank(world):
    """One rank of the tp_zoo path (spawned), learner l's model shard j of
    the TP_N x TP_M grid: for each TP_ZOO model, two TP train steps
    (DIST_DEAD dead in the second) with their collectives timed, then,
    outside the timed parts, each ring's second-step input chunks gathered
    to the ring's rank 0, which runs the one-card round on them and
    compares it with every ring rank's published chunk (by digest); each
    rank's ZeRO-1 part against FlatAdamW of its words of the published
    chunks; the full leaves on global rank 0; and the weighted FedAvg round
    of TP_ZOO_FED's models. The launch counts are read after the rounds.
    (tp_dist and tests/test_torch_dist_tp_zoo.py gather the whole ZeRO-1
    state instead: 6 vectors of padded_size words through the host
    transport, ~25 s a model here.)"""
    import torch.distributed as dist

    from repro_torch.core import make_aggregator
    from repro_torch.dist import collectives, grid_worlds
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import AdamState, FlatAdamW
    from repro_torch.train import make_federated_round, make_train_step
    dev = world.device
    ring, tp = grid_worlds(world, TP_M)
    l, j = ring.rank, tp.rank
    lead = world.rank == 0
    out = {}
    build.reset_launches()
    launches = {k: 0 for k in DIST_KERNELS}
    warm_cublas(dev)  # cuBLAS's workspaces
    for name in TP_ZOO:
        res = out[name] = {"step_ms": [], "step_transport_ms": [], "losses": [], "phase_s": {}}
        clock = [time.perf_counter()]

        def lap(part):  # this model's seconds by part of the rank's work
            now = time.perf_counter()
            res["phase_s"][part] = round(now - clock[0], 2)
            clock[0] = now
        sync()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        model, steps, fed = tpz_model(dev, name, tp, ring)
        agg = make_aggregator("safe", TP_N, device=dev)
        rounds = []
        aggregate_rank = agg.aggregate_rank

        def record(values, counter_base=0, **kw):
            """Each step's words of the published chunk this rank's ZeRO-1
            part updates (to the host: the first step's peak is compared),
            and the second step's input and published chunks (on the card)."""
            mean = aggregate_rank(values, counter_base, **kw)
            second = len(rounds) == 1
            part = mean.numel() // TP_N
            rounds.append((values.clone() if second else None, mean.clone() if second else None,
                           mean[l * part:(l + 1) * part].to("cpu", copy=True),
                           counter_base, kw["alive"], kw["rotate"]))
            return mean

        agg.aggregate_rank = record
        bundle = make_train_step(model, agg, ring, lr=TS_LR)
        state = bundle.init_state_fn(model.tree())  # the model's tensors, detached
        master0 = state["master"].to("cpu", copy=True)
        res["padded_size"], res["sec_size"] = bundle.padded_size, bundle.sec_size
        sync()
        lap("build")
        torch.cuda.reset_peak_memory_stats(dev)
        for i, alive in enumerate((np.ones(TP_N, np.float32), dist_alive())):
            toks = torch.from_numpy(steps[i][l]).to(dev)
            counter = agg.reserve_round(bundle.padded_size + 2)
            dist.barrier()
            sync()
            collectives.reset_stats(timed=True)
            t0 = time.perf_counter()
            state, m = bundle.step_fn(state, toks, counter=counter, alive=alive)
            sync()
            res["step_ms"].append((time.perf_counter() - t0) * 1e3)
            res["step_transport_ms"].append(collectives.stats["seconds"] * 1e3)
            res["losses"].append(float(m["loss"]))
            if i == 0:
                res["step1_peak"] = torch.cuda.max_memory_allocated(dev) - base
        collectives.reset_stats()
        res["train_peak"] = torch.cuda.max_memory_allocated(dev) - base
        res["train_reserved"] = torch.cuda.max_memory_reserved(dev)
        for k, v in build.launches.items():
            launches[k] += v
        build.reset_launches()
        lap("steps")
        res["held"] = held_for_backward(model, state["params"],
                                        torch.from_numpy(steps[0][l]).to(dev))
        lap("saved inputs")

        # the second step's chunks against the one-card round on each ring's
        # rows: ring j's rows to its rank 0 (learner 0's shard j), which runs
        # the round with the counter base moved to chunk j's start word, as
        # aggregate_rank moves it, and compares the ring's published chunks
        # by digest; every rank first returns its steps' blocks to the card,
        # and waits while the two ring heads hold the rows there
        sync()
        torch.cuda.empty_cache()
        rows, pub, _, counter, alive, rotate = rounds[1]
        L = pub.numel()
        rows = collectives.gather_to_host(rows, 0, ring)
        mine = torch.tensor(list(bytes.fromhex(digest(pub))), dtype=torch.uint8, device=dev)
        pubs = [bytes(d.tolist()).hex() for d in collectives.all_gather(mine, ring).cpu()]
        ok = True
        if l == 0:
            want = make_aggregator("safe", TP_N, device=dev).aggregate(
                rows.view(TP_N, L).to(dev), counter + j * (L // 2), alive=alive, rotate=rotate)
            ok = all(p == digest(want) for p in pubs)
            del want
        del rows, pub
        sync()
        torch.cuda.empty_cache()
        res["chunks_exact"] = bool(collectives.all_gather(torch.tensor([int(ok)], device=dev),
                                                          world).all())
        lap("chunks check")
        # ZeRO-1's part on every rank: FlatAdamW from its initial part by its
        # words of each published chunk, word for word its state's
        master = master0.to(dev)
        zero = torch.zeros_like(master)
        opt, st = FlatAdamW(lr=TS_LR, weight_decay=0.1), AdamState(0, zero, zero.clone())
        for r in rounds:
            master, st = opt.update(r[2].to(dev), st, master, inplace=True)
        ok = digest(master, st.m, st.v) == digest(state["master"], state["fm"], state["fv"])
        res["zero1"] = bool(collectives.all_gather(torch.tensor([int(ok)], device=dev),
                                                   world).all())
        del rounds, master0, master, zero, st
        lap("ZeRO-1 check")
        res["train_leaves"] = tp_full_leaves(state["params"], model, ring, tp)
        del state, bundle, agg, model
        sync()
        torch.cuda.empty_cache()
        lap("leaves")

        build.reset_launches()  # the checks' launches are not the path's
        if name in TP_ZOO_FED:  # the weighted FedAvg round
            model = tpz_model(dev, name, tp, fed=True)[0]
            agg = make_aggregator("safe", TP_N, weighted=True, pipelined=TP_ZOO_FED[name],
                                  device=dev)
            fb = make_federated_round(model, agg, ring, local_steps=DIST_K, local_lr=FED_LR,
                                      return_delta=True)
            counter = agg.reserve_round(fb.padded_size + 1)
            torch.cuda.reset_peak_memory_stats(dev)
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            params, m = fb.round_fn(model.tree(), torch.from_numpy(fed[l]).to(dev),
                                    weights=DIST_WEIGHTS, counter=counter, alive=dist_alive())
            sync()
            res["fedavg_ms"] = (time.perf_counter() - t0) * 1e3
            res["fedavg_peak"] = torch.cuda.max_memory_allocated(dev) - base
            res["fed_padded"] = fb.padded_size
            res["fed_loss"] = float(m["local_loss"])
            res["fed_delta"] = m["avg_delta"].cpu() if lead else None
            for k, v in build.launches.items():
                launches[k] += v
            build.reset_launches()
            res["fed_leaves"] = tp_full_leaves(params, model, ring, tp)
            del model, params, m, fb, agg
            sync()
            torch.cuda.empty_cache()
            lap("fedavg")
        dist.barrier()
        lap("barrier")
    out["launches"] = launches
    return out


def held_for_backward(model, params, tokens):
    """The bytes the model's forward (its loss under autograd, left
    undifferentiated) holds for the backward, with each block's input saved
    as this rank's share of the token rows (the port's
    ``transformer.sliced_checkpoint``) and as the whole input
    (``torch.utils.checkpoint``, the form before it): {form: bytes}. Every
    rank of the grid calls it (the forward's collectives)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import transformer
    from repro_torch.train.flatten import tree_map
    sliced = transformer.sliced_checkpoint
    forms = {"sliced": sliced,
             "whole": lambda fn, x, positions, bp, world: checkpoint(fn, x, positions, bp,
                                                                     use_reentrant=False)}
    out = {}
    try:
        for form, fn in forms.items():
            transformer.sliced_checkpoint = fn
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            before = torch.cuda.memory_allocated()
            loss, aux = model.loss(p, tokens)
            out[form] = torch.cuda.memory_allocated() - before
            del loss, aux, p
    finally:
        transformer.sliced_checkpoint = sliced
    return out


def tpz_dryrun(name):
    """The dry run's rank 0 of the TP_N x TP_M grid for tp_zoo's ``name``
    (meta tensors): its record."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    try:
        return dryrun.measure(tpz_config(name), "train_4k", shape=tp_shape(), learners=TP_N,
                              batch=TS_B, per_rank=True, model_shards=TP_M)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tpz_one_card(dev, name):
    """tp_zoo's model ``name`` on one card, the learners as dim 0: the
    initial leaves, two train steps and (TP_ZOO_FED) the weighted FedAvg
    round, on the host."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import make_federated_round, make_train_step
    from repro_torch.train.flatten import leaf_paths, leaves
    model, steps, fed = tpz_model(dev, name)
    out = {"init": [p.detach().to("cpu", copy=True) for p in leaves(model.tree())],
           "paths": leaf_paths(model.tree()), "losses": []}
    agg = make_aggregator("safe", TP_N, device=dev)
    bundle = make_train_step(model, agg, lr=TS_LR)
    state = bundle.init_state_fn(model.tree())
    del model
    for i, alive in enumerate((np.ones(TP_N, np.float32), dist_alive())):
        state, m = bundle.step_fn(state, torch.from_numpy(steps[i]).to(dev),
                                  counter=agg.reserve_round(bundle.padded_size + 2), alive=alive)
        out["losses"].append(float(m["loss"]))
    out["train"] = [p.detach().cpu() for p in leaves(state["params"])]
    del state, bundle
    torch.cuda.empty_cache()
    if name in TP_ZOO_FED:
        model = tpz_model(dev, name, fed=True)[0]
        agg = make_aggregator("safe", TP_N, weighted=True, pipelined=TP_ZOO_FED[name],
                              device=dev)
        fb = make_federated_round(model, agg, local_steps=DIST_K, local_lr=FED_LR,
                                  return_delta=True)
        params, m = fb.round_fn(model.tree(), torch.from_numpy(fed).to(dev),
                                weights=DIST_WEIGHTS,
                                counter=agg.reserve_round(tree_size_of(model) + 1),
                                alive=dist_alive())
        out["fed"] = ([p.detach().cpu() for p in leaves(params)], m["avg_delta"].cpu(),
                      float(m["local_loss"]))
        del model, params, m, fb
        torch.cuda.empty_cache()
    return out


def tp_zoo_path(dev, launches, err, smi):
    """The tp_zoo path: TP_ZOO's models on the TP_N x TP_M grid of ranks
    sharing the card (``transport="host"``), against the same work in this
    process on the card: the second step's chunks and the ZeRO-1 update
    exactly, the float math within bounds, rank 0's first-step peak against
    the dry run's; adds the ranks' launches to ``launches`` and the kernels'
    checks at the path's chunks to ``err``."""
    from repro_torch.train.flatten import is_expert_path
    t0 = time.perf_counter()
    preds = {name: tpz_dryrun(name) for name in TP_ZOO}
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = {name: tpz_one_card(dev, name) for name in TP_ZOO}
    one_s = time.perf_counter() - t0
    held = (torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev))
    t0 = time.perf_counter()
    ranks = spawn_ranks(_tp_zoo_rank, TP_N * TP_M)
    ranks_s = time.perf_counter() - t0
    how = (f"{TP_N} learners x {TP_M} model shards = {TP_N * TP_M} ranks sharing "
           f"{torch.cuda.device_count()} card ({smi}), gloo through pinned host buffers")
    counts = {k: sum(r["launches"][k] for r in ranks) for k in DIST_KERNELS}
    chunks = []
    for name in TP_ZOO:
        padded = ranks[0][name]["padded_size"]
        chunks += [(padded // TP_M, j * padded // TP_M) for j in range(TP_M)]
        if name in TP_ZOO_FED:
            fp = ranks[0][name]["fed_padded"]
            chunks += [(fp // TP_M + (j == TP_M - 1), j * fp // TP_M) for j in range(TP_M)]
    t1 = time.perf_counter()
    kerr, checks = check_tp_kernels(dev, chunks, err)
    from repro_torch.configs import get_config
    cut = {TP_ZOO[name][0]: ", ".join(f"{k} {getattr(get_config(TP_ZOO[name][0]), k)} -> {v}"
                                      for k, v in TP_ZOO[name][1].items()
                                      if k in ("n_layers", "vocab"))
           for name in TP_ZOO}
    say(f"phase 4 main path tp_zoo ({how}): at full width, "
        f"{({TP_ZOO[n][0]: cfg_dtype(n) for n in TP_ZOO})}, reduced: {json.dumps(cut)}; "
        f"Megatron tensor parallelism over each learner's {TP_M} ranks (Mamba2 and RWKV6 by "
        f"head, the MoE's expert-ff over the model ranks and its experts over the learners' "
        f"rings): two train steps each (learner {DIST_DEAD} dead in the second), weighted "
        f"FedAvg rounds of {DIST_K} local steps for {list(TP_ZOO_FED)} (rwkv6's pipelined); "
        f"padded_size {({n: ranks[0][n]['padded_size'] for n in TP_ZOO})}; {ranks_s:.1f} s "
        f"spawned, {one_s:.1f} s for the same in one process; launches summed over the ranks "
        f"{counts}; the kernels at the path's chunks (length, start word) {chunks} == plain: "
        f"{checks} comparisons in {time.perf_counter() - t1:.1f} s, max |err| {kerr}")
    missing = sorted(k for k in PATH_KERNELS["tp_zoo"] if counts[k] <= 0)
    if missing:
        fail(f"path tp_zoo never launched {missing} in its ranks: {counts}")
    for k, c in counts.items():
        launches[k] += c

    problems = []  # every model's checks run before the path fails
    for name in TP_ZOO:
        arch = TP_ZOO[name][0]
        res = [r[name] for r in ranks]
        lead, o = res[0], one[name]
        if not lead["chunks_exact"]:
            problems.append(f"tp_zoo {arch}: a ring's published chunk differs from the "
                            "one-card round on the ring's own gradient rows")
        if not lead["zero1"]:
            problems.append(f"tp_zoo {arch}: a rank's ZeRO-1 part is not FlatAdamW of its "
                            "words of the published means")
        if any(r["losses"] != lead["losses"] for r in res):
            problems.append(f"tp_zoo {arch}: the ranks' losses differ: "
                            f"{[r['losses'] for r in res]}")
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lead["losses"], o["losses"]))
        if name == "moe":
            expert = [is_expert_path(p) for p in o["paths"]]
            parts = {"SAFE partition": [i for i, e in enumerate(expert) if not e],
                     "experts": [i for i, e in enumerate(expert) if e]}
            bounds = {"loss": EP_LOSS_RTOL, "SAFE partition": EP_MASTER_REL,
                      "experts": EP_EXPERT_REL}
        else:
            parts = {"parameters": list(range(len(o["paths"])))}
            bounds = {"loss": TP_LOSS_RTOL, "parameters": TP_CHANGE_REL}
        change = {k: _rel([lead["train_leaves"][i] for i in idx], [o["train"][i] for i in idx],
                          [o["init"][i] for i in idx], dev)
                  for k, idx in parts.items()}
        floats = (f"losses {[round(x, 5) for x in lead['losses']]} vs one card's "
                  f"{[round(x, 5) for x in o['losses']]} ({loss_rel:.2e} relative, bound "
                  f"{bounds['loss']}); the change over two steps, relative L2: "
                  + ", ".join(f"{k} {v:.3e} (bound {bounds[k]})" for k, v in change.items()))
        bad = loss_rel > bounds["loss"] or any(v > bounds[k] for k, v in change.items())
        if name in TP_ZOO_FED:
            fo = o["fed"]
            fed_loss_rel = abs(lead["fed_loss"] - fo[2]) / abs(fo[2])
            delta_rel = _rel([lead["fed_delta"][:fo[1].numel()]], [fo[1]],
                             [torch.zeros_like(fo[1])], dev)
            fed_change = _rel(lead["fed_leaves"], fo[0], o["init"], dev)
            floats += (f"; FedAvg: local loss {fed_loss_rel:.2e} relative, the published delta "
                       f"{delta_rel:.3e} and the parameters' change {fed_change:.3e} relative "
                       f"L2 (bound {TP_CHANGE_REL})")
            bad = bad or fed_loss_rel > TP_LOSS_RTOL or max(delta_rel, fed_change) > TP_CHANGE_REL
        if bad:
            problems.append(f"tp_zoo {arch}: the float math left its bounds: {floats}")
        p, r = preds[name]["peak_bytes"], lead["step1_peak"]
        dry = (f"rank 0's first step: dry run (--per-rank --model-shards {TP_M}) {p / 1e9:.3f} "
               f"GB against max_memory_allocated {r / 1e9:.3f} GB, off by {abs(p - r) / r:.2%}")
        if abs(p - r) / r > DRY_TOL:
            problems.append(f"tp_zoo {arch} {dry}, over {DRY_TOL:.0%}")
        dry += f"; {gathered_head('tp_zoo ' + name)}"
        cfg = tpz_config(name)
        x = TS_B * TS_S * cfg.d_model * (4 if cfg.dtype == "float32" else 2)
        want = cfg.n_layers * (x - x // TP_M)
        fall = lead["held"]["whole"] - lead["held"]["sliced"]
        saved = (f"the forward leaves the backward {lead['held']['sliced'] / 1e6:.3f} MB with "
                 f"each block's input saved as the rank's 1/{TP_M} of its {TS_B}x{TS_S} token "
                 f"rows, {lead['held']['whole'] / 1e6:.3f} MB with the whole input saved: "
                 f"{fall / 1e6:.3f} MB less, against {cfg.n_layers} blocks x (1 - 1/{TP_M}) x "
                 f"{TS_B * TS_S} x {cfg.d_model} x {x // (TS_B * TS_S * cfg.d_model)} B = "
                 f"{want / 1e6:.3f} MB")
        if abs(fall - want) > DRY_TOL * want:
            problems.append(f"tp_zoo {arch}: {saved}, off by more than {DRY_TOL:.0%}")
        say(f"phase 5 tp_zoo {arch} saved inputs (rank 0, {smi}): {saved} (<= {DRY_TOL:.0%})")
        say(f"phase 5 tp_zoo {arch} ({cfg_dtype(name)}): each ring's published chunk of the "
            f"second step torch.equal to the one-card round of the ring's own gradient rows, "
            f"the counter base moved to the chunk's start word (which tp_dist shows gives the "
            f"whole vector's words): "
            f"{lead['chunks_exact']}; every rank's ZeRO-1 part after two steps word for word "
            f"FlatAdamW from its initial part by its words of the published chunks: "
            f"{lead['zero1']}; against the one-card step on the same weights: "
            f"{floats}; {dry} (bound {DRY_TOL:.0%})")
        for i in range(2):
            walls = [x["step_ms"][i] for x in res]
            tr = [x["step_transport_ms"][i] for x in res]
            say(f"phase 6 tp_zoo {arch} train step {i + 1} ({how}): wall {max(walls):.1f} ms; in "
                f"collectives {[round(t, 1) for t in tr]} ms, transport share "
                f"{[f'{t / w:.0%}' for t, w in zip(tr, walls)]}")
        fed = (f", FedAvg round wall {max(x['fedavg_ms'] for x in res):.1f} ms, peaks "
               f"{[round(x['fedavg_peak'] / 1e9, 2) for x in res]} GB" if name in TP_ZOO_FED
               else "")
        say(f"phase 6 tp_zoo {arch} peak memory ({how}): train steps "
            f"{[round(x['train_peak'] / 1e9, 2) for x in res]} GB a rank (the dry run's rank 0 "
            f"{p / 1e9:.2f} GB, by category "
            f"{json.dumps({k: round(v / 1e9, 3) for k, v in preds[name]['peak_by_category'].items()})}); "
            f"reserved {[round(x['train_reserved'] / 1e9, 2) for x in res]} GB{fed}; rank 0's "
            f"seconds by part {json.dumps(lead['phase_s'])}")
    say(f"phase 6 tp_zoo ({smi}): {dry_s:.1f} s of dry runs on meta tensors; this process held "
        f"{held[0] / 1e9:.2f} GB allocated, {held[1] / 1e9:.2f} GB reserved while the ranks ran")
    if problems:
        fail(" | ".join(problems))


def pt_model(dev, tp=None):
    """pod_tp's model: internlm2-1.8b at full width and POD_LAYERS layers from
    seed SEED (the one-card model, or model rank tp.rank's shards of it),
    the train steps' tokens [2, P·n, B, S] pod-major and the FedAvg round's
    [P·n, k, B, S]."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(TS_ARCH), n_layers=POD_LAYERS)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED),
                  tp_world=tp)
    rows = POD_P * POD_STEP_N
    stream = make_federated_batches(cfg, rows, TS_B, TS_S, seed=SEED)
    steps = np.stack([stream.global_batch(i)["tokens"] for i in range(2)])
    fed = np.stack([np.stack([stream.learner_batch(r, 10 + k)["tokens"] for k in range(DIST_K)])
                    for r in range(rows)])
    return model, steps, fed


def _pod_tp_rank(world):
    """One rank of the pod_tp path (spawned): pod p's learner l, model shard
    j of the POD_P x POD_STEP_N x TP_M grid (``dist.grid``). Two train steps
    (learner DIST_DEAD dead in the second) with their collectives timed and
    a weighted FedAvg round, through the entry points; the launch counts
    read after them. Then, outside the timed parts: the second step's
    chunks, each ring's rows to its head (learner 0), which runs the
    one-card round on them, the two pods' heads of a chunk their
    ``pod_mean`` (the one-card ``pod_rounds``), compared by digest with
    every rank's published chunk; each rank's ZeRO-1 part against
    FlatAdamW of its words of the published chunks; the full leaves on
    global rank 0."""
    import torch.distributed as dist

    from repro_torch.core import make_aggregator
    from repro_torch.core.chain import pod_mean
    from repro_torch.dist import collectives, grid
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import AdamState, FlatAdamW
    from repro_torch.train import make_federated_round, make_train_step
    dev = world.device
    g = grid(world, TP_M, POD_P)
    p, l, j = g.pod.rank, g.data.rank, g.model.rank
    row = p * POD_STEP_N + l
    out = {"step_ms": [], "step_transport_ms": [], "losses": []}
    build.reset_launches()
    warm_cublas(dev)  # cuBLAS's workspaces
    sync()
    base = torch.cuda.memory_allocated(dev)
    model, steps, fed = pt_model(dev, g.model)
    agg = make_aggregator("safe", POD_STEP_N, pod_axis="pod", device=dev)
    rounds = []
    aggregate_rank = agg.aggregate_rank

    def record(values, counter_base=0, **kw):
        """Each step's words of the published chunk this rank's ZeRO-1 part
        updates (to the host), the second step's input and published chunks."""
        mean = aggregate_rank(values, counter_base, **kw)
        second = len(rounds) == 1
        part = mean.numel() // POD_STEP_N
        rounds.append((values.clone() if second else None, mean.clone() if second else None,
                       mean[l * part:(l + 1) * part].to("cpu", copy=True),
                       counter_base, kw["alive"], kw["rotate"]))
        return mean

    agg.aggregate_rank = record
    bundle = make_train_step(model, agg, g, lr=TS_LR, pod_axis="pod")
    state = bundle.init_state_fn(model.tree())
    master0 = state["master"].to("cpu", copy=True)
    out["padded_size"] = bundle.padded_size
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    for i, alive in enumerate((np.ones(POD_STEP_N, np.float32), pod_alive())):
        toks = torch.from_numpy(steps[i][row]).to(dev)
        counter = agg.reserve_round(bundle.padded_size + 2)
        dist.barrier()
        sync()
        collectives.reset_stats(timed=True)
        t0 = time.perf_counter()
        state, m = bundle.step_fn(state, toks, counter=counter, alive=alive)
        sync()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["step_transport_ms"].append(collectives.stats["seconds"] * 1e3)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["step1_peak"] = torch.cuda.max_memory_allocated(dev) - base
    collectives.reset_stats()
    out["train_peak"] = torch.cuda.max_memory_allocated(dev) - base
    launches = dict(build.launches)

    # the second step's chunks against the one-card pod_rounds of their rows
    sync()
    torch.cuda.empty_cache()
    rows, pub, _, counter, alive, rotate = rounds[1]
    L = pub.numel()
    rows = collectives.gather_to_host(rows, 0, g.data)
    mine = torch.tensor(list(bytes.fromhex(digest(pub))), dtype=torch.uint8, device=dev)
    pubs = [bytes(d.tolist()).hex() for d in collectives.all_gather(mine, g.data).cpu()]
    ok = True
    if l == 0:  # ring (p, j)'s head: its pod's round, then the pods' mean over the heads
        avg = make_aggregator("safe", POD_STEP_N, device=dev).aggregate(
            rows.view(POD_STEP_N, L).to(dev), counter + j * (L // 2), alive=alive,
            rotate=rotate)
        want = pod_mean(list(collectives.all_gather(avg, g.pod).unbind(0)))
        ok = all(d == digest(want) for d in pubs)
        del avg, want
    del rows, pub
    sync()
    torch.cuda.empty_cache()
    out["chunks_exact"] = bool(collectives.all_gather(torch.tensor([int(ok)], device=dev),
                                                      world).all())
    # ZeRO-1's part on every rank: FlatAdamW from its initial part by its words
    # of each published chunk, word for word its state's
    master = master0.to(dev)
    zero = torch.zeros_like(master)
    opt, st = FlatAdamW(lr=TS_LR, weight_decay=0.1), AdamState(0, zero, zero.clone())
    for r in rounds:
        master, st = opt.update(r[2].to(dev), st, master, inplace=True)
    ok = digest(master, st.m, st.v) == digest(state["master"], state["fm"], state["fv"])
    out["zero1"] = bool(collectives.all_gather(torch.tensor([int(ok)], device=dev),
                                               world).all())
    out["master_words"] = state["master"].numel()
    del rounds, master0, master, zero, st
    out["train_leaves"] = tp_full_leaves(state["params"], model, g.data, g.model)
    del state, bundle, agg, model
    sync()
    torch.cuda.empty_cache()

    # the weighted FedAvg round
    model = pt_model(dev, g.model)[0]
    agg = make_aggregator("safe", POD_STEP_N, weighted=True, pod_axis="pod", device=dev)
    fb = make_federated_round(model, agg, g, local_steps=DIST_K, local_lr=FED_LR,
                              return_delta=True)
    counter = agg.reserve_round(fb.padded_size + 1)
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    params, m = fb.round_fn(model.tree(), torch.from_numpy(fed[row]).to(dev),
                            weights=PT_WEIGHTS, counter=counter, alive=pod_alive())
    sync()
    out["fedavg_ms"] = (time.perf_counter() - t0) * 1e3
    out["fedavg_peak"] = torch.cuda.max_memory_allocated(dev) - base
    out["fed_padded"] = fb.padded_size
    out["launches"] = {k: launches[k] + build.launches[k] for k in launches}
    out["fed_loss"] = float(m["local_loss"])
    out["fed_delta"] = m["avg_delta"].cpu() if world.rank == 0 else None
    out["fed_leaves"] = tp_full_leaves(params, model, g.data, g.model)
    dist.barrier()
    return out


def pt_one_card(dev):
    """pod_tp's work on one card, the pods' learners as dim 0: the initial
    leaves, two pod train steps and the weighted pod FedAvg round."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import make_federated_round, make_train_step
    from repro_torch.train.flatten import leaves
    model, steps, fed = pt_model(dev)
    out = {"init": [p.detach().to("cpu", copy=True) for p in leaves(model.tree())],
           "losses": []}
    agg = make_aggregator("safe", POD_STEP_N, pod_axis="pod", device=dev)
    bundle = make_train_step(model, agg, lr=TS_LR, pod_axis="pod")
    state = bundle.init_state_fn(model.tree())
    del model
    for i, alive in enumerate((np.ones(POD_STEP_N, np.float32), pod_alive())):
        state, m = bundle.step_fn(state, torch.from_numpy(steps[i]).to(dev),
                                  counter=agg.reserve_round(bundle.padded_size + 2), alive=alive)
        out["losses"].append(float(m["loss"]))
    out["train"] = [p.detach().cpu() for p in leaves(state["params"])]
    del state, bundle
    torch.cuda.empty_cache()
    model = pt_model(dev)[0]
    agg = make_aggregator("safe", POD_STEP_N, weighted=True, pod_axis="pod", device=dev)
    fb = make_federated_round(model, agg, local_steps=DIST_K, local_lr=FED_LR,
                              return_delta=True)
    params, m = fb.round_fn(model.tree(), torch.from_numpy(fed).to(dev), weights=PT_WEIGHTS,
                            counter=agg.reserve_round(tree_size_of(model) + 1),
                            alive=pod_alive())
    out["fed"] = ([p.detach().cpu() for p in leaves(params)], m["avg_delta"].cpu(),
                  float(m["local_loss"]))
    del model, params, m, fb
    torch.cuda.empty_cache()
    return out


def pt_dryrun():
    """The dry run's rank 0 of pod_tp's grid (meta tensors): its record."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_config(TS_ARCH), n_layers=POD_LAYERS)
    try:
        return dryrun.measure(cfg, "train_4k", shape=dict(
            seq_len=TS_S, global_batch=POD_P * POD_STEP_N * TS_B, kind="train"),
            learners=POD_STEP_N, batch=TS_B, per_rank=True, model_shards=TP_M, pods=POD_P)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def pod_tp_path(dev, launches, err, smi):
    """The pod_tp path: the ('pod', 'data', 'model') grid, POD_P pods x
    POD_STEP_N learners x TP_M model shards spawned and sharing the card
    (``transport="host"``), against the same work in this process on the
    card: the second step's chunks (each the one-card ``pod_rounds`` of its
    rows) and the ZeRO-1 parts exactly, the float math within tp_dist's
    bounds, rank 0's first-step peak against the dry run's; adds the ranks'
    launches to ``launches`` and the kernels' checks at the path's chunks
    to ``err``."""
    t0 = time.perf_counter()
    pred = pt_dryrun()
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = pt_one_card(dev)
    one_s = time.perf_counter() - t0
    size = POD_P * POD_STEP_N * TP_M
    t0 = time.perf_counter()
    ranks = spawn_ranks(_pod_tp_rank, size)
    ranks_s = time.perf_counter() - t0
    how = (f"{POD_P} pods x {POD_STEP_N} learners x {TP_M} model shards = {size} ranks sharing "
           f"{torch.cuda.device_count()} card ({smi}), gloo through pinned host buffers")
    counts = {k: sum(r["launches"][k] for r in ranks) for k in DIST_KERNELS}
    padded, fed_padded = ranks[0]["padded_size"], ranks[0]["fed_padded"]
    chunks = [(padded // TP_M, j * padded // TP_M) for j in range(TP_M)]
    chunks += [(fed_padded // TP_M + (j == TP_M - 1), j * fed_padded // TP_M)
               for j in range(TP_M)]
    t1 = time.perf_counter()
    kerr, checks = check_tp_kernels(dev, chunks, err)
    say(f"phase 4 main path pod_tp ({how}; dist.grid: rank (p*{POD_STEP_N} + l)*{TP_M} + j): "
        f"{TS_ARCH} at full width, reduced: n_layers 24 -> {POD_LAYERS}; each pod's ring j runs "
        f"chunk j's SAFE round, the pods' chunks meet over the pod group, ZeRO-1 within each "
        f"pod, the rebuilt vector pmean'd over the pods: two train steps (learner {DIST_DEAD} "
        f"of each pod dead in the second) and a weighted FedAvg round of {DIST_K} local steps; "
        f"padded_size {padded} (chunks of {padded // TP_M}), the FedAvg round's {fed_padded}; "
        f"{ranks_s:.1f} s spawned, {one_s:.1f} s for the same in one process; launches summed "
        f"over the ranks {counts}; the kernels at the path's chunks (length, start word) "
        f"{chunks} == plain: {checks} comparisons in {time.perf_counter() - t1:.1f} s, max "
        f"|err| {kerr}")
    missing = sorted(k for k in PATH_KERNELS["pod_tp"] if counts[k] <= 0)
    if missing:
        fail(f"path pod_tp never launched {missing} in its ranks: {counts}")
    for k, c in counts.items():
        launches[k] += c

    lead = ranks[0]
    problems = []
    if not lead["chunks_exact"]:
        problems.append("pod_tp: a published chunk differs from the one-card pod_rounds of its "
                        "rows")
    if not lead["zero1"]:
        problems.append("pod_tp: a rank's ZeRO-1 part is not FlatAdamW of its words of the "
                        "published means")
    if any(r["losses"] != lead["losses"] for r in ranks):
        problems.append(f"pod_tp: the ranks' losses differ: {[r['losses'] for r in ranks]}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lead["losses"], one["losses"]))
    change = _rel(lead["train_leaves"], one["train"], one["init"], dev)
    fo = one["fed"]
    fed_loss_rel = abs(lead["fed_loss"] - fo[2]) / abs(fo[2])
    delta_rel = _rel([lead["fed_delta"][:fo[1].numel()]], [fo[1]], [torch.zeros_like(fo[1])],
                     dev)
    fed_change = _rel(lead["fed_leaves"], fo[0], one["init"], dev)
    floats = (f"losses {[round(x, 5) for x in lead['losses']]} vs one card's "
              f"{[round(x, 5) for x in one['losses']]} ({loss_rel:.2e} relative, bound "
              f"{TP_LOSS_RTOL}); the parameters' change over two steps {change:.3e} relative L2 "
              f"(bound {TP_CHANGE_REL}); FedAvg: local loss {fed_loss_rel:.2e} relative, the "
              f"published delta {delta_rel:.3e} and the parameters' change {fed_change:.3e} "
              f"relative L2 (bound {TP_CHANGE_REL})")
    if (loss_rel > TP_LOSS_RTOL or change > TP_CHANGE_REL or fed_loss_rel > TP_LOSS_RTOL
            or max(delta_rel, fed_change) > TP_CHANGE_REL):
        problems.append(f"pod_tp: the float math left its bounds: {floats}")
    p, r = pred["peak_bytes"], lead["step1_peak"]
    dry = (f"rank 0's first step: dry run (--per-rank --model-shards {TP_M}, {POD_P} pods) "
           f"{p / 1e9:.3f} GB against max_memory_allocated {r / 1e9:.3f} GB, off by "
           f"{abs(p - r) / r:.2%}")
    if abs(p - r) / r > DRY_TOL:
        problems.append(f"pod_tp {dry}, over {DRY_TOL:.0%}")
    dry += f"; {gathered_head('pod_tp')}"
    say(f"phase 5 pod_tp: every rank's published chunk of the second step torch.equal to the "
        f"one-card pod_rounds of its rows (each pod's ring round on its head, the counter base "
        f"moved to the chunk's start word, then pod_mean of the pods' results): "
        f"{lead['chunks_exact']}; every rank's ZeRO-1 part ({lead['master_words']} words) "
        f"after two steps word for word FlatAdamW from its initial part by its words of the "
        f"published chunks: {lead['zero1']}; against the one-card pod step on the same weights "
        f"(bf16): {floats}; {dry} (bound {DRY_TOL:.0%}, {dry_s:.1f} s on meta tensors)")
    for i in range(2):
        walls = [x["step_ms"][i] for x in ranks]
        tr = [x["step_transport_ms"][i] for x in ranks]
        say(f"phase 6 pod_tp train step {i + 1} ({how}): wall {max(walls):.1f} ms; in "
            f"collectives {[round(t, 1) for t in tr]} ms, transport share "
            f"{[f'{t / w:.0%}' for t, w in zip(tr, walls)]}")
    say(f"phase 6 pod_tp ({how}): FedAvg round wall {max(x['fedavg_ms'] for x in ranks):.1f} "
        f"ms; peaks: train steps {[round(x['train_peak'] / 1e9, 2) for x in ranks]} GB a rank "
        f"(the dry run's rank 0 {p / 1e9:.2f} GB, by category "
        f"{json.dumps({k: round(v / 1e9, 3) for k, v in pred['peak_by_category'].items()})}), "
        f"FedAvg {[round(x['fedavg_peak'] / 1e9, 2) for x in ranks]} GB")
    if problems:
        fail(" | ".join(problems))


def sd_model(dev, part, tp=None):
    """serve_dist's model of ``part`` ("a": internlm2-1.8b at SERVE_LAYERS,
    "b": gemma3-12b at SD_B_LAYERS) at full width from seed SEED: the
    one-process model, or model rank tp.rank's shards of it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = serve_config() if part == "a" else get_config(SD_B_ARCH)
    if part == "b":
        cfg = dataclasses.replace(cfg, n_layers=SD_B_LAYERS, dtype="float32")
    return Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED),
                 tp_world=tp)


def sd_prefill(model, prompts):
    """Each prompt prefilled alone (B = 1, as ``ServeEngine`` admits a
    request) into its row of one cache of SD_A_MAX positions; returns
    (the prefills' logits [rows, V], the cache)."""
    cache = model.init_cache(len(prompts), SD_A_MAX, prefilled=False)
    logits = []
    for i, prompt in enumerate(prompts):
        one = model.init_cache(1, SD_A_MAX, prefilled=False)
        lg, one = model.prefill(model.tree(), torch.as_tensor(prompt[None]).to(
            model.embed.device), cache=one)
        for c, o in zip(cache, one):
            for k in c:
                c[k][:, i] = o[k][:, 0]
        logits.append(lg[0])
        del one
    return torch.stack(logits), cache


def sd_fill_cache(model, pos, seq_world=None, tp=None):
    """serve_dist (b)'s cache: every attention cache's k and v seeded random
    words (a generator a block of S_c/SD_DATA slots and a leaf, so each rank
    draws only its blocks, then keeps its heads), ``pos`` tokens in it."""
    cfg = model.cfg
    cache = model.init_cache(1, SD_B_SEQ, prefilled=False, seq_world=seq_world)
    dev = model.embed.device
    for p, c in enumerate(cache):
        for k in ("k", "v"):
            leaf = c[k]  # [1, 1, S_loc, nkv_loc, hd]
            S_loc = leaf.shape[2]
            blocks = SD_DATA if seq_world is None else 1
            first = 0 if seq_world is None else seq_world.rank
            nkv = cfg.n_kv_heads
            for b in range(blocks):
                S_b = S_loc // blocks
                gen = torch.Generator(device=dev).manual_seed(
                    SEED + 1000 * p + 10 * (first + b) + (k == "v"))
                full = torch.randn((S_b, nkv, cfg.resolved_head_dim), generator=gen,
                                   device=dev).to(leaf.dtype)
                h = leaf.shape[3]
                j = 0 if tp is None or h == nkv else tp.rank
                leaf[0, 0, b * S_b:(b + 1) * S_b] = full[:, j * h:(j + 1) * h]
                del full
        c["pos"].fill_(pos)
    return cache


def sd_c_model(dev, g=None):
    """serve_dist (c)'s model: qwen3-moe-235b-a22b at full width, one unit, f32,
    from seed SEED: the one-process model (every expert, one-process
    routing), or grid rank ``g``'s (its experts over the data ranks, its
    shards over the model group)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(EP_ARCH), n_layers=1, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if g is None:
        return Model(cfg, device=dev, generator=gen)
    cfg = dataclasses.replace(cfg, ep_axis="data", ep_ranks=g.data.size)
    return Model(cfg, device=dev, generator=gen, tp_world=g.model, ep_world=g.data)


def sd_c_cache(model, first, rows, tp=None):
    """serve_dist (c)'s cache of rows [first, first + rows) of the batch:
    seeded random k and v (a generator a row, the full heads drawn, this
    model rank's kept), SD_C_POS tokens in it."""
    cfg = model.cfg
    dev = model.embed.device
    cache = model.init_cache(rows, SD_C_MAX, prefilled=False)
    for c in cache:
        for k in ("k", "v"):
            leaf = c[k]  # [1, rows, S_c, nkv_loc, hd]
            h = leaf.shape[3]
            j = 0 if tp is None or h == cfg.n_kv_heads else tp.rank
            for r in range(rows):
                gen = torch.Generator(device=dev).manual_seed(
                    SEED + 10 * (first + r) + (k == "v"))
                full = torch.randn((SD_C_MAX, cfg.n_kv_heads, cfg.resolved_head_dim),
                                   generator=gen, device=dev)
                leaf[0, r] = full[:, j * h:(j + 1) * h].to(leaf.dtype)
        c["pos"].fill_(SD_C_POS)
    return cache


def sd_c_tokens(cfg):
    """serve_dist (c)'s decode tokens [SD_C_STEPS, SD_C_ROWS]."""
    return np.random.RandomState(SEED + 11).randint(
        0, cfg.vocab, (SD_C_STEPS, SD_C_ROWS)).astype(np.int64)


def sd_c_decode(model, step, cache, toks):
    """SD_C_STEPS decode steps of ``toks`` [steps, rows]: (the logits
    [steps, rows, V] on the host, each MoE call's kept tokens by expert)."""
    from repro_torch.models import moe
    moe.route_stats["kept"] = []
    try:
        out = []
        for t in range(SD_C_STEPS):
            logits, cache = step(model.tree(), toks[t], cache)
            out.append(logits.float().cpu())
        return torch.stack(out), moe.route_stats["kept"]
    finally:
        moe.route_stats["kept"] = None


def _serve_dist_rank(world, tokens_a):
    """One rank of the serve_dist path (spawned), data rank i's model shard
    j of the SD_DATA x TP_M grid. (a) internlm2-1.8b at SERVE_LAYERS: its
    SD_A_ROWS / SD_DATA rows of traffic B's prompts prefilled alone into
    its cache of SD_A_MAX, then SD_A_STEPS decode steps teacher-forced on
    ``tokens_a`` (the one-process run's greedy tokens) through
    ``make_serve_step(model, grid)``; rank 0's peak over one decode step.
    (b) gemma3-12b at one unit with long_500k's cache split over the data
    ranks by slot: for each of SD_B_POS, the cache filled with seeded random
    k and v, SD_B_STEPS decode steps through ``make_serve_step(model, grid,
    seq_axis="data")``; rank 0's peak over one step. (c) qwen3-moe at one
    unit: its SD_C_ROWS / SD_DATA rows of seeded caches, SD_C_STEPS decode
    steps routed over the global batch; the logits and each MoE call's kept
    tokens by expert."""
    import torch.distributed as dist

    from repro_torch.dist import grid
    from repro_torch.kernels import build
    from repro_torch.serve import make_serve_step
    dev = world.device
    g = grid(world, TP_M)
    i = g.data.rank
    out = {"pos": (i, g.model.rank)}
    build.reset_launches()
    rows = SD_A_ROWS // SD_DATA
    warm_cublas(dev)  # cuBLAS's workspaces
    with torch.inference_mode():
        sync()
        base = torch.cuda.memory_allocated(dev)
        model = sd_model(dev, "a", g.model)
        prompts = [r.prompt for r in serve_requests(model.cfg, "B")[i * rows:(i + 1) * rows]]
        dist.barrier()
        t0 = time.perf_counter()
        logits, cache = sd_prefill(model, prompts)
        sync()
        out["a_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        step = make_serve_step(model, g)
        steps, ms = [logits.float().cpu()], []
        toks = torch.from_numpy(tokens_a[:, i * rows:(i + 1) * rows]).to(dev)
        del logits
        for t in range(SD_A_STEPS):
            if t == 1:
                sync()
                torch.cuda.reset_peak_memory_stats(dev)
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            logits, cache = step(model.tree(), toks[t], cache)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if t == 1:
                out["a_peak"] = torch.cuda.max_memory_allocated(dev) - base
            steps.append(logits.float().cpu())
            del logits
        out["a_logits"], out["a_ms"] = torch.stack(steps), ms
        del model, cache, step, toks
        sync()
        torch.cuda.empty_cache()

        base = torch.cuda.memory_allocated(dev)
        model = sd_model(dev, "b", g.model)
        step = make_serve_step(model, g, seq_axis="data")
        toks = torch.from_numpy(sd_b_tokens(model.cfg)).to(dev)
        for pos in SD_B_POS:
            cache = sd_fill_cache(model, pos, g.data, g.model)
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            steps, ms = [], []
            for t in range(SD_B_STEPS):
                dist.barrier()
                sync()
                t0 = time.perf_counter()
                logits, cache = step(model.tree(), toks[t], cache)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                if t == 0:
                    out[f"b{pos}_peak"] = torch.cuda.max_memory_allocated(dev) - base
                steps.append(logits.float().cpu())
                del logits
            out[f"b{pos}_logits"], out[f"b{pos}_ms"] = torch.stack(steps), ms
            del cache
            sync()
            torch.cuda.empty_cache()
        del model, step, toks

        model = sd_c_model(dev, g)
        rows = SD_C_ROWS // SD_DATA
        cache = sd_c_cache(model, i * rows, rows, g.model)
        toks = torch.from_numpy(sd_c_tokens(model.cfg)[:, i * rows:(i + 1) * rows]).to(dev)
        dist.barrier()
        t0 = time.perf_counter()
        out["c_logits"], out["c_kept"] = sd_c_decode(model, make_serve_step(model, g), cache,
                                                     toks)
        out["c_ms"] = (time.perf_counter() - t0) * 1e3
        del model, cache
        sync()
        torch.cuda.empty_cache()
    out["launches"] = dict(build.launches)
    dist.barrier()
    return out


def sd_b_tokens(cfg):
    """serve_dist (b)'s decode tokens, [SD_B_STEPS, 1]."""
    return np.random.RandomState(SEED + 7).randint(0, cfg.vocab, (SD_B_STEPS, 1)).astype(
        np.int64)


def sd_one_process(dev):
    """serve_dist's work in this process on the card, unsplit: (a) the
    prefills and SD_A_STEPS greedy decode steps (their tokens feed the
    ranks), (b) the dense decode of each whole cache, (c) the MoE's decode
    of the whole batch with one process's routing."""
    from repro_torch.serve import make_serve_step
    out = {}
    with torch.inference_mode():
        model = sd_model(dev, "a")
        prompts = [r.prompt for r in serve_requests(model.cfg, "B")[:SD_A_ROWS]]
        logits, cache = sd_prefill(model, prompts)
        step = make_serve_step(model)
        steps, toks = [logits.float().cpu()], []
        for _ in range(SD_A_STEPS):
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok.cpu())
            logits, cache = step(model.tree(), tok, cache)
            steps.append(logits.float().cpu())
        out["a_logits"], out["a_tokens"] = torch.stack(steps), torch.stack(toks).numpy()
        del model, cache, logits
        torch.cuda.empty_cache()
        model = sd_model(dev, "b")
        step = make_serve_step(model)
        toks = torch.from_numpy(sd_b_tokens(model.cfg)).to(dev)
        for pos in SD_B_POS:
            cache = sd_fill_cache(model, pos)
            steps = []
            for t in range(SD_B_STEPS):
                logits, cache = step(model.tree(), toks[t], cache)
                steps.append(logits.float().cpu())
            out[f"b{pos}_logits"] = torch.stack(steps)
            del cache, logits
            torch.cuda.empty_cache()
        del model
        model = sd_c_model(dev)
        cache = sd_c_cache(model, 0, SD_C_ROWS)
        toks = torch.from_numpy(sd_c_tokens(model.cfg)).to(dev)
        out["c_logits"], out["c_kept"] = sd_c_decode(model, make_serve_step(model), cache, toks)
        del model, cache
        torch.cuda.empty_cache()
    return out


def sd_dryrun():
    """The dry run's rank 0 of serve_dist's two layouts (meta tensors):
    (a)'s decode step at SD_A_ROWS / SD_DATA rows and a cache of SD_A_MAX,
    (b)'s at long_500k's sequence-sharded cache."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    grid_kw = dict(learners=SD_DATA, model_shards=TP_M, per_rank=True)
    try:
        a = dryrun.measure(serve_config(), "decode_32k", shape=dict(
            seq_len=SD_A_MAX, global_batch=SD_A_ROWS, kind="decode"), **grid_kw)
        b = dryrun.measure(dataclasses.replace(get_config(SD_B_ARCH), n_layers=SD_B_LAYERS,
                                               dtype="float32"), "long_500k", **grid_kw)
        return a, b
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def serve_dist_path(dev, launches, smi):
    """The serve_dist path: decode and prefill across SD_DATA x TP_M ranks
    sharing the card (``transport="host"``): (a) the decode_32k layout,
    batch rows over 'data' and heads over 'model', internlm2-1.8b at SERVE_LAYERS
    layers on traffic B's prompts, within SERVE_TOL of the one-process
    decode; (b) long_500k's, gemma3-12b at one unit with its caches split by
    slot over 'data', within SD_B_TOL of one process's dense decode of the
    whole cache; (c) the decode_32k layout of qwen3-moe at one unit, its MoE
    routed over the global batch, within SERVE_TOL of one process's decode
    of the whole batch and keeping as many tokens an expert; rank 0's peaks
    against the dry run's. No SAFE kernel runs on these paths: their launch
    line says so."""
    t0 = time.perf_counter()
    pred_a, pred_b = sd_dryrun()
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = sd_one_process(dev)
    one_s = time.perf_counter() - t0
    size = SD_DATA * TP_M
    t0 = time.perf_counter()
    ranks = spawn_ranks(_serve_dist_rank, size, (one["a_tokens"],))
    ranks_s = time.perf_counter() - t0
    how = (f"{SD_DATA} data x {TP_M} model ranks = {size} ranks sharing "
           f"{torch.cuda.device_count()} card ({smi}), gloo through pinned host buffers")
    counts = {k: sum(r["launches"][k] for r in ranks) for k in DIST_KERNELS}
    say(f"phase 4 main path serve_dist ({how}; dist.grid: rank 2*i + j): (a) {SERVE_ARCH} at "
        f"full width, reduced: n_layers 24 -> {SERVE_LAYERS} (bf16, seed {SEED}), the "
        f"decode_32k layout: "
        f"{SD_A_ROWS} of traffic B's prompts, {SD_A_ROWS // SD_DATA} a data rank, each "
        f"prefilled alone into its rank's cache of {SD_A_MAX} and its model rank's kv heads, "
        f"then {SD_A_STEPS} decode steps through make_serve_step(model, grid) teacher-forced "
        f"on the one-process run's greedy tokens; (b) {SD_B_ARCH} at full width in f32, reduced: "
        f"n_layers 48 -> {SD_B_LAYERS} (one unit: 5 local, 1 global), long_500k's layout: "
        f"batch 1, every attention cache's {SD_B_SEQ} slots (the local rings' 1024) split "
        f"over the data ranks, seeded random k and v, pos {list(SD_B_POS)}, {SD_B_STEPS} "
        f"decode steps through make_serve_step(model, grid, seq_axis='data'); (c) {EP_ARCH} "
        f"at full width in f32, reduced: n_layers 94 -> 1, the decode_32k layout: "
        f"{SD_C_ROWS} rows, {SD_C_ROWS // SD_DATA} a data rank, seeded caches of {SD_C_MAX} "
        f"at pos {SD_C_POS}, {SD_C_STEPS} decode steps of seeded tokens, the MoE routed over "
        f"the global batch; {ranks_s:.1f} s spawned, {one_s:.1f} s for the same in one process; SAFE kernel "
        f"launches (none on these paths) {counts}")
    if any(counts.values()):
        fail(f"serve_dist launched a SAFE kernel: {counts}")
    problems, gates = [], []

    def gate(name, key, tol):
        want = one[key]
        worst = 0.0
        for r in ranks:
            got = r[key]
            if key[0] in "ac":
                i = r["pos"][0]
                rows = (SD_A_ROWS if key[0] == "a" else SD_C_ROWS) // SD_DATA
                want_r = want[:, i * rows:(i + 1) * rows]
            else:
                want_r = want
            if not torch.isfinite(got).all():
                problems.append(f"serve_dist {name}: rank {r['pos']} has a non-finite logit")
            for s in range(want_r.shape[0]):
                worst = max(worst, float((got[s] - want_r[s]).abs().max()
                                         / want_r[s].abs().max()))
        gates.append(f"{name} {worst:.2e} of max |logit| (bound {tol})")
        if worst > tol:
            problems.append(f"serve_dist {name}: {worst:.2e} of max |logit| over {tol}")

    gate("(a) prefill and decode", "a_logits", SERVE_TOL)
    for pos in SD_B_POS:
        gate(f"(b) pos {pos}", f"b{pos}_logits", SD_B_TOL)
    gate("(c) MoE decode", "c_logits", SERVE_TOL)
    firsts = [r for r in ranks if r["pos"][1] == 0]   # model rank 0 of each data rank
    kept = [sum(k) for k in zip(*[r["c_kept"] for r in firsts])]
    want_kept = one["c_kept"]
    if len(kept) != len(want_kept) or any(not torch.equal(a, b)
                                          for a, b in zip(kept, want_kept)):
        problems.append(f"serve_dist (c): tokens kept by expert differ from one process's: "
                        f"{[int(k.sum()) for k in kept]} against "
                        f"{[int(k.sum()) for k in want_kept]} kept a step")
    from repro_torch.configs import get_config
    from repro_torch.models.moe import _capacity
    mc = get_config(EP_ARCH).moe
    sent = SD_C_ROWS * mc.top_k
    cap = _capacity(SD_C_ROWS, mc.top_k, mc.num_experts, mc.capacity_factor, floor=8)
    gates.append(f"(c) tokens kept by expert equal to one process's in all {len(want_kept)} "
                 f"MoE calls ({[sent - int(k.sum()) for k in want_kept]} of {sent} "
                 f"assignments dropped a step at capacity {cap})")
    for key in ["a_logits", "c_logits"] + [f"b{pos}_logits" for pos in SD_B_POS]:
        for r in ranks:  # the data ranks of (b) and the model ranks of a row agree bit for bit
            twin = ranks[r["pos"][1]] if key[0] == "b" else ranks[2 * r["pos"][0]]
            if not torch.equal(r[key], twin[key]):
                problems.append(f"serve_dist {key}: rank {r['pos']} differs from rank "
                                f"{twin['pos']}")
    dry = []
    for name, pred, peak in [("(a) decode", pred_a, ranks[0]["a_peak"])] + [
            (f"(b) decode pos {pos}", pred_b, ranks[0][f"b{pos}_peak"]) for pos in SD_B_POS]:
        p = pred["peak_bytes"]
        dry.append(f"{name}: dry run {p / 1e9:.3f} GB against max_memory_allocated "
                   f"{peak / 1e9:.3f} GB, off by {abs(p - peak) / peak:.2%}")
        if abs(p - peak) / peak > DRY_TOL:
            problems.append(f"serve_dist rank 0's {dry[-1]}, over {DRY_TOL:.0%}")
    say(f"phase 5 serve_dist: logits against the one-process port on the card: "
        f"{'; '.join(gates)}; rank 0's peak over one step against the dry run's (--per-rank "
        f"--model-shards {TP_M}, {dry_s:.1f} s on meta tensors): {'; '.join(dry)} (bound "
        f"{DRY_TOL:.0%}); collective bytes a rank by op: (a) "
        f"{json.dumps(pred_a['collective_bytes'])}, (b) "
        f"{json.dumps(pred_b['collective_bytes'])} (dry run)")
    lead = ranks[0]
    say(f"phase 6 serve_dist ({how}): (a) prefill {max(r['a_prefill_ms'] for r in ranks):.1f} "
        f"ms for a rank's {SD_A_ROWS // SD_DATA} prompts, decode step "
        f"{sorted(round(x, 1) for x in lead['a_ms'])[len(lead['a_ms']) // 2]} ms median "
        f"(rank 0), peak {lead['a_peak'] / 1e9:.3f} GB a rank; (b) decode step "
        + ", ".join(f"pos {pos}: {sorted(round(x, 1) for x in lead[f'b{pos}_ms'])[SD_B_STEPS // 2]}"
                    f" ms median, peak {lead[f'b{pos}_peak'] / 1e9:.3f} GB" for pos in SD_B_POS)
        + f"; (c) {SD_C_STEPS} MoE decode steps {max(r['c_ms'] for r in ranks):.1f} ms")
    if problems:
        fail(" | ".join(problems))


def th_config():
    """tp_heads' configuration: internvl2-1b at full width, TH_LAYERS layers,
    text only."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TH_ARCH), n_layers=TH_LAYERS, prefix_embeds=0)


def th_model(dev, tp=None):
    """tp_heads' model from seed SEED (the one-card model, or model rank
    tp.rank's shards of it), the train steps' tokens [2, n, B, S] and the
    FedAvg round's [n, k, B, S]."""
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    cfg = th_config()
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED),
                  tp_world=tp)
    stream = make_federated_batches(cfg, TH_N, TS_B, TS_S, seed=SEED)
    steps = np.stack([stream.global_batch(i)["tokens"] for i in range(2)])
    fed = np.stack([np.stack([stream.learner_batch(r, 10 + k)["tokens"] for k in range(DIST_K)])
                    for r in range(TH_N)])
    return model, steps, fed


def th_serve_tokens(cfg):
    """tp_heads' decode tokens, [TH_SERVE_STEPS, TH_N]: row l's are data
    rank l's."""
    return np.random.RandomState(SEED + 11).randint(0, cfg.vocab, (TH_SERVE_STEPS, TH_N))


def th_serve(model, rows, mesh=None):
    """Traffic B's prompts ``rows`` (indices) each prefilled alone into its
    row of a cache of SD_A_MAX, then TH_SERVE_STEPS decode steps
    teacher-forced on their columns of ``th_serve_tokens``. Returns (logits
    [steps + 1, rows, V] on the host, the decode steps' ms)."""
    from repro_torch.serve import make_serve_step
    prompts = [r.prompt for r in serve_requests(model.cfg, "B")]
    tokens = th_serve_tokens(model.cfg)[:, rows]
    with torch.inference_mode():
        logits, cache = sd_prefill(model, [prompts[i] for i in rows])
        step = make_serve_step(model, mesh)
        out, ms = [logits.float().cpu()], []
        for t in range(TH_SERVE_STEPS):
            tok = torch.from_numpy(tokens[t]).to(logits.device)
            if mesh is not None:
                import torch.distributed as dist
                dist.barrier()
            sync()
            t0 = time.perf_counter()
            logits, cache = step(model.tree(), tok, cache)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits.float().cpu())
        del cache, logits
    return torch.stack(out), ms


def _tp_heads_rank(world):
    """One rank of the tp_heads path (spawned): learner l's model shard j
    of the TH_N x TH_M grid. Two train steps (learner DIST_DEAD dead in the
    second) with their collectives timed, a weighted FedAvg round, then its
    data rank's prompt prefilled and decoded (``th_serve``); the launch
    counts read after the train step and the round. Outside the timed
    parts: the second step's chunks, each ring's rows to its head (learner
    0), which runs the one-card round on them, compared by digest with
    every rank's published chunk; each rank's ZeRO-1 part against FlatAdamW
    of its words of the published chunks; the full leaves on global rank
    0."""
    import torch.distributed as dist

    from repro_torch.core import make_aggregator
    from repro_torch.dist import collectives, grid
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import AdamState, FlatAdamW
    from repro_torch.train import make_federated_round, make_train_step
    dev = world.device
    g = grid(world, TH_M)
    l, j = g.data.rank, g.model.rank
    out = {"pos": (l, j), "step_ms": [], "step_transport_ms": [], "losses": [], "phase_s": {}}
    clock = [time.perf_counter()]

    def lap(part):  # the rank's seconds by part of its work
        now = time.perf_counter()
        out["phase_s"][part] = round(now - clock[0], 2)
        clock[0] = now
    build.reset_launches()
    warm_cublas(dev)  # cuBLAS's workspaces
    sync()
    base = torch.cuda.memory_allocated(dev)
    model, steps, fed = th_model(dev, g.model)
    cfg = model.cfg
    out["q_heads"] = model.tree()["blocks"][0]["attn"]["wq"].shape[-1] // cfg.resolved_head_dim
    agg = make_aggregator("safe", TH_N, device=dev)
    rounds = []
    aggregate_rank = agg.aggregate_rank

    def record(values, counter_base=0, **kw):
        """Each step's words of the published chunk this rank's ZeRO-1 part
        updates (to the host), the second step's input and published chunks."""
        mean = aggregate_rank(values, counter_base, **kw)
        second = len(rounds) == 1
        part = mean.numel() // TH_N
        rounds.append((values.clone() if second else None, mean.clone() if second else None,
                       mean[l * part:(l + 1) * part].to("cpu", copy=True),
                       counter_base, kw["alive"], kw["rotate"]))
        return mean

    agg.aggregate_rank = record
    bundle = make_train_step(model, agg, g, lr=TS_LR)
    state = bundle.init_state_fn(model.tree())
    master0 = state["master"].to("cpu", copy=True)
    out["padded_size"] = bundle.padded_size
    sync()
    lap("build")
    torch.cuda.reset_peak_memory_stats(dev)
    for i, alive in enumerate((np.ones(TH_N, np.float32), pod_alive(TH_N))):
        toks = torch.from_numpy(steps[i][l]).to(dev)
        counter = agg.reserve_round(bundle.padded_size + 2)
        dist.barrier()
        sync()
        collectives.reset_stats(timed=True)
        t0 = time.perf_counter()
        state, m = bundle.step_fn(state, toks, counter=counter, alive=alive)
        sync()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["step_transport_ms"].append(collectives.stats["seconds"] * 1e3)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["step1_peak"] = torch.cuda.max_memory_allocated(dev) - base
    collectives.reset_stats()
    out["train_peak"] = torch.cuda.max_memory_allocated(dev) - base
    launches = dict(build.launches)
    lap("steps")

    # the second step's chunks against the one-card round of their rows
    sync()
    torch.cuda.empty_cache()
    rows, pub, _, counter, alive, rotate = rounds[1]
    L = pub.numel()
    rows = collectives.gather_to_host(rows, 0, g.data)
    mine = torch.tensor(list(bytes.fromhex(digest(pub))), dtype=torch.uint8, device=dev)
    pubs = [bytes(d.tolist()).hex() for d in collectives.all_gather(mine, g.data).cpu()]
    ok = True
    if l == 0:  # ring j's head: the one-card round of the ring's rows
        want = make_aggregator("safe", TH_N, device=dev).aggregate(
            rows.view(TH_N, L).to(dev), counter + j * (L // 2), alive=alive, rotate=rotate)
        ok = all(d == digest(want) for d in pubs)
        del want
    del rows, pub
    sync()
    torch.cuda.empty_cache()
    out["chunks_exact"] = bool(collectives.all_gather(torch.tensor([int(ok)], device=dev),
                                                      world).all())
    lap("chunks check")
    master = master0.to(dev)
    zero = torch.zeros_like(master)
    opt, st = FlatAdamW(lr=TS_LR, weight_decay=0.1), AdamState(0, zero, zero.clone())
    for r in rounds:
        master, st = opt.update(r[2].to(dev), st, master, inplace=True)
    ok = digest(master, st.m, st.v) == digest(state["master"], state["fm"], state["fv"])
    out["zero1"] = bool(collectives.all_gather(torch.tensor([int(ok)], device=dev),
                                               world).all())
    out["master_words"] = state["master"].numel()
    del rounds, master0, master, zero, st
    lap("ZeRO-1 check")
    out["train_leaves"] = tp_full_leaves(state["params"], model, g.data, g.model)
    del state, bundle, agg, model
    sync()
    torch.cuda.empty_cache()
    lap("leaves")

    # the weighted FedAvg round
    model = th_model(dev, g.model)[0]
    agg = make_aggregator("safe", TH_N, weighted=True, device=dev)
    fb = make_federated_round(model, agg, g, local_steps=DIST_K, local_lr=FED_LR,
                              return_delta=True)
    counter = agg.reserve_round(fb.padded_size + 1)
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    params, m = fb.round_fn(model.tree(), torch.from_numpy(fed[l]).to(dev),
                            weights=TH_WEIGHTS, counter=counter, alive=pod_alive(TH_N))
    sync()
    out["fedavg_ms"] = (time.perf_counter() - t0) * 1e3
    out["fedavg_peak"] = torch.cuda.max_memory_allocated(dev) - base
    out["fed_padded"] = fb.padded_size
    out["launches"] = {k: launches[k] + build.launches[k] for k in launches}
    out["fed_loss"] = float(m["local_loss"])
    out["fed_delta"] = m["avg_delta"].cpu() if world.rank == 0 else None
    out["fed_leaves"] = tp_full_leaves(params, model, g.data, g.model)
    del params, m, fb, agg
    sync()
    torch.cuda.empty_cache()
    lap("fedavg")

    # serving: this data rank's prompt over the model group
    t0 = time.perf_counter()
    out["serve_logits"], out["serve_ms"] = th_serve(model, [l], g)
    out["serve_s"] = time.perf_counter() - t0
    del model
    lap("serve")
    dist.barrier()
    lap("barrier")
    return out


def th_one_card(dev):
    """tp_heads' work on one card: the initial leaves, two train steps, the
    weighted FedAvg round, and the TH_N prompts' prefills and decode steps."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import make_federated_round, make_train_step
    from repro_torch.train.flatten import leaves
    model, steps, fed = th_model(dev)
    out = {"init": [p.detach().to("cpu", copy=True) for p in leaves(model.tree())],
           "losses": []}
    agg = make_aggregator("safe", TH_N, device=dev)
    bundle = make_train_step(model, agg, lr=TS_LR)
    state = bundle.init_state_fn(model.tree())
    del model
    for i, alive in enumerate((np.ones(TH_N, np.float32), pod_alive(TH_N))):
        state, m = bundle.step_fn(state, torch.from_numpy(steps[i]).to(dev),
                                  counter=agg.reserve_round(bundle.padded_size + 2), alive=alive)
        out["losses"].append(float(m["loss"]))
    out["train"] = [p.detach().cpu() for p in leaves(state["params"])]
    del state, bundle
    torch.cuda.empty_cache()
    model = th_model(dev)[0]
    agg = make_aggregator("safe", TH_N, weighted=True, device=dev)
    fb = make_federated_round(model, agg, local_steps=DIST_K, local_lr=FED_LR,
                              return_delta=True)
    params, m = fb.round_fn(model.tree(), torch.from_numpy(fed).to(dev), weights=TH_WEIGHTS,
                            counter=agg.reserve_round(tree_size_of(model) + 1),
                            alive=pod_alive(TH_N))
    out["fed"] = ([p.detach().cpu() for p in leaves(params)], m["avg_delta"].cpu(),
                  float(m["local_loss"]))
    del params, m, fb
    torch.cuda.empty_cache()
    model = th_model(dev)[0]
    out["serve_logits"], _ = th_serve(model, list(range(TH_N)))
    del model
    torch.cuda.empty_cache()
    return out


def th_dryrun():
    """The dry run's rank 0 of tp_heads' grid (meta tensors): its record."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    try:
        return dryrun.measure(th_config(), "train_4k", shape=dict(
            seq_len=TS_S, global_batch=TH_N * TS_B, kind="train"),
            learners=TH_N, batch=TS_B, per_rank=True, model_shards=TH_M)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_heads_path(dev, launches, err, smi):
    """The tp_heads path: whole-unit uneven head splits, TH_N learners x
    TH_M model shards spawned and sharing the card (``transport="host"``),
    against the same work in this process on the card: the second step's
    chunks (each the one-card round of its rows) and the ZeRO-1 parts
    exactly, the float math within tp_dist's bounds, prefill and decode
    within SERVE_TOL, rank 0's first-step peak against the dry run's; adds
    the ranks' launches to ``launches`` and the kernels' checks at the
    path's chunks to ``err``."""
    t0 = time.perf_counter()
    pred = th_dryrun()
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = th_one_card(dev)
    one_s = time.perf_counter() - t0
    size = TH_N * TH_M
    t0 = time.perf_counter()
    ranks = spawn_ranks(_tp_heads_rank, size)
    ranks_s = time.perf_counter() - t0
    how = (f"{TH_N} learners x {TH_M} model shards = {size} ranks sharing "
           f"{torch.cuda.device_count()} card ({smi}), gloo through pinned host buffers")
    cfg = th_config()
    counts = {k: sum(r["launches"][k] for r in ranks) for k in DIST_KERNELS}
    padded, fed_padded = ranks[0]["padded_size"], ranks[0]["fed_padded"]
    chunks = [(padded // TH_M, j * padded // TH_M) for j in range(TH_M)]
    chunks += [(fed_padded // TH_M + (j == TH_M - 1), j * fed_padded // TH_M)
               for j in range(TH_M)]
    t1 = time.perf_counter()
    kerr, checks = check_tp_kernels(dev, chunks, err)
    heads = [r["q_heads"] for r in ranks[:TH_M]]
    say(f"phase 4 main path tp_heads ({how}; dist.grid: rank l*{TH_M} + j): {TH_ARCH} at full "
        f"width ({cfg.n_heads} q heads of {cfg.resolved_head_dim}, {cfg.n_kv_heads} kv heads, "
        f"d_ff {cfg.d_ff}, vocabulary {cfg.vocab} replicated), reduced: n_layers 24 -> "
        f"{TH_LAYERS}, prefix_embeds 256 -> 0 (text only); whole q heads split unevenly "
        f"{heads} a model rank, the kv heads on every rank; two train steps (learner "
        f"{DIST_DEAD} dead in the second), a weighted FedAvg round of {DIST_K} local steps, "
        f"then {TH_N} of traffic B's prompts (one a data rank) prefilled and {TH_SERVE_STEPS} "
        f"decode steps through make_serve_step(model, grid), teacher-forced on seeded tokens; "
        f"padded_size {padded} (chunks of "
        f"{padded // TH_M}), the FedAvg round's {fed_padded}; {ranks_s:.1f} s spawned, "
        f"{one_s:.1f} s for the same in one process; launches summed over the ranks {counts}; "
        f"the kernels at the path's chunks (length, start word) {chunks} == plain: {checks} "
        f"comparisons in {time.perf_counter() - t1:.1f} s, max |err| {kerr}")
    missing = sorted(k for k in PATH_KERNELS["tp_heads"] if counts[k] <= 0)
    if missing:
        fail(f"path tp_heads never launched {missing} in its ranks: {counts}")
    for k, c in counts.items():
        launches[k] += c

    lead = ranks[0]
    problems = []
    if heads != [4, 4, 3, 3]:
        problems.append(f"tp_heads: the model ranks hold {heads} q heads, not 4, 4, 3, 3")
    if not lead["chunks_exact"]:
        problems.append("tp_heads: a published chunk differs from the one-card round of its "
                        "rows")
    if not lead["zero1"]:
        problems.append("tp_heads: a rank's ZeRO-1 part is not FlatAdamW of its words of the "
                        "published means")
    if any(r["losses"] != lead["losses"] for r in ranks):
        problems.append(f"tp_heads: the ranks' losses differ: {[r['losses'] for r in ranks]}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lead["losses"], one["losses"]))
    change = _rel(lead["train_leaves"], one["train"], one["init"], dev)
    fo = one["fed"]
    fed_loss_rel = abs(lead["fed_loss"] - fo[2]) / abs(fo[2])
    delta_rel = _rel([lead["fed_delta"][:fo[1].numel()]], [fo[1]], [torch.zeros_like(fo[1])],
                     dev)
    fed_change = _rel(lead["fed_leaves"], fo[0], one["init"], dev)
    floats = (f"losses {[round(x, 5) for x in lead['losses']]} vs one card's "
              f"{[round(x, 5) for x in one['losses']]} ({loss_rel:.2e} relative, bound "
              f"{TP_LOSS_RTOL}); the parameters' change over two steps {change:.3e} relative L2 "
              f"(bound {TP_CHANGE_REL}); FedAvg: local loss {fed_loss_rel:.2e} relative, the "
              f"published delta {delta_rel:.3e} and the parameters' change {fed_change:.3e} "
              f"relative L2 (bound {TP_CHANGE_REL})")
    if (loss_rel > TP_LOSS_RTOL or change > TP_CHANGE_REL or fed_loss_rel > TP_LOSS_RTOL
            or max(delta_rel, fed_change) > TP_CHANGE_REL):
        problems.append(f"tp_heads: the float math left its bounds: {floats}")
    worst = 0.0
    for r in ranks:
        l = r["pos"][0]
        got, want = r["serve_logits"][:, 0], one["serve_logits"][:, l]
        if not torch.isfinite(got).all():
            problems.append(f"tp_heads: rank {r['pos']} has a non-finite logit")
        for s in range(want.shape[0]):
            worst = max(worst, float((got[s] - want[s]).abs().max() / want[s].abs().max()))
        if not torch.equal(r["serve_logits"], ranks[l * TH_M]["serve_logits"]):
            problems.append(f"tp_heads: rank {r['pos']}'s logits differ from its row's rank 0")
    serve = (f"prefill and {TH_SERVE_STEPS} decode steps {worst:.2e} of max |logit| from the "
             f"one-process run's on the same tokens (bound {SERVE_TOL})")
    if worst > SERVE_TOL:
        problems.append(f"tp_heads: {serve}")
    p, r = pred["peak_bytes"], lead["step1_peak"]
    dry = (f"rank 0's first step: dry run (--per-rank --model-shards {TH_M}) {p / 1e9:.3f} GB "
           f"against max_memory_allocated {r / 1e9:.3f} GB, off by {abs(p - r) / r:.2%}")
    if abs(p - r) / r > DRY_TOL:
        problems.append(f"tp_heads {dry}, over {DRY_TOL:.0%}")
    dry += f"; {gathered_head('tp_heads')}"
    say(f"phase 5 tp_heads: every rank's published chunk of the second step torch.equal to the "
        f"one-card round of its rows (the counter base moved to the chunk's start word): "
        f"{lead['chunks_exact']}; every rank's ZeRO-1 part ({lead['master_words']} words) after "
        f"two steps word for word FlatAdamW from its initial part by its words of the published "
        f"chunks: {lead['zero1']}; against the one-card step on the same weights (bf16): "
        f"{floats}; {serve}; {dry} (bound {DRY_TOL:.0%}, {dry_s:.1f} s on meta tensors)")
    for i in range(2):
        walls = [x["step_ms"][i] for x in ranks]
        tr = [x["step_transport_ms"][i] for x in ranks]
        say(f"phase 6 tp_heads train step {i + 1} ({how}): wall {max(walls):.1f} ms; in "
            f"collectives {[round(t, 1) for t in tr]} ms, transport share "
            f"{[f'{t / w:.0%}' for t, w in zip(tr, walls)]}")
    say(f"phase 6 tp_heads ({how}): FedAvg round wall {max(x['fedavg_ms'] for x in ranks):.1f} "
        f"ms; serving {max(x['serve_s'] for x in ranks):.1f} s a rank, decode step "
        f"{sorted(round(x, 1) for x in lead['serve_ms'])[TH_SERVE_STEPS // 2]} ms median (rank "
        f"0); peaks: train steps {[round(x['train_peak'] / 1e9, 2) for x in ranks]} GB a rank "
        f"(the dry run's rank 0 {p / 1e9:.2f} GB, by category "
        f"{json.dumps({k: round(v / 1e9, 3) for k, v in pred['peak_by_category'].items()})}), "
        f"FedAvg {[round(x['fedavg_peak'] / 1e9, 2) for x in ranks]} GB; collective bytes of "
        f"rank 0's step by op (dry run) {json.dumps(pred['collective_bytes'])}; rank 0's "
        f"seconds by part {json.dumps(lead['phase_s'])} of {ranks_s:.1f} s spawned")
    if problems:
        fail(" | ".join(problems))


def tree_size_of(model):
    from repro_torch.train import tree_size
    return tree_size(model.tree())


def nccl_tp_paths():
    """``python3 chip_smoke.py --nccl4-tp``, on a host with four cards: the
    launcher under ``torch.distributed.run`` with ``--learners 2
    --model-shards 2`` (2 learners x 2 model shards, a card a rank, nccl),
    internlm2-1.8b at all 24 layers, BON then INSEC (SAFE's rings need 3
    learners), after the dry run sizes rank 0's step; each rank's steps'
    peak against it; then zamba2-2.7b and rwkv6-1.6b with BON at the depth
    the dry run fits (``nccl_tp_zoo``); then the smoke model through the
    same layout with a checkpoint every step and a run resumed from step 1,
    whose step-2 checkpoint must equal the uninterrupted run's word for
    word."""
    import gzip
    import shutil
    import tempfile

    from repro_torch.launch.dryrun import H100_USABLE_BYTES
    cards, smi, env, run = nccl_setup()
    line = smi.splitlines()[0]
    layout = ["--learners", "2", "--model-shards", "2", "--seq-len", str(TS_S),
              "--batch-per-learner", str(TS_B), "--lr", str(TS_LR)]
    for mode in ("bon", "insec"):
        t0 = time.perf_counter()
        pred = tp_dryrun(24, 2, 2, mode)
        p = pred["peak_bytes"]
        say(f"nccl tp dry run ({mode}): {TS_ARCH} at 24 layers, rank 0 of 2 learners x 2 model "
            f"shards: {p / 1e9:.3f} GB (by category "
            f"{json.dumps({k: round(v / 1e9, 3) for k, v in pred['peak_by_category'].items()})}); "
            f"{'fits' if p <= H100_USABLE_BYTES else 'does not fit'} "
            f"{H100_USABLE_BYTES / 1e9:.1f} GB ({time.perf_counter() - t0:.1f} s)")
        if p > H100_USABLE_BYTES:
            fail(f"nccl tp: the dry run says 24 layers do not fit a card ({mode})")
        with tempfile.TemporaryDirectory() as tmp:
            metrics = os.path.join(tmp, "m.jsonl")
            t0 = time.perf_counter()
            proc = subprocess.run(run + ["-m", "repro_torch.launch.train", "--arch", TS_ARCH,
                                         "--steps", str(NCCL_STEPS), "--aggregator", mode,
                                         *layout, "--metrics", metrics],
                                  env=env, capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            lines = proc.stdout.splitlines()
            say("\n".join(ln for ln in lines if "rank" in ln or ln.startswith("done")))
            if proc.returncode != 0:
                fail(f"nccl tp launcher ({mode}): rc {proc.returncode}\n{proc.stderr[-3000:]}")
            recs = [json.loads(ln) for ln in open(metrics) if ln.strip()]
        peaks = [float(ln.split("steps' peak ")[1].split(" GB")[0]) * 1e9 for ln in lines
                 if "steps' peak " in ln]
        times = [r["time"] for r in recs]
        walls = [round((b - a) * 1e3, 1) for a, b in zip(times, times[1:])]
        off = [abs(p - r) / r for r in peaks]
        say(f"nccl tp launcher ({line} x{cards}, nccl, a card a rank, 2 learners x 2 model "
            f"shards, {mode}): {TS_ARCH} at 24 layers, {NCCL_STEPS} steps in {wall:.1f} s with "
            f"start-up; losses {[round(r['loss'], 4) for r in recs]}; steps 2.. wall {walls} ms "
            f"(rank 0's metrics); the steps' peak a rank {[round(r / 1e9, 3) for r in peaks]} GB "
            f"against the dry run's rank 0 {p / 1e9:.3f} GB, off by "
            f"{[f'{o:.2%}' for o in off]}")
        if len(peaks) != 4 or not all(math.isfinite(r["loss"]) for r in recs):
            fail(f"nccl tp launcher ({mode}): {len(peaks)} ranks reported, losses {recs}")
        if off[0] > DRY_TOL:
            fail(f"nccl tp ({mode}): the dry run is {off[0]:.2%} off rank 0's peak")
    for arch in NCCL_TP_ZOO:  # the newly split kinds, BON, at the depth the dry run fits
        nccl_tp_zoo(arch, run, env, layout, line, cards)
    with tempfile.TemporaryDirectory() as tmp:
        smoke = ["-m", "repro_torch.launch.train", "--arch", TS_ARCH, "--smoke", "--steps", "2",
                 "--aggregator", "bon", "--learners", "2", "--model-shards", "2",
                 "--ckpt-every", "1", "--ckpt-dir"]
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        for where, before in ((a, None), (b, a)):
            if before:
                shutil.copytree(before, where)
                shutil.rmtree(os.path.join(where, "step_00000002"))
            proc = subprocess.run(run + smoke + [where], env=env, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                fail(f"nccl tp resume: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        same = all(gzip.open(os.path.join(a, "step_00000002", f)).read()
                   == gzip.open(os.path.join(b, "step_00000002", f)).read()
                   for f in ("buffers.bin.gz", "manifest.msgpack.gz"))
        if "resumed from step 1" not in proc.stdout or not same:
            fail("nccl tp resume: the resumed run's step 2 differs from the uninterrupted run's")
        say(f"nccl tp resume ({line} x{cards}, smoke, 2 learners x 2 model shards, BON, nccl): "
            "the run resumed from step 1 wrote step 2 word for word as the uninterrupted run "
            "did (the one-process checkpoint: full leaves, whole vectors)")


def nccl_tp_zoo(arch, run, env, layout, line, cards):
    """``--nccl4-tp``'s ``arch`` through the launcher at 2 learners x 2 model
    shards with BON, a card a rank, at its full depth or the most layers
    the dry run's rank 0 fits a card with; each rank's steps' peak against
    the dry run's."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    t0 = time.perf_counter()
    layers = cfg.n_layers
    pred = tp_dryrun(layers, 2, 2, "bon", arch)
    while pred["peak_bytes"] > dryrun.H100_USABLE_BYTES and layers > len(cfg.pattern):
        layers -= len(cfg.pattern)
        pred = tp_dryrun(layers, 2, 2, "bon", arch)
    p = pred["peak_bytes"]
    say(f"nccl tp dry run (bon): {arch} at {layers} of {cfg.n_layers} layers, rank 0 of 2 "
        f"learners x 2 model shards: {p / 1e9:.3f} GB (by category "
        f"{json.dumps({k: round(v / 1e9, 3) for k, v in pred['peak_by_category'].items()})}); "
        f"{'fits' if p <= dryrun.H100_USABLE_BYTES else 'does not fit'} "
        f"{dryrun.H100_USABLE_BYTES / 1e9:.1f} GB ({time.perf_counter() - t0:.1f} s)")
    if p > dryrun.H100_USABLE_BYTES:
        fail(f"nccl tp {arch}: the dry run says no depth fits a card")
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "m.jsonl")
        t0 = time.perf_counter()
        proc = subprocess.run(run + ["-m", "repro_torch.launch.train", "--arch", arch,
                                     "--steps", str(NCCL_STEPS), "--aggregator", "bon",
                                     "--n-layers", str(layers), *layout, "--metrics", metrics],
                              env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        say("\n".join(ln for ln in lines if "rank" in ln or ln.startswith("done")))
        if proc.returncode != 0:
            fail(f"nccl tp launcher ({arch}): rc {proc.returncode}\n{proc.stderr[-3000:]}")
        recs = [json.loads(ln) for ln in open(metrics) if ln.strip()]
    peaks = [float(ln.split("steps' peak ")[1].split(" GB")[0]) * 1e9 for ln in lines
             if "steps' peak " in ln]
    times = [r["time"] for r in recs]
    walls = [round((b - a) * 1e3, 1) for a, b in zip(times, times[1:])]
    off = [abs(p - r) / r for r in peaks]
    say(f"nccl tp launcher ({line} x{cards}, nccl, a card a rank, 2 learners x 2 model shards, "
        f"bon): {arch} at {layers} layers, {NCCL_STEPS} steps in {wall:.1f} s with start-up; "
        f"losses {[round(r['loss'], 4) for r in recs]}; steps 2.. wall {walls} ms (rank 0's "
        f"metrics); the steps' peak a rank {[round(r / 1e9, 3) for r in peaks]} GB against the "
        f"dry run's rank 0 {p / 1e9:.3f} GB, off by {[f'{o:.2%}' for o in off]}")
    if len(peaks) != 4 or not all(math.isfinite(r["loss"]) for r in recs):
        fail(f"nccl tp launcher ({arch}): {len(peaks)} ranks reported, losses {recs}")
    if off[0] > DRY_TOL:
        fail(f"nccl tp ({arch}): the dry run is {off[0]:.2%} off rank 0's peak")


def main():
    if "--nccl-pod-rank" in sys.argv:
        return nccl_pod_rank()
    if "--dist-depth" in sys.argv:
        return dist_depth([int(a) for a in sys.argv[sys.argv.index("--dist-depth") + 1:]])
    if "--nccl-rank" in sys.argv:
        return nccl_rounds_rank()
    if "--nccl-pod-ep-rank" in sys.argv:
        return nccl_pod_ep_rank()
    if "--nccl4" in sys.argv:
        return nccl_paths()
    if "--nccl4-tp" in sys.argv:
        return nccl_tp_paths()
    if "--nccl4-moe" in sys.argv:
        cards, smi, env, run = nccl_setup()
        return nccl_moe(run, env, smi, cards)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    from repro_torch.kernels import bon_mask as bm
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import chain_combine as cc
    from repro_torch.kernels import threefry_mask_add as tma

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"phase 1 card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    reports = build.build()
    say(f"phase 2 build: {time.perf_counter() - t0:.1f} s, libraries {sorted(reports) or 'cached'}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    err, checks = check_kernels(dev, (tma, cc, bm), ref)
    say(f"phase 3 kernels == plain: {checks} comparisons, max |err| {err} "
        f"({time.perf_counter() - t0:.1f} s)")
    dispatch_cost(dev, smi)

    walls = {}

    def timed(name, fn, *args):  # a path's wall-clock seconds, for the script's budget
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t, 1)
        return out

    launches, times, published = timed("aggregation", aggregation_paths, dev)
    torch.cuda.empty_cache()
    timed("wire", wire_paths, dev, launches, published, smi)
    torch.cuda.empty_cache()
    timed("fedavg", fedavg_paths, dev, launches, err, smi)
    torch.cuda.empty_cache()
    timed("train step", train_step_paths, dev, launches, err, smi)
    for name in ZOO_PATHS:
        timed(name, zoo_path, dev, name, launches, err, smi)
    timed("flat adamw", flat_adamw_check, dev)
    timed("wire fedavg", wire_fedavg_path, dev, smi)
    timed("launcher", launcher_paths, smi)
    timed("engine load", engine_load_path, dev, launches, smi)
    torch.cuda.empty_cache()
    timed("examples", examples_path, dev, launches, smi)
    torch.cuda.empty_cache()
    timed("serve", serve_paths, dev, launches, smi)
    torch.cuda.empty_cache()
    timed("prefill flash", prefill_flash_path, dev, launches, smi)
    torch.cuda.empty_cache()
    timed("dry run", dryrun_paths, dev, launches, smi)
    torch.cuda.empty_cache()
    # the paths across ranks, those of one rank count on one pool of ranks
    timed("dist", dist_paths, dev, launches, err, smi)
    torch.cuda.empty_cache()
    timed("moe dist", ep_dist_path, dev, launches, err, smi)
    torch.cuda.empty_cache()
    timed("pod ep", pod_ep_path, dev, launches, err, smi)  # starts the pod steps' 6 ranks
    torch.cuda.empty_cache()
    timed("pod dist", pod_dist_paths, dev, launches, err, smi)
    torch.cuda.empty_cache()
    timed("tp dist", tp_dist_path, dev, launches, err, smi)
    torch.cuda.empty_cache()
    timed("tp zoo", tp_zoo_path, dev, launches, err, smi)
    torch.cuda.empty_cache()
    timed("serve dist", serve_dist_path, dev, launches, smi)
    torch.cuda.empty_cache()
    timed("pod tp", pod_tp_path, dev, launches, err, smi)
    torch.cuda.empty_cache()
    timed("tp heads", tp_heads_path, dev, launches, err, smi)
    close_pool()
    say(f"phase 6 rank pools ({smi}): (ranks, start-up s, paths run) "
        f"{POOL['done']}: a path after a pool's first takes its ranks started")
    say(f"phase 6 script ({smi}): {time.perf_counter() - t_start:.1f} s from the start of "
        f"main, of a {LIMIT_S} s limit; seconds by path {json.dumps(walls)}")
    say(f"launches {json.dumps(launches)}")

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        t = times[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=err[name],
                            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                            bound_by=t["bound_by"], library_ms=None))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
