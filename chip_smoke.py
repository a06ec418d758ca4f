#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (coati_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

With CHIP_SMOKE_LOG=<file> in the environment, every JSON line it prints is
also appended to that file.

Phases, in order; any failure ends the run with a non-zero exit. The
first line names the host CPU (vendor, model, cores), on which every host
number is taken.

 1. build: nvcc builds every kernel under coati_tpu_torch/csrc for sm_90a,
    one process per source, all at once; ptxas's registers and spills of
    each kernel are reported, and the bf16 tensor-core kernels and every
    form of K1 must not spill.
 2. kernels: each kernel against its plain PyTorch version on the card, on
    the main paths' shapes (for the tensor-core bodies also the edges of
    their tiles, the other head sizes and the trainer's shapes; K1 in every
    form at the positions the paths decode, 3 to about 40, and at 0, 95 and
    249; K1, K5b, K3's bf16 body and all but dc of K4's must repeat bit for
    bit over two launches; K3's bf16 body must refuse Hm 257 before any
    launch), within a stated tolerance; each timed with CUDA events (median
    of 25 launches after warm-up, L2 flushed before each, the host's launch
    hidden behind a spin on the card), beside its bound and, where one
    PyTorch call computes the same function, that call (a yardstick only:
    the port never calls it); K2, K5f and K3 also beside the floor of their
    exponentials; the attention kernels and K1 also untimed at Dh 24, which
    they run zero-padded to 32. Then routing:
    forward + backward of the trainer's attention through K5f + K5b and
    through K2 + its replayed plain backward, side by side.
 3. chem (host only): the port's chemistry core. The native C libraries
    (coati_tpu_torch/native/*.c, built with cc) must build and load; the
    canonicalizer is timed over all 120,000 lines of
    corpora/chembl_synth_v1.smi.gz with its cache cleared (seconds,
    molecules/s, and how many the native and the Python path answered), and
    again warm; on a seeded sample of 2,000 lines its native path must equal
    its Python path byte for byte, every permuted writing must canonicalize
    to the line's canonical form, and the native matcher must split the
    tokenizer's text as the Python scan does.
 4. paths: the trained grande document docs/eval_model_r5.pkl on the card,
    through the user entry points. Each path starts with every kernel's
    launch count set to 0 and ends by reading the counts; runs through the
    plain versions, made for comparison, lie outside those windows.
    smiles: (a) an fp32 greedy round trip of 64 SMILES through the kernels
    and through the plain versions; (b) the production setting, bf16 with
    an int8 KV cache, at batch 1024, k 100, inverse temperature 2, at the
    document's n_seq 250 and at total_len 96, each with its encode timed
    alone and one round trip traced by torch.profiler (device time by
    kernel, the card's idle share).
    points: the 1,024 point clouds of coati_tpu_torch/data/points_fixture.npz
    through encode_points in fp32, by the message kernel and by its plain
    version; the cosine of each point embedding with the same molecule's
    SMILES embedding; points_to_2d_batch in the production setting, timed
    and traced the same way.
    points_from_smiles: the fixture's 1,024 SMILES embedded by the port's
    own conformer embedder (chem/conformers.py, host seconds); the atoms
    must equal the fixture's in every row and, in every row, the pairwise
    distances the fixture's (written by coati_tpu) within 1e-4 Angstrom
    (the worst row is printed); then points_to_2d_batch on those coordinates in the
    production setting: every row decodes, K3 launches once per EGNN layer
    and the int8 K1 every decode step.
    packed: the total_len 96 production round trip again under
    prefill_kernel="packed", which sends every full-sequence attention to
    the short-sequence kernel.
    k1_positions: after the paths, K1's int8 form timed at every position
    each production round trip decoded, and its time in each call weighted
    by those launches, beside its bound and the same launches priced at
    pos 95. Every traced call lists the device time of each of the port's
    kernels by name.
    mla_moe (after decode_graph; `python3 chip_smoke.py mla_moe` runs it
    alone): DeepSeek-V2-Lite's block as the trunk. K6 (absorbed-MLA decode,
    ops/kernels/mla_decode.py) against its plain version at B 1024, T 250,
    pos 3 / 95 / 249 within 2 bf16 ulps of the output's scale, the same
    bits over two launches and from the position read on the card, timed
    beside its bound, the plain version and SDPA; the grouped expert
    product against the per-expert loop (routed picks, and every pick on
    one expert); a seeded model at the cell's widths, its round trip of
    1,024 corpus SMILES graphed against eager: the same greedy and sampled
    tokens and K6 launches.
    decode_graph: the decode step captured once as a CUDA graph and
    replayed each token (models/decode_graph.py). K1's form that reads pos
    on the card against its host-int form at every position of B 1024,
    int8, T 250 (COATI) and T 128, Dh 32 (COATI2): the same bits where
    both take the same groups, else within 2 bf16 ulps; both timed at pos
    95, within 2%. Then the production round trip of 1,024 corpus SMILES
    (the trained document, then seeded COATI2) graphed and eager: greedy
    and sampled tokens equal under one generator seed, K1's launch counts
    equal, one capture, a replay for every decode step; capture seconds,
    kept shapes, the graph's static bytes and each way's seconds printed.
    Then (the trained document) greedy calls cycling over six batch sizes
    from 16 to 256, three rounds, against eager: the same tokens; each
    round's seconds and captures, and the memory reserved and at peak.
    top_k (after decode_graph; `python3 chip_smoke.py top_k` builds and
    runs it alone, about a minute): K7 (the sampler's exact top k,
    ops/kernels/top_k.py) against the stable sort, its plain version, bit
    for bit in values and indices, on rows of N(0, 9) among which the first
    are hard (all equal, all -inf, five levels, +0.0 / -0.0 across the cut,
    NaN of both signs and two payloads with infinities, ascending, a tie of
    seven across the 100th place): B 1024 x 13,603 and x 4,266 at k 100
    (timed beside the byte bound, the sort and torch.topk), the serving
    engine's 65 rows, 3-D and padded rows, widths 1,000, 128 and 100, the
    widest row (32,768) at k 128, and k 2; the sort past k 128 at k 1,000
    (timed), the whole row at 4,266 and 32,768, and k 129; k past the
    width, k 0, bfloat16, strided rows and a row of 32,769 raise
    ValueError. Then the trained document's
    production round trip of 1,024 SMILES at k 100 under three seeds,
    through K7 and through the stable sort: the same tokens, one K7 launch
    a decode step, and a profile.
    train: train_autoencoder with the grande recipe as it is written (16 x
    256 transformer, 5 x 256 EGNN, bf16 over float32 masters, batch 160,
    n_seq 80, remat of the transformer blocks, every row canonicalized, 30%
    of the targets permuted) on the fixture's molecules, from a seeded fresh
    model and a seeded global random module (permute_smiles draws from
    it), so a run repeats its batches: 3 warm-up and 20 timed steps, then
    a few more steps split into forward, backward and optimizer by CUDA
    events and traced by torch.profiler. Every loss must be finite, the autoregressive loss must
    fall, and the backward kernels must launch. The host pipeline is
    reported beside the step: the transform's seconds a batch inside the
    run, and replayed after it on the same raw batches, drawn again from
    the seeded pipe so that no copy is taken inside the run, cold (caches
    cleared) and warm, with the share of permuted targets and the
    canonicalizations each path answered.
    train_graph (after train; `python3 chip_smoke.py train_graph` runs it
    alone): the training step's forward and backward replayed from a CUDA
    graph a batch shape (training/step_graph.py) against the eager step.
    The grande recipe in bf16 with `p_clip_emb_smi` 0.4 (the generator's
    draws matter), 12 steps over batches that cycle through three (T, N)
    widths (each: eager, capture, two replays), three models from one seed
    in lockstep: two eager (inside `graphs.eager()`) and one graphed,
    each step started from the first eager model's state. The losses and
    the generators' states must be the same bits, and so every gradient
    but the point encoder's (K4's dc adds by float32 atomics, so those vary
    from eager run to eager run: within 1e-4 x max(1, max |eager|)); the
    parameters and Adam's moments after the step too where the clipped
    norms are the same bits. Which leaves differ, and by how much, graphed
    and eager beside eager and eager; K3, K4, K5f and K5b launches equal; 3
    captures and 6 replays. A capture while a loss of a step run by hand on
    the default stream is kept alive (its autograd graph holds the
    parameters' gradient accumulators there): one capture, two replays,
    the same losses as an eager twin. Then each path free-running from the
    seed: the steps' host seconds, the losses, the peak memory.
 5. train_fp32_vs_plain: one float32 training step at full width (4
    transformer layers, 2 EGNN layers, batch 64) from the same weights,
    batch and clip-token choice, through the kernels and through their plain
    versions: the loss and every parameter's gradient must agree. Once more
    at T 200, batch 32, where K2 carries the trunk and its backward replays
    the plain attention.
 6. coati2: COATI2 grande (16 x 512, 16 heads of 32, n_seq 128, SwiGLU-resnet
    heads, the coati2_12_12 vocabulary) from seeded fresh weights, written
    as a reference-format document and read back by load_coati2 on the card
    (after the COATI paths, before train). (a) An fp32 greedy round trip of
    64 corpus SMILES through the kernels and through the plain versions:
    embeddings within 1e-5, tokens equal on at least 63 rows, and a row that
    differs must first differ where the plain run's top-2 logit margin is
    under 1e-4 (printed); (b) the production setting, bf16 with the int8 KV
    cache, on the first 1,024 corpus SMILES that fit n_seq, k 100, inverse
    temperature 2, timed and traced (untrained weights rarely emit [STOP],
    so a call decodes to n_seq); (c) one property-conditioned decode
    ([PROPS]...[ENDPROPS][SMILES]) through hcoati_to_2d_batch. K2 and K1
    run at Dh 32. The kernels phase also holds K2, K1, K5f and K5b at
    COATI2's shapes.
 7. coati2_train (after train_fp32_vs_plain): train_coati2 with the grande
    recipe of examples/train_coati2.py in bf16 on corpus rows with only a
    'smiles' column (the transform computes every property, as a user's
    run does), batch 160, 3 warm-up and 10 timed steps from a seeded fresh
    model and a seeded global random module: K5f 64 and K5b 32 times a
    step, every loss finite, ar_loss falls; the transform's seconds a batch
    in the run and its share of the step (`coati2_host_pipeline`); the
    run's document reloaded by load_coati2 encodes as the model does; three
    steps traced on batches made before. Then coati2_fp32_vs_plain: one
    float32 step at full width (4 layers), batch 32, through the kernels
    and through the plain versions: loss within 1e-5 relative, every
    gradient within 1e-4 x max(1, max |plain|).
 8. dataset_pool (host only): the 1,024 fixture molecules written as 4
    pickle shards of COATI_dataset (rows cut to their atoms, source
    geom_drugs) and read back: rows per partition; then the grande recipe's
    clip_ar_xform (n_seq 80, batch 160) over the raw batches, serially and
    through XformWorkerPool at 1, 2 and cores - 2 workers (host caches
    cleared first), samples/s beside the trainer's mol/s of phase train,
    and the peak count of batches in flight, at most read_ahead + workers.
 9. train_restart: train_autoencoder with the grande recipe in bf16 on that
    COATI_dataset with orbax_dir, three times over one directory: one epoch
    with a mid-epoch and an end-of-run checkpoint; the same again, which
    takes no step and returns run 1's parameters, its checkpoint holding run
    1's parameters and optimizer state bit for bit; two epochs, resuming at
    epoch 1 with global_step carried on and every loss finite. The
    checkpoint's bytes and the save, write and restore seconds; K3, K4, K5f
    and K5b launches.
10. lora: the trained document at full width, rank-8 adapters, 20 AR steps
    of batch 64 in bf16 over bench.py's and the corpus's SMILES padded to
    n_seq 250 (K2 forward, its replayed backward): the loss of a fixed batch
    falls, the base weights do not move; the merged model written as a
    document and reloaded encodes as the merged model does, bit for bit.
    Then one float32 step through K2 against the plain versions: loss within
    1e-5 relative, adapter gradients within 1e-4 x max(1, max |plain|).
11. generative: the trained document in the production setting (bf16,
    int8 KV cache): bench.py's 16 SMILES embedded and force-decoded (how
    many come back as their input's canonical SMILES), 4 purified (n_rep
    128), a closed-form density over the fixture's 1,024 SMILES with 64
    draws force-decoded (the valid share), one epoch of
    estimate_density_batchwise at batch 1024; seconds of each.
12. serving: the HTTP server (coati_tpu_torch/serving/server.py) on
    127.0.0.1, warmed up before traffic. fp32: /embed of 64 corpus SMILES
    must equal in-process encode_tokens within 1e-5, and greedy (k 1)
    /generate through the micro-batcher and through the continuous engine
    must agree on at least 63 of 64 rows. The production setting (bf16,
    int8 KV cache, k 100, inverse temperature 2) behind the micro-batcher,
    8 client threads over urllib: /embed of the first 1,024 corpus SMILES
    that fit n_seq in requests of 16, /generate of those embeddings, and
    /analogs of bench.py's 16 SMILES (noise 0.3, 4 analogs each). Then
    continuous mode with 64 slots: 256 single-row /generate requests at t =
    0 (rows picked as scripts/bench_continuous.py picks them), and the same
    rows in-process through the engine and in drain-the-batch cohorts of 64,
    twice each; the engine's run traced (idle share, the ring attention's
    share of the card time). COATI2 grande (phase coati2's document): the
    fp32 checks, and 64 production requests in continuous mode. Every
    response must be 200 and every row a string. requests/s, mol/s, p50 and
    p99 per endpoint and mode. K2 and K1 held at the shapes and positions
    the phase ran them.
13. metadynamics: 4,096 corpus SMILES embedded by the trained document in
    the production setting; train_due (the published widths: 256 features,
    depth 4, 60 inducing points) against the port's Crippen logP, 2,000
    steps of batch 512, on 7/8 of them, then remove_spectral_norm; held-out
    RMSE (must be below the targets' spread) and calibration; the pure
    walk of 120 steps from a held-out molecule without and with hills (the
    checks of scripts/eval_metadynamics.py: the unbiased ascent never
    decreases and improves, the hills displace the samples more); then
    run_metadynamics from that molecule, 20 steps of 32 decodes. Seconds of
    each; K2 and K1 int8 held at the shapes and positions it ran.
14. examples: the port's user entry points (coati_tpu_torch/examples/),
    each through its main at the full width of the model it loads, after a
    COATI2 grande document, a DUE model of Crippen logP and the fixture's
    COATI_dataset shards are made for them: tutorial, chembl_analysis,
    generation_examples and metadynamics_example on the trained document;
    coati2_tutorial (its conditioned batch mixes prefixes of 5 and 7
    tokens: generate_prefix_batch prefills the shorter and forces the
    longer through its own); finetune_lora, whose document is reloaded;
    serve --tiny, over the trained document and over the COATI2 document,
    two rounds of requests each; train_grande and train_coati2 --dry_run,
    then one epoch of 3 steps each over the shards. Then the
    generation-quality protocol of scripts/eval_generation_quality.py on
    the trained document in its loader's setting: greedy round trips of
    2,048 train and 2,048 holdout molecules of the corpus's split and 10 x
    1,024 draws behind [SET][chembl_mols][SMILES] at k 10,000, inverse
    temperature 1.75, each number beside docs/eval_generation_quality.json's
    and within its band (round trips 0.04, fraction valid and unique 0.03).
    Seconds of each example; K2 and K1 held at every shape and position.
15. decode_quality: the JAX package's decode-quality protocol
    (scripts/torch_eval_trained_decode.py, the port's counterpart of
    scripts/eval_trained_decode.py) on the trained document. Four
    configurations built from it: fp32; bf16 over a bf16 KV cache; bf16
    over an int8 cache with float32 scales; the default (bf16, which takes
    the int8 cache). Each decodes the protocol's 2,048 train and 2,048
    holdout molecules from their float32 embeddings (k 2, inverse
    temperature 20) and 1,024 draws (k 100, inverse temperature 2) with the
    same seeds: round trips, mean length, stop rate, validity proxy, the
    token histogram's total variation against fp32's and the share of
    round-trip tokens equal to fp32's, one line a configuration. Every
    configuration but fp32 must keep its round trips within 0.02 of fp32's
    on each split and the TV within 0.05 (the JAX script's rule). Then the
    generation-quality protocol on the default configuration: fraction
    valid and unique within 0.03 of phase examples' float32 numbers, each
    number beside docs/eval_generation_quality.json's. The phase's seconds;
    K1's launches by the form of its cache (the bf16 cache must launch);
    K2 and K1 held at every shape and position.
16. multi_device: multi-device training and sharded inference on the one
    card. (a) World 1 over NCCL: one float32 step of the grande recipe at
    full width (batch 160 of the fixture through the recipe's transform,
    seeded clip-token choices) as train_autoencoder's step over a world-1
    mesh, in both formulations ("pjit", "shard_map") and under FSDP, each
    within the CPU tests' tolerance of the single-device step (losses 1e-5
    relative; parameters 3 lr everywhere, 1e-3 lr for 99.9%); K3, K4, K5f
    and K5b must launch; the bf16 step's seconds on one device and on the
    world-1 mesh. (b) World 2 as two processes on the one card over gloo
    (NCCL refuses two ranks on one device; gloo carries CUDA tensors): DP in
    both formulations and FSDP on each rank's half of the batch, TP 2 on the
    whole, each held to (a)'s single-device step (shard_map to the same
    step with its per-half AR mean); FSDP's moment bytes a rank must be
    about half of world 1's; the bf16 DP step's seconds (a test of
    correctness, not of scaling). K5f and K5b at TP's 8 heads held against
    their plain versions and timed. (c) ShardedCOATI over [cuda:0, cuda:0]
    with the trained document: 1,024 corpus SMILES, fp32 greedy, every
    token equal to the single-device decode; then a server with two
    replicas answers /embed and /generate as the single-device model.
    (d) World 2 on the one card over gloo: ring_permute carries a CUDA
    tensor forward and backward (its route printed); the composite grande
    step through the pipeline (pipe 2; 2 and 4 microbatches; fp32) held to
    (a)'s single-device step, and its reduced fp32 gradients before the
    optimizer held to that step's within 1e-4 x max(1, max |grad|), each
    rank launching K3, K4, K5f and K5b, then
    the bf16 pipelined step's seconds (median of 10); the trunk's AR step
    by ring attention (seq 2, T 80, 40 a shard; fp32) held to the
    single-device step, and make_sp_encode of 1,024 corpus SMILES (T 250)
    against encode_tokens; the MoE step (expert 2; D 256, F 1024, E 8;
    160 x 80 tokens, capacity factor 1, which drops tokens; fp32) held to
    the one-rank step. (e) dryrun_multichip(4): four gloo ranks on the card,
    its five lines. (f) The continuous engine over [cuda:0, cuda:0] with
    the trained document: 64 slots, 256 single-row fp32 greedy requests,
    every token equal to the single-device engine's, seconds of both; then a
    server in continuous mode over the two devices answers /generate as the
    single-device one.
17. report: the card's name and power limit, one `kernels` JSON line, and
    as the last line {"ok": true, "device": {...}}.

Every number printed is measured in this run, on this card, except the
bounds, which are computed from this run's shapes and the card's published
peaks (H100 SXM: 3.35 TB/s; 989 TFLOP/s bf16; 67 TFLOP/s fp32; 16
special-function results a clock on each of 132 SMs, at the highest SM
clock that nvidia-smi reports).
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import itertools
import json
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DOC = ROOT / "docs" / "eval_model_r5.pkl"
CORPUS = ROOT / "corpora" / "chembl_synth_v1.smi.gz"

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_ULP = 2.0**-7  # spacing of bf16 values in [1, 2)
# special-function results (ex2) a clock: 16 on each of an H100's 132 SMs
SFU_RESULTS_PER_CLOCK = 132 * 16

# the SMILES of bench.py, the JAX package's throughput workload
BENCH_SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
    "c1ccc2c(c1)cccn2",
    "OCC1OC(O)C(O)C(O)C1O",
    "CC(C)NCC(O)c1ccc(O)c(O)c1",
    "Clc1ccccc1C2=NCC(=O)Nc3ccc(cc23)N(=O)=O",
    "CC1=CC(=O)C=CC1=O",
    "NC(=O)c1ccc(N)cc1",
    "COc1cc2c(cc1OC)CC(N)C2",
    "CCN(CC)CCNC(=O)c1ccc(N)cc1",
    "CC(N)Cc1ccccc1",
    "OC(=O)c1ccccc1O",
    "Nc1ccc(cc1)S(=O)(=O)N",
    "CCOC(=O)c1ccccc1N",
    "CN(C)CCOC(c1ccccc1)c1ccccc1",
]


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if os.environ.get("CHIP_SMOKE_LOG"):
        with open(os.environ["CHIP_SMOKE_LOG"], "a") as log:
            log.write(line + "\n")


def check(cond: bool, what: str) -> None:
    if not cond:
        print(f"FAIL: {what}", flush=True)
        sys.exit(1)


# ------------------------------------------------------------- timing


_FLUSH = None


def time_ms(fn, n: int = 25, warmup: int = 3, spin: int = 200_000, flush=None) -> float:
    """Median device time of fn() in ms, by CUDA events around each call,
    with a 256 MB write before each to evict the 50 MB L2 (or `flush()`).
    A spin of `spin` clock cycles on the card (about 0.1 ms by default)
    follows it, so that the host has enqueued the start event and fn's
    kernels before the card reaches them: the time between the events is
    the card's, not the host's launch."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(n):
        if flush:
            flush()
        else:
            _FLUSH.zero_()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(n_bytes: float, n_ops: float, dtype: torch.dtype):
    """(least time in ms, what bounds it): bytes over the memory rate, or
    operations over the peak rate for the inputs' type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_SM_CLOCK_HZ = None


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    global _SM_CLOCK_HZ
    if _SM_CLOCK_HZ is None:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        )
        _SM_CLOCK_HZ = float(out.stdout.split()[0]) * 1e6
    return _SM_CLOCK_HZ


def attention_exps(name: str, dtype: torch.dtype, b: int, t: int, h: int) -> int:
    """Exponentials one call of K2 or K5f takes, counted at the kernel's
    tile granularity. bf16 bodies: K2 takes one per (query, key) of each
    warp's 16 rows and the 16-key chunks it computes (all of every key tile
    below the diagonal, those up to its last row on it), and two a lane per
    key tile to rescale; K5f one per (query, key) of its 16 x 16 tiles on
    and below the diagonal. The float32 bodies take one per causal pair."""
    if dtype == torch.float32:
        return b * h * t * (t + 1) // 2
    n = 0
    if name == "flash_causal_attention":
        for i in range(-(-t // 64)):
            for w in range(4):
                if 64 * i + 16 * w < t:
                    n += 16 * (64 * i + 16 * (w + 1)) + 64 * (i + 1)
    else:
        n = sum(16 * 16 * (i + 1) for i in range(-(-t // 16)))
    return b * h * n


def tolerance(ref: torch.Tensor, dtype: torch.dtype, fp32_tol: float) -> float:
    """bf16 output: 2 bf16 ulps of the output scale (rounding of the output
    and of the plain version's bf16 scores and probs); float32: fp32_tol
    (summation order only)."""
    if dtype == torch.bfloat16:
        return 2 * BF16_ULP * float(ref.float().abs().max())
    return fp32_tol


# -------------------------------------------------------------- phases


def _kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol:
    packed_causal_bf16_kernel<16,8> for ..25packed_causal_bf16_kernelILi16ELi8EEEv..."""
    # every digit run that could be a length prefix, suffixes of runs too
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled):
        start = m.start() + len(m.group(1))
        name = mangled[start:start + int(m.group(1))]
        if name.endswith("_kernel"):
            args = re.match(r"I(.*?)EEv", mangled[start + len(name):])
            if not args:
                return name
            text = re.sub(r"L[a-z](\d+)E", r"\1,", args.group(1).replace("13__nv_bfloat16", "bf16,"))
            return f"{name}<{re.sub(r'^f', 'f32,', text).rstrip(',')}>"
    return mangled


def ptxas_usage(log: str) -> dict:
    """{kernel: {"registers": n, "spill_bytes": stores + loads}} from the
    -Xptxas -v output of one nvcc run."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = _kernel_label(m.group(1))
            usage[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m.group(1))
    return usage


def phase_build():
    from coati_tpu_torch.ops.kernels import build

    seconds = build.build()
    usage = {name: ptxas_usage(log) for name, log in build.BUILD_LOG.items()}
    emit({"phase": "build", "sources": list(build.SOURCES), "seconds": round(seconds, 2),
          "arch": "sm_90a", "ptxas": usage})
    # the tensor-core bodies keep their scores (attention), their dW2 slice
    # (K4) and their z2 tile and range sums (K3) in registers, and K1 every
    # form its two chunks of the cache in flight: a spill would put them in
    # local memory
    spilled = [k for src in ("flash_attention", "packed_attention", "packed_attention_bwd",
                             "egnn_messages_bwd", "egnn_messages", "decode_attention")
               for k, u in usage.get(src, {}).items()
               if ("bf16" in k or src == "decode_attention") and u.get("spill_bytes", 0) > 0]
    check(not spilled, f"kernels spill registers: {spilled}")


def _attention_case(name, b, t, h, dh, dtype, gen, timed=True):
    """A full-sequence attention wrapper (K2 `flash_causal_attention` or
    K5f `packed_causal_attention`) against causal_attention; K5f's case also
    times K2 on the same inputs."""
    from coati_tpu_torch.ops.attention import causal_attention
    from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention
    from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention

    kernel = {"flash_causal_attention": flash_causal_attention,
              "packed_causal_attention": packed_causal_attention}[name]
    # strided q/k/v views of one fused projection, as the model passes them
    qkv = torch.randn(b, t, 3 * h * dh, generator=gen, device="cuda").to(dtype)
    q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    out = kernel(q, k, v)
    ref = causal_attention(q, k, v, torch.float32)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = tolerance(ref, dtype, 1e-5)
    elt = torch.finfo(dtype).bits // 8
    bound, by = bound_ms(4 * b * t * h * dh * elt, 4 * b * h * (t * (t + 1) // 2) * dh, dtype)
    case = {
        "kernel": name, "shape": [b, t, h, dh], "dtype": str(dtype)[6:],
        "max_abs_err": err, "tol": tol, "ok": err <= tol, "bound_ms": bound, "bound_by": by,
    }
    if not timed:
        return case
    exps = attention_exps(name, dtype, b, t, h)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    case.update({
        "ms": time_ms(lambda: kernel(q, k, v)),
        "plain_ms": time_ms(lambda: causal_attention(q, k, v, torch.float32)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        ),
        # the exponentials' floor on the special-function units, at the
        # highest SM clock
        "exps": exps, "sm_clock_mhz": sm_clock_hz() / 1e6,
        "exp_floor_ms": exps / (SFU_RESULTS_PER_CLOCK * sm_clock_hz()) * 1e3,
    })
    case["vs_library"] = case["ms"] / case["library_ms"]
    if kernel is packed_causal_attention:
        case["k2_ms"] = time_ms(lambda: flash_causal_attention(q, k, v))
    return case


def _fixture_geometry(rows=None, cutoff=5.0):
    """(d2, w, atom counts) of the fixture's molecules on the card, as
    egnn_forward computes them at a message cutoff in Angstrom: 5 in the
    trained document, 12 in the grande training recipe."""
    from coati_tpu_torch.data import load_points_fixture
    from coati_tpu_torch.models.egnn import pair_geometry

    _, atoms, coords = load_points_fixture()
    atoms, coords = atoms[:rows], coords[:rows]
    mask = torch.as_tensor(atoms > 0, device="cuda").float()
    d2, w = pair_geometry(mask, torch.as_tensor(coords, device="cuda"), cutoff)
    return d2, w, (atoms > 0).sum(1)


def _random_geometry(counts, n, gen):
    """(d2, w) of random point clouds with the given atom counts: points a
    few Angstrom apart, so that part of the pairs passes the cutoff."""
    from coati_tpu_torch.models.egnn import pair_geometry

    counts = torch.as_tensor(counts, device="cuda")
    mask = (torch.arange(n, device="cuda")[None, :] < counts[:, None]).float()
    coords = 3.0 * torch.randn(len(counts), n, 3, generator=gen, device="cuda")
    return pair_geometry(mask, coords, 5.0)


def _messages_case(d2, w, hm, mm_dtype, gen, label, timed=True):
    """K3 against its plain version (which walks the batch in chunks) on
    the pair geometry (d2, w), with random a, c and weights at the scale
    the encoder gives them. In the bf16-product mode a second launch must
    repeat the first bit for bit."""
    from coati_tpu_torch.ops import egnn_messages as plain
    from coati_tpu_torch.ops.kernels.egnn_messages import egnn_messages

    b, n, _ = d2.shape

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    a, c = rand(b, n, hm, scale=0.5), rand(b, n, hm, scale=0.5)
    wd, b1, b2 = rand(hm, scale=0.1), rand(hm, scale=0.1), rand(hm, scale=0.1)
    w2 = rand(hm, hm, scale=hm**-0.5)
    args = (a, c, d2, w, wd, b1, w2, b2)
    out = egnn_messages(*args, mm_dtype=mm_dtype)
    again = egnn_messages(*args, mm_dtype=mm_dtype)
    ref = plain.egnn_messages(*args, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    repeats = bool(torch.equal(out, again))
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    # float32: the order of the sums only (Hm products a pair, up to N pairs
    # an atom). bf16 product: the plain version rounds e1 and w2 to bf16 the
    # same way, but its SiLU and the kernel's differ in the last float32 bit,
    # which now and then rounds an e1 to the neighbouring bf16 value
    # (2^-8 relative, times one w2 entry, on one pair's message).
    tol = (1e-5 if mm_dtype == torch.float32 else 1e-3) * scale
    pairs = int((w != 0).sum())
    n_bytes = 4 * (3 * b * n * hm + 2 * b * n * n + hm * hm + 3 * hm)
    bound, by = bound_ms(n_bytes, pairs * (2 * hm * hm + 8 * hm), mm_dtype)
    exps = 2 * hm * pairs  # the two SiLUs of each live pair, an exponential each
    case = {
        "kernel": "egnn_messages", "case": label, "shape": [b, n, hm],
        "mm_dtype": str(mm_dtype)[6:], "live_pairs": pairs, "dense_pairs": b * n * n,
        "padding_rows_zero": bool((out[w.abs().sum(-1) == 0] == 0).all()),
        "repeats_bit_for_bit": repeats,
        "max_abs_err": err, "tol": tol, "ok": err <= tol,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        # the exponentials' floor on the special-function units, at the
        # highest SM clock (each SiLU also takes a reciprocal there)
        "exps": exps, "exp_floor_ms": exps / (SFU_RESULTS_PER_CLOCK * sm_clock_hz()) * 1e3,
    }
    case["ok"] = (case["ok"] and case["padding_rows_zero"]
                  and (repeats or mm_dtype == torch.float32))
    if timed:
        case["ms"] = time_ms(lambda: egnn_messages(*args, mm_dtype=mm_dtype))
        case["plain_ms"] = time_ms(
            lambda: plain.egnn_messages(*args, mm_dtype=mm_dtype), n=3, warmup=1
        )
    return case


def _messages_refusal_case(gen):
    """K3's bf16-product body keeps W2 in shared memory and takes Hm <= 256:
    at Hm 257 the wrapper must raise before any launch."""
    from coati_tpu_torch.ops.kernels.egnn_messages import FWD_MAX_HM, egnn_messages

    d2, w = _random_geometry([5, 3], 5, gen)
    hm = FWD_MAX_HM + 1
    x = torch.zeros(2, 5, hm, device="cuda")
    v, m = torch.zeros(hm, device="cuda"), torch.zeros(hm, hm, device="cuda")
    before = egnn_messages.launches
    try:
        egnn_messages(x, x, d2, w, v, v, m, v, mm_dtype=torch.bfloat16)
        message = None
    except ValueError as exc:
        message = str(exc)
    launched = egnn_messages.launches - before
    return {"kernel": "egnn_messages", "case": "refuses_hm_257", "shape": [2, 5, hm],
            "mm_dtype": "bfloat16", "raised": message, "launches": launched,
            "ok": message is not None and launched == 0}


def _attention_bwd_case(b, t, h, dh, dtype, gen, timed=True):
    """K5b `packed_causal_attention_backward` against
    causal_attention_backward, on strided q, k, v and a contiguous g; a
    second launch on the same inputs must repeat the first bit for bit."""
    from coati_tpu_torch.ops.attention import causal_attention_backward
    from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention_backward

    qkv = torch.randn(b, t, 3 * h * dh, generator=gen, device="cuda").to(dtype)
    q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    g = torch.randn(b, t, h, dh, generator=gen, device="cuda").to(dtype)
    outs = packed_causal_attention_backward(q, k, v, g)
    again = packed_causal_attention_backward(q, k, v, g)
    refs = causal_attention_backward(q, k, v, g)
    torch.cuda.synchronize()
    repeats = all(torch.equal(x, y) for x, y in zip(outs, again))
    # float32: the order of sums of up to T terms, on gradients that reach
    # 6-7 here; bf16: 2 ulps of each output's scale, as for the forward
    errs = [float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs)]
    tols = [tolerance(r, dtype, 2e-5) for r in refs]
    elt = torch.finfo(dtype).bits // 8
    # five products of 2 * Dh operations per causal pair: the scores, dP, dq, dk, dv
    bound, by = bound_ms(7 * b * t * h * dh * elt, 10 * b * h * (t * (t + 1) // 2) * dh, dtype)
    case = {
        "kernel": "packed_causal_attention_backward", "shape": [b, t, h, dh],
        "dtype": str(dtype)[6:], "max_abs_err": max(errs), "max_abs_err_dq_dk_dv": errs,
        "tol_dq_dk_dv": tols, "repeats_bit_for_bit": repeats,
        "ok": repeats and all(e <= t_ for e, t_ in zip(errs, tols)),
        "bound_ms": bound, "bound_by": by,
    }
    if not timed:
        return case
    qt, kt, vt, gt = (x.transpose(1, 2).detach() for x in (q, k, v, g))
    for x in (qt, kt, vt):
        x.requires_grad_(True)
    sdpa = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    case.update({
        "ms": time_ms(lambda: packed_causal_attention_backward(q, k, v, g)),
        "plain_ms": time_ms(lambda: causal_attention_backward(q, k, v, g)),
        # the library's backward alone, on a retained graph
        "library_ms": time_ms(
            lambda: torch.autograd.grad(sdpa, (qt, kt, vt), gt, retain_graph=True)
        ),
    })
    case["vs_library"] = case["ms"] / case["library_ms"]
    return case


def _messages_bwd_case(d2, w, hm, mm_dtype, gen, label, timed=True):
    """K4 `egnn_messages_backward` against its plain version on the pair
    geometry (d2, w), inputs as in _messages_case and a random cotangent. In
    the bf16-product mode a second launch must repeat da and the parameter
    gradients (dwd, db1, dW2, db2) bit for bit."""
    from coati_tpu_torch.ops import egnn_messages as plain
    from coati_tpu_torch.ops.kernels.egnn_messages import egnn_messages_backward

    b, n, _ = d2.shape

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    a, c = rand(b, n, hm, scale=0.5), rand(b, n, hm, scale=0.5)
    wd, b1, b2 = rand(hm, scale=0.1), rand(hm, scale=0.1), rand(hm, scale=0.1)
    w2 = rand(hm, hm, scale=hm**-0.5)
    args = (a, c, d2, w, wd, b1, w2, b2, rand(b, n, hm))
    outs = egnn_messages_backward(*args, mm_dtype=mm_dtype)
    again = egnn_messages_backward(*args, mm_dtype=mm_dtype)
    refs = plain.egnn_messages_backward(*args, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    names = ("da", "dc", "dwd", "db1", "dw2", "db2")
    # all but dc, which the bf16 body sums by float32 atomics
    repeats = all(torch.equal(x, y) for i, (x, y) in enumerate(zip(outs, again)) if i != 1)
    errs = {k: float((o - r).abs().max()) for k, o, r in zip(names, outs, refs)}
    scales = {k: max(1.0, float(r.abs().max())) for k, r in zip(names, refs)}
    # float32: the order of the sums only, by atomics for all but da; da and
    # dc sum up to N pairs, the parameter gradients every live pair (2e5 on
    # the fixture), so each is held relative to its own largest entry. bf16
    # products: as for K3, a last-bit difference of a SiLU now and then
    # rounds an e1 or a dz2 to the neighbouring bf16 value.
    rel = 1e-5 if mm_dtype == torch.float32 else 1e-3
    pairs = int((w != 0).sum())
    dead_i, dead_j = w.abs().sum(-1) == 0, w.abs().sum(-2) == 0
    zero = bool((outs[0][dead_i] == 0).all()) and bool((outs[1][dead_j] == 0).all())
    n_bytes = 4 * (5 * b * n * hm + 2 * b * n * n + 2 * hm * hm + 6 * hm)
    bound, by = bound_ms(n_bytes, pairs * (6 * hm * hm + 24 * hm), mm_dtype)
    case = {
        "kernel": "egnn_messages_backward", "case": label, "shape": [b, n, hm],
        "mm_dtype": str(mm_dtype)[6:], "live_pairs": pairs, "dense_pairs": b * n * n,
        "dead_rows_and_columns_zero": zero, "repeats_but_dc": repeats,
        "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
        "tol_by_output": {k: rel * scales[k] for k in names},
        "ok": zero and (repeats or mm_dtype == torch.float32)
        and all(errs[k] <= rel * scales[k] for k in names),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }
    if timed:
        case["ms"] = time_ms(lambda: egnn_messages_backward(*args, mm_dtype=mm_dtype))
        case["plain_ms"] = time_ms(
            lambda: plain.egnn_messages_backward(*args, mm_dtype=mm_dtype), n=3, warmup=1
        )
    return case


def _decode_case(b, t, h, dh, pos, q_dtype, kv, gen, timed=True):
    """kv: a cache dtype (float32, bfloat16) or "int8/<scale dtype>"."""
    from coati_tpu_torch.models.transformer import quantize_kv
    from coati_tpu_torch.ops import attention as plain
    from coati_tpu_torch.ops.kernels import decode_attention as k1

    q = torch.randn(b, h, dh, generator=gen, device="cuda").to(q_dtype)
    k = torch.randn(b, t, h, dh, generator=gen, device="cuda")
    v = torch.randn(b, t, h, dh, generator=gen, device="cuda")
    live = pos + 1
    if isinstance(kv, str):
        scale_dtype = {"int8/float32": torch.float32, "int8/bfloat16": torch.bfloat16}[kv]
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        ks, vs = ks.to(scale_dtype), vs.to(scale_dtype)
        name = "decode_attention_quant"
        run = lambda: k1.decode_attention_quant(q, k8, ks, v8, vs, pos)  # noqa: E731
        run_plain = lambda: plain.decode_attention_quant(q, k8, ks, v8, vs, pos)  # noqa: E731
        scale_elt = torch.finfo(scale_dtype).bits // 8
        n_bytes = 2 * b * h * dh * q.element_size() + live * b * h * (2 * dh + 2 * scale_elt)
        # int8 data times a float query: count the products at the fp32 rate
        ops_dtype, library = torch.float32, None
    else:
        k, v = k.to(kv), v.to(kv)
        name = "decode_attention"
        run = lambda: k1.decode_attention(q, k, v, pos)  # noqa: E731
        run_plain = lambda: plain.decode_attention(q, k, v, pos)  # noqa: E731
        n_bytes = 2 * b * h * dh * q.element_size() + live * b * h * dh * 2 * k.element_size()
        ops_dtype = kv
        q4, kl, vl = q[:, :, None, :], k[:, :live].transpose(1, 2), v[:, :live].transpose(1, 2)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(q4, kl, vl)  # noqa: E731
    out, again, ref = run(), run(), run_plain()
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    # int8 with a float32 query compares in float32, before any final cast
    tol = tolerance(ref, q_dtype, 1e-4 if isinstance(kv, str) else 1e-5)
    bound, by = bound_ms(n_bytes, 4 * b * h * live * dh, ops_dtype)
    repeats = bool(torch.equal(out, again))  # the states merge in a fixed order
    return {
        "kernel": name, "shape": [b, t, h, dh], "pos": pos, "q_dtype": str(q_dtype)[6:],
        "kv": kv if isinstance(kv, str) else str(kv)[6:],
        "max_abs_err": err, "tol": tol, "repeats": repeats, "ok": err <= tol and repeats,
        "ms": time_ms(run) if timed else None,
        "plain_ms": time_ms(run_plain) if timed else None, "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(library) if library and timed else None,
    }


def attention_cases(gen):
    """K2 and K5f against their plain version: the main paths' shapes, the
    edges of the bf16 bodies' tiles (64 keys and 16 query rows for K2,
    16 x 16 for K5f), the other head sizes and the trainer's shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    k2, k5f = "flash_causal_attention", "packed_causal_attention"
    shapes = [
        (k2, 1024, 96, 16, 16, bf16),
        (k2, 1024, 96, 16, 16, f32),
        (k2, 1024, 250, 16, 16, bf16),
        (k2, 1024, 250, 16, 16, f32),
        (k2, 1024, 3, 16, 16, bf16),  # prefill of [CLIP][UNK][SMILES]
        (k2, 3, 37, 4, 32, f32),
        (k2, 3, 37, 4, 32, bf16),
        (k2, 2, 70, 2, 64, f32),
        *[(k2, 64, t, 16, 16, bf16) for t in (1, 16, 17, 64, 65, 127, 128, 250)],
        (k2, 4, 250, 8, 32, bf16),
        (k2, 4, 250, 4, 64, bf16),
        (k5f, 1024, 96, 16, 16, bf16),
        (k5f, 1024, 96, 16, 16, f32),
        (k5f, 1024, 3, 16, 16, bf16),
        (k5f, 1024, 128, 16, 16, bf16),
        (k5f, 1024, 128, 16, 16, f32),
        (k5f, 3, 37, 4, 32, f32),
        (k5f, 2, 70, 2, 64, bf16),
        *[(k5f, 16, t, h, dh, bf16) for t in (1, 17, 65, 127)
          for h, dh in ((8, 16), (4, 32), (6, 64))],
        (k5f, 160, 48, 16, 16, bf16),  # the trainer's batches
        (k5f, 160, 80, 16, 16, bf16),
    ]
    return [_attention_case(*shape, gen) for shape in shapes]


def coati2_kernel_cases(gen):
    """The four attention kernels at COATI2 grande's shapes (16 heads of
    32): K2 at the encode batch (T 128) and at its prefills (T 3 behind
    [CLIP][UNK][SMILES], T 27 behind the conditioned prefix the path
    decodes from), K1 in every production form at its decode batch over a
    128-wide cache, K5f and K5b at the trainer's doubled views (B 320) and
    its AR pass (B 160), at n_seq and at the widths its batches take (48 to
    80, where the bf16 bodies group 4 or 2 heads a block forward and 1
    backward; 128 groups 1 in both)."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [_attention_case("flash_causal_attention", 1024, t, 16, 32, bf16, gen)
             for t in (128, 3, 27)]
    for pos in (3, 36, 95, 127):
        for kv in (bf16, "int8/float32", "int8/bfloat16"):
            cases.append(_decode_case(1024, 128, 16, 32, pos, bf16, kv, gen))
    for t in (128, 48, 64, 80):
        for b in (320, 160):
            cases.append(_attention_case("packed_causal_attention", b, t, 16, 32, bf16, gen))
            cases.append(_attention_bwd_case(b, t, 16, 32, bf16, gen))
    cases.append(_attention_bwd_case(320, 128, 16, 32, f32, gen))
    for case in cases:
        case["model"] = "coati2"
    return cases


# (kernel, B, T, H, Dh, dtype) of every full-sequence attention case held
# against its plain version so far
HELD = set()
ATTENTION_KERNELS = ("flash_causal_attention", "packed_causal_attention",
                     "packed_causal_attention_backward")


def _held(case):
    return (case["kernel"], *case["shape"], case["dtype"])


def hold_path_shapes(phase, shapes):
    """Holds each attention kernel against its plain version, untimed, at
    the (kernel, B, T, H, Dh, dtype) shapes a path ran that phase kernels
    did not hold: the widths of a path's batches come from its data."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    new = sorted(set(shapes) - HELD)
    cases = []
    for name, b, t, h, dh, dtype_name in new:
        dtype = getattr(torch, dtype_name)
        if name == "packed_causal_attention_backward":
            cases.append(_attention_bwd_case(b, t, h, dh, dtype, gen, timed=False))
        else:
            cases.append(_attention_case(name, b, t, h, dh, dtype, gen, timed=False))
    for case in cases:
        emit({"phase": "kernel", "held_for": phase, **case})
    emit({"phase": "path_shapes", "path": phase, "shapes": [list(x) for x in sorted(set(shapes))],
          "held_here": [list(x) for x in new]})
    HELD.update(new)
    check(all(c["ok"] for c in cases), f"{phase}: a kernel case at the path's shapes is "
          "outside tolerance")


@contextlib.contextmanager
def record_shapes(decode_calls=None):
    """Notes the shapes at which the transformer calls each attention
    kernel's wrapper, and calls it on: (kernel, B, T, H, Dh, dtype) of
    every full-sequence call (K5f's also stand for K5b's, which runs at its
    forward's shapes), and (B, T, H, Dh, q dtype, cache) -> positions of
    every decode step; with `decode_calls` (a Counter), also K1's calls by
    the form of the cache ("float32", "bfloat16", "int8/float32", ...).
    The wrappers still count their launches. Decode steps run eagerly
    meanwhile (graphs.eager), and training steps too, so every step's call
    is seen."""
    from coati_tpu_torch.models import transformer
    from coati_tpu_torch.ops import graphs

    full, decode = set(), collections.defaultdict(set)

    def dtype_name(x):
        return str(x.dtype)[6:]

    def full_call(name, fn):
        def call(q, k, v):
            full.add((name, *q.shape, dtype_name(q)))
            if name == "packed_causal_attention" and q.requires_grad:
                full.add(("packed_causal_attention_backward", *q.shape, dtype_name(q)))
            return fn(q, k, v)
        return call

    def decode_call(fn, quant):
        def call(q, *cache_and_pos):
            k, pos = cache_and_pos[0], cache_and_pos[-1]
            kv = f"int8/{dtype_name(cache_and_pos[1])}" if quant else dtype_name(k)
            decode[(q.shape[0], k.shape[1], *q.shape[1:], dtype_name(q), kv)].add(int(pos))
            if decode_calls is not None:
                decode_calls[kv] += 1
            return fn(q, *cache_and_pos)
        return call

    saved = {name: getattr(transformer, name) for name in (
        "flash_causal_attention", "packed_causal_attention", "decode_attention",
        "decode_attention_quant")}
    transformer.flash_causal_attention = full_call("flash_causal_attention",
                                                   saved["flash_causal_attention"])
    transformer.packed_causal_attention = full_call("packed_causal_attention",
                                                    saved["packed_causal_attention"])
    transformer.decode_attention = decode_call(saved["decode_attention"], False)
    transformer.decode_attention_quant = decode_call(saved["decode_attention_quant"], True)
    try:
        with graphs.eager():
            yield full, decode
    finally:
        for name, fn in saved.items():
            setattr(transformer, name, fn)


def hold_decode_positions(phase, decode):
    """Holds K1 against its plain version, untimed, at every (B, T, H, Dh,
    q dtype, cache) a path decoded with and at every position it decoded
    at; one line for each such shape."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    ok = True
    for (b, t, h, dh, q_name, kv), positions in sorted(decode.items()):
        kv_arg = kv if kv.startswith("int8/") else getattr(torch, kv)
        cases = [_decode_case(b, t, h, dh, pos, getattr(torch, q_name), kv_arg, gen, timed=False)
                 for pos in sorted(positions)]
        worst = max(cases, key=lambda c: c["max_abs_err"] / c["tol"])
        emit({"phase": "kernel", "held_for": phase, "kernel": cases[0]["kernel"],
              "shape": [b, t, h, dh], "q_dtype": q_name, "kv": kv,
              "positions": [min(positions), max(positions)], "n_positions": len(positions),
              "ok": all(c["ok"] for c in cases), "max_abs_err": worst["max_abs_err"],
              "tol_at_worst": worst["tol"], "worst_pos": worst["pos"],
              "repeats": all(c["repeats"] for c in cases)})
        ok = ok and all(c["ok"] for c in cases)
    check(ok, f"{phase}: K1 at a position the path decoded is outside tolerance")


def phase_kernels():
    """Every kernel against its plain version; returns the case of each
    kernel at the production shape, for the report."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = attention_cases(gen) + coati2_kernel_cases(gen)
    # K5b: the trainer's batch at its widest and at its real widths, the
    # inference batch at the widths K5f serves, ragged shapes at the other
    # head sizes, and the edges of the bf16 body's 16-row tiles
    for dtype in (bf16, f32):
        cases.append(_attention_bwd_case(160, 80, 16, 16, dtype, gen))
        cases.append(_attention_bwd_case(1024, 96, 16, 16, dtype, gen))
        cases.append(_attention_bwd_case(1024, 128, 16, 16, dtype, gen))
    cases.append(_attention_bwd_case(160, 32, 16, 16, bf16, gen))
    cases.append(_attention_bwd_case(160, 48, 16, 16, bf16, gen))
    cases.append(_attention_bwd_case(5, 17, 4, 32, f32, gen))
    cases.append(_attention_bwd_case(5, 17, 4, 32, bf16, gen))
    cases.append(_attention_bwd_case(2, 70, 2, 64, bf16, gen))
    cases += [_attention_bwd_case(16, t, h, dh, bf16, gen, timed=False)
              for t in (1, 15, 16, 17, 127) for h, dh in ((8, 16), (4, 32), (6, 64))]
    # K3 and K4: ragged molecules with a lone atom and an all-padding row,
    # small odd shapes, then the fixture's molecules (timed; the main paths'
    # shapes: all 1,024 at the document's cutoff for K3, the trainer's batch
    # of 160 at the document's and at the recipe's cutoff for both)
    ragged = [int(x) for x in torch.randint(2, 65, (64,), generator=gen, device="cuda")]
    ragged[:3] = [64, 1, 0]
    for mm in (f32, bf16):
        geometry = _random_geometry(ragged, 64, gen)
        cases.append(_messages_case(*geometry, 256, mm, gen, "ragged"))
        cases.append(_messages_bwd_case(*geometry, 256, mm, gen, "ragged"))
    cases.append(_messages_bwd_case(*_random_geometry([11, 5, 0], 11, gen), 32, f32, gen, "odd"))
    cases.append(_messages_bwd_case(*_random_geometry([11, 7, 3], 11, gen), 128, bf16, gen, "odd"))
    cases.append(_messages_bwd_case(*_random_geometry([9, 130], 130, gen), 20, f32, gen, "odd"))
    # the bf16 body's edges: Hm not a multiple of 16 or 64 (slices of 32 and
    # 64 columns, padded), N not a multiple of 8, an all-padding molecule
    for counts, n, hm in (([11, 5, 0], 11, 20), ([9, 130, 0], 130, 200),
                          ([37, 0, 20, 1], 37, 100), ([13, 2], 13, 136)):
        geometry = _random_geometry(counts, n, gen)
        cases.append(_messages_bwd_case(*geometry, hm, bf16, gen, "odd", timed=False))
    for cutoff, label in ((5.0, "fixture160"), (12.0, "fixture160_cutoff12")):
        d2, w, _ = _fixture_geometry(160, cutoff)
        for mm in (f32, bf16):
            cases.append(_messages_case(d2, w, 256, mm, gen, label))
            cases.append(_messages_bwd_case(d2, w, 256, mm, gen, label))
    cases.append(_messages_case(*_random_geometry([11, 5, 0], 11, gen), 32, f32, gen, "odd"))
    cases.append(_messages_case(*_random_geometry([11, 7, 3], 11, gen), 128, bf16, gen, "odd"))
    cases.append(_messages_case(*_random_geometry([9, 130], 130, gen), 20, f32, gen, "odd"))
    # K3's bf16 body at its edges: Hm not a multiple of 16 or 64 (W2 and e1
    # padded to 64, 128, 192, 256), N not a multiple of 8 and up to 130, a
    # lone atom, an all-padding molecule
    for counts, n, hm in (([11, 5, 0], 11, 20), ([9, 130, 0, 1], 130, 200),
                          ([37, 0, 20, 1], 37, 100), ([13, 2, 1], 13, 136)):
        cases.append(_messages_case(*_random_geometry(counts, n, gen), hm, bf16, gen, "edge",
                                    timed=False))
    cases.append(_messages_refusal_case(gen))
    d2, w, _ = _fixture_geometry()
    for mm in (f32, bf16):
        cases.append(_messages_case(d2, w, 256, mm, gen, "fixture"))
    del d2, w
    # K1: the paths decode from pos 3 (after [CLIP][UNK][SMILES]) to about
    # 15 (SMILES) and 36 (points); 0, 95 and 249 are the cache's edges and
    # middle. Every form at every position, and odd widths and head sizes
    for pos in (0, 3, 15, 36, 95, 249):
        cases.append(_decode_case(1024, 250, 16, 16, pos, bf16, bf16, gen))
        cases.append(_decode_case(1024, 250, 16, 16, pos, f32, "int8/float32", gen))
        cases.append(_decode_case(1024, 250, 16, 16, pos, f32, "int8/bfloat16", gen))
        cases.append(_decode_case(1024, 250, 16, 16, pos, bf16, "int8/float32", gen))
        cases.append(_decode_case(64, 250, 16, 16, pos, f32, f32, gen))  # the fp32 round trip's
    cases.append(_decode_case(3, 40, 4, 32, 17, f32, f32, gen))
    for pos in (0, 17, 39):
        for kv in (bf16, "int8/float32", "int8/bfloat16"):
            cases.append(_decode_case(5, 40, 16, 32, pos, bf16, kv, gen))  # COATI2-grande's Dh
        cases.append(_decode_case(3, 40, 6, 16, pos, f32, f32, gen))  # H not a power of two
        cases.append(_decode_case(3, 40, 6, 16, pos, bf16, "int8/float32", gen))
        cases.append(_decode_case(2, 40, 64, 16, pos, f32, "int8/float32", gen))  # H 64
    # Dh 24 (the conditioning protocol's COATI2, 96 wide over 4 heads): no
    # body takes it, so every attention kernel runs it zero-padded to 32
    for dtype in (f32, bf16):
        for t in (5, 48):
            cases.append(_attention_case("flash_causal_attention", 64, t, 4, 24, dtype, gen,
                                         timed=False))
            cases.append(_attention_case("packed_causal_attention", 64, t, 4, 24, dtype, gen,
                                         timed=False))
            cases.append(_attention_bwd_case(64, t, 4, 24, dtype, gen, timed=False))
    for pos in (0, 5, 47):
        for q_dtype, kv in ((f32, f32), (bf16, bf16), (bf16, "int8/float32")):
            cases.append(_decode_case(64, 48, 4, 24, pos, q_dtype, kv, gen, timed=False))
    for case in cases:
        emit({"phase": "kernel", **case})
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"{len(bad)} kernel case(s) outside tolerance")
    HELD.update(_held(c) for c in cases if c["kernel"] in ATTENTION_KERNELS)
    pick = {  # the case of each wrapper that the report's line carries
        "flash_causal_attention": {"shape": [1024, 250, 16, 16], "dtype": "bfloat16"},
        "decode_attention": {"shape": [1024, 250, 16, 16], "q_dtype": "bfloat16", "pos": 95},
        "decode_attention_quant": {"shape": [1024, 250, 16, 16], "q_dtype": "bfloat16",
                                   "pos": 95},
        # the production mode: the points path and the trainer run bf16
        "egnn_messages": {"case": "fixture", "mm_dtype": "bfloat16"},
        "packed_causal_attention": {"shape": [1024, 96, 16, 16], "dtype": "bfloat16"},
        # the trainer's shapes: bf16, batch 160, the recipe's cutoff
        "egnn_messages_backward": {"case": "fixture160_cutoff12", "mm_dtype": "bfloat16"},
        "packed_causal_attention_backward": {"shape": [160, 80, 16, 16], "dtype": "bfloat16"},
    }
    chosen = {}
    for c in cases:
        if all(c.get(key) == value for key, value in pick[c["kernel"]].items()):
            chosen.setdefault(c["kernel"], c)
    return chosen


def phase_routing():
    """Routing numbers, no routing change: forward and backward of the
    trainer's attention at its widths (B 160, H 16, Dh 16, bf16, strided q,
    k, v of one fused projection, as the model passes them) through the
    packed pair (K5f + K5b), which the trainer takes at n_seq <= 128, and
    through K2 with its replayed plain backward. Each is the device time of
    one forward and one torch.autograd.grad, between CUDA events."""
    from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention
    from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, dh = 160, 16, 16
    for t in (48, 80):
        qkv = torch.randn(b, t, 3 * h * dh, generator=gen, device="cuda").to(torch.bfloat16)
        qkv.requires_grad_(True)
        g = torch.randn(b, t, h, dh, generator=gen, device="cuda").to(torch.bfloat16)

        def fwd_bwd(kernel):
            q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
            return torch.autograd.grad(kernel(q, k, v), (qkv,), g)

        # a spin of about 5 ms: autograd's host work for one forward and
        # backward is enqueued before the card starts on it
        row = {"phase": "routing", "shape": [b, t, h, dh], "dtype": "bfloat16",
               "packed_k5f_k5b_ms": time_ms(lambda: fwd_bwd(packed_causal_attention),
                                            spin=10_000_000),
               "flash_k2_replayed_ms": time_ms(lambda: fwd_bwd(flash_causal_attention),
                                               spin=10_000_000)}
        row["packed_over_flash"] = row["packed_k5f_k5b_ms"] / row["flash_k2_replayed_ms"]
        emit(row)


@contextlib.contextmanager
def plain_versions():
    """Route the model to the kernels' plain versions, for comparison:
    swaps the kernel wrappers that the transformer and EGNN modules and the
    sampler's top k call.
    The plain forwards are plain tensor code, so a backward through them is
    PyTorch's own autograd and reaches neither K4, K5b nor K2's replay.
    Decode and training steps run eagerly meanwhile (graphs.eager): a
    graph captured over the plain versions must not outlive the swap."""
    from coati_tpu_torch.models import egnn, transformer
    from coati_tpu_torch.ops import graphs, sampling
    from coati_tpu_torch.ops import attention as plain
    from coati_tpu_torch.ops import egnn_messages as plain_messages
    from coati_tpu_torch.ops.kernels.top_k import top_k_plain

    def causal(q, k, v):
        return plain.causal_attention(q, k, v, torch.float32)

    swaps = [
        (transformer, "flash_causal_attention", causal),
        (transformer, "packed_causal_attention", causal),
        (transformer, "decode_attention", plain.decode_attention),
        (transformer, "decode_attention_quant", plain.decode_attention_quant),
        (egnn, "egnn_messages", plain_messages.egnn_messages),
        (sampling, "top_k", top_k_plain),
    ]
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, fn in swaps:
        setattr(module, name, fn)
    try:
        with graphs.eager():
            yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _wrappers():
    from coati_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_quant
    from coati_tpu_torch.ops.kernels.egnn_messages import egnn_messages
    from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention
    from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention
    from coati_tpu_torch.ops.kernels.top_k import top_k

    return {w.__name__: w for w in (flash_causal_attention, decode_attention,
                                    decode_attention_quant, egnn_messages,
                                    packed_causal_attention, top_k)}


# the backward kernels count on the forward wrapper they belong to
BACKWARD_OF = {"egnn_messages_backward": "egnn_messages",
               "packed_causal_attention_backward": "packed_causal_attention"}


def _counts():
    wrappers = _wrappers()
    counts = {name: w.launches for name, w in wrappers.items()}
    counts.update({name: wrappers[fwd].bwd_launches for name, fwd in BACKWARD_OF.items()})
    return counts


def _zero_counts():
    for w in _wrappers().values():
        w.launches = 0
    for fwd in BACKWARD_OF.values():
        _wrappers()[fwd].bwd_launches = 0


def _tokens(tok, smiles, width):
    """(B, width) '[SMILES]...[STOP]' rows padded with the vocabulary's
    [PAD] (0 in COATI's, 31 in COATI2's)."""
    rows = [tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False) for s in smiles]
    out = np.full((len(rows), width), tok.pad_token, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _timed(fn):
    """(fn(), seconds on the host clock with the card drained before and
    after, launches of each kernel in the call)."""
    before = _counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return out, seconds, {n: c - before[n] for n, c in _counts().items()}


def _round_trip(model, tok, tokens, **kw):
    """One timed round trip; returns (smiles, hclip, seconds, launches)."""
    (smiles, h), seconds, launches = _timed(
        lambda: model.smiles_to_2d_batch(tokens, tok, return_embeddings=True, **kw)
    )
    return smiles, h, seconds, launches


def host_cpu() -> dict:
    """The host CPU's vendor and model (/proc/cpuinfo) and core count: the
    host numbers of phases chem, points_from_smiles and host_pipeline are
    taken on it."""
    info = {}
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    return {"phase": "host", "cpu_vendor": info.get("vendor_id", "not reported"),
            "cpu_model": info.get("model name", "not reported"), "cores": os.cpu_count()}


def phase_chem():
    """The chemistry core on the host: the native libraries must build and
    load (a GPU host has a C compiler, and a silent fall back to Python
    would hide the path), the canonicalizer over the whole corpus, and its
    native path, permutations and the native matcher on a seeded sample."""
    from coati_tpu_torch import native
    from coati_tpu_torch.chem import graph_canon
    from coati_tpu_torch.chem.selfies_lite import permute_smiles
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.matcher import VocabMatcher

    start = time.perf_counter()
    canon_lib, matcher_lib = native.load_fast_canon(), native.load_fast_matcher()
    build_s = time.perf_counter() - start
    check(canon_lib is not None and matcher_lib is not None,
          f"chem: the native libraries did not build or load: {native.BUILD_ERRORS}")
    corpus = gzip.open(CORPUS, "rt").read().split()
    distinct = len(set(corpus))

    graph_canon._canonical_cached.cache_clear()
    before = dict(native.CANON_PATHS)
    start = time.perf_counter()
    canonical = [graph_canon.canonical_smiles(s) for s in corpus]
    cold_s = time.perf_counter() - start
    paths = {k: native.CANON_PATHS[k] - before[k] for k in before}
    check(sum(paths.values()) == distinct, f"chem: {paths} canonicalizations of {distinct} lines")
    start = time.perf_counter()
    check([graph_canon.canonical_smiles(s) for s in corpus] == canonical, "chem: a warm pass differs")
    warm_s = time.perf_counter() - start

    sample = random.Random(0).sample(corpus, 2000)
    start = time.perf_counter()
    by_python = [graph_canon._canonical_python(s, True, 512) for s in sample]
    python_s = time.perf_counter() - start
    start = time.perf_counter()
    by_native = [graph_canon._try_native(s, True, 512) for s in sample]
    native_s = time.perf_counter() - start
    differ = sum(a != b for a, b in zip(by_native, by_python))
    check(differ == 0, f"chem: the native path differs from the Python path on {differ} of 2000")
    rng = random.Random(1)
    permuted = [permute_smiles(s, rng) for s in sample]
    moved = sum(p != s for p, s in zip(permuted, sample))
    wrong = sum(graph_canon.canonical_smiles(p) != graph_canon.canonical_smiles(s)
                for p, s in zip(permuted, sample))
    check(wrong == 0, f"chem: {wrong} of 2000 permuted writings canonicalize to another string")

    vocab = get_vocab("mar")
    tokens = list(vocab["special_tokens"]) + list(vocab["smiles_tokens"])
    fast = VocabMatcher(tokens)
    check(fast.uses_native, "chem: the native matcher is not in use")
    texts = ["[SMILES]" + s + "[STOP]" for s in sample + permuted]
    start = time.perf_counter()
    splits = [fast.split(t) for t in texts]
    fast_s = time.perf_counter() - start
    start = time.perf_counter()
    differ = sum(a != fast._split_python(t) for a, t in zip(splits, texts))
    scan_s = time.perf_counter() - start
    check(differ == 0, f"chem: the native matcher splits {differ} of {len(texts)} texts otherwise")
    emit({"phase": "chem", "native_build_and_load_s": build_s,
          "corpus_lines": len(corpus), "corpus_distinct": distinct,
          "canonicalize_cold_s": cold_s, "canonicalize_cold_mol_per_s": len(corpus) / cold_s,
          "canonicalize_warm_s": warm_s, "canonicalize_warm_mol_per_s": len(corpus) / warm_s,
          "answered_by": paths, "fixed_points": sum(a == b for a, b in zip(canonical, corpus)),
          "sample": len(sample), "native_equals_python": True,
          "sample_native_s": native_s, "sample_python_s": python_s,
          "permuted_writings_moved": moved, "permuted_canonicalize_back": True,
          "matcher_texts": len(texts), "matcher_native_s": fast_s, "matcher_python_s": scan_s})


def load_model():
    from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

    start = time.perf_counter()
    model, tok = load_e3gnn_smiles_clip_e2e(str(DOC))  # no device: the card
    check(model.device.type == "cuda", f"model loaded on {model.device}, not the card")
    cfg = model.config
    emit({"phase": "load", "doc": DOC.name, "seconds": time.perf_counter() - start,
          "n_layer": cfg.n_layer_xformer, "n_embd": cfg.n_hidden_xformer,
          "n_head": cfg.n_head, "n_seq": cfg.n_seq, "n_tok": tok.n_token,
          "egnn_layers": cfg.n_layer_e3gnn, "egnn_hidden": cfg.n_hidden_e3nn,
          "egnn_cutoff": cfg.egnn_config.message_cutoff})
    return model, tok


def phase_smiles(model, tok):
    """The first main path: SMILES -> embedding -> SMILES on the card.
    Returns (launch counts of the path, the total_len 96 production run)."""
    from coati_tpu_torch.models.api import COATI

    n_layer = model.config.n_layer_xformer

    # (a) fp32 greedy: kernels against plain versions, 64 corpus SMILES
    corpus = gzip.open(CORPUS, "rt").read().split()
    picks = [corpus[i] for i in np.random.default_rng(0).permutation(len(corpus))[:64]]
    tokens = _tokens(tok, picks, tok.n_seq)
    with plain_versions():
        plain_smiles, plain_h, _, plain_launches = _round_trip(model, tok, tokens, k=1)
    check(sum(plain_launches.values()) == 0, "the plain run launched a kernel")

    _zero_counts()  # the path starts here
    smiles, h, seconds, launches = _round_trip(model, tok, tokens, k=1)
    agree = sum(a == b for a, b in zip(smiles, plain_smiles))
    emit({"phase": "fp32_greedy", "rows": len(picks), "agree_with_plain": agree,
          "hclip_max_abs_diff": float(np.abs(h - plain_h).max()),
          "exact_round_trips": sum(a == b for a, b in zip(smiles, picks)),
          "seconds": seconds, "launches": launches})
    check(agree >= 63, f"fp32 greedy: only {agree}/64 rows agree with the plain versions")
    check(launches["flash_causal_attention"] == 2 * n_layer,
          "fp32: flash kernel not launched once per layer for the encode and the prefill")
    check(launches["decode_attention"] > 0 and launches["decode_attention"] % n_layer == 0,
          "fp32: decode kernel not launched once per layer per step")

    # (b) production: bf16, int8 KV cache (kv_dtype "auto"), batch 1024
    prod = COATI(model.params, model.config.replace(dtype="bfloat16"), seed=0)
    check(prod.config.xformer_config.kv_quantized, "bf16 config does not quantize the cache")
    _production(prod, tok, "n_seq_250", None, "flash_causal_attention")
    short = _production(prod, tok, "total_len_96", 96, "flash_causal_attention")
    return _counts(), short


def _production(prod, tok, label, total_len, full_kernel):
    """The production round trip of bench.py's SMILES at batch 1024: one
    warm-up and three timed runs, the encode alone, one traced run. Every
    full-sequence attention must go through `full_kernel`, the other of K2
    and K5f must not run, and every decode step through the int8 K1."""
    n_layer = prod.config.n_layer_xformer
    other = ({"flash_causal_attention", "packed_causal_attention"} - {full_kernel}).pop()
    bench = (BENCH_SMILES * 64)[:1024]
    width = total_len or tok.n_seq
    tokens = _tokens(tok, bench, width)
    kw = dict(k=100, inv_temp=2.0, total_len=total_len)
    runs = [_round_trip(prod, tok, tokens, **kw) for _ in range(4)]  # the first is warm-up
    for out, _, _, run_launches in runs:
        check(len(out) == 1024 and all(isinstance(s, str) for s in out), "rows not decoded")
        check(run_launches[full_kernel] == 2 * n_layer and run_launches[other] == 0,
              f"{label}: full-sequence kernel counts {run_launches}")
        steps, rem = divmod(run_launches["decode_attention_quant"], n_layer)
        check(steps > 0 and rem == 0, f"{label}: int8 decode kernel count {run_launches}")
    seconds = statistics.median(r[2] for r in runs[1:])
    out = runs[-1][0]
    encode_s = statistics.median(
        _timed(lambda: prod.encode_tokens(tokens, tok))[1] for _ in range(3)
    )
    result = {"phase": "production", "shape": label, "batch": 1024, "dtype": "bfloat16",
              "prefill_kernel": prod.config.prefill_kernel,
              "kv": "int8/float32", "k": 100, "inv_temp": 2.0, "encode_T": width,
              "mol_per_s": 1024 / seconds, "seconds": seconds,
              "seconds_all": [r[2] for r in runs], "encode_seconds": encode_s,
              "decode_steps": runs[-1][3]["decode_attention_quant"] // n_layer,
              "launches_per_round_trip": runs[-1][3],
              "exact_round_trips": sum(a == b for a, b in zip(out, bench)),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(result)
    DECODE_RUNS.append((label, width, result["decode_steps"]))
    _profile(lambda: prod.smiles_to_2d_batch(tokens, tok, **kw), label, seconds)
    return result


def phase_points(model, tok):
    """The second main path: 3D point clouds -> embedding -> SMILES, on the
    1,024 molecules of the fixture (N 128 with hydrogens), EGNN at the
    document's 5 layers x 256. Returns the launch counts of the path."""
    from coati_tpu_torch.data import load_points_fixture
    from coati_tpu_torch.models.api import COATI
    from coati_tpu_torch.models.egnn import egnn_forward

    cfg = model.config
    n_egnn, n_layer = cfg.n_layer_e3gnn, cfg.n_layer_xformer
    smiles, atoms, coords = load_points_fixture()
    check(atoms.shape[0] == 1024, f"fixture has {atoms.shape[0]} rows, not 1024")
    atoms_t = torch.as_tensor(atoms.astype(np.int64), device="cuda")
    coords_t = torch.as_tensor(coords, device="cuda")

    # comparisons first, outside the counted window: the plain version of
    # the message kernel, and the SMILES embeddings of the same molecules
    with plain_versions(), torch.no_grad():
        (plain_pool, plain_h), plain_s, plain_launches = _timed(lambda: (
            egnn_forward(model.params.point_encoder, cfg.egnn_config, atoms_t, coords_t),
            model.encode_points(atoms, coords),
        ))
    check(sum(plain_launches.values()) == 0, "the plain run launched a kernel")
    h_smiles = model.encode_tokens(_tokens(tok, smiles, tok.n_seq), tok)

    _zero_counts()  # the path starts here
    with torch.no_grad():
        pool = egnn_forward(model.params.point_encoder, cfg.egnn_config, atoms_t, coords_t)
    runs = [_timed(lambda: model.encode_points(atoms, coords)) for _ in range(4)]
    h = runs[-1][0]
    for _, _, run_launches in runs:
        check(run_launches["egnn_messages"] == n_egnn and sum(run_launches.values()) == n_egnn,
              f"encode_points: kernel counts {run_launches}")
    pool_diff = float((pool - plain_pool).abs().max())
    check(tuple(h.shape) == (1024, cfg.embed_dim) and bool(torch.isfinite(h).all()),
          "encode_points: embeddings not finite or of the wrong shape")
    # the pooled EGNN output, before the projection's LayerNorm rescales it:
    # float32 through the kernel and through its plain version differ by
    # the order of sums only, five layers deep
    check(pool_diff <= 1e-4, f"EGNN through K3 and through the plain version differ by {pool_diff}")
    cos = torch.nn.functional.cosine_similarity(h, h_smiles, dim=-1)
    shuffled = torch.nn.functional.cosine_similarity(h, h_smiles.roll(1, dims=0), dim=-1)
    quantiles = torch.quantile(cos, torch.tensor([0.0, 0.05, 0.5, 0.95, 1.0], device="cuda"))
    emit({"phase": "points_fp32", "rows": 1024, "atoms_max": int(atoms.shape[1]),
          "atoms_per_molecule_mean": float((atoms > 0).sum(1).mean()),
          "egnn_pooled_max_abs_diff_vs_plain": pool_diff,
          "hclip_max_abs_diff_vs_plain": float((h - plain_h).abs().max()),
          "encode_points_seconds_all": [r[1] for r in runs],
          "encode_points_seconds": statistics.median(r[1] for r in runs[1:]),
          "plain_egnn_and_encode_seconds": plain_s,
          "cosine_point_vs_smiles": {
              "min_p5_median_p95_max": [float(x) for x in quantiles],
              "mean": float(cos.mean()), "mean_shuffled_pairs": float(shuffled.mean())},
          "launches_per_encode": runs[-1][2]})
    check(float(cos.mean()) > float(shuffled.mean()),
          "point embeddings are no closer to their own SMILES embeddings than to others'")

    # production: bf16 (bf16 inner product in K3), int8 KV cache, k 100
    prod = COATI(model.params, cfg.replace(dtype="bfloat16"), seed=0)
    kw = dict(k=100, inv_temp=2.0)
    runs = [_timed(lambda: prod.points_to_2d_batch(atoms, coords, tok, **kw))
            for _ in range(4)]  # the first is warm-up
    for out, _, run_launches in runs:
        check(len(out) == 1024 and all(isinstance(s, str) for s in out), "rows not decoded")
        check(run_launches["egnn_messages"] == n_egnn, f"points: K3 count {run_launches}")
        check(run_launches["flash_causal_attention"] == n_layer,
              f"points: the prefill's flash kernel count {run_launches}")
        steps, rem = divmod(run_launches["decode_attention_quant"], n_layer)
        check(steps > 0 and rem == 0, f"points: int8 decode kernel count {run_launches}")
    seconds = statistics.median(r[1] for r in runs[1:])
    out = runs[-1][0]
    encode_s = [_timed(lambda: prod.encode_points(atoms, coords))[1] for _ in range(3)]
    h_bf16 = prod.encode_points(atoms, coords).float()
    emit({"phase": "points_production", "batch": 1024, "dtype": "bfloat16",
          "kv": "int8/float32", "k": 100, "inv_temp": 2.0,
          "mol_per_s": 1024 / seconds, "seconds": seconds,
          "seconds_all": [r[1] for r in runs],
          "encode_points_seconds": statistics.median(encode_s),
          "encode_points_seconds_all": encode_s,
          "cosine_bf16_vs_fp32_mean": float(
              torch.nn.functional.cosine_similarity(h_bf16, h, dim=-1).mean()),
          "decode_steps": runs[-1][2]["decode_attention_quant"] // n_layer,
          "launches_per_call": runs[-1][2],
          "exact_recoveries": sum(a == b for a, b in zip(out, smiles)),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    DECODE_RUNS.append(("points", tok.n_seq, runs[-1][2]["decode_attention_quant"] // n_layer))
    _profile(lambda: prod.points_to_2d_batch(atoms, coords, tok, **kw), "points", seconds)
    _profile(lambda: prod.encode_points(atoms, coords), "encode_points",
             statistics.median(encode_s))
    return _counts()


def phase_points_from_smiles(model, tok):
    """SMILES -> the port's own conformers -> points_to_2d_batch: the
    fixture's 1,024 SMILES embedded on the host by chem/conformers.py, held
    against the fixture coati_tpu wrote, then decoded in the production
    setting. Returns the launch counts of the path."""
    from coati_tpu_torch.chem.conformers import embed_smiles_to_atoms_coords
    from coati_tpu_torch.data import load_points_fixture
    from coati_tpu_torch.models.api import COATI

    cfg = model.config
    n_egnn, n_layer = cfg.n_layer_e3gnn, cfg.n_layer_xformer
    smiles, f_atoms, f_coords = load_points_fixture()
    start = time.perf_counter()
    embedded = [embed_smiles_to_atoms_coords(s) for s in smiles]
    embed_s = time.perf_counter() - start
    atoms, coords = np.zeros_like(f_atoms), np.zeros_like(f_coords)
    same_atoms = close = 0
    worst_dist = worst_xyz = 0.0
    worst_row = -1
    for i, (a, c) in enumerate(embedded):
        n = len(a)
        check(n <= atoms.shape[1] and np.isfinite(c).all(), f"points_from_smiles: row {i}")
        atoms[i, :n], coords[i, :n] = a, c
        same_atoms += bool(np.array_equal(atoms[i], f_atoms[i]))
        mine = np.linalg.norm(c[:, None] - c[None], axis=-1)
        ref = f_coords[i, :n].astype(np.float64)
        err = float(np.abs(mine - np.linalg.norm(ref[:, None] - ref[None], axis=-1)).max())
        close += err <= 1e-3
        if err > worst_dist:
            worst_dist, worst_row = err, i
        worst_xyz = max(worst_xyz, float(np.abs(c - ref).max()))
    rows = len(smiles)
    emit({"phase": "points_from_smiles_embed", "rows": rows,
          "embed_seconds": embed_s, "mol_per_s": rows / embed_s,
          "rows_with_the_fixture_s_atoms": same_atoms,
          "rows_with_distances_within_1e-3": close,
          "max_distance_diff_angstrom": worst_dist, "max_distance_diff_row": worst_row,
          "max_coordinate_diff_angstrom": worst_xyz})
    check(same_atoms == rows, f"points_from_smiles: atoms differ from the fixture's in "
                              f"{rows - same_atoms} rows")
    check(worst_dist <= 1e-4, f"points_from_smiles: distances differ from the fixture's by "
                              f"{worst_dist} A in row {worst_row} (tolerance 1e-4)")

    prod = COATI(model.params, cfg.replace(dtype="bfloat16"), seed=0)
    kw = dict(k=100, inv_temp=2.0)
    _zero_counts()  # the path starts here
    runs = [_timed(lambda: prod.points_to_2d_batch(atoms, coords, tok, **kw))
            for _ in range(2)]  # the first is warm-up
    counts = _counts()  # and ends here
    for out, _, run_launches in runs:
        check(len(out) == rows and all(isinstance(s, str) for s in out),
              "points_from_smiles: rows not decoded")
        check(run_launches["egnn_messages"] == n_egnn, f"points_from_smiles: K3 {run_launches}")
        steps, rem = divmod(run_launches["decode_attention_quant"], n_layer)
        check(steps > 0 and rem == 0, f"points_from_smiles: int8 K1 {run_launches}")
    out, seconds, launches = runs[-1]
    emit({"phase": "points_from_smiles", "batch": rows, "dtype": "bfloat16",
          "kv": "int8/float32", "k": 100, "inv_temp": 2.0, "seconds": seconds,
          "seconds_all": [r[1] for r in runs], "mol_per_s": rows / seconds,
          "decode_steps": launches["decode_attention_quant"] // n_layer,
          "launches_per_call": launches,
          "exact_recoveries": sum(a == b for a, b in zip(out, smiles))})
    return counts


def phase_packed(model, tok, flash_run):
    """The total_len 96 production round trip again under
    prefill_kernel="packed": K5f in place of K2. Returns the launch counts."""
    from coati_tpu_torch.models.api import COATI

    # comparison first, outside the counted window: fp32 embeddings under
    # K5f against those under K2 (the order of sums only)
    tokens = _tokens(tok, (BENCH_SMILES * 64)[:1024], 96)
    packed32 = COATI(model.params, model.config.replace(prefill_kernel="packed"), seed=0)
    diff = float((packed32.encode_tokens(tokens, tok) - model.encode_tokens(tokens, tok)).abs().max())
    check(diff <= 1e-5, f"fp32 embeddings under K5f and under K2 differ by {diff}")

    _zero_counts()  # the path starts here
    prod = COATI(model.params,
                 model.config.replace(dtype="bfloat16", prefill_kernel="packed"), seed=0)
    run = _production(prod, tok, "total_len_96_packed", 96, "packed_causal_attention")
    emit({"phase": "packed_vs_flash", "shape": "total_len_96",
          "fp32_hclip_max_abs_diff": diff,
          "encode_seconds": {"packed": run["encode_seconds"], "flash": flash_run["encode_seconds"]},
          "round_trip_seconds": {"packed": run["seconds"], "flash": flash_run["seconds"]}})
    return _counts()


# (path, cache width, decode steps) of each production round trip: a step
# at position p launches K1 once a layer, from p = 3 after the prefix
# [CLIP][UNK][SMILES]
DECODE_RUNS = []
PREFIX_LEN = 3


def phase_k1_positions(n_layer):
    """K1's int8 form (bf16 query, float32 scales; B 1024, H 16, Dh 16) timed
    at every position each production round trip decoded, and its time in
    each call weighted by those launches, beside its bound and beside the
    same launches priced at pos 95. Runs after the paths' windows: these
    launches are not the paths'."""
    from coati_tpu_torch.models.transformer import quantize_kv
    from coati_tpu_torch.ops.kernels import decode_attention as k1

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, dh = 1024, 16, 16
    q = torch.randn(b, h, dh, generator=gen, device="cuda").to(torch.bfloat16)
    caches, times = {}, {}

    def ms(width, pos):
        if width not in caches:
            kv = torch.randn(2, b, width, h, dh, generator=gen, device="cuda")
            caches[width] = (*quantize_kv(kv[0]), *quantize_kv(kv[1]))
        if (width, pos) not in times:
            k8, ks, v8, vs = caches[width]
            times[width, pos] = time_ms(lambda: k1.decode_attention_quant(q, k8, ks, v8, vs, pos))
        return times[width, pos]

    def bound(pos):
        live = pos + 1
        return bound_ms(2 * b * h * dh * 2 + live * b * h * (2 * dh + 2 * 4),
                        4 * b * h * live * dh, torch.float32)[0]

    for label, width, steps in DECODE_RUNS:
        positions = range(PREFIX_LEN, PREFIX_LEN + steps)
        total = n_layer * sum(ms(width, p) for p in positions)
        emit({"phase": "k1_positions", "path": label, "cache_width": width,
              "positions": [positions[0], positions[-1]], "launches": n_layer * steps,
              "ms_by_position": {p: ms(width, p) for p in positions},
              "k1_ms_per_call": total, "k1_ms_per_launch": total / (n_layer * steps),
              "bound_ms_per_call": n_layer * sum(bound(p) for p in positions),
              "priced_at_pos95_ms": n_layer * steps * ms(width, 95)})


class _KeepRows:
    """The tokenizer, keeping the token rows of the last call it
    detokenized."""

    def __init__(self, tok):
        self._tok, self.rows = tok, None

    def decode_batch(self, rows, *args, **kwargs):
        self.rows = np.asarray(rows)
        return self._tok.decode_batch(rows, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._tok, name)


def _k1_device_position(label, t, h, dh, gen):
    """K1's int8 form (bf16 query, float32 scales, B 1024) read at a
    position on the card against the host int, at every position of a
    cache of width t: the same bits where both take the same groups G (the
    device form takes them for t - 1), else within 2 bf16 ulps; both timed
    at pos 95."""
    from coati_tpu_torch.models.transformer import quantize_kv
    from coati_tpu_torch.ops.kernels import decode_attention as k1

    b = 1024
    q = torch.randn(b, h, dh, generator=gen, device="cuda").to(torch.bfloat16)
    kv = torch.randn(2, b, t, h, dh, generator=gen, device="cuda")
    (k8, ks), (v8, vs) = quantize_kv(kv[0]), quantize_kv(kv[1])
    at = torch.zeros(1, dtype=torch.int32, device="cuda")
    form = (torch.bfloat16, torch.int8, torch.float32)
    g_dev = k1.groups(b, h, dh, t - 1, *form)
    equal_g, differ, worst = [], [], 0.0
    for pos in range(t):
        at.fill_(pos)
        host = k1.decode_attention_quant(q, k8, ks, v8, vs, pos)
        dev = k1.decode_attention_quant(q, k8, ks, v8, vs, at)
        if k1.groups(b, h, dh, pos, *form) == g_dev:
            equal_g.append(pos)
            ok = torch.equal(host, dev)
        else:
            err = float((host.float() - dev.float()).abs().max())
            worst = max(worst, err / tolerance(host, torch.bfloat16, 0.0))
            ok = err <= tolerance(host, torch.bfloat16, 0.0)
        if not ok:
            differ.append(pos)
    at.fill_(95)
    times = {"host": [], "device": []}
    for _ in range(2):  # interleaved
        times["host"].append(time_ms(lambda: k1.decode_attention_quant(q, k8, ks, v8, vs, 95)))
        times["device"].append(time_ms(lambda: k1.decode_attention_quant(q, k8, ks, v8, vs, at)))
    host_ms, dev_ms = min(times["host"]), min(times["device"])
    line = {"phase": "decode_graph_k1", "model": label, "shape": [b, t, h, dh],
            "groups_device_form": g_dev, "positions_with_equal_groups": [equal_g[0], t - 1],
            "positions_outside_tolerance": differ, "worst_over_tolerance_elsewhere": worst,
            "ms_pos95_host": host_ms, "ms_pos95_device": dev_ms, "times": times}
    emit(line)
    check(not differ, f"decode_graph {label}: K1's device-position form differs at {differ}")
    check(abs(dev_ms / host_ms - 1) <= 0.02,
          f"decode_graph {label}: K1 at pos 95 {dev_ms} ms on the card's position, {host_ms} "
          "by the host int")


def _tracer_totals() -> dict:
    """The tracer's graph counters and decode-step count so far."""
    from coati_tpu_torch.common import tracing

    snap = tracing.snapshot()
    return {"captures": snap["counters"].get("decode.graph_captures", 0),
            "graph_steps": snap["counters"].get("decode.graph_steps", 0),
            "steps": snap["spans"].get("decode.step", {}).get("count", 0),
            "capture_seconds": snap["spans"].get("decode.capture", {}).get("seconds", 0.0)}


def _graphed_vs_eager(label, model, tok, tokens, n_layer):
    """A handle's round trips eagerly (graphs.eager) and through the
    decode graph, greedy and sampled under one generator seed. The graphed
    side first makes two greedy calls, which note the shape (unless met
    before) and capture its graph; the compared calls replay it: the same
    tokens and the same K1 launch counts as eager, a replay for every
    step. The two set-up calls launch K1 as eager's greedy call does, plus
    one warm-up step where this thread captures the shape for the first
    time. Prints captures, capture seconds, kept shapes, the graph's
    static bytes and the seconds of each way (medians of three sampled
    calls)."""
    from coati_tpu_torch.common import tracing
    from coati_tpu_torch.models import decode_graph
    from coati_tpu_torch.ops import graphs

    keep = _KeepRows(tok)

    def run(k, seed):
        model._generator.manual_seed(seed)
        _, seconds, launches = _timed(
            lambda: model.smiles_to_2d_batch(tokens, keep, k=k, inv_temp=2.0))
        return keep.rows, seconds, launches["decode_attention_quant"]

    with graphs.eager():
        eager = {k: run(k, 5) for k in (1, 100)}
    tracing.reset()
    tracing.start()
    setup = [run(1, 5) for _ in range(2)]
    after_setup = _tracer_totals()
    graphed = {k: run(k, 5) for k in (1, 100)}
    compared = _tracer_totals()
    tracing.stop()
    seconds = {"graphed": [run(100, 6 + i)[1] for i in range(3)]}
    with graphs.eager():
        seconds["eager"] = [run(100, 6 + i)[1] for i in range(3)]
    compute = model._compute.xformer
    graph = decode_graph.kept_graphs(compute)[0]
    steps = {k: graphed[k][2] // n_layer for k in graphed}
    setup_extra = sum(x[2] for x in setup) - 2 * eager[1][2]
    line = {"phase": "decode_graph", "model": label, "batch": len(tokens),
            "greedy_equal": all(np.array_equal(x[0], eager[1][0]) for x in (*setup, graphed[1])),
            "sampled_equal": bool(np.array_equal(graphed[100][0], eager[100][0])),
            "k1_launches_graphed": {k: graphed[k][2] for k in graphed},
            "k1_launches_eager": {k: eager[k][2] for k in eager},
            "k1_launches_setup": [x[2] for x in setup], "setup_warmup_launches": setup_extra,
            "decode_steps": steps, "setup": after_setup, "compared": compared,
            "capture_seconds": after_setup["capture_seconds"],
            "kept_shapes": decode_graph.kept_shapes(compute), "static_bytes": graph.bytes,
            "seconds_graphed": seconds["graphed"], "seconds_eager": seconds["eager"],
            "speedup": statistics.median(seconds["eager"]) / statistics.median(
                seconds["graphed"])}
    emit(line)
    check(line["greedy_equal"] and line["sampled_equal"],
          f"decode_graph {label}: graphed tokens differ from the eager path's")
    check(all(graphed[k][2] == eager[k][2] and graphed[k][2] % n_layer == 0 for k in graphed)
          and setup_extra in (0, n_layer),
          f"decode_graph {label}: K1 launch counts {line['k1_launches_graphed']} graphed, "
          f"{line['k1_launches_eager']} eager, {line['k1_launches_setup']} in set-up")
    check(after_setup["captures"] == 1 and compared["captures"] == 1
          and compared["graph_steps"] - after_setup["graph_steps"] == sum(steps.values())
          == compared["steps"] - after_setup["steps"],
          f"decode_graph {label}: counters {after_setup} after set-up, {compared} after")


CHURN_ROWS = (16, 48, 96, 160, 224, 256)  # batch sizes a micro-batcher (max 256) may flush


def _shape_churn(label, model, tok, tokens):
    """Greedy calls cycling over six batch sizes, three rounds, against the
    same calls eager: the first round meets each size once (eager by the
    second-use rule, unless met before); past it the handle's MAX_SHAPES
    kept graphs never hold the size that comes next, so every call
    captures, the worst case of the bound. Tokens equal eager's; seconds,
    captures and memory of each round."""
    from coati_tpu_torch.common import tracing
    from coati_tpu_torch.models import decode_graph
    from coati_tpu_torch.ops import graphs

    keep = _KeepRows(tok)

    def run(b):
        _, seconds, _ = _timed(
            lambda: model.smiles_to_2d_batch(tokens[:b], keep, k=1, inv_temp=1.0))
        return keep.rows, seconds

    with graphs.eager():
        eager = {b: run(b) for b in CHURN_ROWS}
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    tracing.reset()
    tracing.start()
    rounds, differ = [], []
    for r in range(3):
        before = _tracer_totals()
        out = {b: run(b) for b in CHURN_ROWS}
        after = _tracer_totals()
        differ += [[r, b] for b in CHURN_ROWS if not np.array_equal(out[b][0], eager[b][0])]
        rounds.append({"seconds": sum(x[1] for x in out.values()),
                       "captures": after["captures"] - before["captures"],
                       "graph_steps": after["graph_steps"] - before["graph_steps"],
                       "steps": after["steps"] - before["steps"],
                       "capture_seconds": after["capture_seconds"] - before["capture_seconds"]})
    tracing.stop()
    torch.cuda.synchronize()
    line = {"phase": "decode_graph_churn", "model": label, "rows": list(CHURN_ROWS),
            "eager_seconds": sum(x[1] for x in eager.values()), "rounds": rounds,
            "differing": differ, "kept_shapes": decode_graph.kept_shapes(model._compute.xformer),
            "reserved_bytes_before": reserved, "reserved_bytes_after": torch.cuda.memory_reserved(),
            "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(line)
    check(not differ, f"decode_graph churn {label}: graphed tokens differ at {differ}")
    check(line["kept_shapes"] <= decode_graph.MAX_SHAPES,
          f"decode_graph churn {label}: {line['kept_shapes']} graphs kept")


def phase_decode_graph(model, tok):
    """The decode step captured once as a CUDA graph (models/decode_graph.py),
    K1 reading its position on the card: K1's two entries at every position
    of COATI's and COATI2's production caches; then the trained document's
    and seeded COATI2's production round trips of 1,024 corpus SMILES,
    graphed against eager."""
    from coati_tpu_torch.models.api import COATI
    from coati_tpu_torch.models.coati2 import COATI2
    from coati_tpu_torch.models.io import load_coati2, model_to_state, serialize_model
    from coati_tpu_torch.training.train_coati2 import Coati2TrainConfig, fresh_model

    gen = torch.Generator(device="cuda").manual_seed(20)
    _k1_device_position("coati", 250, 16, 16, gen)
    _k1_device_position("coati2", 128, 16, 32, gen)

    prod = COATI(model.params, model.config.replace(dtype="bfloat16"), seed=0)
    tokens = _tokens(tok, _coati2_corpus(tok, 1024), tok.n_seq)
    _graphed_vs_eager("coati", prod, tok, tokens, model.config.n_layer_xformer)
    _shape_churn("coati", prod, tok, tokens)
    del prod

    tok2 = _coati2_tokenizer()
    config = Coati2TrainConfig(**COATI2_GRANDE)
    if not COATI2_DOC.exists():
        fresh = fresh_model(config.model_config(tok2.n_token), torch.device("cpu"), seed=0)
        COATI2_DOC.parent.mkdir(parents=True, exist_ok=True)
        COATI2_DOC.write_bytes(serialize_model(
            train_args={"tokenizer_vocab": "coati2_12_12"}, dataset_summary={},
            model_state=model_to_state(fresh), model_kwargs=config.model_kwargs(tok2.n_token)))
        del fresh
    m, tok2 = load_coati2(str(COATI2_DOC))
    prod2 = COATI2(m.params, m.config.replace(dtype="bfloat16"), seed=0)
    tokens2 = _tokens(tok2, _coati2_corpus(tok2, 1024), tok2.n_seq)
    _graphed_vs_eager("coati2", prod2, tok2, tokens2, m.config.n_layer_xformer)
    del prod2, m
    torch.cuda.empty_cache()


# numbers one phase measures and a later one prints beside its own
MEASURED = {}


class _StampedDataset:
    """A training dataset that notes the host clock each time the trainer
    takes a batch, and keeps the transformed batches and the seconds the
    trainer's transform took on each. With the trainer's deferred metric
    reads, the time between two takes is one whole step in steady state:
    the wait for the step before, this step's launches, and the next
    batch's host transform."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.summary = dataset.summary
        self.stamps, self.batches, self.xform_s = [], [], []
        self.pipe_kw = {}

    def get_data_pipe(self, xform_routine=lambda b: b, **kw):
        self.pipe_kw = kw

        def timed(batch):
            start = time.perf_counter()
            out = xform_routine(batch)
            self.xform_s.append(time.perf_counter() - start)
            return out

        for batch in self.dataset.get_data_pipe(xform_routine=timed, **kw):
            self.stamps.append(time.perf_counter())
            self.batches.append(batch)
            yield batch

    def raw_batches(self, n):
        """The first n raw batches of the last pipe again, untransformed:
        the pipe is seeded, so they are the ones the trainer took."""
        return list(itertools.islice(self.dataset.get_data_pipe(**self.pipe_kw), n))


def _host_pipeline(config, data, steps, step_s, canon_in_run):
    """The trainer's transform replayed on the raw batches of the counted
    run, after it: cold (the canonical-SMILES and conformer caches cleared
    before each batch) and warm, beside the step; the share of targets that
    were permuted; the canonicalizations each path answered."""
    import statistics as st

    from coati_tpu_torch import native
    from coati_tpu_torch.chem.rdkit_support import canonicalize_or_self
    from coati_tpu_torch.data import xform
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

    tok = TrieTokenizer(n_seq=config.n_seq, **get_vocab(config.tokenizer_vocab))

    def replay(raw):
        batch = {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in raw.items()}
        start = time.perf_counter()
        xform.clip_ar_xform(batch, tokenizer=tok, p_dataset=config.p_dataset,
                            p_formula=config.p_formula, p_fim=config.p_fim,
                            p_graph=config.p_graph, p_clip=config.p_clip,
                            p_clip_cut=config.p_clip_cut, p_randsmiles=config.p_randsmiles)
        return time.perf_counter() - start

    raws = data.raw_batches(steps)
    check(all(list(r["smiles"]) == list(b["smiles"]) for r, b in zip(raws, data.batches)),
          "host_pipeline: the replayed raw batches are not the run's")
    before = dict(native.CANON_PATHS)
    cold = []
    for raw in raws:
        _clear_host_caches()
        cold.append(replay(raw))
    canon_cold = {k: native.CANON_PATHS[k] - before[k] for k in before}
    warm = [replay(raw) for raw in raws]
    rows = permuted = 0
    for batch in data.batches[:steps]:
        for smiles, target in zip(batch["smiles"], batch["raw_tokens"]):
            plain = tok.tokenize_text("[SMILES]" + canonicalize_or_self(str(smiles)) + "[STOP]",
                                      pad=False)
            rows += 1
            permuted += list(target[target > 0]) != plain
    in_run = st.median(data.xform_s[:steps])
    out = {"phase": "host_pipeline", "batch": config.batch_size,
           "batches": len(raws), "p_randsmiles": config.p_randsmiles,
           "permuted_target_share": permuted / rows,
           "xform_in_run_s": in_run, "xform_in_run_s_all": data.xform_s[:steps],
           "xform_cold_s": st.median(cold), "xform_cold_s_all": cold,
           "xform_warm_s": st.median(warm), "xform_warm_s_all": warm,
           "step_seconds": step_s, "in_run_share_of_step": in_run / step_s,
           "cold_share_of_step": st.median(cold) / step_s,
           "warm_share_of_step": st.median(warm) / step_s,
           "canonicalized_in_run_by": canon_in_run, "canonicalized_cold_replay_by": canon_cold}
    emit(out)
    check(canon_in_run["python"] == 0 and canon_in_run["native"] > 0,
          f"train: canonicalizations in the run {canon_in_run}")
    check(0 < permuted < rows, f"train: {permuted} of {rows} targets permuted")
    return out


def _train_step(config, model):
    """(the trainer's step over `model` with a new optimizer, tokenizer)."""
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
    from coati_tpu_torch.training import train

    tok = TrieTokenizer(n_seq=config.n_seq, **get_vocab(config.tokenizer_vocab))
    model_cfg = train.model_config_from_train_config(config, tok.n_token)
    if model is None:
        model = train.fresh_model(model_cfg, torch.device("cuda"), seed=0)
    step = train.make_train_step(
        model, model_cfg, train.make_optimizer(config, model),
        stop_token=tok.stop_token, unk_token=tok.unk_token,
        p_clip_emb_smi=config.p_clip_emb_smi,
        token_entropy_unit=float(np.log2(tok.n_token)), do_clip=config.do_clip,
    )
    return step, tok


def phase_train():
    """The training path: train_autoencoder with the grande recipe on the
    card. Returns the launch counts of the path."""
    from coati_tpu_torch import native
    from coati_tpu_torch.chem import graph_canon
    from coati_tpu_torch.data import fixture_dataset
    from coati_tpu_torch.training import train
    from coati_tpu_torch.training.config import grande_config

    warm, timed = 3, 20
    steps = warm + timed
    # the recipe in bf16 as it is written: every row canonicalized, 30% of
    # the targets permuted
    config = grande_config(dtype="bfloat16", n_epochs=1)
    check(config.p_randsmiles == 0.3, f"train: p_randsmiles {config.p_randsmiles}")
    # one batch more than is trained on: the loop takes it before it stops
    data = _StampedDataset(fixture_dataset((steps + 1) * config.batch_size))
    torch.cuda.reset_peak_memory_stats()
    graph_canon._canonical_cached.cache_clear()  # the run starts cold, as a user's does
    canon_before = dict(native.CANON_PATHS)
    random.seed(0)  # permute_smiles draws from the global random module
    _zero_counts()  # the path starts here
    start = time.perf_counter()
    model, results = train.train_autoencoder(config, data, max_steps_per_epoch=steps, seed=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - start
    counts = _counts()  # and ends here
    canon_in_run = {k: native.CANON_PATHS[k] - canon_before[k] for k in canon_before}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    history = results["history"]
    check(len(history) == steps and all(h[0] == "train" for h in history),
          f"train: {len(history)} steps in the history, not {steps}")
    check(next(model.parameters()).device.type == "cuda", "train: the model is not on the card")
    losses = np.array([h[3:] for h in history], np.float64)  # loss, ar_loss, clip_loss
    check(bool(np.isfinite(losses).all()), "train: a loss is not finite")
    check(losses[-1, 1] < losses[0, 1],
          f"train: ar_loss went from {losses[0, 1]} to {losses[-1, 1]}")
    per_step = {name: c / steps for name, c in counts.items()}
    n_x, n_e = config.n_layer_xformer, config.n_layer_e3gnn
    # encode and decoder trunk, each recomputed once under xformer_remat;
    # the EGNN is not rematerialized
    expected = {"packed_causal_attention": 4 * n_x, "packed_causal_attention_backward": 2 * n_x,
                "egnn_messages": n_e, "egnn_messages_backward": n_e,
                "flash_causal_attention": 0, "decode_attention": 0, "decode_attention_quant": 0,
                "top_k": 0}
    check(per_step == expected, f"train: launches a step {per_step}, expected {expected}")
    intervals = np.diff(data.stamps)[warm:]
    check(len(intervals) == timed, f"train: {len(intervals)} timed steps, not {timed}")
    step_s = float(np.median(intervals))
    MEASURED["train_mol_per_s"] = config.batch_size / step_s
    widths = sorted({(b["tokens"].shape[1], b["raw_tokens"].shape[1], b["atoms"].shape[1])
                     for b in data.batches[:steps]})
    emit({"phase": "train", "recipe": "grande", "dtype": config.dtype,
          "batch": config.batch_size, "n_seq": config.n_seq,
          "xformer": [n_x, config.n_hidden_xformer, config.n_head],
          "egnn": [n_e, config.n_hidden_e3nn, config.msg_cutoff_e3nn],
          "xformer_remat": config.xformer_remat, "egnn_remat": config.egnn_remat,
          "p_randsmiles": config.p_randsmiles, "canonicalize": True,
          "parameters": sum(p.numel() for p in model.parameters()),
          "warmup_steps": warm, "timed_steps": timed,
          "step_seconds": step_s, "step_seconds_all": [float(x) for x in np.diff(data.stamps)],
          "mol_per_s": config.batch_size / step_s,
          "trainer_step_seconds_all": results["train_step_seconds"],
          "train_autoencoder_seconds": total_s,
          "batch_widths_tokens_raw_atoms": widths,
          "loss_first_last": [losses[0, 0], losses[-1, 0]],
          "ar_loss_first_last": [losses[0, 1], losses[-1, 1]],
          "clip_loss_first_last": [losses[0, 2], losses[-1, 2]],
          "ar_loss_all": [float(x) for x in losses[:, 1]],
          "launches_per_step": per_step, "peak_mem_gb": peak_gb})
    _host_pipeline(config, data, steps, step_s, canon_in_run)

    # the split of a step, outside the counted window: the same model and
    # the last batches again, each part between two CUDA events
    step, _ = _train_step(config, model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [train.batch_to_device(b, torch.device("cuda")) for b in data.batches[-6:]]
    parts, host_parts = [], []
    for batch in batches:  # the first is warm-up: it makes the optimizer's state
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        host = [time.perf_counter()]
        marks[0].record()
        loss, _, _ = step.losses(gen, batch)
        marks[1].record()
        host.append(time.perf_counter())
        loss.backward()
        marks[2].record()
        host.append(time.perf_counter())
        step.update()
        marks[3].record()
        host.append(time.perf_counter())
        torch.cuda.synchronize()
        parts.append([a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])])
        host_parts.append([b - a for a, b in zip(host, host[1:])])
    fwd, bwd, opt = (float(x) for x in np.median(np.array(parts[1:]), axis=0))
    # between the events the card also waits for the host; host_launch_s is
    # the time the host took to launch each part, without waiting for the card
    emit({"phase": "train_split", "steps": len(parts) - 1,
          "forward_s": fwd, "backward_s": bwd, "optimizer_s": opt,
          "shares": {"forward": fwd / (fwd + bwd + opt), "backward": bwd / (fwd + bwd + opt),
                     "optimizer": opt / (fwd + bwd + opt)},
          "host_launch_s": [float(x) for x in np.median(np.array(host_parts[1:]), axis=0)],
          "seconds_all": parts})
    _profile(lambda: [step(gen, b) for b in batches[1:4]], "train_step_x3", 3 * step_s, top=24)
    return counts


def _step_gradients(config, batch, pick, plain: bool):
    """(loss, {parameter name: gradient}, launch counts) of one training
    step's backward from a fresh seeded model, through the kernels or, with
    `plain`, through their plain versions."""
    step, _ = _train_step(config, None)
    _zero_counts()
    with plain_versions() if plain else contextlib.nullcontext():
        loss, _, _ = step.losses(None, batch, pick_point=pick)
        loss.backward()
    torch.cuda.synchronize()
    named = list(step.model.named_parameters())
    # the EGNN's coordinate MLPs are in the state dict and in no forward
    unused = [name for name, p in named if p.grad is None]
    check(all(".coord_mlp." in name for name in unused), f"no gradient for {unused}")
    grads = {name: p.grad for name, p in named if p.grad is not None}
    return float(loss.detach()), grads, _counts()


def phase_train_fp32_vs_plain():
    """One float32 training step through the kernels against the same step
    through their plain versions: the packed route (K5f, K5b, K3, K4) at the
    recipe's n_seq, and the flash route (K2 and its replayed backward) at
    T 200."""
    from coati_tpu_torch.data import fixture_dataset
    from coati_tpu_torch.data.xform import clip_ar_xform
    from coati_tpu_torch.training import train
    from coati_tpu_torch.training.config import grande_config

    def one(label, batch_size, n_seq, pad_to):
        config = grande_config(dtype="float32", n_layer_xformer=4, n_layer_e3gnn=2,
                               batch_size=batch_size, n_seq=n_seq)
        _, tok = _train_step(config, None)
        random.seed(0)  # permute_smiles draws from the global random module
        pipe = fixture_dataset(batch_size).get_data_pipe(
            batch_size=batch_size,
            xform_routine=lambda b: clip_ar_xform(
                b, tokenizer=tok, p_dataset=config.p_dataset, p_formula=config.p_formula,
                p_clip=config.p_clip, p_clip_cut=config.p_clip_cut,
                p_randsmiles=config.p_randsmiles, rng=random.Random(0)))
        host = next(iter(pipe))
        if pad_to:  # widen the token arrays with padding, which the loss ignores
            for key, fill in (("tokens", 0), ("raw_tokens", 0), ("y_next", -1)):
                extra = pad_to - host[key].shape[1]
                host[key] = np.pad(host[key], ((0, 0), (0, extra)), constant_values=fill)
        batch = train.batch_to_device(host, torch.device("cuda"))
        pick = torch.rand(batch_size, generator=torch.Generator().manual_seed(0)) > 0.5
        plain_loss, plain_grads, plain_counts = _step_gradients(config, batch, pick, plain=True)
        check(sum(plain_counts.values()) == 0, f"{label}: the plain step launched a kernel")
        loss, grads, counts = _step_gradients(config, batch, pick, plain=False)
        check(grads.keys() == plain_grads.keys(), f"{label}: the two steps reach other parameters")
        worst, worst_name = 0.0, ""
        for name, g in grads.items():
            ref = plain_grads[name]
            # the order of sums only, through 4 + 2 layers and two passes
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            err = float((g - ref).abs().max())
            check(err <= tol, f"{label}: gradient of {name} differs by {err} (tolerance {tol})")
            if err / tol > worst:
                worst, worst_name = err / tol, name
        rel = abs(loss - plain_loss) / abs(plain_loss)
        check(rel <= 1e-5, f"{label}: loss {loss} against {plain_loss} through the plain versions")
        emit({"phase": "train_fp32_vs_plain", "route": label, "batch": batch_size,
              "T": int(batch["tokens"].shape[1]), "atoms": int(batch["atoms"].shape[1]),
              "layers_xformer_egnn": [4, 2], "loss": loss, "plain_loss": plain_loss,
              "loss_rel_diff": rel, "parameters_compared": len(grads),
              "worst_gradient_err_over_tol": worst, "worst_parameter": worst_name,
              "launches": counts})
        return counts

    counts = one("packed", 64, 80, None)
    check(counts["packed_causal_attention_backward"] == 8 and counts["egnn_messages_backward"] == 2
          and counts["flash_causal_attention"] == 0,
          f"packed route: launches {counts}")
    counts = one("flash_T200", 32, 200, 200)
    check(counts["flash_causal_attention"] == 16 and counts["packed_causal_attention"] == 0
          and counts["packed_causal_attention_backward"] == 0,
          f"flash route: launches {counts}")


TRAIN_GRAPH_STEPS = 12


def _train_graph_batches(config, tok, steps):
    """`steps` device batches of the recipe's transform on the fixture's
    molecules: three batches, each padded to a (T, N) width of its own, in
    turn. Padding tokens are [PAD] with label -1 and padding atoms 0, which
    the losses and the EGNN leave out."""
    from coati_tpu_torch.data import fixture_dataset
    from coati_tpu_torch.data.xform import clip_ar_xform
    from coati_tpu_torch.training import train

    random.seed(0)  # permute_smiles draws from the global random module
    pipe = fixture_dataset(3 * config.batch_size).get_data_pipe(
        batch_size=config.batch_size,
        xform_routine=lambda b: clip_ar_xform(
            b, tokenizer=tok, p_dataset=config.p_dataset, p_formula=config.p_formula,
            p_clip=config.p_clip, p_clip_cut=config.p_clip_cut,
            p_randsmiles=config.p_randsmiles, rng=random.Random(0)))
    hosts = list(itertools.islice(pipe, 3))
    t0 = max(h["tokens"].shape[1] for h in hosts)
    n0 = max(h["atoms"].shape[1] for h in hosts)
    widths = [(t0, n0), (t0 + 16, n0 + 32), (t0 + 32, n0 + 16)]
    batches = []
    for host, (t, n) in zip(hosts, widths):
        host = dict(host)
        for key, fill in (("tokens", 0), ("raw_tokens", 0), ("y_next", -1)):
            host[key] = np.pad(host[key], ((0, 0), (0, t - host[key].shape[1])),
                               constant_values=fill)
        extra = n - host["atoms"].shape[1]
        host["atoms"] = np.pad(host["atoms"], ((0, 0), (0, extra)))
        host["coords"] = np.pad(host["coords"], ((0, 0), (0, extra), (0, 0)))
        batches.append(train.batch_to_device(host, torch.device("cuda")))
    return [batches[i % 3] for i in range(steps)], widths


def _leaf_gaps(mine: dict, ref: dict) -> dict:
    """{leaf: max |mine - ref| / max(1, max |ref|)} of the leaves that
    differ at all."""
    out = {}
    for name, r in ref.items():
        m = mine[name]
        if r is None or m is None:
            if (r is None) != (m is None):
                out[name] = float("inf")
            continue
        if not torch.equal(m, r):
            out[name] = float((m - r).abs().max()) / max(1.0, float(r.abs().max()))
    return out


def _gap_summary(gaps: dict) -> dict:
    worst = max(gaps, key=gaps.get) if gaps else None
    return {"leaves": len(gaps), "worst": worst, "worst_gap": gaps[worst] if worst else 0.0,
            "point_encoder_only": all(n.startswith("point_encoder.") for n in gaps)}


class _GradTap:
    """The gradients as the optimizer gets them (before its clip), by
    parameter name, from a pre-step hook."""

    def __init__(self, model, optimizer):
        self.named = list(model.named_parameters())
        self.grads = {}
        optimizer.register_step_pre_hook(self._take)

    def _take(self, opt, args, kwargs):
        self.grads = {n: None if p.grad is None else p.grad.detach().clone()
                      for n, p in self.named}


def _training_state(model, optimizer) -> dict:
    """Parameters and both Adam moments by name, cloned."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = p.detach().clone()
        state = optimizer.state.get(p, {})
        for key in ("exp_avg", "exp_avg_sq"):
            if key in state:
                out[f"{key}:{name}"] = state[key].detach().clone()
    return out


def _copy_training_state(src, dst) -> None:
    """dst's model and optimizer take src's values, in place (a graph reads
    dst's parameters where they are)."""
    (m_src, o_src), (m_dst, o_dst) = src, dst
    with torch.no_grad():
        for p, q in zip(m_src.parameters(), m_dst.parameters()):
            q.copy_(p)
            for key, value in o_src.state.get(p, {}).items():
                o_dst.state[q][key].copy_(value)


def phase_train_graph():
    """The training step's forward and backward replayed from a CUDA graph
    a batch shape (training/step_graph.py) against the eager step, bit for
    bit but for K4's dc atomics; see the module docstring's `train_graph`."""
    from coati_tpu_torch.common import tracing
    from coati_tpu_torch.ops import graphs
    from coati_tpu_torch.training import train
    from coati_tpu_torch.training.config import grande_config

    steps = TRAIN_GRAPH_STEPS
    config = grande_config(dtype="bfloat16", n_epochs=1, p_clip_emb_smi=0.4)
    _, tok = _train_step(config, None)
    batches, widths = _train_graph_batches(config, tok, steps)

    def make(tap=True):
        step, _ = _train_step(config, None)  # fresh from seed 0
        return (step, torch.Generator(device="cuda").manual_seed(1),
                _GradTap(step.model, step.optimizer) if tap else None)

    def run_step(step, gen, batch, graphed):
        before = _counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        with contextlib.nullcontext() if graphed else graphs.eager():
            metrics = step(gen, batch)
        host_s = time.perf_counter() - start
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        launches = {n: c - before[n] for n, c in _counts().items()}
        return [float(metrics[k]) for k in ("loss", "ar_loss", "clip_loss")], host_s, wall_s, \
            launches

    # lockstep: every step starts from the first eager model's state
    eager1, eager2, graphed = make(), make(), make()
    totals = {"eager": collections.Counter(), "graphed": collections.Counter()}
    tracing.reset()
    tracing.start()
    rows = []
    for i, batch in enumerate(batches):
        if i:
            for twin in (eager2, graphed):
                _copy_training_state((eager1[0].model, eager1[0].optimizer),
                                     (twin[0].model, twin[0].optimizer))
        out = {}
        for label, (step, gen, _), is_graphed in (("eager", eager1, False), ("eager2", eager2, False),
                                                  ("graphed", graphed, True)):
            if label == "graphed":
                tracing.start()
            else:
                tracing.stop()
            out[label] = run_step(step, gen, batch, is_graphed)
            if label in totals:
                totals[label].update(out[label][3])
        tracing.stop()
        states = {label: _training_state(step.model, step.optimizer)
                  for label, (step, _, _) in (("eager", eager1), ("eager2", eager2),
                                              ("graphed", graphed))}
        grads = {"eager": eager1[2].grads, "eager2": eager2[2].grads, "graphed": graphed[2].grads}
        gens = [g.get_state() for g in (eager1[1], eager2[1], graphed[1])]
        norms = [float(s.optimizer.last_grad_norm) for s, _, _ in (eager1, eager2, graphed)]
        row = {"phase": "train_graph_step", "step": i, "T_N": list(widths[i % 3]),
               "losses": {k: v[0] for k, v in out.items()},
               "host_s": {k: v[1] for k, v in out.items()},
               "wall_s": {k: v[2] for k, v in out.items()},
               "clip_norms": norms,
               "generators_equal": all(torch.equal(gens[0], g) for g in gens[1:]),
               "grads_graphed_vs_eager": _gap_summary(_leaf_gaps(grads["graphed"], grads["eager"])),
               "grads_eager_vs_eager": _gap_summary(_leaf_gaps(grads["eager2"], grads["eager"])),
               "state_graphed_vs_eager": _gap_summary(_leaf_gaps(states["graphed"],
                                                                 states["eager"])),
               "state_eager_vs_eager": _gap_summary(_leaf_gaps(states["eager2"],
                                                               states["eager"]))}
        emit(row)
        rows.append(row)
        check(row["losses"]["graphed"] == row["losses"]["eager"],
              f"train_graph step {i}: losses {row['losses']}")
        check(row["generators_equal"], f"train_graph step {i}: the generators' states differ")
        g = row["grads_graphed_vs_eager"]
        check(g["point_encoder_only"] and g["worst_gap"] <= 1e-4,
              f"train_graph step {i}: gradients differ {g}")
        if norms[2] == norms[0]:
            st = row["state_graphed_vs_eager"]
            check(st["point_encoder_only"],
                  f"train_graph step {i}: parameters or moments differ past the point encoder {st}")
    counters = tracing.snapshot()["counters"]
    captures = counters.get("train.graph_captures", 0)
    replays = counters.get("train.graph_steps", 0)
    kernels = ("egnn_messages", "egnn_messages_backward", "packed_causal_attention",
               "packed_causal_attention_backward")
    launches = {label: {k: totals[label][k] for k in kernels} for label in totals}
    check(launches["graphed"] == launches["eager"], f"train_graph: launches {launches}")
    check(all(launches["eager"][k] > 0 for k in kernels), f"train_graph: launches {launches}")
    check((captures, replays) == (3, steps - 6),
          f"train_graph: {captures} captures and {replays} replays")
    del eager1, eager2, graphed, rows

    # a loss kept alive from a step run by hand on the default stream holds
    # that step's autograd graph and its gradient accumulators: the capture
    # runs over fresh leaves (step_graph.fresh_leaves), so it neither waits on
    # them nor fails, and the steps equal an eager twin's
    (twin, twin_gen, _), (held, held_gen, _) = make(tap=False), make(tap=False)
    kept = {"eager": [], "graphed": []}
    for step, gen, label in ((twin, twin_gen, "eager"), (held, held_gen, "graphed")):
        loss, ar, cl = step.losses(gen, batches[0])
        loss.backward()
        step.update()
        kept[label].append([float(x.detach()) for x in (loss, ar, cl)])
        kept[label + "_graph"] = loss  # kept alive through the steps below
    del loss, ar, cl
    tracing.reset()
    for _ in range(4):  # eager, capture, two replays
        for step, gen, label in ((twin, twin_gen, "eager"), (held, held_gen, "graphed")):
            if label == "graphed":
                tracing.start()
            kept[label].append(run_step(step, gen, batches[0], label == "graphed")[0])
            tracing.stop()
    counters = tracing.snapshot()["counters"]
    line = {"phase": "train_graph_held_loss", "losses": {k: kept[k] for k in ("eager", "graphed")},
            "captures": counters.get("train.graph_captures", 0),
            "replays": counters.get("train.graph_steps", 0)}
    emit(line)
    check(kept["graphed"] == kept["eager"], f"train_graph: with a loss held, losses {line}")
    check((line["captures"], line["replays"]) == (1, 2),
          f"train_graph: with a loss held, captures and replays {line}")
    del twin, held, kept

    # each path free-running from the seed: host seconds, losses, peak memory
    free = {}
    for label, is_graphed in (("eager", False), ("graphed", True)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, gen, _ = make(tap=False)
        runs = [run_step(step, gen, batch, is_graphed) for batch in batches]
        free[label] = {"losses": [r[0] for r in runs], "host_s": [r[1] for r in runs],
                       "wall_s": [r[2] for r in runs],
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del step, gen
    replayed = [i for i in range(steps) if i >= 6]  # every shape's third and fourth steps
    emit({"phase": "train_graph", "steps": steps, "widths_T_N": [list(w) for w in widths],
          "p_clip_emb_smi": config.p_clip_emb_smi, "captures": captures, "replays": replays,
          "launches": launches,
          "host_s_replayed_steps": {k: [free[k]["host_s"][i] for i in replayed] for k in free},
          "wall_s_replayed_steps": {k: [free[k]["wall_s"][i] for i in replayed] for k in free},
          "capture_step_wall_s": [free["graphed"]["wall_s"][i] for i in range(3, 6)],
          "free_running": free,
          "free_running_first_loss_equal": free["graphed"]["losses"][0] == free["eager"]["losses"][0]})
    check(free["graphed"]["losses"][0] == free["eager"]["losses"][0],
          "train_graph: the free-running runs' first losses differ")


# COATI2 grande: the recipe of examples/train_coati2.py (16 x 512, 16 heads
# of 32, n_seq 128, SwiGLU-resnet heads, the coati2_12_12 vocabulary)
COATI2_GRANDE = dict(n_layer_xformer=16, n_hidden_xformer=512, embed_dim=512, n_head=16,
                     n_seq=128, enc_to_coati="swiglu_resnet", n_direct_clr=64)
COATI2_DOC = ROOT / "coati_tpu_torch" / "_build" / "coati2_grande_seed0.pkl"


def _coati2_tokenizer():
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

    return TrieTokenizer(n_seq=COATI2_GRANDE["n_seq"], **get_vocab("coati2_12_12"))


def _coati2_corpus(tok, n):
    """The first n corpus SMILES whose [SMILES]...[STOP] fits n_seq."""
    out = []
    with gzip.open(CORPUS, "rt") as f:
        for line in f:
            s = line.strip()
            with contextlib.suppress(KeyError):
                if len(tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False,
                                         range_check=False)) <= tok.n_seq:
                    out.append(s)
            if len(out) == n:
                return out
    return out


def _top2_margin(model, tok, h, row, pos):
    """The plain version's margin between its two largest logits at the
    step that chose token `pos` of `row`, teacher-forced in float32."""
    from coati_tpu_torch.models.transformer import forward_logits

    with plain_versions(), torch.no_grad():
        tokens = torch.as_tensor(np.asarray(row)[None], device="cuda")
        inject = model._clip_token(np.asarray(h, np.float32)[None])
        logits = forward_logits(model._compute.xformer, model.config.xformer_config, tokens,
                                inject, tok.unk_token)[0, pos - 1].float()
    top = logits.topk(2).values
    return float(top[0] - top[1])


def phase_coati2():
    """COATI2 grande on the card (inference): seeded fresh weights written
    as a reference-format document and read back by load_coati2; an fp32
    greedy round trip through the kernels and through the plain versions;
    the production round trip of 1,024 corpus SMILES; one
    property-conditioned decode. Returns the launch counts of the path."""
    from coati_tpu_torch.data.xform_coati2 import property_tokens
    from coati_tpu_torch.models.coati2 import COATI2
    from coati_tpu_torch.models.io import load_coati2, model_to_state, serialize_model
    from coati_tpu_torch.training.train_coati2 import Coati2TrainConfig, fresh_model

    tok = _coati2_tokenizer()
    config = Coati2TrainConfig(**COATI2_GRANDE)
    model = fresh_model(config.model_config(tok.n_token), torch.device("cpu"), seed=0)
    COATI2_DOC.parent.mkdir(parents=True, exist_ok=True)
    COATI2_DOC.write_bytes(serialize_model(
        train_args={"tokenizer_vocab": "coati2_12_12"}, dataset_summary={},
        model_state=model_to_state(model), model_kwargs=config.model_kwargs(tok.n_token)))
    del model
    start = time.perf_counter()
    m, tok = load_coati2(str(COATI2_DOC))  # no device: the card
    check(m.device.type == "cuda", f"coati2: model loaded on {m.device}, not the card")
    cfg, n_layer = m.config, m.config.n_layer_xformer
    emit({"phase": "coati2_load", "seconds": time.perf_counter() - start,
          "config": {k: getattr(cfg, k) for k in (*COATI2_GRANDE, "n_tok")},
          "head_dim": cfg.xformer_config.head_dim,
          "parameters": sum(p.numel() for p in m.params.parameters())})
    check(cfg.xformer_config.head_dim == 32, "coati2: head dim is not 32")
    smiles = _coati2_corpus(tok, 1024)
    check(len(smiles) == 1024, f"coati2: {len(smiles)} corpus SMILES fit n_seq")
    tokens = _tokens(tok, smiles, tok.n_seq)

    # fidelity: fp32 greedy, 64 rows, through the plain versions and the kernels
    fid = tokens[:64]

    def greedy():
        h = m.encode_tokens(fid, tok)
        out, rows = m.hcoati_to_2d_batch(h, tok, k=1, keep_special=True, return_tokens=True)
        return h.float().cpu().numpy(), rows

    with plain_versions():
        (plain_h, plain_rows), _, plain_launches = _timed(greedy)
    check(sum(plain_launches.values()) == 0, "coati2: the plain run launched a kernel")
    _zero_counts()  # the path starts here
    (h, rows), seconds, launches = _timed(greedy)
    agree = sum(a == b for a, b in zip(rows, plain_rows))
    differing = []
    for i, (a, b) in enumerate(zip(rows, plain_rows)):
        if a != b:
            pos = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            differing.append({"row": i, "position": pos,
                              "plain_top2_margin": _top2_margin(m, tok, plain_h[i], b, pos)})
    h_diff = float(np.abs(h - plain_h).max())
    emit({"phase": "coati2_fp32_greedy", "rows": 64, "agree_with_plain": agree,
          "embedding_max_abs_diff": h_diff, "differing_rows": differing,
          "seconds": seconds, "launches": launches})
    check(h_diff <= 1e-5, f"coati2 fp32: embeddings differ by {h_diff}")
    check(agree >= 63, f"coati2 fp32: only {agree}/64 rows agree with the plain versions")
    check(all(d["plain_top2_margin"] < 1e-4 for d in differing),
          f"coati2 fp32: a row first differs where the plain margin is not under 1e-4: "
          f"{differing}")
    check(launches["flash_causal_attention"] == 2 * n_layer
          and launches["decode_attention"] % n_layer == 0 and launches["decode_attention"] > 0,
          f"coati2 fp32: launches {launches}")

    # production: bf16 with the int8 KV cache, batch 1024
    prod = COATI2(m.params, cfg.replace(dtype="bfloat16"), seed=0)
    check(prod.config.xformer_config.kv_quantized, "coati2: bf16 does not quantize the cache")
    kw = dict(k=100, inv_temp=2.0)
    runs = [_round_trip(prod, tok, tokens, **kw) for _ in range(4)]  # the first is warm-up
    for out, emb, _, run_launches in runs:
        check(len(out) == 1024 and np.isfinite(emb).all()
              and emb.shape == (1024, cfg.embed_dim),
              "coati2: rows not decoded or embeddings not finite")
        check(run_launches["flash_causal_attention"] == 2 * n_layer
              and run_launches["packed_causal_attention"] == 0,
              f"coati2: full-sequence kernel counts {run_launches}")
        steps, rem = divmod(run_launches["decode_attention_quant"], n_layer)
        check(steps > 0 and rem == 0, f"coati2: int8 decode kernel count {run_launches}")
    seconds = statistics.median(r[2] for r in runs[1:])
    encode_s = statistics.median(
        _timed(lambda: prod.encode_tokens(tokens, tok))[1] for _ in range(3))
    last = runs[-1][3]
    emit({"phase": "coati2_production", "batch": 1024, "dtype": "bfloat16", "kv": "int8/float32",
          "k": 100, "inv_temp": 2.0, "encode_T": tok.n_seq, "seconds": seconds,
          "seconds_all": [r[2] for r in runs], "mol_per_s": 1024 / seconds,
          "encode_seconds": encode_s, "decode_steps": last["decode_attention_quant"] // n_layer,
          "max_decode_steps": tok.n_seq - 3,
          "k2_launches": last["flash_causal_attention"],
          "k1_launches": last["decode_attention_quant"], "launches_per_call": last,
          "exact_round_trips": sum(a == b for a, b in zip(runs[-1][0], smiles)),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    _profile(lambda: prod.smiles_to_2d_batch(tokens, tok, **kw), "coati2_production", seconds)

    # a property-conditioned prefix, through hcoati_to_2d_batch
    block = property_tokens(smiles[0], tok)
    check(block.startswith("[PROPS]"), f"coati2: no conditioning block for {smiles[0]}")
    fill = block + "[SMILES]"
    h_prod = prod.encode_tokens(tokens, tok)
    (out, rows), seconds, launches = _timed(lambda: prod.hcoati_to_2d_batch(
        h_prod, tok, fill_in_from=fill, keep_special=True, return_tokens=True, **kw))
    prefix = tok.tokenize_text("[CLIP][UNK]" + fill, pad=False)
    check(all(r[: len(prefix)] == prefix for r in rows), "coati2: a row lost its prefix")
    emit({"phase": "coati2_conditioned", "batch": 1024, "fill_in_from": fill,
          "prefix_tokens": len(prefix), "seconds": seconds,
          "decode_steps": launches["decode_attention_quant"] // n_layer, "launches": launches})
    counts = _counts()  # the path ends here
    # K2 in bf16 at the encode and at both prefills
    plain_prefix = len(tok.tokenize_text("[CLIP][UNK][SMILES]", pad=False))
    hold_path_shapes("coati2", [
        ("flash_causal_attention", 1024, t, cfg.n_head, cfg.xformer_config.head_dim, "bfloat16")
        for t in (tok.n_seq, plain_prefix, len(prefix))])
    return counts


def phase_coati2_train():
    """The COATI2 training path: train_coati2 with the grande recipe in
    bf16 on corpus rows with only a 'smiles' column. Returns the launch
    counts of the path."""
    from coati_tpu_torch.data.batch_pipe import SmilesRows
    from coati_tpu_torch.models.coati2 import COATI2
    from coati_tpu_torch.models.io import load_coati2, model_to_state, serialize_model
    from coati_tpu_torch.training import train_coati2 as tt2

    warm, timed = 3, 10
    steps = warm + timed
    config = tt2.Coati2TrainConfig(**COATI2_GRANDE, batch_size=160, lr=5e-4, n_epochs=1,
                                   dtype="bfloat16")
    tok = _coati2_tokenizer()
    with gzip.open(CORPUS, "rt") as f:
        corpus = f.read().split()
    # rows with only a 'smiles' column, so that the transform computes the
    # properties as in a user's run, in a seeded order; one batch more than
    # is trained on: the loop takes it before it stops
    picked = corpus[: (steps + 1) * config.batch_size]
    order = np.random.default_rng(0).permutation(len(picked))
    data = _StampedDataset(SmilesRows(picked[i] for i in order))
    torch.cuda.reset_peak_memory_stats()
    random.seed(0)  # the transform draws from the global random module
    _zero_counts()  # the path starts here
    start = time.perf_counter()
    model, results = tt2.train_coati2(config, data, max_steps_per_epoch=steps, seed=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - start
    counts = _counts()  # and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    history = results["history"]
    check(len(history) == steps, f"coati2_train: {len(history)} steps, not {steps}")
    losses = np.array([h[3:] for h in history], np.float64)  # loss, ar_loss, clr_loss
    check(bool(np.isfinite(losses).all()), "coati2_train: a loss is not finite")
    check(losses[-1, 1] < losses[0, 1],
          f"coati2_train: ar_loss went from {losses[0, 1]} to {losses[-1, 1]}")
    per_step = {name: c / steps for name, c in counts.items()}
    n_x = config.n_layer_xformer
    # the doubled views and the AR pass, each recomputed once under remat
    expected = {"packed_causal_attention": 4 * n_x, "packed_causal_attention_backward": 2 * n_x,
                "flash_causal_attention": 0, "decode_attention": 0, "decode_attention_quant": 0,
                "egnn_messages": 0, "egnn_messages_backward": 0, "top_k": 0}
    check(per_step == expected, f"coati2_train: launches a step {per_step}, expected {expected}")
    intervals = np.diff(data.stamps)[warm:]
    check(len(intervals) == timed, f"coati2_train: {len(intervals)} timed steps, not {timed}")
    step_s = float(np.median(intervals))
    widths = sorted({(b["tokens"].shape[1], b["raw_tokens"].shape[1])
                     for b in data.batches[:steps]})
    # K5f and K5b in bf16 at the widths the run took: the AR pass (B 160)
    # at the targets' width, the two views as one batch (B 320) at theirs
    head = (config.n_head, config.n_hidden_xformer // config.n_head, "bfloat16")
    hold_path_shapes("coati2_train", [
        (kernel, b, t, *head) for t_ar, t_views in widths
        for b, t in ((config.batch_size, t_ar), (2 * config.batch_size, t_views))
        for kernel in ("packed_causal_attention", "packed_causal_attention_backward")])
    emit({"phase": "coati2_train", "recipe": "examples/train_coati2.py grande",
          "dtype": config.dtype, "batch": config.batch_size, "n_seq": config.n_seq,
          "xformer": [n_x, config.n_hidden_xformer, config.n_head], "remat": config.remat,
          "parameters": sum(p.numel() for p in model.parameters()),
          "warmup_steps": warm, "timed_steps": timed,
          "step_seconds": step_s, "step_seconds_all": [float(x) for x in np.diff(data.stamps)],
          "mol_per_s": config.batch_size / step_s,
          "trainer_step_seconds_all": results["train_step_seconds"],
          "train_coati2_seconds": total_s, "batch_widths_tokens_views": widths,
          "loss_first_last": [losses[0, 0], losses[-1, 0]],
          "ar_loss_first_last": [losses[0, 1], losses[-1, 1]],
          "clr_loss_first_last": [losses[0, 2], losses[-1, 2]],
          "ar_loss_all": [float(x) for x in losses[:, 1]],
          "launches_per_step": per_step, "peak_mem_gb": peak_gb})

    props_id = tok.tokenize_text("[PROPS]", pad=False)[0]
    with_props = sum(int((b["tokens"][:, 0] == props_id).sum()) for b in data.batches[:steps])
    in_run = float(np.median(data.xform_s[:steps]))
    emit({"phase": "coati2_host_pipeline", "batch": config.batch_size, "batches": steps,
          "p_props": config.p_props, "xform_in_run_s": in_run,
          "xform_in_run_s_all": data.xform_s[:steps], "step_seconds": step_s,
          "in_run_share_of_step": in_run / step_s,
          "rows_with_properties": with_props, "rows": steps * config.batch_size})
    check(0 < with_props < steps * config.batch_size,
          f"coati2_train: {with_props} rows drew properties")

    # the run's document, read back by load_coati2, encodes as the model does
    path = COATI2_DOC.with_name("coati2_trained.pkl")
    path.write_bytes(serialize_model(
        train_args=config.as_dict(), dataset_summary=data.summary,
        model_state=model_to_state(model), model_kwargs=config.model_kwargs(tok.n_token)))
    loaded, ltok = load_coati2(str(path))
    rows = _tokens(ltok, corpus[:8], ltok.n_seq)
    h = loaded.encode_tokens(rows, ltok)
    direct = COATI2(model.eval(), loaded.config).encode_tokens(rows, tok)
    diff = float((h - direct).abs().max())
    emit({"phase": "coati2_train_document", "rows": 8, "shape": list(h.shape),
          "finite": bool(torch.isfinite(h).all()), "max_abs_diff_vs_trained_model": diff})
    check(h.shape == (8, config.embed_dim) and bool(torch.isfinite(h).all()) and diff <= 1e-5,
          f"coati2_train: the reloaded document encodes {diff} away")

    # three traced steps on batches made before, outside the counted window
    step = tt2.Coati2TrainStep(
        model.train(), config.model_config(tok.n_token),
        tt2.make_optimizer(config, model), stop_token=tok.stop_token,
        unk_token=tok.unk_token, pad_token=tok.pad_token,
        token_entropy_unit=float(np.log2(tok.n_token)))
    batches = [tt2.batch_to_device(b, torch.device("cuda")) for b in data.batches[-4:]]
    step(batches[0])  # warm-up: makes the optimizer's state
    _, wall_s, _ = _timed(lambda: [step(b) for b in batches[1:]])
    _profile(lambda: [step(b) for b in batches[1:]], "coati2_train_step_x3", wall_s, top=24)

    return counts


def phase_coati2_fp32_vs_plain():
    """One float32 COATI2 step at full width (4 layers of 512, 16 heads of
    32), batch 32, T <= 128, through the kernels (K5f, K5b) and through their
    plain versions: the loss and every parameter's gradient must agree."""
    from coati_tpu_torch.data.xform_coati2 import coati2_ar_xform
    from coati_tpu_torch.training import train_coati2 as tt2

    config = tt2.Coati2TrainConfig(**dict(COATI2_GRANDE, n_layer_xformer=4), batch_size=32)
    tok = _coati2_tokenizer()
    model_cfg = config.model_config(tok.n_token)
    with gzip.open(CORPUS, "rt") as f:
        rows = [next(f).strip() for _ in range(32)]
    random.seed(0)
    host = coati2_ar_xform({"smiles": rows}, tok, rng=random.Random(0))
    batch = tt2.batch_to_device(host, torch.device("cuda"))

    def one(plain):
        model = tt2.fresh_model(model_cfg, torch.device("cuda"), seed=0)
        step = tt2.Coati2TrainStep(model, model_cfg, None, stop_token=tok.stop_token,
                                   unk_token=tok.unk_token, pad_token=tok.pad_token,
                                   token_entropy_unit=float(np.log2(tok.n_token)))
        _zero_counts()
        with plain_versions() if plain else contextlib.nullcontext():
            loss, _, _ = step.losses(batch)
            loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}, _counts()

    plain_loss, plain_grads, plain_counts = one(True)
    check(sum(plain_counts.values()) == 0, "coati2_fp32_vs_plain: the plain step launched")
    loss, grads, counts = one(False)
    check(counts["packed_causal_attention_backward"] == 2 * 4
          and counts["flash_causal_attention"] == 0, f"coati2_fp32_vs_plain: launches {counts}")
    worst, worst_name = 0.0, ""
    for name, g in grads.items():
        ref = plain_grads[name]
        check(g is not None and ref is not None, f"coati2_fp32_vs_plain: no gradient for {name}")
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        err = float((g - ref).abs().max())
        check(err <= tol, f"coati2_fp32_vs_plain: gradient of {name} differs by {err} (tol {tol})")
        if err / tol > worst:
            worst, worst_name = err / tol, name
    rel = abs(loss - plain_loss) / abs(plain_loss)
    emit({"phase": "coati2_fp32_vs_plain", "batch": 32, "T": int(batch["tokens"].shape[1]),
          "views_T": int(batch["raw_tokens"].shape[1]), "layers": 4, "loss": loss,
          "plain_loss": plain_loss, "loss_rel_diff": rel, "parameters_compared": len(grads),
          "worst_gradient_err_over_tol": worst, "worst_parameter": worst_name,
          "launches": counts})
    check(rel <= 1e-5, f"coati2_fp32_vs_plain: loss {loss} against {plain_loss}")

# ------------------------------------------------- data, restart, LoRA, generative

def write_fixture_shards(root: Path, n_shards: int = 4) -> None:
    """The 1,024 fixture molecules as COATI_dataset pickle shards under
    root/datasets/coati_data/: each row's padding cut to its atoms, and
    source_collection geom_drugs (a [SET] token of the 'mar' vocabulary)."""
    import pickle

    from coati_tpu_torch.data import load_points_fixture
    from coati_tpu_torch.data.dataset import S3_PATH

    smiles, atoms, coords = load_points_fixture()
    rows = []
    for s, a, c in zip(smiles, atoms, coords):
        n = int((a > 0).sum())
        rows.append({"smiles": s, "source_collection": "geom_drugs",
                     "atoms": a[:n].astype(np.float64), "coords": c[:n].astype(np.float64)})
    shard_dir = root / S3_PATH
    shard_dir.mkdir(parents=True, exist_ok=True)
    per = -(-len(rows) // n_shards)
    for i in range(n_shards):
        with open(shard_dir / f"{i}.pkl", "wb") as f:
            pickle.dump(rows[i * per : (i + 1) * per], f)


def _clear_host_caches():
    from coati_tpu_torch.chem import graph_canon
    from coati_tpu_torch.data import xform

    graph_canon._canonical_cached.cache_clear()
    xform._embed_conformer_cached.cache_clear()


def phase_dataset_pool(data_root: Path):
    """The dataset on disk and the host worker pool (host only): the
    fixture's shards through COATI_dataset, rows per partition; then the
    recipe's transform over its raw batches serially and through
    XformWorkerPool at 1, 2 and cores - 2 workers with the default
    read_ahead, beside the trainer's mol/s of phase train. The raw batches
    are the fixture's 6 batches, then 4 more passes over them with each
    SMILES written anew (permute_smiles), so that the canonicalizer's cache,
    keyed on the string, misses on every row on both sides, as over a real
    corpus of distinct rows."""
    from coati_tpu_torch.chem.rdkit_support import permute_smiles
    from coati_tpu_torch.data.dataset import COATI_dataset
    from coati_tpu_torch.data.host_workers import XformWorkerPool
    from coati_tpu_torch.data.xform import clip_ar_xform
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
    from coati_tpu_torch.training.config import grande_config

    recipe = grande_config()
    xform_kwargs = {k: getattr(recipe, k) for k in (
        "p_dataset", "p_formula", "p_fim", "p_graph", "p_clip", "p_clip_cut", "p_randsmiles")}
    start = time.perf_counter()
    write_fixture_shards(data_root)
    write_s = time.perf_counter() - start
    ds = COATI_dataset(str(data_root))
    per_partition = {}
    for part in ("train", "valid", "test"):
        per_partition[part] = sum(len(b["smiles"]) for b in ds.get_data_pipe(
            batch_size=1, partition=part, shuffle_seed=0))
    check(sum(per_partition.values()) == 1024, f"dataset_pool: partitions {per_partition}")
    batch, n_seq, repeats = recipe.batch_size, recipe.n_seq, 5
    start = time.perf_counter()
    distinct = list(ds.get_data_pipe(batch_size=batch, partition="raw", shuffle_seed=0))
    read_s = time.perf_counter() - start
    raws = list(distinct)
    for r in range(1, repeats):
        random.seed(r)  # permute_smiles draws from the global random module
        raws += [dict(b, smiles=np.asarray([permute_smiles(str(s)) for s in b["smiles"]],
                                           dtype=object)) for b in distinct]
    writings = [str(s) for b in raws for s in b["smiles"]]

    def copies():  # every batch a fresh copy: the transform writes into it
        return ({k: v.copy() if isinstance(v, np.ndarray) else v for k, v in b.items()}
                for b in raws)

    tok = TrieTokenizer(n_seq=n_seq, **get_vocab(recipe.tokenizer_vocab))
    _clear_host_caches()
    rng = random.Random(0)
    start = time.perf_counter()
    serial = [clip_ar_xform(b, tokenizer=tok, rng=rng, **xform_kwargs) for b in copies()]
    serial_s = time.perf_counter() - start
    samples = sum(b["tokens"].shape[0] for b in serial)
    cores = os.cpu_count() or 1
    pools = []
    for workers in sorted({1, 2, max(1, cores - 2)}):
        _clear_host_caches()  # the workers fork with cold caches
        start = time.perf_counter()
        with XformWorkerPool(recipe.tokenizer_vocab, n_seq, xform_kwargs=xform_kwargs,
                             n_workers=workers, seed=0) as pool:
            it = pool.map(copies())
            first = next(it)
            first_s = time.perf_counter() - start
            out = [first, *it]
            total_s = time.perf_counter() - start
            peak, read_ahead = pool.peak_in_flight, pool.read_ahead
        check(len(out) == len(raws) and all(
            b["tokens"].shape[0] == r["tokens"].shape[0] for b, r in zip(out, serial)),
            f"dataset_pool: {workers} workers gave {len(out)} batches")
        check(peak == min(len(raws), read_ahead + workers),
              f"dataset_pool: {peak} batches in flight, read_ahead {read_ahead}, "
              f"{workers} workers")
        steady = sum(b["tokens"].shape[0] for b in out[1:]) / (total_s - first_s)
        pools.append({"workers": workers, "read_ahead": read_ahead, "peak_in_flight": peak,
                      "first_batch_s": first_s, "seconds": total_s,
                      "samples_per_s": samples / total_s,
                      "samples_per_s_after_first": steady,
                      "over_serial": samples / total_s / (samples / serial_s)})
    train_rate = MEASURED.get("train_mol_per_s")
    emit({"phase": "dataset_pool", "rows_per_partition": per_partition,
          "shards": len(ds.shard_paths()), "write_shards_s": write_s,
          "read_raw_batches_s": read_s, "batch": batch, "n_seq": n_seq,
          "distinct_batches": len(distinct), "batches": len(raws), "samples": samples,
          "distinct_smiles_strings": len(set(writings)), "rows": len(writings),
          "xform": xform_kwargs, "cores": cores, "serial_s": serial_s,
          "serial_samples_per_s": samples / serial_s, "pools": pools,
          "trainer_mol_per_s": train_rate,
          "trainers_fed_at_most_workers": (max(p["samples_per_s_after_first"] for p in pools)
                                           / train_rate if train_rate else None)})


def phase_train_restart(data_root: Path, ckpt: Path):
    """Restart checkpoints on the training path: train_autoencoder with the
    grande recipe in bf16 on COATI_dataset over the fixture's shards, with
    orbax_dir, three times over one directory: (1) one epoch, writing a
    checkpoint mid-epoch (ngrad_to_save 480) and at its end; (2) the same
    config again, which takes no step and must return run 1's parameters,
    its end-of-run checkpoint holding run 1's parameters and optimizer state
    bit for bit; (3) n_epochs 2, which resumes at epoch 1 with global_step
    carried on. K5f and K5b are then held against their plain versions at
    every width the runs' batches took. Returns the launch counts of runs 1
    and 3."""
    from coati_tpu_torch.data.dataset import COATI_dataset
    from coati_tpu_torch.training import checkpoints, train
    from coati_tpu_torch.training.config import grande_config

    timings = {"save_s": [], "write_s": [], "restore_s": []}

    class TimedManager(checkpoints.CheckpointManager):
        def save(self, *a, **kw):
            start = time.perf_counter()
            super().save(*a, **kw)
            timings["save_s"].append(time.perf_counter() - start)

        def _write(self, *a, **kw):
            start = time.perf_counter()
            super()._write(*a, **kw)
            timings["write_s"].append(time.perf_counter() - start)

        def restore_latest(self, *a, **kw):
            start = time.perf_counter()
            out = super().restore_latest(*a, **kw)
            torch.cuda.synchronize()
            timings["restore_s"].append(time.perf_counter() - start)
            return out

    def run(n_epochs):
        config = grande_config(dtype="bfloat16", n_epochs=n_epochs, orbax_dir=str(ckpt),
                               ngrad_to_save=480)
        random.seed(0)  # permute_smiles draws from the global random module
        start = time.perf_counter()
        model, results = train.train_autoencoder(config, COATI_dataset(str(data_root)), seed=0)
        torch.cuda.synchronize()
        return config, model, results, time.perf_counter() - start

    def load(step):
        return torch.load(ckpt / f"{step}.pt", map_location="cpu", weights_only=True)

    saved_manager = train.CheckpointManager
    train.CheckpointManager = TimedManager
    try:
        with record_shapes() as (shapes, _):
            _zero_counts()  # the path starts here
            config, first, r1, s1 = run(1)
            counts = _counts()
            steps1 = sorted(int(p.stem) for p in ckpt.glob("*.pt"))
            _, second, r2, s2 = run(1)
            steps2 = sorted(int(p.stem) for p in ckpt.glob("*.pt"))
            n1 = len(r1["history"])
            # run 1's end-of-run checkpoint and run 2's, before run 3's saves
            # retire them
            ends = ([load(n1)["state"], load(n1 + 1)["state"]]
                    if steps2[-2:] == [n1, n1 + 1] else None)
            ckpt_bytes = (ckpt / f"{n1}.pt").stat().st_size if ends else None
            before = _counts()
            config3, third, r3, s3 = run(2)
            counts = {k: counts[k] + _counts()[k] - before[k] for k in counts}  # and ends here
    finally:
        train.CheckpointManager = saved_manager

    check(n1 >= 4 and len(steps1) == 2 and steps1[-1] == n1,
          f"train_restart: run 1 took {n1} steps and wrote steps {steps1}")
    check(r2["history"] == [], f"train_restart: run 2 took {len(r2['history'])} steps")
    same_params = all(torch.equal(a, b) for a, b in zip(first.state_dict().values(),
                                                         second.state_dict().values()))
    check(same_params, "train_restart: run 2 does not return run 1's parameters")
    check(steps2 == steps1 + [n1 + 1] and ends is not None,
          f"train_restart: run 2 wrote steps {steps2}")
    a, b = ends
    same = (all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
            and a["opt_state"]["param_groups"] == b["opt_state"]["param_groups"]
            and a["opt_state"]["state"].keys() == b["opt_state"]["state"].keys()
            and all(torch.equal(x, b["opt_state"]["state"][i][k])
                    for i, s in a["opt_state"]["state"].items() for k, x in s.items())
            and torch.equal(a["counters"], b["counters"]))
    check(same, "train_restart: run 2's checkpoint differs from run 1's")
    losses3 = np.array([h[3:] for h in r3["history"]], np.float64)
    epochs3 = {h[1] for h in r3["history"]}
    final = load(max(int(p.stem) for p in ckpt.glob("*.pt")))["state"]["counters"].tolist()
    check(epochs3 == {1} and len(losses3) == n1 and bool(np.isfinite(losses3).all()),
          f"train_restart: run 3 epochs {epochs3}, {len(losses3)} steps")
    check(final[2:] == [2, 2 * n1], f"train_restart: run 3 ended with counters {final}")
    check(r3["learning_rates"][0] == train.cosine_lr(config3, 1),
          f"train_restart: run 3 began at lr {r3['learning_rates'][0]}")
    n_x, n_e = config.n_layer_xformer, config.n_layer_e3gnn
    expected = {"packed_causal_attention": 4 * n_x, "packed_causal_attention_backward": 2 * n_x,
                "egnn_messages": n_e, "egnn_messages_backward": n_e,
                "flash_causal_attention": 0, "decode_attention": 0, "decode_attention_quant": 0,
                "top_k": 0}
    per_step = {k: c / (2 * n1) for k, c in counts.items()}
    check(per_step == expected, f"train_restart: launches a step {per_step}")
    # K5f and K5b at the widths the batches took: the AR pass (B 160) and
    # the two views (B 320)
    check({s[0] for s in shapes} == {"packed_causal_attention",
                                     "packed_causal_attention_backward"},
          f"train_restart: attention shapes {sorted(shapes)}")
    hold_path_shapes("train_restart", shapes)
    emit({"phase": "train_restart", "recipe": "grande", "dtype": config.dtype,
          "batch": config.batch_size, "ngrad_to_save": config.ngrad_to_save,
          "steps_run1_run2_run3": [n1, 0, len(losses3)],
          "seconds_run1_run2_run3": [s1, s2, s3], "steps_written": steps2,
          "checkpoint_bytes": ckpt_bytes,
          "save_s": timings["save_s"], "write_s": timings["write_s"],
          "restore_s": timings["restore_s"], "run2_equal_bit_for_bit": True,
          "run3_first_lr": r3["learning_rates"][0], "run3_counters": final,
          "ar_loss_run1_first_last": [r1["history"][0][4], r1["history"][-1][4]],
          "ar_loss_run3_first_last": [losses3[0, 1], losses3[-1, 1]],
          "launches": counts})
    return counts


def phase_lora(work: Path):
    """LoRA fine-tuning of the trained document at full width: rank-8
    adapters, 20 AR steps of batch 64 in bf16 over bench.py's SMILES and the
    first corpus SMILES padded to n_seq (the AR loss of a fixed batch must
    fall, the base must not move); then the merged model written as a
    document and reloaded, whose encodings must equal the merged model's.
    Returns the launch counts of the path. After it, one float32 step
    through the kernels against the same step through the plain versions."""
    import copy

    from coati_tpu_torch.models.api import COATI
    from coati_tpu_torch.models.coati import ar_loss_fn
    from coati_tpu_torch.models.io import (
        load_e3gnn_smiles_clip_e2e,
        load_model_doc,
        model_to_state,
        serialize_model,
    )
    from coati_tpu_torch.models.transformer import forward_logits
    from coati_tpu_torch.training import finetune

    model, tok = load_e3gnn_smiles_clip_e2e(str(DOC))
    base = model.params.xformer
    cfg = model.config.xformer_config.replace(dtype="bfloat16")
    corpus = gzip.open(CORPUS, "rt").read().split()
    texts = BENCH_SMILES + corpus[: 1024 - len(BENCH_SMILES)]
    rows = np.asarray([tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=True) for s in texts],
                      np.int64)
    y_next = np.zeros_like(rows)
    y_next[:, :-1] = rows[:, 1:]
    y_next[y_next == tok.pad_token] = -1
    fixed = (torch.as_tensor(rows[:64], device=model.device),
             torch.as_tensor(y_next[:64], device=model.device))
    frozen = {k: v.clone() for k, v in base.state_dict().items()}

    def fixed_loss(lora):
        with torch.no_grad():
            return float(ar_loss_fn(forward_logits(finetune.merge_lora(base, lora), cfg,
                                                   fixed[0]), fixed[1]))

    lora = finetune.init_lora(torch.Generator(device=model.device).manual_seed(0), base, rank=8)
    optimizer = torch.optim.Adam(lora.parameters(), lr=5e-4)
    step = finetune.make_lora_ar_step(base, cfg, optimizer)
    rng = np.random.default_rng(0)
    before = fixed_loss(lora)
    _zero_counts()  # the path starts here
    losses, step_s = [], []
    for _ in range(20):
        idx = rng.integers(0, len(rows), size=64)
        torch.cuda.synchronize()
        start = time.perf_counter()
        losses.append(float(step(lora, rows[idx], y_next[idx])))  # waits for the step
        step_s.append(time.perf_counter() - start)
    train_counts = _counts()
    after = fixed_loss(lora)
    unchanged = all(torch.equal(v, frozen[k]) for k, v in base.state_dict().items())
    merged = finetune.merged_model(model.params, lora)
    src = load_model_doc(str(DOC))
    path = work / "lora_merged.pkl"
    path.write_bytes(serialize_model(
        train_args=dict(src["train_args"], lora_rank=8, lora_alpha=16.0),
        dataset_summary={"finetune_corpus_size": len(rows)},
        model_state=model_to_state(merged), model_kwargs=dict(src["model_kwargs"])))
    loaded, ltok = load_e3gnn_smiles_clip_e2e(str(path))
    enc = rows[:64]
    h_loaded = loaded.encode_tokens(enc, ltok)
    h_merged = COATI(merged, loaded.config).encode_tokens(enc, tok)
    counts = _counts()  # and ends here
    reload_diff = float((h_loaded - h_merged).abs().max())
    check(bool(np.isfinite(losses).all()), "lora: a loss is not finite")
    check(after < before and np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"lora: the fixed batch's AR loss went {before} -> {after}, steps {losses}")
    check(unchanged, "lora: a base weight moved")
    check(torch.equal(h_loaded, h_merged),
          f"lora: the reloaded document encodes {reload_diff} away from the merged model")
    n_layer = cfg.n_layer
    check(train_counts["flash_causal_attention"] == 20 * n_layer
          and train_counts["packed_causal_attention"] == 0,
          f"lora: launches of the 20 steps {train_counts}")
    hold_path_shapes("lora", [("flash_causal_attention", 64, tok.n_seq, cfg.n_head,
                               cfg.head_dim, "bfloat16")])
    emit({"phase": "lora", "doc": DOC.name, "rank": 8, "alpha": 16.0, "lr": 5e-4,
          "dtype": "bfloat16", "batch": 64, "T": tok.n_seq, "steps": 20,
          "adapter_parameters": sum(p.numel() for p in lora.parameters()),
          "trunk_parameters": sum(p.numel() for p in base.parameters()),
          "step_seconds": float(np.median(step_s[3:])), "step_seconds_all": step_s,
          "loss_all": losses, "fixed_batch_loss_before_after": [before, after],
          "base_unchanged": True, "reload_rows": len(enc), "reload_bit_equal": True,
          "document_bytes": path.stat().st_size, "launches": counts,
          "launches_20_steps": train_counts})

    # one float32 step through the kernels and through the plain versions,
    # from the trained adapters and the same batch, outside the window
    f32 = model.config.xformer_config.replace(dtype="float32")
    idx = np.arange(32)

    def fp32_step(plain):
        adapters = copy.deepcopy(lora)
        opt = torch.optim.Adam(adapters.parameters(), lr=5e-4)
        one = finetune.make_lora_ar_step(base, f32, opt)
        _zero_counts()
        with plain_versions() if plain else contextlib.nullcontext():
            loss = float(one(adapters, rows[idx], y_next[idx]))
        torch.cuda.synchronize()
        return loss, {n: p.grad.clone() for n, p in adapters.named_parameters()}, _counts()

    plain_loss, plain_grads, plain_counts = fp32_step(True)
    check(sum(plain_counts.values()) == 0, "lora_fp32_vs_plain: the plain step launched")
    loss, grads, fp32_counts = fp32_step(False)
    check(fp32_counts["flash_causal_attention"] == n_layer,
          f"lora_fp32_vs_plain: launches {fp32_counts}")
    worst, worst_name = 0.0, ""
    for name, g in grads.items():
        ref = plain_grads[name]
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        err = float((g - ref).abs().max())
        check(err <= tol, f"lora_fp32_vs_plain: gradient of {name} differs by {err} (tol {tol})")
        if err / tol > worst:
            worst, worst_name = err / tol, name
    rel = abs(loss - plain_loss) / abs(plain_loss)
    emit({"phase": "lora_fp32_vs_plain", "batch": len(idx), "T": tok.n_seq, "loss": loss,
          "plain_loss": plain_loss, "loss_rel_diff": rel, "adapters_compared": len(grads),
          "worst_gradient_err_over_tol": worst, "worst_adapter": worst_name,
          "launches": fp32_counts})
    check(rel <= 1e-5, f"lora_fp32_vs_plain: loss {loss} against {plain_loss}")
    return counts


def phase_generative(model, tok):
    """The generative helpers on the trained document in the production
    setting (bf16, int8 KV cache): embed bench.py's 16 SMILES and
    force-decode each (how many come back as their input's canonical
    SMILES); purify 4 of them (n_rep 128); fit a density in closed form to
    the embeddings of the fixture's 1,024 SMILES and force-decode 64 draws
    (the valid share); one epoch of estimate_density_batchwise at batch
    1024. K2 is then held against its plain version at every shape the path
    ran it, and K1 at every batch and position the path decoded at. Returns
    the launch counts of the path."""
    from coati_tpu_torch.chem.rdkit_support import canonicalize_or_self, is_valid_smiles
    from coati_tpu_torch.data import load_points_fixture
    from coati_tpu_torch.generative import density, purifications

    fixture, _, _ = load_points_fixture()
    seconds = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - start
        return out

    with record_shapes() as (full, decode):
        _zero_counts()  # the path starts here
        h = timed("embed_smiles_batch_16", lambda: purifications.embed_smiles_batch(
            BENCH_SMILES, model, tok))
        decoded = timed("force_decode_valid_batch_16", lambda: [
            purifications.force_decode_valid_batch(v, model, tok) for v in h])
        purified = timed("purify_vector_4", lambda: [
            purifications.purify_vector(v, model, tok, n_rep=128) for v in h[:4]])
        embeds = timed("embed_fixture_1024", lambda: model.encode_tokens(
            _tokens(tok, fixture, tok.n_seq), tok))
        fit = timed("fit_density_closed_form", lambda: density.fit_density_closed_form(embeds))
        draws = fit.sample(torch.Generator(device=model.device).manual_seed(0), (64,))
        sampled = timed("force_decode_64_draws", lambda: [
            purifications.force_decode_valid_batch(v, model, tok)
            for v in draws.cpu().numpy()])
        estimated = timed("estimate_density_batchwise_1024",
                          lambda: density.estimate_density_batchwise(
                              fixture, model, tok, batch_size=1024, epochs=1, verbose=False))
        counts = _counts()  # and ends here

    canonical = [canonicalize_or_self(s) for s in BENCH_SMILES]
    back = sum(d == c for d, c in zip(decoded, canonical))
    valid = sum(s != "C" and is_valid_smiles(s) for s in sampled)
    moved = [float(np.linalg.norm(p - v)) for p, v in zip(purified, h[:4])]
    check(h.shape == (16, model.embed_dim) and np.isfinite(h).all(), "generative: embeddings")
    check(all(is_valid_smiles(s) for s in decoded), "generative: a force-decode is not valid")
    check(all(p.shape == (model.embed_dim,) and np.isfinite(p).all() for p in purified),
          "generative: a purified vector")
    check(bool(torch.isfinite(fit.scale_tril).all()) and bool(torch.isfinite(draws).all()),
          "generative: the closed-form density")
    check(counts["flash_causal_attention"] > 0 and counts["decode_attention_quant"] > 0,
          f"generative: launches {counts}")
    hold_path_shapes("generative", full)
    hold_decode_positions("generative", decode)
    emit({"phase": "generative", "doc": DOC.name, "dtype": "bfloat16", "kv": "int8/float32",
          "force_decoded": len(decoded), "back_to_input_canonical": back,
          "decoded": decoded, "purified": len(purified),
          "purify_moved_norm": moved, "density_rows": int(embeds.shape[0]),
          "density_draws": len(sampled), "draws_valid": valid, "draws_valid_share": valid / 64,
          "distinct_valid_draws": len({s for s in sampled if s != "C"}),
          "estimate_density_stopped": estimated is not None, "seconds": seconds,
          "launches": counts})
    return counts


# ----------------------------------------------------------- serving

# the serving phase's corpus rows (/embed, /generate), its requests at t = 0
# to the continuous server, and the metadynamics phase's rows and DUE steps
SERVING_ROWS = 1024
CONTINUOUS_REQUESTS = 256
TRACED_TICKS = 2  # engine ticks in the traced window of the continuous run
DUE_ROWS = 4096
DUE_STEPS = 2000


def _post(port, path, body, timeout=600.0):
    """POSTs `body` as JSON to the server on 127.0.0.1:port -> (the reply,
    seconds). A reply other than 200 raises (urllib's HTTPError)."""
    import urllib.request

    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    start = time.perf_counter()
    with urllib.request.urlopen(request, timeout=timeout) as resp:
        check(resp.status == 200, f"{path}: status {resp.status}")
        reply = json.loads(resp.read())
    return reply, time.perf_counter() - start


def _load(port, path, bodies, clients):
    """Every body POSTed to `path` by `clients` threads at once -> (the
    replies in order, each request's seconds, the load's wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    start = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        out = list(pool.map(lambda body: _post(port, path, body), bodies))
    return [r for r, _ in out], [s for _, s in out], time.perf_counter() - start


def _rates(endpoint, n_rows, latencies, wall):
    return {"endpoint": endpoint, "requests": len(latencies), "rows": n_rows, "wall_s": wall,
            "requests_per_s": len(latencies) / wall, "mol_per_s": n_rows / wall,
            "p50_s": float(np.percentile(latencies, 50)),
            "p99_s": float(np.percentile(latencies, 99))}


@contextlib.contextmanager
def _server(model, tok, gen_params, max_bucket=256, **kw):
    """A CoatiInferenceServer on 127.0.0.1, a free port, warmed up at
    `max_bucket` rows; stopped on the way out."""
    from coati_tpu_torch.serving import CoatiInferenceServer

    server = CoatiInferenceServer(model, tok, host="127.0.0.1", port=0, **kw)
    try:
        server.warmup(max_bucket=max_bucket, gen_params=gen_params, verbose=False)
        server.start()
        yield server
    finally:
        server.stop()


def _in_16s(rows):
    return [rows[i : i + 16] for i in range(0, len(rows), 16)]


def _serving_fidelity(model, tok, smiles, family):
    """fp32: /embed of 64 SMILES in requests of 16 against in-process
    encode_tokens (within 1e-5), and greedy (k 1) /generate of those
    embeddings through the micro-batched and the continuous server, which
    must agree on at least 63 rows. Returns the embeddings."""
    ref = model.encode_tokens(_tokens(tok, smiles, tok.n_seq), tok).float().cpu().numpy()
    bodies = [{"smiles": s} for s in _in_16s(smiles)]
    with _server(model, tok, ((1, 1.0),), max_bucket=64, max_batch=64) as server:
        replies, _, _ = _load(server.port, "/embed", bodies, 4)
        emb = np.asarray([e for r in replies for e in r["embeddings"]], np.float32)
        gen = [{"embeddings": h.tolist(), "k": 1, "inv_temp": 1.0} for h in _in_16s(emb)]
        micro = [s for r in _load(server.port, "/generate", gen, 4)[0] for s in r["smiles"]]
    with _server(model, tok, ((1, 1.0),), max_bucket=64, continuous=True, n_slots=64) as server:
        cont = [s for r in _load(server.port, "/generate", gen, 4)[0] for s in r["smiles"]]
    diff = float(np.abs(emb - ref).max())
    agree = sum(a == b for a, b in zip(micro, cont))
    emit({"phase": "serving_fp32", "model": family, "rows": len(smiles),
          "embed_max_abs_diff": diff, "greedy_continuous_agree_with_micro_batched": agree,
          "differing": [[a, b] for a, b in zip(micro, cont) if a != b]})
    check(emb.shape == ref.shape and diff <= 1e-5,
          f"serving {family}: /embed differs from encode_tokens by {diff}")
    check(len(micro) == len(cont) == len(smiles)
          and all(isinstance(s, str) for s in micro + cont),
          f"serving {family}: a /generate row is not a string")
    check(agree >= len(smiles) - 1,
          f"serving {family}: greedy continuous agrees with micro-batched on {agree} rows")
    return emb


@contextlib.contextmanager
def _annotated(module, name, label):
    """Wraps module.name in a torch.profiler range called `label`."""
    fn = getattr(module, name)

    def call(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _engine_run(engine, h, max_steps=20_000):
    """h's rows submitted to the engine at once and stepped to the end, in
    this thread, as scripts/bench_continuous.py drives it -> (each row's
    seconds to its harvest, each row's generated tokens, wall seconds)."""
    rids = [engine.submit(row) for row in h]
    done, lengths = {}, {}
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(max_steps):
        if len(done) == len(rids):
            break
        engine.step()
        now = time.perf_counter() - start
        for rid, row in engine.pop_results().items():
            done[rid] = now
            lengths[rid] = len(row) - len(engine.prefix)
    check(len(done) == len(rids), f"continuous engine: {len(done)} of {len(rids)} rows ended")
    return ([done[r] for r in rids], [lengths[r] for r in rids],
            time.perf_counter() - start)


def _drain_run(prod, tok, h, cohort=64):
    """h's rows in drain-the-batch cohorts of `cohort` through the sampler
    (what the micro-batcher calls) -> (each row's seconds to its cohort's
    end, each row's generated tokens, wall seconds)."""
    latencies, lengths = [], []
    p = len(tok.tokenize_text("[CLIP][UNK][SMILES]", pad=False))
    torch.cuda.synchronize()
    start = time.perf_counter()
    for i in range(0, len(h), cohort):
        _, rows = prod.hclip_to_2d_batch(h[i : i + cohort], tok, k=100, inv_temp=2.0,
                                         keep_special=True, return_tokens=True)
        now = time.perf_counter() - start
        latencies += [now] * len(rows)
        lengths += [(r.index(tok.stop_token) + 1 if tok.stop_token in r else len(r)) - p
                    for r in rows]
    return latencies, lengths, time.perf_counter() - start


def _engine_window(engine, h, trace=None):
    """h's rows submitted to the engine at once; one tick untimed, then
    TRACED_TICKS ticks timed (inside `trace(fn)` when given), all 64 slots
    busy while the queue lasts; then the rest drained, untimed -> (the
    window's wall seconds or what `trace` returns, its decode steps, its
    segments)."""
    for row in h:
        engine.submit(row)
    engine.step()

    def window():
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(TRACED_TICKS):
            engine.step()
        torch.cuda.synchronize()
        return time.perf_counter() - start

    steps0, segments0 = engine.decode_steps, engine.segments
    out = window() if trace is None else trace(window)
    steps, segments = engine.decode_steps - steps0, engine.segments - segments0
    engine.run_until_done()
    check(engine.n_active == 0 and len(engine.pop_results()) == len(h),
          f"continuous engine: {engine.n_active} rows left after the window")
    return out, steps, segments


def _continuous_vs_drain(prod, tok, emb, family, n_requests):
    """`n_requests` rows of `emb`, picked by default_rng(0) as
    scripts/bench_continuous.py picks them, sent at t = 0 as single-row
    /generate requests to the production server in continuous mode (64
    slots); then the same rows in this thread through that server's engine
    and in drain-the-batch cohorts of 64, twice each, alternating; and a
    window of TRACED_TICKS engine ticks under that load timed, then traced
    (idle share and ring attention share are ratios over the window)."""
    from coati_tpu_torch.models import transformer

    pick = np.random.default_rng(0).integers(0, len(emb), size=n_requests)
    h = emb[pick]
    bodies = [{"embeddings": [row.tolist()], "k": 100, "inv_temp": 2.0} for row in h]
    with _server(prod, tok, ((100, 2.0),), continuous=True, n_slots=64) as server:
        replies, latencies, wall = _load(server.port, "/generate", bodies, n_requests)
        service = server._gen_batchers[(100, 2.0, None)]
    rows = [s for r in replies for s in r["smiles"]]
    check(len(rows) == n_requests and all(isinstance(s, str) for s in rows),
          f"serving {family}: a continuous /generate row is not a string")
    engine = service.engine  # its stepping thread ended with the server
    http = _rates("/generate continuous", n_requests, latencies, wall)
    runs = {"drain": [], "continuous": []}
    for _ in range(2):
        for mode in runs:
            lat, lengths, wall = (_drain_run(prod, tok, h) if mode == "drain"
                                  else _engine_run(engine, h))
            runs[mode].append({**_rates(mode, n_requests, lat, wall),
                               "gen_len_mean": float(np.mean(lengths)),
                               "gen_len_p99": float(np.percentile(lengths, 99)),
                               "gen_len_max": int(max(lengths))})
    window_s, _, _ = _engine_window(engine, h)
    label = f"{family}_continuous_{n_requests}_{TRACED_TICKS}_ticks"
    with _annotated(transformer, "decode_attention_quant_ring", "ring_attention"):
        traced, steps, segments = _engine_window(engine, h, trace=lambda window: _profile(
            window, label, window_s, annotations=("ring_attention",)))
    ring_s = traced["annotations"]["ring_attention"] / 1e3
    check(steps > 0 and ring_s > 0, f"serving {family}: the traced window ran {steps} decode "
          f"steps and {ring_s} s of ring attention")
    result = {"phase": "serving_continuous", "model": family, "requests": n_requests,
              "slots": 64, "http": http, "in_process": runs,
              "traced_ticks": TRACED_TICKS, "window_s": window_s,
              "decode_steps_traced_window": steps, "segments_traced_window": segments,
              "idle_share": traced["idle_share"], "device_busy_s": traced["device_busy_s"],
              "ring_attention_device_s": ring_s,
              "ring_attention_share": ring_s / traced["device_busy_s"]}
    emit(result)
    return result


def phase_serving(model, prod, tok):
    """The HTTP server over the trained document, the continuous engine
    against drain-the-batch cohorts, and COATI2 in continuous mode; K2 and
    K1 then held at the shapes and positions the phase ran them. Returns the
    launch counts of the path."""
    from coati_tpu_torch.models.coati2 import COATI2
    from coati_tpu_torch.models.io import load_coati2

    smiles = _coati2_corpus(tok, SERVING_ROWS)
    check(len(smiles) == SERVING_ROWS, f"serving: {len(smiles)} corpus SMILES fit n_seq")
    seconds, mark = {}, [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        seconds[label] = now - mark[0]
        mark[0] = now

    with record_shapes() as (full, decode):
        _zero_counts()  # the path starts here
        _serving_fidelity(model, tok, smiles[:64], "coati")
        lap("coati_fp32")

        # the production setting behind the micro-batcher, 8 clients
        loads = []
        with _server(prod, tok, ((100, 2.0),)) as server:
            replies, lat, wall = _load(server.port, "/embed",
                                       [{"smiles": s} for s in _in_16s(smiles)], 8)
            emb = np.asarray([e for r in replies for e in r["embeddings"]], np.float32)
            loads.append(_rates("/embed", len(smiles), lat, wall))
            replies, lat, wall = _load(server.port, "/generate", [
                {"embeddings": h.tolist(), "k": 100, "inv_temp": 2.0} for h in _in_16s(emb)], 8)
            generated = [s for r in replies for s in r["smiles"]]
            loads.append(_rates("/generate", len(generated), lat, wall))
            replies, lat, wall = _load(server.port, "/analogs", [
                {"smiles": [s], "noise_scale": 0.3, "n_analogs": 4} for s in BENCH_SMILES], 8)
            analogs = [a for r in replies for group in r["analogs"] for a in group]
            loads.append(_rates("/analogs", len(analogs), lat, wall))
        check(emb.shape == (SERVING_ROWS, prod.embed_dim) and np.isfinite(emb).all(),
              "serving: /embed rows")
        check(len(generated) == SERVING_ROWS and all(isinstance(s, str) for s in generated),
              "serving: a /generate row is not a string")
        check(len(analogs) == 64 and all(isinstance(s, str) for s in analogs),
              "serving: an /analogs row is not a string")
        emit({"phase": "serving_micro_batched", "model": "coati", "dtype": "bfloat16",
              "kv": "int8/float32", "clients": 8, "rows_per_request": 16, "loads": loads,
              "generated_sample": generated[:8], "analogs_sample": analogs[:8]})
        lap("coati_micro_batched")
        _continuous_vs_drain(prod, tok, emb, "coati", CONTINUOUS_REQUESTS)
        lap("coati_continuous_vs_drain")

        # COATI2 grande, seeded fresh weights (phase coati2's document)
        m2, tok2 = load_coati2(str(COATI2_DOC))
        smiles2 = _coati2_corpus(tok2, 64)
        emb2 = _serving_fidelity(m2, tok2, smiles2, "coati2")
        lap("coati2_fp32")
        prod2 = COATI2(m2.params, m2.config.replace(dtype="bfloat16"), seed=0)
        with _server(prod2, tok2, ((100, 2.0),), continuous=True, n_slots=64) as server:
            replies, lat, wall = _load(server.port, "/generate", [
                {"embeddings": [h.tolist()], "k": 100, "inv_temp": 2.0} for h in emb2], 64)
        rows2 = [s for r in replies for s in r["smiles"]]
        check(len(rows2) == 64 and all(isinstance(s, str) for s in rows2),
              "serving coati2: a continuous /generate row is not a string")
        emit({"phase": "serving_coati2_continuous", "dtype": "bfloat16", "kv": "int8/float32",
              "slots": 64, **_rates("/generate continuous", 64, lat, wall)})
        counts = _counts()  # and ends here
        lap("coati2_continuous")
    check(counts["flash_causal_attention"] > 0 and counts["decode_attention_quant"] > 0
          and counts["decode_attention"] > 0, f"serving: launches {counts}")
    hold_path_shapes("serving", full)
    hold_decode_positions("serving", decode)
    lap("held_shapes")
    emit({"phase": "serving", "launches": counts, "seconds": seconds})
    return counts


# ------------------------------------------------------ metadynamics


def phase_metadynamics(prod, tok):
    """DUE regression of the port's Crippen logP on 4,096 corpus embeddings
    of the trained document (published widths, 2,000 steps of batch 512),
    the pure embedding-space walk without and with hills (the checks of
    scripts/eval_metadynamics.py), and run_metadynamics from a corpus
    molecule in the production setting. Returns the launch counts."""
    import multiprocessing

    from coati_tpu_torch.chem.crippen import mol_logp
    from coati_tpu_torch.generative.metadynamics import (
        MetadynamicsConfig,
        due_objective,
        run_metadynamics,
        walk_embedding_space,
    )
    from coati_tpu_torch.regression.due import DueConfig, train_due

    smiles = _coati2_corpus(tok, DUE_ROWS)
    check(len(smiles) == DUE_ROWS, f"metadynamics: {len(smiles)} corpus SMILES fit n_seq")
    start = time.perf_counter()
    with multiprocessing.get_context("fork").Pool(max(1, min(8, os.cpu_count() - 1))) as pool:
        y = np.asarray(pool.map(mol_logp, smiles, chunksize=64), np.float32)
    logp_s = time.perf_counter() - start
    seconds = {"crippen_logp_host": logp_s}

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return out

    with record_shapes() as (full, decode):
        _zero_counts()  # the path starts here
        x = timed("embed", lambda: np.concatenate([
            prod.encode_tokens(_tokens(tok, smiles[i : i + 1024], tok.n_seq), tok)
            .float().cpu().numpy() for i in range(0, DUE_ROWS, 1024)]))
        order = np.random.default_rng(0).permutation(DUE_ROWS)
        train, test = order[: DUE_ROWS * 7 // 8], order[DUE_ROWS * 7 // 8 :]
        config = DueConfig(input_dim=x.shape[1])
        due = timed("due_fit", lambda: train_due(x[train], y[train], config=config,
                                                 steps=DUE_STEPS, batch_size=512, seed=0,
                                                 verbose=False, device=prod.device))
        due = due.remove_spectral_norm()
        mean, std = due.predict(x[test])
        noise = float(due.params.gp.log_noise.detach().exp())
        z = (y[test] - mean) / np.sqrt(std**2 + noise)
        rmse = float(np.sqrt(np.mean((mean - y[test]) ** 2)))

        objective = due_objective(due)
        v0 = x[test[0]]
        base = dict(steps=120, step_size=0.02, noise_scale=0.0, seed=0)
        pos_un, obj_un = timed("walk_unbiased_120", lambda: walk_embedding_space(
            objective, v0, MetadynamicsConfig(**base, hill_height=0.0), device=prod.device))
        pos_bi, obj_bi = timed("walk_biased_120", lambda: walk_embedding_space(
            objective, v0, MetadynamicsConfig(**base, hill_height=0.5, hill_width=1.0),
            device=prod.device))
        found = timed("run_metadynamics_20", lambda: run_metadynamics(
            prod, tok, objective, v0,
            MetadynamicsConfig(steps=20, decode_batch=32, k=100, inv_temp=2.0, seed=0)))
        counts = _counts()  # and ends here

    disp_un = np.linalg.norm(np.diff(pos_un, axis=0), axis=1)
    disp_bi = np.linalg.norm(np.diff(pos_bi, axis=0), axis=1)
    monotone = bool(np.all(np.diff(obj_un) >= -1e-5))
    improved = bool(obj_un[-1] > obj_un[0] + 1e-4)
    emit({"phase": "metadynamics", "doc": DOC.name, "dtype": "bfloat16", "kv": "int8/float32",
          "due": {"rows_train": len(train), "rows_test": len(test), "steps": DUE_STEPS,
                  "batch": 512, "features": config.features, "depth": config.depth,
                  "n_inducing": config.n_inducing, "coeff": config.coeff,
                  "target": "Crippen logP (coati_tpu_torch/chem/crippen.py)",
                  "target_std_test": float(y[test].std()), "rmse_test": rmse,
                  "coverage_95": float(np.mean(np.abs(z) <= 1.96)), "z_std": float(z.std()),
                  "noise_var": noise},
          "walk": {"steps": 120, "step_size": 0.02, "start": "held-out corpus molecule",
                   "ascent_start": float(obj_un[0]), "ascent_final": float(obj_un[-1]),
                   "ascent_monotone": monotone, "ascent_improved": improved,
                   "mean_disp_unbiased": float(disp_un.mean()),
                   "mean_disp_biased": float(disp_bi.mean()),
                   "tail_disp_unbiased": float(disp_un[-60:].mean()),
                   "tail_disp_biased": float(disp_bi[-60:].mean()),
                   "biased_final_objective": float(obj_bi[-1])},
          "run": {"steps": 20, "decode_batch": 32, "molecules_found": len(found.smiles),
                  "best_smiles": found.best_smiles, "best_score": float(found.best_score),
                  "start_smiles": smiles[test[0]], "start_logp": float(y[test[0]]),
                  "n_valid_per_step": [h["n_valid"] for h in found.history]},
          "seconds": seconds, "launches": counts})
    check(np.isfinite(x).all() and np.isfinite(mean).all() and np.isfinite(std).all(),
          "metadynamics: embeddings or DUE predictions not finite")
    check(rmse < float(y[test].std()), f"metadynamics: DUE held-out RMSE {rmse} is not below "
          f"the targets' spread {float(y[test].std())}")
    check(monotone and improved, "metadynamics: the unbiased ascent decreased or did not improve")
    check(disp_bi.mean() > disp_un.mean(), "metadynamics: hills do not displace the samples")
    check(len(found.smiles) > 0 and np.isfinite(found.best_score),
          "metadynamics: run_metadynamics found no molecule")
    check(counts["flash_causal_attention"] > 0 and counts["decode_attention_quant"] > 0,
          f"metadynamics: launches {counts}")
    hold_path_shapes("metadynamics", full)
    hold_decode_positions("metadynamics", decode)
    return counts


# ------------------------------------------------------------- examples

QUALITY_RECORD = ROOT / "docs" / "eval_generation_quality.json"
# the generation-quality protocol of scripts/eval_generation_quality.py
QUALITY = dict(rt_sample=2048, batches=10, batch_size=1024, k=10_000, inv_temp=1.75)
# |port - record| allowed: about 3 binomial standard deviations at 2,048
# round trips and 10,240 draws
QUALITY_BANDS = {"greedy_roundtrip_train": 0.04, "greedy_roundtrip_holdout": 0.04,
                 "fraction_valid": 0.03, "fraction_unique": 0.03}
EXAMPLE_DUE_ROWS = 1024


def _example_inputs(prod, tok, work: Path) -> dict:
    """What the examples read, made before the path starts: a COATI2
    grande document of seeded fresh weights (the coati2_12_12 tokenizer,
    so that the [PROPS] branch runs), a DUE model of Crippen logP over the
    trained document's embeddings of corpus SMILES, and the fixture as
    COATI_dataset shards."""
    import multiprocessing

    from coati_tpu_torch.chem.crippen import mol_logp
    from coati_tpu_torch.models.io import model_to_state, serialize_model
    from coati_tpu_torch.regression.due import DueConfig, train_due
    from coati_tpu_torch.training.train_coati2 import Coati2TrainConfig, fresh_model

    c2tok = _coati2_tokenizer()
    config = Coati2TrainConfig(**COATI2_GRANDE)
    model = fresh_model(config.model_config(c2tok.n_token), torch.device("cpu"), seed=0)
    coati2_doc = work / "coati2_grande.pkl"
    coati2_doc.write_bytes(serialize_model(
        train_args={"tokenizer_vocab": "coati2_12_12"}, dataset_summary={},
        model_state=model_to_state(model), model_kwargs=config.model_kwargs(c2tok.n_token)))
    del model
    smiles = _coati2_corpus(tok, EXAMPLE_DUE_ROWS)
    with multiprocessing.get_context("spawn").Pool(max(1, min(8, os.cpu_count() - 1))) as pool:
        y = np.asarray(pool.map(mol_logp, smiles, chunksize=64), np.float32)
    x = prod.encode_tokens(_tokens(tok, smiles, tok.n_seq), tok).float().cpu().numpy()
    due = train_due(x, y, config=DueConfig(input_dim=x.shape[1]), steps=500, batch_size=512,
                    seed=0, verbose=False, device=prod.device).remove_spectral_norm()
    due_path = work / "due_logp.pkl"
    due.save(str(due_path))
    write_fixture_shards(work / "data")
    return {"coati2_doc": str(coati2_doc), "due": str(due_path), "data": str(work / "data")}


def _quality_line(quality: dict, setting: dict) -> dict:
    """The protocol's numbers beside the record's, each with its band."""
    record = json.loads(QUALITY_RECORD.read_text())
    bulk, rec_bulk = quality["bulk"], record["bulk"]
    rec_valid = rec_bulk["fraction_valid"] * rec_bulk["n_samples"]
    pairs = {
        "greedy_roundtrip_train": (quality["greedy_roundtrip_train"],
                                   record["greedy_roundtrip_train"]),
        "greedy_roundtrip_holdout": (quality["greedy_roundtrip_holdout"],
                                     record["greedy_roundtrip_holdout"]),
        "fraction_valid": (bulk["fraction_valid"], rec_bulk["fraction_valid"]),
        "fraction_unique": (bulk["fraction_unique"], rec_bulk["fraction_unique"]),
        "fraction_unique_canonical": (bulk["fraction_unique_canonical"],
                                      rec_bulk["n_unique_canonical"] / rec_valid),
        "mean_len": (bulk["mean_len"], rec_bulk["mean_len"]),
    }
    rows = {}
    for key, (port, rec) in pairs.items():
        rows[key] = {"port": port, "record": rec, "diff": port - rec}
        if key in QUALITY_BANDS:
            rows[key]["band"] = QUALITY_BANDS[key]
            rows[key]["ok"] = abs(port - rec) <= QUALITY_BANDS[key]
    return {"phase": "examples", "part": "generation_quality", "doc": DOC.name,
            "record": str(QUALITY_RECORD.relative_to(ROOT)), "corpus": CORPUS.name, **QUALITY,
            "setting": setting, "rt_rows": [quality["rt_rows_train"], quality["rt_rows_holdout"]],
            "n_samples": bulk["n_samples"], "numbers": rows}


def phase_examples(prod, tok):
    """The port's user entry points (coati_tpu_torch/examples/) on the card,
    each through its main at the full width of the model it loads: (a)
    tutorial, chembl_analysis (one batch of 256 draws), generation_examples
    (with the DUE model) and metadynamics_example (10 steps) on the trained
    document; coati2_tutorial on the COATI2 grande document, whose
    conditioned batch mixes prefixes of 5 and 7 tokens; finetune_lora (20
    steps) and its document reloaded; serve --tiny, over the trained
    document and --coati2, each answering two rounds of requests;
    train_grande and train_coati2 --dry_run, then one epoch of 3 steps each
    over the fixture's shards. (b) The generation-quality protocol of
    scripts/eval_generation_quality.py on the trained document in the
    setting its loader gives, through chembl_analysis's functions, beside
    docs/eval_generation_quality.json: round trips of 2,048 train and 2,048
    holdout molecules, 10 x 1,024 draws. Each example's seconds on a line
    of its own; K2 and K1 held at every shape and position the path ran.
    Returns the launch counts of the path."""
    from coati_tpu_torch.examples import (
        chembl_analysis,
        coati2_tutorial,
        finetune_lora,
        generation_examples,
        metadynamics_example,
        serve,
        train_coati2,
        train_grande,
    )
    from coati_tpu_torch.examples import tutorial
    from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

    doc = str(DOC)
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        start = time.perf_counter()
        inputs = _example_inputs(prod, tok, work)
        emit({"phase": "examples", "part": "inputs", "seconds": time.perf_counter() - start})

        def run(name, module, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = module.main(list(args))
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            emit({"phase": "examples", "example": name, "args": list(args),
                  "seconds": seconds[name]})
            return out

        logs = ["--output_dir", str(work / "logs"), "--model_dir", str(work / "models")]
        with record_shapes() as (full, decode):
            _zero_counts()  # the path starts here
            out = {
                "tutorial": run("tutorial", tutorial, "--doc_url", doc),
                "chembl_analysis": run("chembl_analysis", chembl_analysis, "--doc_url", doc,
                                       "--batches", "1", "--batch_size", "256"),
                "coati2_tutorial": run("coati2_tutorial", coati2_tutorial, "--doc_url",
                                       inputs["coati2_doc"]),
                "generation_examples": run("generation_examples", generation_examples,
                                           "--doc_url", doc, "--due_model", inputs["due"]),
                "metadynamics_example": run("metadynamics_example", metadynamics_example,
                                            "--doc_url", doc, "--due_qed", inputs["due"],
                                            "--steps", "10"),
                "finetune_lora": run("finetune_lora", finetune_lora, "--doc_url", doc,
                                     "--steps", "20", "--out", str(work / "lora.pkl")),
                "serve_tiny": run("serve_tiny", serve, "--tiny", "--port", "0", "--requests",
                                  "2"),
                "serve": run("serve", serve, "--doc_url", doc, "--port", "0", "--max_batch",
                             "64", "--requests", "2"),
                "serve_coati2": run("serve_coati2", serve, "--coati2", "--doc_url",
                                    inputs["coati2_doc"], "--port", "0", "--max_batch", "64",
                                    "--requests", "2"),
                "train_grande_dry_run": run("train_grande_dry_run", train_grande, "--dry_run",
                                            *logs),
                "train_grande": run("train_grande", train_grande, "--data_dir", inputs["data"],
                                    "--n_epochs", "1", "--max_steps_per_epoch", "3", *logs),
                "train_coati2_dry_run": run("train_coati2_dry_run", train_coati2, "--dry_run",
                                            *logs),
                "train_coati2": run("train_coati2", train_coati2, "--data_dir", inputs["data"],
                                    "--n_epochs", "1", "--max_steps_per_epoch", "3", *logs),
            }
            tuned, ttok = load_e3gnn_smiles_clip_e2e(str(work / "lora.pkl"))
            tuned_h = tuned.encode_tokens(_tokens(ttok, BENCH_SMILES, ttok.n_seq), ttok)
            del tuned
            # (b) the generation-quality protocol
            t0 = time.perf_counter()
            model, qtok = load_e3gnn_smiles_clip_e2e(doc)  # the loader's setting
            xcfg = model.config.xformer_config
            setting = {"dtype": model.config.dtype,
                       "kv": "int8" if xcfg.kv_quantized else str(xcfg.compute_dtype)[6:]}
            quality = chembl_analysis.generation_quality(model, qtok, str(CORPUS), **QUALITY)
            torch.cuda.synchronize()
            seconds["generation_quality"] = time.perf_counter() - t0
            del model
            counts = _counts()  # and ends here
    MEASURED["generation_quality_fp32"] = quality  # decode_quality's reference
    line = _quality_line(quality, setting)
    line["seconds"] = seconds["generation_quality"]
    emit(line)
    tut, gen, c2 = out["tutorial"], out["generation_examples"], out["coati2_tutorial"]
    emit({"phase": "examples", "part": "results",
          "tutorial": {k: tut[k] for k in ("round_trip_exact", "analogs_valid",
                                           "analogs_unique")},
          "chembl_analysis": {"s2s_nll": out["chembl_analysis"]["s2s_nll"].tolist(),
                              "fraction_valid": out["chembl_analysis"]["fraction_valid"],
                              "fraction_unique": out["chembl_analysis"]["fraction_unique"]},
          "coati2_tutorial": {"noise": c2["noise"], "prefix_lengths": sorted(
              set(c2["prefix_lengths"]))},
          "generation_examples": {"bulk_valid": gen["bulk_valid"],
                                  "bulk_unique": gen["bulk_unique"],
                                  "analogs_valid": gen["analogs_valid"],
                                  "due_mean_top": float(np.max(gen["due_mean"]))},
          "metadynamics_example": {k: out["metadynamics_example"][k] for k in (
              "molecules_found", "best_smiles", "best_score")},
          "finetune_lora": {"losses": out["finetune_lora"]["losses"]},
          "serve": {k: {e: max(v) for e, v in out[k]["seconds"].items()}
                    for k in ("serve_tiny", "serve", "serve_coati2")},
          "train_grande": [h[3:] for h in out["train_grande"]["results"]["history"]],
          "train_coati2": [h[3:] for h in out["train_coati2"]["results"]["history"]],
          "seconds": seconds, "launches": counts})
    check(tut["embeddings"].shape == (6, 256) and np.isfinite(tut["embeddings"]).all(),
          "examples: tutorial's embeddings")
    check(bool(np.isfinite(out["chembl_analysis"]["s2s_nll"]).all()),
          "examples: a likelihood is not finite")
    c2tok = _coati2_tokenizer()
    prefixes = [c2tok.tokenize_text(c, pad=False) for c in coati2_tutorial.CONDITIONS
                for _ in range(coati2_tutorial.N_CONDITIONED)]
    check(c2["embeddings"].shape == (2, 512) and sorted(set(c2["prefix_lengths"])) == [5, 7]
          and all(row[: len(p)].tolist() == p
                  for row, p in zip(c2["conditioned_tokens"], prefixes)),
          "examples: coati2_tutorial's conditioned rows lost their prefixes")
    check(len(gen["screened"]) == 16 and np.isfinite(gen["due_mean"]).all(),
          "examples: generation_examples' screen")
    check(out["metadynamics_example"]["molecules_found"] > 0,
          "examples: metadynamics_example found no molecule")
    check(bool(np.isfinite(out["finetune_lora"]["losses"]).all())
          and bool(torch.isfinite(tuned_h).all()), "examples: finetune_lora")
    check(all(out[k]["healthz"]["status"] == "ok" and len(out[k]["generated"]) == 4
              for k in ("serve_tiny", "serve", "serve_coati2")), "examples: serve")
    for name in ("train_grande_dry_run", "train_grande", "train_coati2_dry_run", "train_coati2"):
        history = out[name]["results"]["history"]
        check(len(history) == (4 if "dry_run" in name else 3)
              and all(np.isfinite(h[3]) for h in history), f"examples: {name}'s steps")
    check(all(counts[k] > 0 for k in ("flash_causal_attention", "decode_attention",
                                      *TRAINING_KERNELS)),
          f"examples: launches {counts}")
    hold_path_shapes("examples", full)
    hold_decode_positions("examples", decode)
    missed = {k: v for k, v in line["numbers"].items() if not v.get("ok", True)}
    check(not missed, f"examples: the generation-quality protocol misses the record's bands: "
          f"{missed}")
    return counts


# ---------------------------------------------------------- decode_quality


def phase_decode_quality():
    """The JAX package's decode-quality protocol on the card
    (scripts/torch_eval_trained_decode.py, after scripts/eval_trained_decode.py)
    on the trained document: (1) its four configurations (fp32; bf16 over a
    bf16 cache; bf16 over an int8 cache; the default, bf16 with the int8
    cache) decode the same 2,048 train and 2,048 holdout round trips and
    1,024 draws (k 100, inverse temperature 2) from the same float32
    embeddings with the same seeds; every configuration but fp32 must hold
    the JAX script's rule: round trip within 0.02 of fp32's on each split,
    token-histogram TV <= 0.05. (2) The generation-quality protocol on the
    default configuration: fraction valid and unique within 0.03 of the
    float32 protocol that phase examples ran. K2 and K1 held at every shape
    and position the phase ran, K1 over each form of its cache. Returns the
    launch counts of the path."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_eval_trained_decode as ted

    fp32 = MEASURED["generation_quality_fp32"]
    by_cache = collections.Counter()
    seconds = {}
    with record_shapes(by_cache) as (full, decode):
        _zero_counts()  # the path starts here
        t0 = time.perf_counter()
        part1 = ted.evaluate(DOC, CORPUS)
        torch.cuda.synchronize()
        seconds["configurations"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        production = ted.production_quality(DOC, CORPUS)
        torch.cuda.synchronize()
        seconds["generation_quality"] = time.perf_counter() - t0
        counts = _counts()  # and ends here
    part2 = ted.quality_vs_fp32(production, fp32, json.loads(QUALITY_RECORD.read_text()))
    for name, r in part1["results"].items():
        emit({"phase": "decode_quality", "config": name, **r,
              "verdict": part1["verdict"].get(name, "reference")})
    emit({"phase": "decode_quality", "part": "verdict", "rule": part1["rule"],
          "rt_rows": part1["rt_rows"], "sample_batch": part1["sample_batch"],
          "top_k": part1["top_k"], "ok": part1["ok"]})
    emit({"phase": "decode_quality", "part": "generation_quality",
          "setting": dict(ted.CONFIGS)["default"], **ted.QUALITY, **part2})
    emit({"phase": "decode_quality", "part": "seconds", **seconds,
          "seconds": sum(seconds.values()), "launches": counts,
          "decode_attention_by_cache": dict(by_cache)})
    check(part1["ok"], f"decode_quality: a configuration misses the JAX rule: {part1['verdict']}")
    check(part2["ok"], f"decode_quality: the production setting's fraction valid or unique is "
          f"more than {ted.QUALITY_BAND} from float32's: {part2['numbers']}")
    check(counts["flash_causal_attention"] > 0 and counts["decode_attention"] > 0
          and counts["decode_attention_quant"] > 0 and by_cache["bfloat16"] > 0,
          f"decode_quality: launches {counts}, K1 by cache {dict(by_cache)}")
    hold_path_shapes("decode_quality", full)
    hold_decode_positions("decode_quality", decode)
    return counts


# ------------------------------------------------------------- multi_device

MD_LR = 5e-4  # the grande recipe's
TRAINING_KERNELS = ("egnn_messages", "egnn_messages_backward", "packed_causal_attention",
                    "packed_causal_attention_backward")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _md_config(dtype):
    from coati_tpu_torch.training.config import grande_config

    return grande_config(dtype=dtype, lr=MD_LR)


def _md_batch(config, tok):
    """One global batch of the grande recipe (160 fixture rows through
    clip_ar_xform, seeded) as host arrays, and its clip-token choices."""
    from coati_tpu_torch.data import fixture_dataset
    from coati_tpu_torch.data.xform import clip_ar_xform

    random.seed(0)
    pipe = fixture_dataset(config.batch_size).get_data_pipe(
        batch_size=config.batch_size,
        xform_routine=lambda b: clip_ar_xform(
            b, tokenizer=tok, p_dataset=config.p_dataset, p_formula=config.p_formula,
            p_clip=config.p_clip, p_clip_cut=config.p_clip_cut,
            p_randsmiles=config.p_randsmiles, rng=random.Random(0)))
    host = next(iter(pipe))
    batch = {k: np.asarray(host[k], np.int64) for k in ("raw_tokens", "tokens", "y_next", "atoms")}
    batch["coords"] = np.asarray(host["coords"], np.float32)
    batch["pick"] = (torch.rand(config.batch_size, generator=torch.Generator().manual_seed(0))
                     > 0.5).numpy()
    return batch


def _md_rows(batch, lo, hi):
    """Rows [lo, hi) of a host batch as device tensors, and their pick."""
    from coati_tpu_torch.training import train

    part = {k: v[lo:hi] for k, v in batch.items()}
    return (train.batch_to_device(part, torch.device("cuda")),
            torch.as_tensor(part["pick"], device="cuda"))


def _md_step(config, mesh, placement_cls, mode):
    """A fresh seeded grande model (seed 0), its placement over `mesh` (or
    none) and train_autoencoder's step over them."""
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
    from coati_tpu_torch.training import train

    tok = TrieTokenizer(n_seq=config.n_seq, **get_vocab(config.tokenizer_vocab))
    model_cfg = train.model_config_from_train_config(config, tok.n_token)
    model = train.fresh_model(model_cfg, torch.device("cuda"), seed=0)
    placement = placement_cls(mesh, model, config) if placement_cls else None
    optimizer = placement.optimizer if placement else train.make_optimizer(config, model)
    step = train.make_train_step(
        model, model_cfg, optimizer, stop_token=tok.stop_token, unk_token=tok.unk_token,
        p_clip_emb_smi=config.p_clip_emb_smi, token_entropy_unit=float(np.log2(tok.n_token)),
        do_clip=config.do_clip, parallel=train.ParallelStep(placement, mode))
    return step, placement, tok


def _md_compare(label, losses, state, ref):
    """A step's losses and gathered parameters against the reference's:
    losses within 1e-5 relative, parameters within 3 lr everywhere and
    1e-3 lr for 99.9% (the tolerance of the CPU tests' single-device
    steps)."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    diffs = torch.cat([(state[k].float().cpu() - ref["state"][k].float()).abs().flatten()
                       for k in ref["state"]])
    out = {"losses": losses, "loss_rel_diff": rel, "param_max_abs_diff": float(diffs.max()),
           "share_within_1e-3_lr": float((diffs <= 1e-3 * MD_LR).float().mean())}
    check(state.keys() == ref["state"].keys(), f"{label}: other parameters than the reference's")
    check(rel <= 1e-5 and out["param_max_abs_diff"] <= 3 * MD_LR
          and out["share_within_1e-3_lr"] >= 0.999,
          f"{label}: the step differs from the single-device step: {out}")
    return out


def _capture_grads(optimizer, named_parameters) -> dict:
    """Makes `optimizer.step` first copy every parameter's gradient, as the
    step reduced it and before the clip and the update, into the dict it
    returns (keyed by parameter name, on the CPU)."""
    names = {id(p): n for n, p in named_parameters}
    grads = {}
    step = optimizer.step

    def step_keeping_grads(*args, **kwargs):
        grads.clear()
        grads.update({names[id(p)]: (p.grad.detach().cpu().clone() if p.grad is not None
                                     else torch.zeros(p.shape))  # a zero gradient, as optax
                      for g in optimizer.param_groups for p in g["params"]})
        return step(*args, **kwargs)

    optimizer.step = step_keeping_grads
    return grads


def _md_grad_compare(label, grads, ref):
    """A step's reduced fp32 gradients against the single-device step's,
    within train_fp32_vs_plain's tolerance: 1e-4 x max(1, max |ref|) for
    each parameter; the worst parameter by its share of that tolerance."""
    check(grads.keys() == ref.keys(), f"{label}: gradients of other parameters than the "
          "reference's")
    worst = None
    for name, want in ref.items():
        diff = float((grads[name].float() - want.float()).abs().max())
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        if worst is None or diff / tol > worst["share_of_tol"]:
            worst = {"param": name, "max_abs_diff": diff, "tol": tol, "share_of_tol": diff / tol,
                     "ref_max_abs": float(want.abs().max())}
    out = {"n_params": len(ref), "worst": worst,
           "max_abs_diff": max(float((grads[k].float() - v.float()).abs().max())
                               for k, v in ref.items())}
    check(worst["share_of_tol"] <= 1.0, f"{label}: a reduced gradient differs from the "
          f"single-device step's: {out}")
    return out


def _moment_bytes(optimizer) -> int:
    return sum(t.numel() * t.element_size() for s in optimizer.state.values()
               for k, t in s.items() if k != "step")


def _md_step_seconds(step, batch, pick, n=10, warmup=3) -> list:
    times = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step(None, batch, pick_point=pick)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - start)
    return times


def _md_rank(rank: int, world: int, port: int, root: str) -> None:
    """One rank of the world-2 run on the one card (gloo carrying CUDA
    tensors: NCCL refuses two ranks on one device). Each placement takes
    one fp32 step of the global batch from the seeded model, DP and FSDP on
    the rank's half, TP 2 on the whole; rank 0 writes the gathered states,
    which the parent holds to phase (a)."""
    import torch.distributed as dist

    from coati_tpu_torch.parallel.fsdp import FullyShardedPlacement
    from coati_tpu_torch.parallel.mesh import make_mesh
    from coati_tpu_torch.parallel.placement import ReplicatedPlacement
    from coati_tpu_torch.parallel.tp import TensorParallelPlacement, make_tp_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        root = Path(root)
        batch = dict(np.load(root / "batch.npz"))
        dp = make_mesh(axis_names=("data",), device_type="cuda")
        tp = make_tp_mesh(model_parallel=2, device_type="cuda")
        config = _md_config("float32")
        half = config.batch_size // 2
        out = {"runs": {}}
        for label, mesh, cls, mode, split in (
                ("dp_pjit", dp, ReplicatedPlacement, "pjit", True),
                ("dp_shard_map", dp, ReplicatedPlacement, "shard_map", True),
                ("fsdp", dp, FullyShardedPlacement, "pjit", True),
                ("tp2", tp, TensorParallelPlacement, "pjit", False)):
            step, placement, _ = _md_step(config, mesh, cls, mode)
            lo, hi = (rank * half, (rank + 1) * half) if split else (0, config.batch_size)
            rows, pick = _md_rows(batch, lo, hi)
            _zero_counts()
            with record_shapes() as (full, _):
                metrics = step(None, rows, pick_point=pick)
                torch.cuda.synchronize()
            state = placement.full_state()[0]
            counts, moments = [None] * world, [None] * world
            dist.all_gather_object(counts, _counts())
            dist.all_gather_object(moments, _moment_bytes(placement.optimizer))
            out["runs"][label] = {
                "losses": [float(metrics[k]) for k in ("loss", "ar_loss", "clip_loss")],
                "launches_per_rank": counts, "shapes": sorted(full),
                "moment_bytes_per_rank": moments,
                "state": {k: v.cpu() for k, v in state.items()} if rank == 0 else None}
            del step, placement, state
            torch.cuda.empty_cache()
        # the bf16 DP step's seconds at world 2 on the one card
        step, _, _ = _md_step(_md_config("bfloat16"), dp, ReplicatedPlacement, "pjit")
        rows, pick = _md_rows(batch, rank * half, (rank + 1) * half)
        out["bf16_dp_step_s"] = _md_step_seconds(step, rows, pick, n=5)
        if rank == 0:
            torch.save(out, root / "world2.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_multi_device():
    """Multi-device training and sharded inference on the one card.
    (a) world 1 over NCCL: the grande step (16 x 256, EGNN 5 x 256, batch
    160, n_seq 80) from one seeded model, in float32, as
    train_autoencoder's step over a world-1 mesh in both formulations and
    under FSDP, against the single-device step on the same batch and clip
    choices; then the bf16 step's seconds, single-device against the
    world-1 mesh (the cost of the collectives layer). (b) world 2 on the
    one card (two processes over gloo, which carries CUDA tensors: NCCL
    refuses two ranks on one device): DP in both formulations, FSDP and TP
    2, each held to (a); the FSDP moments' bytes a rank; the bf16 DP step's
    seconds (two processes sharing one card: a test of correctness, not of
    scaling). K5f and K5b at TP's 8 heads against their plain versions.
    (c) ShardedCOATI over [cuda:0, cuda:0] with the trained document: fp32
    greedy decode of 1,024 SMILES embeddings, every token equal to the
    single-device decode; then a server with two replicas answers /embed
    and /generate as the single-device model. Returns the launch counts."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from coati_tpu_torch.parallel.fsdp import FullyShardedPlacement
    from coati_tpu_torch.parallel.mesh import make_mesh
    from coati_tpu_torch.parallel.placement import ReplicatedPlacement

    total = collections.Counter()
    config = _md_config("float32")
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        # ---- (a) world 1 over NCCL
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh(axis_names=("data",), device_type="cuda")
            step, _, tok = _md_step(config, None, None, "pjit")
            batch = _md_batch(config, tok)
            rows, pick = _md_rows(batch, 0, config.batch_size)
            grads = _capture_grads(step.optimizer, step.model.named_parameters())
            metrics = step(None, rows, pick_point=pick)
            ref = {"losses": [float(metrics[k]) for k in ("loss", "ar_loss", "clip_loss")],
                   "state": {k: v.detach().cpu() for k, v in step.model.state_dict().items()},
                   "grads": grads}
            single_moments = _moment_bytes(step.optimizer)
            del step
            ref_shard_map = _shard_map_reference(config, rows, pick)
            np.savez(work / "batch.npz", **batch)
            world1 = {}
            for label, cls, mode in (("dp_pjit", ReplicatedPlacement, "pjit"),
                                     ("dp_shard_map", ReplicatedPlacement, "shard_map"),
                                     ("fsdp", FullyShardedPlacement, "pjit")):
                step, placement, _ = _md_step(config, mesh, cls, mode)
                _zero_counts()
                metrics = step(None, rows, pick_point=pick)
                torch.cuda.synchronize()
                counts = _counts()
                total.update(counts)
                losses = [float(metrics[k]) for k in ("loss", "ar_loss", "clip_loss")]
                world1[label] = _md_compare(f"multi_device world 1 {label}", losses,
                                            placement.full_state()[0], ref)
                world1[label].update(launches=counts,
                                     moment_bytes=_moment_bytes(placement.optimizer))
                check(all(counts[k] > 0 for k in TRAINING_KERNELS),
                      f"multi_device world 1 {label}: a training kernel did not launch: {counts}")
                del step, placement
            bf16 = _md_config("bfloat16")
            step, _, _ = _md_step(bf16, None, None, "pjit")
            single_s = _md_step_seconds(step, rows, pick)
            del step
            step, _, _ = _md_step(bf16, mesh, ReplicatedPlacement, "pjit")
            mesh_s = _md_step_seconds(step, rows, pick)
            del step
        finally:
            dist.destroy_process_group()
        emit({"phase": "multi_device", "part": "world1_nccl", "batch": config.batch_size,
              "T": int(batch["tokens"].shape[1]), "atoms": int(batch["atoms"].shape[1]),
              "single_device_losses": ref["losses"], "single_device_moment_bytes": single_moments,
              "runs": world1, "bf16_step_s_single_device": single_s,
              "bf16_step_s_world1_mesh": mesh_s,
              "bf16_step_median_s": [statistics.median(single_s), statistics.median(mesh_s)]})
        torch.cuda.empty_cache()

        # ---- (b) world 2 on the one card
        start = time.perf_counter()
        ctx = mp.spawn(_md_rank, args=(2, _free_port(), str(work)), nprocs=2, join=False)
        try:
            for proc in ctx.processes:
                proc.join(600)
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        codes = [proc.exitcode for proc in ctx.processes]
        check(codes == [0, 0], f"multi_device world 2: rank exit codes {codes}")
        out = torch.load(work / "world2.pt", weights_only=False)
        summary, shapes = {}, set()
        for label, run in out["runs"].items():
            for counts in run["launches_per_rank"]:
                total.update(counts)
                check(all(counts[k] > 0 for k in TRAINING_KERNELS),
                      f"multi_device world 2 {label}: a training kernel did not launch on a "
                      f"rank: {counts}")
            shapes.update(tuple(s) for s in run["shapes"])
            summary[label] = {"launches_per_rank": run["launches_per_rank"],
                              "moment_bytes_per_rank": run["moment_bytes_per_rank"]}
            want = ref_shard_map if label == "dp_shard_map" else ref
            summary[label].update(_md_compare(f"multi_device world 2 {label}", run["losses"],
                                              run["state"], want))
        ratios = [b / world1["fsdp"]["moment_bytes"]
                  for b in out["runs"]["fsdp"]["moment_bytes_per_rank"]]
        emit({"phase": "multi_device", "part": "world2_one_card", "backend": "gloo",
              "runs": summary, "fsdp_moment_bytes_per_rank_over_world1": ratios,
              "bf16_dp_step_s": out["bf16_dp_step_s"],
              "bf16_dp_step_median_s": statistics.median(out["bf16_dp_step_s"]),
              "seconds": time.perf_counter() - start})
        check(all(0.45 <= r <= 0.6 for r in ratios),
              f"multi_device: FSDP moments a rank at world 2 are {ratios} of world 1's")
        heads8 = {s for s in shapes if s[0].startswith("packed") and s[3] == 8}
        check(heads8, "multi_device TP 2: no attention call at 8 heads")
        hold_path_shapes("multi_device_tp", heads8 | {(*s[:5], "bfloat16") for s in heads8})
        gen = torch.Generator(device="cuda").manual_seed(3)
        for name, b, t, h, dh, _ in sorted(heads8):
            if name == "packed_causal_attention_backward":
                case = _attention_bwd_case(b, t, h, dh, torch.bfloat16, gen)
            else:
                case = _attention_case(name, b, t, h, dh, torch.bfloat16, gen)
            emit({"phase": "kernel", "held_for": "multi_device_tp_timed", **case})
            check(case["ok"], f"multi_device TP 2: {name} at 8 heads is outside tolerance")

    # ---- (c) sharded decode and a server with two replicas
    total.update(_sharded_inference())
    # ---- (d) pipeline, sequence and expert parallelism at world 2; (e) the
    # dry run at world 4; (f) the continuous engine over two devices
    total.update(_pipeline_sequence_expert(config, batch, ref))
    total.update(_dryrun_four())
    total.update(_continuous_two_devices())
    return dict(total)


MOE_SHAPE = dict(d=256, hidden=1024, n_experts=8)
MOE_CF = 1.0
SP_ENCODE_CHUNK = 128


def _moe_inputs(config):
    """The seeded MoE (D 256, F 1024, E 8) and its 160 x 80 tokens, on the
    card."""
    from coati_tpu_torch.parallel import ep

    gen = torch.Generator(device="cuda").manual_seed(5)
    moe = ep.init_moe(gen, device="cuda", **MOE_SHAPE)
    x = torch.randn((config.batch_size, config.n_seq, MOE_SHAPE["d"]), generator=gen,
                    device="cuda")
    return moe, x


def _sp_tokens(batch, config):
    """(a)'s tokens and labels padded to the recipe's n_seq (T 80): [PAD]
    tokens, ignored (-1) labels; on the card."""
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

    pad = TrieTokenizer(n_seq=config.n_seq, **get_vocab(config.tokenizer_vocab)).pad_token
    extra = ((0, 0), (0, config.n_seq - batch["tokens"].shape[1]))
    return (torch.as_tensor(np.pad(batch["tokens"], extra, constant_values=pad), device="cuda"),
            torch.as_tensor(np.pad(batch["y_next"], extra, constant_values=-1), device="cuda"))


def _m8b_references(config, batch):
    """On one device, from the seeded models of (d): the trunk's AR step at
    T 80 (through the training route's kernels) and the MoE step, which the
    ranks' results are held to; and how many tokens the MoE drops."""
    from coati_tpu_torch.models import coati as F
    from coati_tpu_torch.models.transformer import forward_logits
    from coati_tpu_torch.parallel import ep
    from coati_tpu_torch.training import train

    step, _, _ = _md_step(config, None, None, "pjit")
    trunk, xcfg = step.model.xformer, step.model_cfg.xformer_config
    tokens, y_next = _sp_tokens(batch, config)
    optimizer = train.make_optimizer(config, trunk)
    loss = F.ar_loss_fn(forward_logits(trunk, xcfg, tokens), y_next)
    loss.backward()
    optimizer.step()
    sp = {"losses": [float(loss.detach())],
          "state": {k: v.detach().cpu() for k, v in trunk.state_dict().items()}}
    del step, trunk, optimizer
    moe, x = _moe_inputs(config)
    with torch.no_grad():
        out, _ = ep.moe_mlp(moe, x, MOE_CF)
    dropped = int((out.abs().amax(dim=-1) == 0).sum())
    loss = ep.make_ep_train_step(None, moe, train.make_optimizer(config, moe), MOE_CF)(x)
    ep_ref = {"losses": [float(loss)],
              "state": {k: v.detach().cpu() for k, v in moe.state_dict().items()}}
    torch.cuda.empty_cache()
    return sp, ep_ref, dropped


def _md_rank_m8b(rank: int, world: int, port: int, root: str) -> None:
    """One rank of (d): two processes on the one card over gloo. The
    permute first, then PP, SP and EP from the seeded models; rank 0 writes
    what the parent holds to the single-device results."""
    import torch.distributed as dist

    from coati_tpu_torch.models import coati as F
    from coati_tpu_torch.parallel import comm, ep, pp, sp
    from coati_tpu_torch.training import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        root = Path(root)
        batch = dict(np.load(root / "batch.npz"))
        out = {}
        shapes = set()
        # the permute carries a CUDA tensor, forward and backward
        group = dist.group.WORLD
        x = (torch.arange(4.0, device="cuda") + 10 * rank).requires_grad_(True)
        y = comm.ring_permute(x, group)
        (y * (rank + 1)).sum().backward()
        other = (rank - 1) % world
        out["permute"] = {
            "route": comm.permute_route(x, group), "device": str(y.device),
            "forward_ok": bool(torch.equal(y.detach().cpu(), torch.arange(4.0) + 10 * other)),
            # rank r's x reached rank r + 1, which scaled it by r + 2
            "backward_ok": bool(torch.equal(x.grad.cpu(),
                                            torch.full((4,), float((rank + 1) % world + 1))))}
        # PP: pipe 2, the composite step in fp32 with 2 and 4 microbatches
        config = _md_config("float32")
        mesh = pp.make_pp_mesh(pipe=2, device_type="cuda")
        rows, pick = _md_rows(batch, 0, config.batch_size)
        out["pp"] = {}

        def pp_step(cfg, m, capture=False):
            step, _, tok = _md_step(cfg, None, None, "pjit")
            model = pp.shard_coati_params_pp(mesh, step.model)
            optimizer = pp.make_pp_optimizer(cfg, mesh, model)
            grads = _capture_grads(optimizer, model.named_parameters()) if capture else None
            fn = pp.make_pp_coati_train_step(
                mesh, step.model_cfg, model, optimizer,
                stop_token=tok.stop_token, unk_token=tok.unk_token,
                p_clip_emb_smi=cfg.p_clip_emb_smi, token_entropy_unit=step.token_entropy_unit,
                n_microbatches=m)
            return fn, model, grads

        for m in (2, 4):
            fn, model, captured = pp_step(config, m, capture=True)
            _zero_counts()
            with record_shapes() as (full, _):
                metrics = fn(None, rows, pick_point=pick)
                torch.cuda.synchronize()
            shapes |= full
            counts = [None] * world
            dist.all_gather_object(counts, _counts())
            state = pp.gather_pp_state(mesh, model)
            grads = pp.gather_stages(mesh, captured)
            out["pp"][m] = {"losses": [float(metrics[k]) for k in ("loss", "ar_loss", "clip_loss")],
                            "launches_per_rank": counts,
                            "state": state if rank == 0 else None,
                            "grads": grads if rank == 0 else None}
            del fn, model, state, grads, captured
            torch.cuda.empty_cache()
        fn, _, _ = pp_step(_md_config("bfloat16"), 2)
        with record_shapes() as (full, _):  # an untimed step, the shapes of the timed ones
            fn(None, rows, pick_point=pick)
            torch.cuda.synchronize()
        shapes |= full
        out["pp_bf16_step_s"] = _md_step_seconds(fn, rows, pick, n=10)
        del fn
        torch.cuda.empty_cache()
        everyone = [None] * world
        dist.all_gather_object(everyone, sorted(shapes))
        out["pp_shapes"] = sorted({tuple(x) for rank_shapes in everyone for x in rank_shapes})
        # SP: seq 2, the trunk's AR step at T 80; then the encode at T 250
        mesh = sp.make_sp_mesh(seq=2, device_type="cuda")
        step, _, _ = _md_step(config, None, None, "pjit")
        trunk, xcfg = step.model.xformer, step.model_cfg.xformer_config
        tokens, y_next = _sp_tokens(batch, config)
        start = time.perf_counter()
        loss = sp.make_sp_train_step(mesh, xcfg, trunk, train.make_optimizer(config, trunk))(
            tokens, y_next)
        torch.cuda.synchronize()
        out["sp"] = {"losses": [float(loss)], "seconds": time.perf_counter() - start,
                     "state": ({k: v.detach().cpu() for k, v in trunk.state_dict().items()}
                               if rank == 0 else None)}
        del step, trunk
        model, tok = load_model()
        enc_tokens = np.load(root / "encode_tokens.npy")
        encode = sp.make_sp_encode(mesh, model.config.xformer_config, model.params.xformer,
                                   tok.stop_token)
        start = time.perf_counter()
        parts = []
        for i in range(0, len(enc_tokens), SP_ENCODE_CHUNK):
            h = encode(torch.as_tensor(enc_tokens[i:i + SP_ENCODE_CHUNK], device="cuda"))
            parts.append(F.apply_projection(model.params.smiles_to_clip, h,
                                            model.config.old_architecture).cpu())
        torch.cuda.synchronize()
        out["sp_encode"] = {"h": torch.cat(parts) if rank == 0 else None,
                            "seconds": time.perf_counter() - start}
        del model
        torch.cuda.empty_cache()
        # EP: expert 2, the MoE step
        mesh = ep.make_ep_mesh(expert=2, device_type="cuda")
        moe, x = _moe_inputs(config)
        mine = ep.shard_params_ep(mesh, moe)
        optimizer = train.make_optimizer(config, mine, grad_norm=ep.ep_grad_norm(mesh, mine))
        start = time.perf_counter()
        loss = ep.make_ep_train_step(mesh, mine, optimizer, MOE_CF)(x)
        torch.cuda.synchronize()
        whole = ep.gather_ep_params(mesh, mine)
        out["ep"] = {"losses": [float(loss)], "seconds": time.perf_counter() - start,
                     "local_experts": int(mine.w_fc.shape[0]),
                     "state": ({k: v.detach().cpu() for k, v in whole.state_dict().items()}
                               if rank == 0 else None)}
        if rank == 0:
            torch.save(out, root / "m8b.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn_ranks(fn, world, work, timeout=600):
    """`world` processes running fn(rank, world, port, work), each joined
    within `timeout` seconds (what is left is killed); their exit codes."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(fn, args=(world, _free_port(), str(work)), nprocs=world, join=False)
    try:
        for proc in ctx.processes:
            proc.join(timeout)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    return [proc.exitcode for proc in ctx.processes]


def _encode_rows(tok, n):
    """The first n corpus SMILES the tokenizer takes, as padded token rows."""
    rows = []
    for s in gzip.open(CORPUS, "rt").read().split():
        try:
            rows.append(tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=True))
        except (KeyError, ValueError):
            continue
        if len(rows) == n:
            break
    return np.asarray(rows)


def _pipeline_sequence_expert(config, batch, ref):
    """(d): the world-2 ranks of _md_rank_m8b on (a)'s batch, held to (a)'s
    single-device step `ref` and to the single-device trunk and MoE steps.
    Returns the PP ranks' launches."""
    total = collections.Counter()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        np.savez(work / "batch.npz", **batch)
        model, doc_tok = load_model()
        enc_tokens = _encode_rows(doc_tok, SERVING_ROWS)
        np.save(work / "encode_tokens.npy", enc_tokens)
        want_h = torch.cat([model.encode_tokens(enc_tokens[i:i + SP_ENCODE_CHUNK], doc_tok).cpu()
                            for i in range(0, len(enc_tokens), SP_ENCODE_CHUNK)])
        del model
        sp_ref, ep_ref, dropped = _m8b_references(config, batch)
        start = time.perf_counter()
        codes = _spawn_ranks(_md_rank_m8b, 2, work)
        check(codes == [0, 0], f"multi_device (d): rank exit codes {codes}")
        out = torch.load(work / "m8b.pt", weights_only=False)
    perm = out["permute"]
    emit({"phase": "multi_device", "part": "ring_permute", "backend": "gloo", **perm})
    check(perm["forward_ok"] and perm["backward_ok"] and perm["device"].startswith("cuda"),
          f"multi_device (d): ring_permute did not carry the CUDA tensor: {perm}")
    pp_summary = {}
    for m, run in out["pp"].items():
        for counts in run["launches_per_rank"]:
            total.update(counts)
            check(all(counts[k] > 0 for k in TRAINING_KERNELS),
                  f"multi_device PP {m} microbatches: a training kernel did not launch on a "
                  f"rank: {counts}")
        pp_summary[m] = {"launches_per_rank": run["launches_per_rank"],
                         **_md_compare(f"multi_device PP {m} microbatches", run["losses"],
                                       run["state"], ref),
                         "grads": _md_grad_compare(f"multi_device PP {m} microbatches",
                                                   run["grads"], ref["grads"])}
    emit({"phase": "multi_device", "part": "pipeline", "pipe": 2, "runs": pp_summary,
          "bf16_step_s": out["pp_bf16_step_s"],
          "bf16_step_median_s": statistics.median(out["pp_bf16_step_s"])})
    _hold_rank_shapes("multi_device_pp", out["pp_shapes"])
    sp_out = _md_compare("multi_device SP", out["sp"]["losses"], out["sp"]["state"], sp_ref)
    enc_diff = float((out["sp_encode"]["h"] - want_h).abs().max())
    emit({"phase": "multi_device", "part": "sequence", "seq": 2, "T": config.n_seq,
          "step": sp_out, "step_s": out["sp"]["seconds"], "encode_rows": len(enc_tokens),
          "encode_T": int(enc_tokens.shape[1]), "encode_max_abs_diff": enc_diff,
          "encode_s": out["sp_encode"]["seconds"]})
    check(enc_diff <= 1e-4, f"multi_device SP encode differs from encode_tokens by {enc_diff}")
    ep_out = _md_compare("multi_device EP", out["ep"]["losses"], out["ep"]["state"], ep_ref)
    emit({"phase": "multi_device", "part": "expert", "expert": 2, **MOE_SHAPE,
          "tokens": config.batch_size * config.n_seq, "capacity_factor": MOE_CF,
          "tokens_dropped": dropped, "local_experts": out["ep"]["local_experts"],
          "step": ep_out, "step_s": out["ep"]["seconds"],
          "seconds": time.perf_counter() - start})
    check(dropped > 0, "multi_device EP: the capacity drops no token")
    check(out["ep"]["local_experts"] == MOE_SHAPE["n_experts"] // 2,
          f"multi_device EP: a rank holds {out['ep']['local_experts']} experts")
    return total


def _hold_rank_shapes(phase, shapes):
    """Holds the attention kernels at the (kernel, B, T, H, Dh, dtype)
    shapes spawned ranks ran (their microbatches and head groups), in their
    dtype and in bf16."""
    shapes = {tuple(s) for s in shapes}
    check(any(s[0] == "packed_causal_attention" for s in shapes),
          f"{phase}: the ranks made no attention call")
    hold_path_shapes(phase, shapes | {(*s[:5], "bfloat16") for s in shapes})


def _md_rank_dryrun(rank: int, world: int, port: int, root: str) -> None:
    """One rank of (e): dryrun_multichip over the gloo world on the card."""
    import torch.distributed as dist

    from coati_tpu_torch.parallel.dryrun import dryrun_multichip

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        _zero_counts()
        with record_shapes() as (full, _):
            losses = dryrun_multichip(world)
        counts, shapes = [None] * world, [None] * world
        dist.all_gather_object(counts, _counts())
        dist.all_gather_object(shapes, sorted(full))
        if rank == 0:
            torch.save({"losses": losses, "launches_per_rank": counts,
                        "shapes": sorted({tuple(x) for s in shapes for x in s})},
                       Path(root) / "dryrun.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _dryrun_four():
    """(e): dryrun_multichip(4) as four gloo ranks on the card."""
    total = collections.Counter()
    with tempfile.TemporaryDirectory() as work:
        start = time.perf_counter()
        codes = _spawn_ranks(_md_rank_dryrun, 4, work)
        check(codes == [0] * 4, f"multi_device (e): dryrun rank exit codes {codes}")
        out = torch.load(Path(work) / "dryrun.pt", weights_only=False)
    for counts in out["launches_per_rank"]:
        total.update(counts)
    emit({"phase": "multi_device", "part": "dryrun_multichip", "ranks": 4,
          "losses": out["losses"], "launches_per_rank": out["launches_per_rank"],
          "seconds": time.perf_counter() - start})
    check(len(out["losses"]) == 5 and all(np.isfinite(v) for v in out["losses"].values()),
          f"multi_device (e): dryrun_multichip(4) gave {out['losses']}")
    _hold_rank_shapes("multi_device_dryrun", out["shapes"])
    return total


def _continuous_two_devices():
    """(f): the engine over [cuda:0, cuda:0] against one device, fp32 greedy,
    256 single-row requests through 64 slots; then continuous servers."""
    from coati_tpu_torch.serving import ContinuousDecoder

    model, tok = load_model()
    emb = model.encode_tokens(_encode_rows(tok, SERVING_ROWS), tok).float().cpu().numpy()
    h = emb[np.random.default_rng(0).integers(0, len(emb), size=CONTINUOUS_REQUESTS)]
    xcfg = model.config.xformer_config
    prefix = list(tok.tokenize_text("[CLIP][UNK][SMILES]", pad=False))
    runs, tokens = {}, {}
    # the one-device reference first; the counts are the two-device run's
    for label, mesh in (("one_device", None), ("two_devices", ["cuda:0", "cuda:0"])):
        engine = ContinuousDecoder(
            model._compute.xformer, xcfg, prefix, n_slots=64, stop_token=tok.stop_token,
            pad_token=tok.pad_token, inject_token=tok.unk_token, k=1, inv_temp=1.0,
            inj_transform=lambda x: model._to_token(x.to(xcfg.compute_dtype)),
            inj_dim=model.embed_dim, mesh=mesh)
        engine.warmup()
        rids = [engine.submit(row) for row in h]
        torch.cuda.synchronize()
        _zero_counts()
        start = time.perf_counter()
        with record_shapes() as (full, _):
            out = engine.run_until_done()
            torch.cuda.synchronize()
        runs[label] = {"seconds": time.perf_counter() - start, "rows": engine.n_rows,
                       "decode_steps": engine.decode_steps, "segments": engine.segments,
                       "launches": _counts()}
        tokens[label] = [[int(t) for t in out[r]] for r in rids]
    counts = runs["two_devices"]["launches"]
    hold_path_shapes("multi_device_continuous", full)  # each device's admission prefills
    equal = sum(a == b for a, b in zip(tokens["one_device"], tokens["two_devices"]))
    gen = [{"embeddings": [x.tolist()], "k": 1, "inv_temp": 1.0} for x in emb[:64]]
    answers = {}
    for label, mesh in (("one_device", None), ("two_devices", ["cuda:0", "cuda:0"])):
        with _server(model, tok, ((1, 1.0),), max_bucket=64, max_batch=64, continuous=True,
                     n_slots=64, mesh=mesh) as server:
            answers[label] = [s for r in _load(server.port, "/generate", gen, 8)[0]
                              for s in r["smiles"]]
    same = sum(a == b for a, b in zip(answers["one_device"], answers["two_devices"]))
    emit({"phase": "multi_device", "part": "continuous_two_devices", "devices": ["cuda:0"] * 2,
          "requests": len(h), "slots": 64, "runs": runs, "rows_token_equal": equal,
          "server_requests": len(gen), "server_rows_equal": same})
    check(equal == len(h), f"continuous engine over two devices: {len(h) - equal} requests "
          "differ from the single-device engine's tokens")
    check(same == len(gen), f"continuous server over two devices: {len(gen) - same} rows "
          "differ from the single-device server's")
    check(counts["flash_causal_attention"] > 0,
          f"continuous engine over two devices: K2 did not launch: {counts}")
    return counts


def _shard_map_reference(config, rows, pick):
    """The "shard_map" step of two ranks, on one device: the mean of the
    two halves' AR means, the clip loss over all rows, one AdamW step from
    the seeded model (the world-2 shard_map run is held to it)."""
    from coati_tpu_torch.models import coati as F

    step, _, _ = _md_step(config, None, None, "pjit")
    h_e3gnn, h_smiles, logits, bad = F.forward(
        step.model, step.model_cfg, None, rows["raw_tokens"], rows["tokens"], rows["atoms"],
        rows["coords"], step.stop_token, step.unk_token, step.p_clip_emb_smi, pick_point=pick)
    half = config.batch_size // 2
    y = rows["y_next"]
    ar = 0.5 * (F.ar_loss_fn(logits[:half], y[:half]) + F.ar_loss_fn(logits[half:], y[half:]))
    cl = F.clip_loss(h_smiles, h_e3gnn, bad)
    loss = ar + cl * step.token_entropy_unit
    loss.backward()
    step.update()
    return {"losses": [float(x.detach()) for x in (loss, ar, cl)],
            "state": {k: v.detach().cpu() for k, v in step.model.state_dict().items()}}


def _sharded_inference():
    from coati_tpu_torch.parallel.inference import ShardedCOATI

    model, tok = load_model()
    corpus = [s for s in gzip.open(CORPUS, "rt").read().split()][:4096]
    tokens = []
    for s in corpus:
        try:
            row = tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=True)
        except (KeyError, ValueError):
            continue
        tokens.append(row)
        if len(tokens) == SERVING_ROWS:
            break
    tokens = np.asarray(tokens)
    h = model.encode_tokens(tokens, tok)
    (single, single_s, _) = _timed(lambda: model.hclip_to_2d_batch(h, tok, k=1,
                                                                   return_tokens=True))
    sharded = ShardedCOATI(model, ["cuda:0", "cuda:0"])
    _zero_counts()
    h2, encode_s, _ = _timed(lambda: sharded.encode_tokens(tokens, tok))
    out, decode_s, _ = _timed(lambda: sharded.hclip_to_2d_batch(h, tok, k=1,
                                                                 return_tokens=True))
    counts = _counts()
    smiles, toks = single
    equal_rows = sum(a == b for a, b in zip(out[1], toks))
    emit({"phase": "multi_device", "part": "sharded_decode", "replicas": ["cuda:0", "cuda:0"],
          "rows": len(tokens), "encode_max_abs_diff": float((h2 - h).abs().max()),
          "rows_token_equal": equal_rows, "single_device_decode_s": single_s,
          "sharded_encode_s": encode_s, "sharded_decode_s": decode_s, "launches": counts})
    check(float((h2 - h).abs().max()) <= 1e-5, "sharded encode differs from the single device's")
    check(equal_rows == len(tokens), f"sharded greedy decode: {len(tokens) - equal_rows} rows "
          "differ from the single-device tokens")
    check(out[0] == smiles, "sharded greedy decode: other SMILES than the single device's")
    check(counts["flash_causal_attention"] > 0 and counts["decode_attention"] > 0,
          f"sharded decode: K2 / K1 did not launch: {counts}")
    # the server with two replicas
    rows = corpus[:64]
    with _server(model, tok, ((1, 1.0),), max_bucket=64, max_batch=64,
                 mesh=["cuda:0", "cuda:0"]) as server:
        check(isinstance(server.frontend.model, ShardedCOATI), "the server did not shard")
        replies, _, _ = _load(server.port, "/embed", [{"smiles": s} for s in _in_16s(rows)], 4)
        emb = np.asarray([e for r in replies for e in r["embeddings"]], np.float32)
        gen = [{"embeddings": x.tolist(), "k": 1, "inv_temp": 1.0} for x in _in_16s(emb)]
        got = [s for r in _load(server.port, "/generate", gen, 4)[0] for s in r["smiles"]]
    ref_emb = model.encode_tokens(_tokens(tok, rows, tok.n_seq), tok).float().cpu().numpy()
    want = model.hclip_to_2d_batch(emb, tok, k=1, inv_temp=1.0)
    diff = float(np.abs(emb - ref_emb).max())
    emit({"phase": "multi_device", "part": "server_two_replicas", "rows": len(rows),
          "embed_max_abs_diff": diff, "generate_equal_rows": sum(a == b for a, b in
                                                                 zip(got, want))})
    check(diff <= 1e-5 and got == want, "the server with two replicas answers otherwise than "
          "the single-device model")
    return counts

def _profile(fn, label, wall_s, top=12, annotations=()):
    """Device time by kernel over one call of fn (torch.profiler): the top
    kernels and every kernel of the port's own; and the card's idle share
    against the call's unprofiled time. `annotations` names record_function
    ranges whose kernels' device time (ms) is reported too. Returns the
    line it prints."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from coati_tpu_torch.ops.kernels import build

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()  # costly over a long trace: once
    # kernels only: an aten op's device time repeats that of its kernels, and
    # a user annotation on the device timeline (the optimizer's step) spans
    # the gaps between them
    rows = [(e.key, e.self_device_time_total, e.count) for e in averages
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    busy_s = sum(t for _, t, _ in rows) / 1e6
    rows = sorted(rows, key=lambda r: -r[1])
    # the port's own kernels by name, whatever their rank (names from ptxas)
    ours = {k.split("<")[0] for log in build.BUILD_LOG.values() for k in ptxas_usage(log)}
    port = [r for r in rows if ours and re.search(r"\b(" + "|".join(ours) + r")\b", r[0])]
    # a range's own kernels and its children's, on the host side of the trace
    ranges = {name: sum(e.device_time_total for e in averages
                        if e.key == name and e.device_type == DeviceType.CPU) / 1e3
              for name in annotations}
    line = {"phase": "profile", "shape": label, "device_busy_s": busy_s,
            "call_s": wall_s, "idle_share": 1 - busy_s / wall_s,
            "kernel_launches": sum(c for _, _, c in rows),
            "top_kernels": [{"name": n[:90], "ms": t / 1e3, "calls": c}
                            for n, t, c in rows[:top]],
            "port_kernels": [{"name": n[:90], "ms": t / 1e3, "calls": c} for n, t, c in port],
            "annotations": ranges}
    emit(line)
    return line



# ------------------------------------------------------------- mla_moe


def dsv2lite_config(dtype: str = "bfloat16"):
    """COATI with DeepSeek-V2-Lite's block as its trunk, one chip's share of
    an 8-way expert-parallel deployment (portbench/configs/coati_dsv2lite.json):
    5 of 27 layers, experts 0-7 of 64, the mar vocabulary."""
    from coati_tpu_torch.models.coati import CoatiConfig
    from coati_tpu_torch.models.mla_moe import MlaMoeConfig

    return CoatiConfig(n_layer_e3gnn=5, n_layer_xformer=5, n_hidden_xformer=2048, n_hidden_e3nn=256,
                       n_embd_common=256, n_head=16, n_seq=250, n_tok=13603, dtype=dtype,
                       mla=MlaMoeConfig(n_held=8, first_expert=0))


def _mla_case(b, t, pos, gen):
    """K6 against its plain version at one position, bf16: within 2 ulps of
    the output's scale, the same bits over two launches and from the
    position read on the card; timed beside its bound, the plain version
    and SDPA over the same rows."""
    from coati_tpu_torch.ops.kernels.mla_decode import mla_decode, mla_decode_plain

    h, w, lat, scale = 16, 576, 512, 0.114721
    q = torch.randn(b, h, w, generator=gen, device="cuda").to(torch.bfloat16)
    cache = torch.randn(b, t, w, generator=gen, device="cuda").to(torch.bfloat16)
    dev_pos = torch.tensor([pos], dtype=torch.int32, device="cuda")
    out = mla_decode(q, cache, pos, scale)
    again = mla_decode(q, cache, pos, scale)
    on_card = mla_decode(q, cache, dev_pos, scale)
    ref = mla_decode_plain(q, cache, pos, scale)
    err = float((out.float() - ref.float()).abs().max())
    tol = tolerance(ref, torch.bfloat16, 1e-5)
    n_bytes = b * ((pos + 1) * w * 2 + h * w * 2 + h * lat * 2)
    bound, by = bound_ms(n_bytes, 2.0 * b * h * (pos + 1) * (w + lat), torch.bfloat16)
    k = cache[:, None, : pos + 1].expand(b, h, pos + 1, w)
    v = cache[:, None, : pos + 1, :lat].expand(b, h, pos + 1, lat)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q[:, :, None], k, v, scale=scale)  # noqa: E731
    line = {"phase": "mla_moe_k6", "shape": [b, t, h, w], "pos": pos, "max_abs_err": err,
            "tolerance": tol, "repeat_equal": bool(torch.equal(out, again)),
            "device_pos_equal": bool(torch.equal(out, on_card)),
            "ms": time_ms(lambda: mla_decode(q, cache, pos, scale)),
            "ms_device_pos": time_ms(lambda: mla_decode(q, cache, dev_pos, scale)),
            "bound_ms": bound, "bound_by": by,
            "plain_ms": time_ms(lambda: mla_decode_plain(q, cache, pos, scale), n=5),
            "library_ms": time_ms(lib, n=10)}
    emit(line)
    check(err <= tol and line["repeat_equal"] and line["device_pos_equal"],
          f"mla_moe K6 at pos {pos}: {line}")
    return line


def _grouped_case(label, x, experts, gen):
    """The grouped expert product on the card against the per-expert loop,
    at the published widths over 8 held experts."""
    from coati_tpu_torch.ops import moe

    d, w, n_held = 2048, 1408, 8
    gu = (torch.rand(n_held, 2 * w, d, generator=gen, device="cuda") * 2 - 1).mul(d ** -0.5)
    down = (torch.rand(n_held, d, w, generator=gen, device="cuda") * 2 - 1).mul(w ** -0.5)
    gu, down = gu.to(torch.bfloat16), down.to(torch.bfloat16)
    order, ends, held = moe.dispatch(experts, 0, n_held)
    xs = x.index_select(0, order // experts.shape[1])
    got = moe.grouped_swiglu(xs, ends, gu, down)
    again = moe.grouped_swiglu(xs, ends, gu, down)
    ref = moe.grouped_swiglu_plain(xs, ends, gu, down)
    n = int(ends[-1])
    err = float((got[:n].float() - ref[:n].float()).abs().max()) if n else 0.0
    tol = tolerance(ref[:n], torch.bfloat16, 1e-5) if n else 0.0
    pairs = n
    active = int((torch.diff(ends.long(), prepend=ends.new_zeros(1).long()) > 0).sum())
    n_bytes = active * 3 * d * w * 2 + pairs * (2 * d + 3 * w) * 2
    bound, by = bound_ms(n_bytes, 6.0 * pairs * d * w, torch.bfloat16)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        moe.grouped_swiglu(xs, ends, gu, down)
        torch.cuda.synchronize()
    names = sorted({e.key[:160] for e in prof.key_averages() if e.device_type.name == "CUDA"})
    line = {"phase": "mla_moe_experts", "case": label, "tokens": x.shape[0], "pairs_here": pairs,
            "device_kernels": names,
            "ends": ends.tolist(), "max_abs_err": err, "tolerance": tol,
            "repeat_equal": bool(torch.equal(got[:n], again[:n])),
            "ms": time_ms(lambda: moe.grouped_swiglu(xs, ends, gu, down)), "bound_ms": bound,
            "bound_by": by, "plain_ms": time_ms(lambda: moe.grouped_swiglu_plain(xs, ends, gu, down),
                                                n=5)}
    emit(line)
    check(err <= tol and line["repeat_equal"], f"mla_moe experts {label}: {line}")


def phase_mla_moe():
    """DeepSeek-V2-Lite's block as COATI's trunk on the card: K6 at B 1024,
    T 250, pos 3 / 95 / 249 against its plain version; the grouped experts
    against the per-expert loop (routed picks of 1,024 tokens, and a
    dropless case with every pick on one held expert); then a seeded model
    at the cell's widths, its round trip of 1,024 corpus SMILES graphed
    against eager, greedy and sampled: the same tokens and K6 launches.
    Returns (K6's launches on that path, its case at pos 249)."""
    from coati_tpu_torch.common import tracing
    from coati_tpu_torch.models.api import COATI
    from coati_tpu_torch.models.coati import CoatiModel
    from coati_tpu_torch.ops import graphs, moe
    from coati_tpu_torch.ops.kernels.mla_decode import mla_decode
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

    gen = torch.Generator(device="cuda").manual_seed(21)
    k6 = {pos: _mla_case(1024, 250, pos, gen) for pos in (3, 95, 249)}
    x = torch.randn(1024, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    router = (torch.rand(64, 2048, generator=gen, device="cuda") * 2 - 1).mul(2048 ** -0.5)
    _, experts = moe.route(x, router.to(torch.bfloat16), 6)
    _grouped_case("routed", x, experts, gen)
    _grouped_case("one_expert", x, torch.full_like(experts, 64).index_fill_(1, torch.tensor(
        [0], device="cuda"), 3), gen)

    cfg = dsv2lite_config()
    torch.manual_seed(21)
    with torch.device("cuda"):
        params = CoatiModel(cfg)
    params.requires_grad_(False)
    model = COATI(params, cfg, seed=0)
    tok = TrieTokenizer(n_seq=cfg.n_seq, **get_vocab("mar"))
    with gzip.open(ROOT / "corpora" / "chembl_synth_v1.smi.gz", "rt") as f:
        smiles = [s.strip() for s in itertools.islice(f, 4096) if 0 < len(s.strip()) <= 200]
    tokens = _tokens(tok, smiles[:1024], cfg.n_seq)
    keep = _KeepRows(tok)

    def run(k, seed):
        model._generator.manual_seed(seed)
        before = mla_decode.launches
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.smiles_to_2d_batch(tokens, keep, k=k, inv_temp=2.0)
        torch.cuda.synchronize()
        return keep.rows, time.perf_counter() - start, mla_decode.launches - before

    torch.cuda.reset_peak_memory_stats()
    with graphs.eager():
        eager = {k: run(k, 5) for k in (1, 100)}
    tracing.reset()
    tracing.start()
    setup = [run(1, 5) for _ in range(2)]
    graphed = {k: run(k, 5) for k in (1, 100)}
    totals = _tracer_totals()
    counters = tracing.snapshot()["counters"]
    tracing.stop()
    timed = [run(100, 7 + i)[1] for i in range(3)]
    start = time.perf_counter()
    model.encode_tokens(tokens, tok)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - start
    line = {"phase": "mla_moe_graph", "batch": len(tokens),
            "greedy_equal": all(np.array_equal(r[0], eager[1][0]) for r in (*setup, graphed[1])),
            "sampled_equal": bool(np.array_equal(graphed[100][0], eager[100][0])),
            "k6_launches_graphed": {k: graphed[k][2] for k in graphed},
            "k6_launches_eager": {k: eager[k][2] for k in eager}, "tracer": totals,
            "pairs_here": counters.get("moe.pairs_here"), "moe_passes": counters.get("moe.passes"),
            "peak_over_mean": counters.get("moe.peak_over_mean_ppm", 0) / 1e6
            / max(counters.get("moe.passes", 1), 1),
            "seconds_eager": [eager[k][1] for k in eager], "seconds_graphed": timed,
            "encode_s": encode_s, "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(line)
    check(line["greedy_equal"] and line["sampled_equal"],
          "mla_moe: graphed tokens differ from the eager path's")
    check(all(graphed[k][2] == eager[k][2] > 0 for k in graphed),
          f"mla_moe: K6 launches {line['k6_launches_graphed']} graphed, "
          f"{line['k6_launches_eager']} eager")
    launches = sum(r[2] for r in (*eager.values(), *setup, *graphed.values()))
    return {"mla_decode": launches}, k6[249]


# ------------------------------------------------------------ K7: top-k


def _top_k_logits(b, width, gen):
    """(b, width) float32 logits on the card: rows of N(0, 9), then among
    the first rows those that make a top k hard: all equal, all -inf, five
    levels (ties everywhere), +0.0 and -0.0 across the cut, NaN of both
    signs and two payloads with +-inf and zeros, sorted ascending, a tie of
    seven across the 100th place, NaN and infinities scattered."""
    x = torch.randn(b, width, generator=gen, device="cuda") * 3
    spots = torch.randperm(width, generator=gen, device="cuda")
    n = min(150, width)
    rows = [
        torch.full((width,), 1.5, device="cuda"),
        torch.full((width,), float("-inf"), device="cuda"),
        torch.randint(0, 5, (width,), generator=gen, device="cuda").float(),
        -x[3].abs() - 1,
        x[4].clone(),
        x[5].sort().values,
        -torch.rand(width, generator=gen, device="cuda") - 1,
        x[7].clone(),
    ]
    rows[3][spots[:n:2]] = 0.0
    rows[3][spots[1:n:2]] = -0.0
    specials = torch.from_numpy(np.array(
        [0x3F800000, 0xFFC00000, 0x7FC00000, 0xFF800000, 0x7F800000, 0, 0x80000000, 0x7FC00001,
         0x80000000, 0], np.uint32).view(np.float32)).cuda()
    m = min(10, width)
    rows[4][:m] = specials[:m]
    rows[4][spots[-m:]] = specials[:m]
    top = spots[: min(95, width // 2)]
    rows[6][top] = 10 + torch.rand(top.numel(), generator=gen, device="cuda")
    rows[6][spots[width // 2: width // 2 + min(7, width // 4)]] = 5.0
    m = min(40, width)
    rows[7][spots[:m:4]] = float("nan")
    rows[7][spots[1:m:4]] = float("inf")
    rows[7][spots[2:m:4]] = float("-inf")
    for r, row in enumerate(rows[:b]):
        x[r] = row
    return x


def _top_k_case(label, logits, k, timed):
    """K7 against the stable sort (its plain version) on the card: values
    as bits and indices equal, the kernel's output repeating; at the main
    paths' shapes, kernel, bound, plain and library (torch.topk) ms."""
    from coati_tpu_torch.ops.kernels.top_k import row_threads, top_k, top_k_plain

    before = top_k.launches
    vals, idxs = top_k(logits, k)
    again = top_k(logits, k)
    torch.cuda.synchronize()
    ref_vals, ref_idxs = top_k_plain(logits, k)
    ref_vals = ref_vals.contiguous()
    same_vals = torch.equal(vals.view(torch.int32), ref_vals.view(torch.int32))
    same_idxs = torch.equal(idxs, ref_idxs)
    rows_off = int(((vals.view(torch.int32) != ref_vals.view(torch.int32)).any(-1)
                    | (idxs != ref_idxs).any(-1)).reshape(-1).sum())
    line = {"phase": "top_k", "case": label, "shape": list(logits.shape), "k": k,
            "threads": row_threads(logits.shape[-1], k), "values_equal": same_vals,
            "indices_equal": same_idxs, "rows_differing": rows_off,
            "repeat_equal": bool(torch.equal(vals.view(torch.int32), again[0].view(torch.int32))
                                 and torch.equal(idxs, again[1])),
            "launches": top_k.launches - before,
            "vals_contiguous": vals.is_contiguous() and idxs.is_contiguous()}
    if timed:
        rows = logits.numel() // logits.shape[-1]
        n_bytes = logits.numel() * 4 + rows * k * (4 + 8)
        bound, by = bound_ms(n_bytes, 0.0, torch.float32)
        line.update({"ms": time_ms(lambda: top_k(logits, k)), "bound_ms": bound, "bound_by": by,
                     "plain_ms": time_ms(lambda: top_k_plain(logits, k)),
                     "library_ms": time_ms(lambda: torch.topk(logits, k, dim=-1)),
                     "max_abs_err": 0.0 if same_vals else float("inf")})
    emit(line)
    check(same_vals and same_idxs and line["repeat_equal"] and line["launches"] == 2
          and line["vals_contiguous"], f"top_k {label}: {line}")
    return line


def phase_top_k(model=None, tok=None):
    """K7 (csrc/top_k.cu) on the card: against the stable sort bit for bit
    on adversarial rows at COATI's and COATI2's decode shapes (B 1024 x
    13,603 and x 4,266, k 100), the serving engine's 65 rows, 3-D and padded
    rows, narrow rows (cub's block sort and, at 128 and under, PyTorch's
    comparison sort) and the largest k and width, the sort past k 128, and
    a ValueError for inputs outside the kernels' rule; kernel / bound / plain /
    library ms at the two decode shapes; then the trained document's
    production round trip of 1,024 corpus SMILES at k 100, seeded, through
    K7 and through the stable sort: the same tokens, and one K7 launch a
    decode step. Returns (the launches of the round trips, the case at B 1024
    x 13,603)."""
    from coati_tpu_torch.common import tracing
    from coati_tpu_torch.models.api import COATI
    from coati_tpu_torch.ops import sampling
    from coati_tpu_torch.ops.kernels.top_k import top_k, top_k_plain

    gen = torch.Generator(device="cuda").manual_seed(24)
    main = _top_k_case("coati_decode", _top_k_logits(1024, 13603, gen), 100, timed=True)
    _top_k_case("coati2_decode", _top_k_logits(1024, 4266, gen), 100, timed=True)
    _top_k_case("serving_pool", _top_k_logits(65, 13603, gen), 100, timed=False)
    _top_k_case("three_d", _top_k_logits(2 * 256, 4266, gen).view(2, 256, 4266), 100, timed=False)
    _top_k_case("padded_rows", _top_k_logits(300, 13603, gen)[:, :12000], 100, timed=False)
    _top_k_case("block_sort_width", _top_k_logits(1024, 1000, gen), 100, timed=False)
    _top_k_case("comparison_sort_width", _top_k_logits(256, 128, gen), 128, timed=False)
    _top_k_case("narrow", _top_k_logits(64, 100, gen), 7, timed=False)
    _top_k_case("widest", _top_k_logits(16, 32768, gen), 128, timed=False)
    _top_k_case("k2", _top_k_logits(1024, 13603, gen), 2, timed=False)
    _top_k_case("sort_bulk_k1000", _top_k_logits(1024, 13603, gen), 1000, timed=True)
    _top_k_case("sort_whole_row", _top_k_logits(256, 4266, gen), 4266, timed=False)
    _top_k_case("sort_k129", _top_k_logits(64, 300, gen), 129, timed=False)
    _top_k_case("sort_widest", _top_k_logits(16, 32768, gen), 32768, timed=False)
    logits, refused, before = _top_k_logits(64, 1000, gen), {}, top_k.launches
    for label, x, k in (("k_past_width", logits, 1001), ("k0", logits, 0),
                        ("bfloat16", logits.bfloat16(), 100), ("strided", logits[:, ::2], 100),
                        ("widest_plus_one", _top_k_logits(16, 32769, gen), 100)):
        try:
            top_k(x, k)
        except ValueError as err:
            refused[label] = str(err)
    emit({"phase": "top_k_refused", "refused": refused, "launches": top_k.launches - before})
    check(len(refused) == 5 and top_k.launches == before,
          f"top_k: the card took an input outside the kernels' rule: {refused}")

    if model is None:
        model, tok = load_model()
    prod = COATI(model.params, model.config.replace(dtype="bfloat16"), seed=0)
    tokens = _tokens(tok, (BENCH_SMILES * 64)[:1024], tok.n_seq)
    keep = _KeepRows(tok)

    def run(seed):
        prod._generator.manual_seed(seed)
        _, _, seconds, launches = _round_trip(prod, keep, tokens, k=100, inv_temp=2.0)
        return keep.rows, seconds, launches

    run(3)  # warm-up: the decode graph is captured on a key's second use
    run(3)
    tracing.reset()
    tracing.start()
    kernel = [run(30 + i) for i in range(3)]
    steps = tracing.snapshot()["spans"].get("decode.step", {}).get("count", 0)
    tracing.stop()
    real = sampling.top_k
    sampling.top_k = top_k_plain
    try:
        plain = [run(30 + i) for i in range(3)]
    finally:
        sampling.top_k = real
    launches = sum(r[2]["top_k"] for r in kernel)
    line = {"phase": "top_k_round_trip", "batch": 1024, "k": 100, "inv_temp": 2.0,
            "seeds": [30, 31, 32],
            "tokens_equal": all(np.array_equal(a[0], b[0]) for a, b in zip(kernel, plain)),
            "decode_steps": steps, "k7_launches": launches,
            "plain_launches": sum(r[2]["top_k"] for r in plain),
            "seconds_k7": [r[1] for r in kernel], "seconds_stable_sort": [r[1] for r in plain]}
    emit(line)
    check(line["tokens_equal"], "top_k: the round trip's tokens differ from the stable sort's")
    check(launches == steps > 0 and line["plain_launches"] == 0,
          f"top_k: {launches} K7 launches over {steps} decode steps")
    _profile(lambda: run(33), "top_k_round_trip", statistics.median(line["seconds_k7"]))
    return {"top_k": launches}, main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import coati_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)

    started = time.perf_counter()
    emit(host_cpu())
    if sys.argv[1:] == ["mla_moe"]:  # that phase alone
        phase_mla_moe()
        emit({"ok": True, "phase": "mla_moe"})
        return 0
    if sys.argv[1:] == ["train_graph"]:  # that phase alone
        phase_train_graph()
        emit({"ok": True, "phase": "train_graph"})
        return 0
    if sys.argv[1:] == ["top_k"]:  # that phase alone
        phase_build()
        phase_top_k()
        emit({"ok": True, "phase": "top_k"})
        return 0

    def lap(phase):
        emit({"phase": "elapsed", "after": phase, "seconds": time.perf_counter() - started})

    phase_build()
    lap("build")
    chosen = phase_kernels()
    lap("kernels")
    phase_routing()
    lap("routing")
    phase_chem()
    lap("chem")
    model, tok = load_model()
    paths = {}
    paths["smiles"], flash_run = phase_smiles(model, tok)
    lap("smiles")
    paths["points"] = phase_points(model, tok)
    lap("points")
    paths["points_from_smiles"] = phase_points_from_smiles(model, tok)
    lap("points_from_smiles")
    paths["packed"] = phase_packed(model, tok, flash_run)
    lap("packed")
    phase_k1_positions(model.config.n_layer_xformer)
    lap("k1_positions")
    phase_decode_graph(model, tok)
    lap("decode_graph")
    paths["top_k"], chosen["top_k"] = phase_top_k(model, tok)
    lap("top_k")
    del model
    paths["mla_moe"], chosen["mla_decode"] = phase_mla_moe()
    lap("mla_moe")
    torch.cuda.empty_cache()
    paths["coati2"] = phase_coati2()
    lap("coati2")
    paths["train"] = phase_train()
    lap("train")
    phase_train_graph()
    lap("train_graph")
    phase_train_fp32_vs_plain()
    lap("train_fp32_vs_plain")
    paths["coati2_train"] = phase_coati2_train()
    lap("coati2_train")
    phase_coati2_fp32_vs_plain()
    lap("coati2_fp32_vs_plain")
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        phase_dataset_pool(work / "data")
        lap("dataset_pool")
        paths["train_restart"] = phase_train_restart(work / "data", work / "ckpt")
        lap("train_restart")
        paths["lora"] = phase_lora(work)
        lap("lora")
    model, tok = load_model()
    from coati_tpu_torch.models.api import COATI

    prod = COATI(model.params, model.config.replace(dtype="bfloat16"), seed=0)
    paths["generative"] = phase_generative(prod, tok)
    lap("generative")
    paths["serving"] = phase_serving(model, prod, tok)
    lap("serving")
    paths["metadynamics"] = phase_metadynamics(prod, tok)
    lap("metadynamics")
    del model
    torch.cuda.empty_cache()
    paths["examples"] = phase_examples(prod, tok)
    lap("examples")
    del prod
    torch.cuda.empty_cache()
    paths["decode_quality"] = phase_decode_quality()
    lap("decode_quality")
    torch.cuda.empty_cache()
    paths["multi_device"] = phase_multi_device()
    lap("multi_device")
    emit({"phase": "launches", "by_path": paths})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: unavailable")
    csrc, pallas = "coati_tpu_torch/csrc/", "coati_tpu/ops/pallas/"
    sources = {
        "flash_causal_attention": ("flash_attention.cu", "flash_attention.py:121"),
        "decode_attention": ("decode_attention.cu", "decode_attention.py:205"),
        "decode_attention_quant": ("decode_attention.cu", "decode_attention.py:205"),
        "egnn_messages": ("egnn_messages.cu", "egnn_messages.py:205"),
        "packed_causal_attention": ("packed_attention.cu", "packed_attention.py:142"),
        "egnn_messages_backward": ("egnn_messages_bwd.cu", "egnn_messages.py:329"),
        "packed_causal_attention_backward": ("packed_attention_bwd.cu",
                                             "packed_attention.py:282"),
        "mla_decode": ("mla_decode.cu", None),  # K6: the JAX package has no latent attention
        "top_k": ("top_k.cu", None),  # K7: the JAX package's sampler takes lax.top_k
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        c = chosen[name]
        launches = sum(counts.get(name, 0) for counts in paths.values())
        check(launches > 0, f"{name} was not launched on any main path")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source, "replaces": pallas + replaces if replaces else "none",
            "launches": launches, "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "ok": True,  # every case of every kernel passed, or phase 2 exited
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
