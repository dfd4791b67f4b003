#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``quantization_tpu_torch``) on one H100.

Phases, each of which raises (and exits nonzero) when its check fails:

1. build the six CUDA sources of ``quantization_tpu_torch/csrc``, one
   ``nvcc`` per source, started together;
2. decode (K1) at B=65,536, d512: bit-exact against its plain PyTorch
   version on the card; kernel, plain and ``F.embedding_bag`` times;
3. seqbeam v2 encode (K2) at every K2 rung of ``ops.ladder.LADDERS`` (d1280's
   in the kernel's wide instantiations), on 32,768 in-distribution frames: at least 99.5%
   of indexes equal to the plain version and summed squared error within
   0.1% (``ops.quality_guard.against_plain``); kernel and plain times on
   the same inputs.  At auto's rungs (d512 int8 E, d256 bf16 E, d1280 int8
   E) the stage-timed build (``ops.seqbeam.seqbeam_stages``) gives the
   same indexes and prints the ``[seqbeam stages]`` line: each stage's
   share of the warps' cycles and its microseconds a block-step;
4. the main path, for the four committed trained quantizers (d512 / 8 B,
   d256 / 4 B, d1280 / 8 B and d1280 / 16 B):
   ``load_quantizer`` -> ``Quantizer.encode(x)`` (``search_method="auto"``)
   -> ``decode(codes, use_kernel=True)`` on 32,768 frames, with the launch
   counts set to 0 just before and read just after, of whichever search
   kernel auto takes (K3 on a gramv3 rung, K2 on a seqbeam one); on a gramv3
   rung its launches by codebooks (``ops.gramv3.NC_LAUNCHES``) and its
   ``gramv3.launch`` spans (``g_dtype``, ``nc``, ``rows``) must count them,
   the count of launches that load all rows a candidate
   (``ops.gramv3.ALL_ROWS_LAUNCHES``) every bf16 launch at 16 codebooks and
   none below, and at
   d1280 / 16 B (K3 at 16 codebooks) the stage-timed build prints its
   ``[gramv3 stages]`` entry.  The path's
   own outputs are held against the plain versions on its own inputs: its
   indexes against that kernel's plain version (the bars of phase 3) and
   its reconstruction against the plain decode of those indexes
   (bit-exact).  The squared error on 8,192 of the frames must be within
   1.012 x the port's beam-5 on the same frames; encode and decode
   vectors/s.  The call launches the initial indexes' kernel
   (``ops.logits_argmax``) once a search, counted apart.  Then that kernel
   alone (``[logits_argmax ...]`` lines) at the bulk calls' 8,192 frames
   (d512, d1280, d256, d1280 / 16 B) and the stream's 512 (d512): its tables' kernel
   equal to their plain build bit for bit; its indexes and its
   plain version's equal the f64 argmax wherever its top-two gap is decided
   (``f64_argmax``), and each at least 99.95% of the other's and of the f32
   GEMM's it replaced; its time beside its bound (the split product's TF32
   operations), its plain version's and the library chain's (f32
   ``torch.matmul``, bias, argmax);
5. the Gram-table encode (K3) on the serving path: ``Quantizer.encode(x,
   search_method="gramv3")`` (5 passes, M=8, R=4) on the same 32,768 frames
   of both trained quantizers, with bf16 and int8 tables, and at d512 also
   with the ``altparity`` schedule; each launches K3 (counted around the
   call), its indexes are held against the plain gramv3 on the same problem
   (every index equal), and its squared error against 1.012 x beam-5;
   kernel, plain, bound and the encode time split into precompute +
   kernel + rest, the precompute by device time into the logits-argmax
   init, the Gram table, XC, ``ss0`` and the table's layout.  At d512 bf16,
   d512 int8 and d256 bf16 the stage-timed build
   (``ops.gramv3.gramv3_stages``) gives the same indexes and prints the
   ``[gramv3 stages]`` line: each stage's share of the warps' cycles and
   its microseconds a frame-step, with registers and blocks an SM.  Then
   K3 at 16 codebooks on seeded d1280 codebooks
   (``experiments/gramv3_nc16.py``): every index against plain, its ms at
   3, 4 and 5 passes in bf16 and int8, registers, blocks an SM and shared
   memory, the stage split with load's share, and ptxas's lines of every
   instantiation, each printed beside the committed figures of the build
   that staged the shared rows at 16 codebooks in bf16 too (a comparison
   that never raises); K3's entry holds only this run's numbers, and its
   launches count only the checks';
6. training at full width: ``QuantizerTrainer(dim=512, bytes_per_frame=8,
   phase_one_iters=4, phase_two_iters=6)`` on batches of 600 frames, driven
   with ``step_many`` across the phase switch, for ``train_search`` "auto"
   (the exact beam), "gramv3", "gramv3-int8" and "seqbeam" (with
   ``beam_finetune_iters=0``, so that phase 2 runs the kernel).  Checks: K3
   (K2 for "seqbeam") launches in phase 2, the config switches from 16 x 16
   to 8 x 256, every loss term is finite, the kernel's indexes on a phase-2
   batch equal its plain version's (K2: the bars of phase 3), and a
   checkpoint saved mid-phase-2 and loaded gives, after two more steps on
   both trainers, equal parameters.  Phase-1 and phase-2 steps/s: the
   median over whole fresh runs, the searches interleaved, of each phase's
   ``step_many`` time;
7. the rest of seqbeam, on phase 4's 32,768 frames of both trained
   quantizers, through ``Quantizer.encode(x, search_method="seqbeam",
   refine_indexes_iters=passes, **kw)``: v1 (``impl="v1"``, M=16, R=8, 3
   passes) at d512 and d256, and at d512 int8 E with ``requant="pass"``, the
   guard's ``bound``, ``bound_fi`` and ``lazy`` candidates, and bf16 E with
   ``lazy_r1``.  Each launches its kernel (v1 its own count, counted around
   the call), its indexes pass the bars of phase 3 against the plain version
   on the same problem, and its squared error is within 1.012 x beam-5.
   v1's stage-timed build gives the same indexes and prints a second
   ``[seqbeam stages]`` line, as phase 3's.
   v1 holds to ported v2 at the same M, R and passes (f32 E, all-pool) as
   in the JAX tests (>= 95% of indexes equal, squared error within 1e-3),
   each lazy config to its eager twin (>= 98%, within 2e-3), and pass and
   bound end below their initial indexes' error.  Quality vs beam-5,
   kernel, plain and bound ms, and encode vec/s.  Then the beams whose E
   leaves the block (the spill layout: bf16 E with M=64 at d640 and d1024,
   f32 E with M=64 at d512 and d1024 and M=32 at d768, v1 with M=24 at
   d1024 and M=64 at d384), each at B=1,024 on seeded codebooks against its
   plain version (the bars of phase 3), with kernel, plain and bound ms;
8. the primitive probes, ``quantization_tpu_torch.experiments.prim_bench``
   (P1-P4: minround, gather, matmul, assembly) and ``.int8_mxu_probe`` (P5,
   P6: the "bf16" and int8 rescore chains), at the JAX scripts' shapes and
   K on seeded inputs with the scripts' distributions.  Each probe's own
   path (the per-iteration slope through its dispatcher; one timed run of
   each chain) runs with its launch count set to 0 just before and read
   just after, and must launch its kernel.  Each kernel is then held
   against its plain version on the same inputs at both K: P1, P2, P4 and
   P6 bit-exact, P3 within 1e-5 of the sum of |terms|, P5 at >= 99.99% of
   elements equal, the rest within one bf16 ulp, and every element the
   chain changes equal.  Per-iteration (P1-P4) or per-chain (P5, P6)
   kernel, plain, bound and library times.  P5 has two bounds: the split-c
   scheme's bf16 products on the tensor cores (``bound_ms``) and the f32
   FMAs of the plain arithmetic (``bound_f32_ms``); beside it, the kernels
   a chain launches (``torch.profiler``), which must be P5's own two.  P3
   prints the ``[matmul stages]`` line from its stage-timed build (whose
   output must equal the shipped kernel's at both K): each stage's share of
   the warps' cycles at each K and a warp's clocks an iteration (the slope
   between the two K), with its registers and blocks an SM.  P6
   prints the ``[int8_chain stages]`` line from its stage-timed build (whose
   output must equal the shipped kernel's): each stage's share of the
   warps' cycles and its microseconds a block-step, with registers and
   blocks an SM, and its barrier floor (its grid running its 24 barriers
   and no other work) beside its bound; a chain must launch its own
   kernel and no other.  P1 and P2 print their floors beside their bounds
   (``floor_ms``): P1's ``[floor minround]``, a chain of warp-wide
   reductions on its grid (measured), with its fixed cost a call
   (``fixed_ms``: the device time at the first K less its rounds); P2's
   ``[floor gather]``, its shared loads from fixed rows with no index math
   (measured), beside the rate the SMs serve them (computed, on that line
   only).  Each floor kernel's output is checked before it is timed.  P2's
   library time is one ``torch.gather`` of its table, an iteration's work.

9. the CLI at full width (``python -m quantization_tpu_torch``, called in
   process through ``cli.main``, decode as a subprocess), in a temporary
   directory deleted at the end: a 524,288-frame d512 corpus of the key-42
   sampler (seed 11) written as 3 raw-f16 shards of at most 200,000 frames;
   ``ShardStream`` must run the native loader.  ``train`` (4 + 4 steps,
   batch 600) writes a quantizer that loads, is 8 x 256 and has a finite
   loss; ``encode`` of the whole corpus with the defaults and the committed
   d512 quantizer must launch auto's search kernel once a batch (64), its
   codes on rows 0-32,767 and 196,608-204,799 (the first shard boundary)
   must equal
   ``Quantizer.encode`` of the same batches bit for bit, pass phase 3's bars
   against its plain version and stay within 1.012 x beam-5 on 8,192
   frames; ``decode`` must exit 0 and give rows 65,000-66,000 and the last
   1,000 equal to ``Quantizer.decode`` bit for bit.  ``profile_device_ops``
   traces one CLI encode of 131,072 frames (the card's busy share, its top
   5 rows, which must hold that kernel) and one phase-1 and one phase-2
   training step for ``train_search`` "auto" and "gramv3" (top 8 rows, busy share).
10. the aux models at full width.  (a) ``QuantizerTrainer(dim=512,
   bytes_per_frame=8, init="multi_kmeans", init_data=<the guard's 8,192
   seed-7 frames>, init_iters=300, train_search="gramv3",
   beam_finetune_iters=0)``, 4 + 6 steps: ``to_logits_w`` equals the fitted
   centers in its own storage, the fit's ``compute_ref_loss`` on the seed-8
   frames ends below its start, ``step_many`` across the phase switch
   launches K3 once in each of 3 phase-2 steps (every index equal to plain
   on a phase-2 batch), every loss term is finite; the fit's seconds.  (b)
   ``MultiKmeansTrainer(dim=512, codebook_size=4, num_codebooks=16,
   num_stages=3, iters_per_stage=20)`` at batch 512: 16 x 4 -> 8 x 16 -> 4 x
   256, finite losses, ``encode(as_bytes=True)`` of 8,192 frames (8192, 4)
   uint8 whose decode equals the unpacked codes' bit for bit; steps/s a
   stage.  (c) ``PredictorTrainer`` against the d512 and d256 quantizers
   (hidden 512, batch 512, 50 steps each): auto's search kernel once a
   step, the targets held against its plain version, finite losses, the
   mean CE of the last 10 steps below the first 10's; at d512 the checkpointed predictor's
   gradients within 1e-6 relative of the plain ones, and one traced step
   (top 5 rows hold that kernel; busy share); steps/s.  (d), run in phase
   9's corpus: ``train --init multi_kmeans`` (4 + 4 steps, batch 600) writes an
   8 x 256 quantizer that loads, with finite losses.
11. multi-device runs (``quantization_tpu_torch.parallel``) at full width,
   each against one process.  (a) One rank over NCCL in this process
   (world 1, so every collective goes through NCCL): ``encode_sharded``
   (auto's search kernel) and ``decode_sharded(use_kernel=True)`` (K1) on
   phase 4's 32,768 frames equal ``Quantizer.encode`` and ``decode`` bit for bit, and
   ``QuantizerTrainer(mesh=...)`` at d512 / 8 B, 4 + 4 steps, batch 600,
   ``train_search="gramv3"`` (K3 once in each of the 4 phase-2 steps) ends
   with parameters equal to the same run without a mesh.  (b) Two ranks,
   two processes on the one card, over gloo (NCCL refuses two ranks on one
   device), a 2 x 1 mesh: each rank encodes 16,384 of the frames (auto), the
   codes equal phase 4's, the decode (K1) equals it, and the data-parallel
   trainer runs (300 + 300 frames a step, gramv3, K3 once a phase-2 step).
   (c) The same two ranks as a 1 x 2 model mesh: the trainer with the
   beam.  Each trainer is held to one process step by step from the same
   state (``_lockstep``): every step's training indexes must agree at
   least at phase 3's 99.5%, at least half the steps on every index, and
   on those steps the loss terms and the summed gradients must be within
   ``rtol=2e-4, atol=2e-5`` (the CPU tests') of one process's.  Whole free
   runs are not held to that tolerance at this width: Adam turns the sign
   of a gradient near 0 into a step of lr, so a one-process run on the same
   rows reordered is as far off (PERF.md, phase 11); their distance is
   printed.  Both ranks' parameters must be equal, each rank runs under a
   timeout and must exit 0.  ``[parallel ...]`` lines give the wall
   seconds of the encodes and the training runs (each rank warmed first);
   two ranks on one card measure no scaling.

12. the quality-parity run (``quantization_tpu_torch.experiments.head_to_head``,
   the function its entry point calls): d512 / 8 B, 1000 + 1000 steps,
   batch 300 (the batch of the JAX package's record), the exact beam, seed
   0, one process, then the eval on 2,048 frames, with the launch counts set
   to 0 just before and read just after (K2 or K3 by the eval's
   ``encode(auto)``, K1 by its kernel decode).  Held to bars (i)-(iii): the final relative
   error within 1.01 x the reference's recorded 0.58556, within 1% of the
   JAX package's 0.58486, and the auto encode with the kernel decode within
   +1.2% of the beam; a ``[parity ...]`` line.

``[rule 2]`` ranks every kernel: first those slower than their library
call, by how many times, then the rest by launches x (ms - bound ms), over
the paths (K2, K3, B4) or their own run (K1, the probes).

The output ends with the ``paths`` JSON line, the card's ``nvidia-smi``
name and power limit, one JSON line with the kernels' numbers, and the
device line.  Without a CUDA card it exits nonzero before printing any
result.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import sys
import tempfile
import time

import torch

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# dense tensor-core rates for bf16 and int8; "f32" is the rate of a plain
# FP32 add outside the tensor cores: the 67e12/s of the data sheet counts an
# FMA as two operations, so one add a cycle is half of it
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 33.5e12}
ROOT = pathlib.Path(__file__).resolve().parent
# the committed trained quantizers by (dim, num_codebooks), and each dim's first
TRAINED = {(512, 8): ROOT / "experiments/q512_8_full.npz",
           (256, 4): ROOT / "experiments/q256_4_full.npz",
           (1280, 8): ROOT / "quantization_tpu_torch/experiments/q1280_8_full.npz",
           (1280, 16): ROOT / "quantization_tpu_torch/experiments/q1280_16_full.npz"}
FIRST = {512: (512, 8), 256: (256, 4), 1280: (1280, 8)}
# auto's rungs: the timed build
STAGE_CONFIGS = ("seqbeam_int8e_d512", "seqbeam_hl_d256", "seqbeam_int8e_d1280")
PRED_DIMS = (512, 256)  # the predictor's quantizers (phase 10)
# (quantizer, B): each cell's call
LOGITS_SHAPES = (((512, 8), 8192), ((1280, 8), 8192), ((256, 4), 8192), ((512, 8), 512),
                 ((1280, 16), 8192))
DECODE_B = 65536
CHECK_B = 8192
TIME_B = 32768
BAR = 1.012
V1 = dict(impl="v1", M=16, R=8)  # the JAX wrapper's defaults
V1_PASSES = 3
GRAM_CONFIGS = ((512, "bf16", None), (512, "int8", None), (512, "bf16", "altparity"),
                (256, "bf16", None), (256, "int8", None))  # (dim, g_dtype, pool_mask)
# auto's K3 rungs whose stage-timed build phase 4 runs on the main path
GRAM_STAGE_RUNGS = ("gramv3_bf16_alt4_d1280_b16",)
GRAM_PASSES = 5  # encode's default refine_indexes_iters
TRAIN_BATCH = 600  # the CLI's default batch (quantization_tpu/cli.py:243)
TRAIN = dict(dim=512, bytes_per_frame=8, phase_one_iters=4, phase_two_iters=6, seed=0,
             diagnostics=False)
TRAIN_SEARCHES = ("auto", "gramv3", "gramv3-int8", "seqbeam")
TRAIN_TIME_ROUNDS = 5  # whole runs of each search, interleaved, for step times
CHECK_KEYS = ("frames", "index_agreement", "sse_rel_diff", "max_abs_err")
# (impl, e_dtype, M, dim): beams that take the spill layout, on seeded codebooks
# (experiments/seqbeam_times.py::seeded_problem)
SPILL_BEAMS = (("v2", "bf16", 64, 640), ("v2", "bf16", 64, 1024), ("v2", "f32", 64, 512),
               ("v2", "f32", 64, 1024), ("v2", "f32", 32, 768), ("v1", "f32", 24, 1024),
               ("v1", "f32", 64, 384))
SPILL_B = 1024
CLI_FRAMES = 524288  # phase 9's corpus: 64 encode batches at the CLI's default
CLI_SHARD = 200000
CLI_BATCH = 8192  # the CLI's encode default (quantization_tpu_torch/cli.py)
CLI_PROFILE_LIMIT = 131072  # 16 batches traced
AUX_INIT_ITERS = 300  # the trainer's default multi-kmeans fit
AUX_STAGE_ITERS = 20
AUX_PRED_STEPS = 50
PARALLEL_TRAIN = dict(TRAIN, phase_two_iters=4)  # phase 11's runs: 4 + 4 steps
PARALLEL_TIMEOUT_S = 300  # phase 11's two ranks, from their start
PARITY = (512, 8, 1000, 1000, 300)  # phase 12: dim, bytes, P1, P2, batch (the JAX record's)
ENCODE_ROWS = ((0, 32768), (196608, 204800))  # whole batches; the second straddles 200,000
DECODE_ROWS = ((65000, 66000), (CLI_FRAMES - 1000, CLI_FRAMES))  # the first crosses 65,536


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def auto_search(config, x, iters: int = 5) -> dict:
    """What ``encode(x)`` with auto runs: its rung (``name``, ``passes``,
    ``kw``: the problem's arguments), the search kernel's name in the
    ``kernels`` line (``kernel``) and in a trace (``op``), its launch
    count, its problem builder, the kernel and its plain version on a
    problem, and its bound at ``B`` frames (``bound(B)``): K3 on a gramv3
    rung, K2 on a seqbeam one."""
    from quantization_tpu_torch.ops import gramv3 as K3
    from quantization_tpu_torch.ops import ladder
    from quantization_tpu_torch.ops import seqbeam as K2

    rung = ladder.pick(config, x, iters)
    K, passes, sem, nc = rung.kernel, rung.passes, rung.beam, config.num_codebooks
    kernel, op, bound = {
        K3.GRAMV3: ("gramv3", "gramv3_kernel",
                    lambda B: _gramv3_bound(B, nc, passes, sem["M"], sem["g_dtype"])),
        K2.SEQBEAM: ("seqbeam_v2", "seqbeam_kernel",
                     lambda B: _seqbeam_bound(B, config.dim, nc, passes, sem["M"],
                                              sem["e_dtype"])),
    }[K]
    return dict(name=rung.name, passes=passes, kw=sem, kernel=kernel, op=op, counter=K.entry,
                problem=K.problem, cuda=K.cuda, plain=K.plain, bound=bound)


def launch_counters() -> dict:
    """The launch counts of K1, K2 and K3, by their ``kernels`` line names."""
    from quantization_tpu_torch.ops import decode, gramv3, seqbeam

    return {"decode": decode.DECODE_KERNEL, "seqbeam_v2": seqbeam.SEQBEAM_KERNEL,
            "gramv3": gramv3.GRAMV3_KERNEL}


def host_s(fn, reps: int) -> float:
    """Best host seconds of ``fn`` (ending in a synchronize) over ``reps``."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from quantization_tpu_torch import load_quantizer
    from quantization_tpu_torch.core import codec
    from quantization_tpu_torch.core.types import scaled_centers
    from quantization_tpu_torch.data.synthetic import make_mlp_sampler
    from quantization_tpu_torch.ops import cuda_build
    from quantization_tpu_torch.ops import decode as K1
    from quantization_tpu_torch.ops import gramv3 as K3
    from quantization_tpu_torch.ops import logits_argmax as LA
    from quantization_tpu_torch.ops import seqbeam as K2
    from quantization_tpu_torch.ops.ladder import LADDERS
    from quantization_tpu_torch.ops.quality_guard import against_plain
    from quantization_tpu_torch.utils import spans
    from quantization_tpu_torch.utils.device import device_ms, nvidia_smi_line

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {smi}", flush=True)

    # ---- 1. build
    sources = ("decode", "seqbeam", "gramv3", "logits_argmax", "prim_bench", "int8_mxu_probe")
    build_s = cuda_build.build(sources)
    print(f"[build] {build_s:.1f} s", flush=True)
    for name in sources:
        regs = [l.strip() for l in cuda_build.build_log(name).splitlines() if "registers" in l]
        print(f"[build] {name}: {len(regs)} kernels; {regs[0] if regs else ''}", flush=True)

    quantizers = {key: load_quantizer(path, device=dev) for key, path in TRAINED.items()}
    samplers = {dim: make_mlp_sampler(dim, device=dev) for dim, _ in TRAINED}

    def frames(dim, seed, n):
        return samplers[dim](torch.Generator().manual_seed(seed), n)

    # ---- 2. decode, K1
    q = quantizers[FIRST[512]]
    nc, cs, D = q.num_codebooks, q.codebook_size, q.dim
    cb = scaled_centers(q.params, q.config.scale_speed).detach().to(torch.bfloat16).contiguous()
    idx = torch.randint(0, cs, (DECODE_B, nc), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0)).to(dev)
    got = K1.decode_cuda(idx, cb)
    torch.cuda.synchronize()
    want = K1.decode_plain(idx, cb)
    check(bool(torch.equal(got, want)), "decode kernel is not bit-exact against its plain version")
    table = cb.float().reshape(nc * cs, D)
    flat = (idx + cs * torch.arange(nc, dtype=torch.int32, device=dev)).long()
    lib_out = F.embedding_bag(flat, table, mode="sum")
    k1 = {
        "name": "decode", "route": "cuda", "source": "quantization_tpu_torch/csrc/decode.cu",
        "replaces": "quantization_tpu/ops/decode.py:32",
        "shape": f"B={DECODE_B} nc={nc} cs={cs} D={D}",
        "max_abs_err": float((got - want).abs().max()),
        "library_max_abs_diff": float((lib_out - want).abs().max()),
        "ms": device_ms(lambda: K1.decode_cuda(idx, cb), 50),
        "plain_ms": device_ms(lambda: K1.decode_plain(idx, cb), 10),
        "library_ms": device_ms(lambda: F.embedding_bag(flat, table, mode="sum"), 50),
    }
    k1_bytes = DECODE_B * nc * 4 + nc * cs * D * 2 + DECODE_B * D * 4
    k1_ops = DECODE_B * nc * D
    k1.update(_bound(k1_bytes, {"f32": k1_ops}))
    print(f"[decode] bit-exact; kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, "
          f"embedding_bag {k1['library_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms", flush=True)

    # ---- 3. encode, K2, at every K2 rung of auto's ladder
    k2_configs, stage_lines = [], []
    for key, rung in [(key, r) for key, rungs in LADDERS.items() for r in rungs
                      if r.kernel is K2.SEQBEAM]:
        qq, dim = quantizers[key], key[0]
        name, passes, sem = rung.name, rung.passes, rung.beam
        pt = K2.seqbeam_problem(qq.params, qq.config, frames(dim, 8, TIME_B), passes=passes,
                                **sem)
        chk = against_plain(pt, qq.get_centers().detach())
        check(chk["ok"], f"{name}: kernel vs plain at B={TIME_B}: {chk}")
        entry = {
            "config": name, "shape": f"B={TIME_B} D={dim} nc={qq.num_codebooks} passes={passes}",
            **sem, **{k: chk[k] for k in CHECK_KEYS},
            "ms": device_ms(lambda: K2.seqbeam_cuda(pt), 5),
            "plain_ms": device_ms(lambda: K2.seqbeam_plain(pt), 2),
        }
        entry.update(_seqbeam_bound(TIME_B, dim, qq.num_codebooks, passes, sem["M"],
                                    sem["e_dtype"]))
        k2_configs.append(entry)
        print(f"[seqbeam {name}] B={TIME_B}: agreement {chk['index_agreement']:.6f}, "
              f"sse rel diff {chk['sse_rel_diff']:+.2e}; kernel {entry['ms']:.3f} ms, "
              f"plain {entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({TIME_B / entry['ms'] * 1e3:,.0f} vec/s)", flush=True)
        if name in STAGE_CONFIGS:
            entry["stages"] = stage_breakdown(pt)
            stage_lines.append(f"{name} ({entry['stages']['summary']})")
    print("[seqbeam stages] share of the warps' cycles, us a block-step: "
          + "; ".join(stage_lines), flush=True)

    # ---- 4. the main path, per trained quantizer, through whichever search
    # kernel auto takes (K3 on a gramv3 rung, K2 on a seqbeam one)
    paths = []
    main_frames = {}  # quantizer -> (frames, beam-5 squared error on the first CHECK_B)
    launches = {"decode": 0, "seqbeam_v2": 0, "gramv3": 0, "logits_argmax": 0}
    k1_checks = [{"where": "phase 2", "shape": k1["shape"], "max_abs_err": k1["max_abs_err"]}]
    k2_checks, main_k3_checks, main_bounds, main_stage_lines = [], [], {}, []
    for key, qq in quantizers.items():
        dim, nc = key
        x = frames(dim, 9, TIME_B)
        auto = auto_search(qq.config, x)
        kernel, counter, gram = auto["kernel"], auto["counter"], auto["kernel"] == "gramv3"
        K1.DECODE_KERNEL.launches = 0
        counter.launches = 0
        n_init = LA.LOGITS_ARGMAX_KERNEL.launches
        n_nc, n_all = K3.NC_LAUNCHES[nc], K3.ALL_ROWS_LAUNCHES
        spans.start()
        codes = qq.encode(x)
        records = spans.stop()
        recon = qq.decode(codes, use_kernel=True)
        torch.cuda.synchronize()
        n_dec, n_enc = K1.DECODE_KERNEL.launches, counter.launches
        n_init = LA.LOGITS_ARGMAX_KERNEL.launches - n_init
        check(n_enc > 0, f"d{dim}: encode(auto) did not launch the {kernel} kernel")
        if gram:  # the kernel's launches by codebooks and by path, and its span's attributes
            launch_attrs = [r.attrs for r in records if r.name == "gramv3.launch"]
            g_dtype = auto["kw"]["g_dtype"]
            rows = K3.rows_path(g_dtype, nc)
            check(K3.NC_LAUNCHES[nc] - n_nc == n_enc and launch_attrs == [
                {"g_dtype": g_dtype, "nc": nc, "rows": rows}] * n_enc
                and K3.ALL_ROWS_LAUNCHES - n_all == (n_enc if rows == "all" else 0),
                f"d{dim} nc={nc}: NC_LAUNCHES {K3.NC_LAUNCHES}, ALL_ROWS_LAUNCHES "
                f"{K3.ALL_ROWS_LAUNCHES - n_all} and gramv3.launch spans {launch_attrs} for "
                f"{n_enc} launches")
        check(n_init == n_enc, f"d{dim}: {n_init} initial-index launches for {n_enc} searches")
        check(n_dec > 0, f"d{dim}: decode(use_kernel=True) did not launch the decode kernel")
        launches["decode"] += n_dec
        launches[kernel] += n_enc
        launches["logits_argmax"] += n_init
        check(codes.dtype == torch.uint8 and codes.shape == (TIME_B, qq.config.bytes_per_frame),
              f"d{dim}: codes {codes.dtype} {tuple(codes.shape)}")
        check(recon.shape == x.shape and bool(torch.isfinite(recon).all()),
              f"d{dim}: reconstruction {tuple(recon.shape)} not finite")
        # the main path's own outputs against the plain versions on its inputs
        passes, sem, make, run = auto["passes"], auto["kw"], auto["problem"], auto["cuda"]
        problem = make(qq.params, qq.config, x, passes=passes, **sem)
        indexes = codec.unpack_indexes(codes, qq.codebook_size, qq.num_codebooks)
        shape = f"B={TIME_B} D={dim} nc={qq.num_codebooks} passes={passes}"
        chk = against_plain(problem, qq.get_centers().detach(), got=indexes)
        check(chk["ok"], f"d{dim}: encode(auto) indexes vs the plain {kernel}: {chk}")
        (main_k3_checks if gram else k2_checks).append(
            {"where": f"main path d{dim}", "config": auto["name"], "shape": shape,
             **{k: chk[k] for k in CHECK_KEYS}})
        main_bounds[auto["name"]] = auto["bound"](TIME_B)["bound_ms"]
        cb = scaled_centers(qq.params, qq.config.scale_speed).detach().to(torch.bfloat16)
        want = K1.decode_plain(indexes, cb)
        dec_err = float((recon - want).abs().max())
        check(bool(torch.equal(recon, want)),
              f"d{dim}: decode(use_kernel=True) is not bit-exact against the plain decode")
        k1_checks.append({"where": f"main path d{dim}", "max_abs_err": dec_err,
                          "shape": f"B={TIME_B} nc={qq.num_codebooks} cs={qq.codebook_size} D={dim}"})
        print(f"[main d{dim}_b{nc}] vs plain on the path's own inputs ({shape}): {kernel} agreement "
              f"{chk['index_agreement']:.6f}, sse rel diff {chk['sse_rel_diff']:+.2e}; "
              f"decode bit-exact", flush=True)
        xs, cs_ = x[:CHECK_B], codes[:CHECK_B]
        beam5 = qq.encode(xs, search_method="beam")
        sse_beam = float(((qq.decode(beam5) - xs) ** 2).sum())
        main_frames[key] = (x, sse_beam)
        sse_auto = float(((qq.decode(cs_) - xs) ** 2).sum())
        sse_auto_k1 = float(((recon[:CHECK_B] - xs) ** 2).sum())
        ratio = sse_auto / sse_beam
        check(ratio <= BAR, f"d{dim}: auto/beam-5 squared error {ratio} > {BAR}")
        check(sse_auto_k1 / sse_beam <= BAR, f"d{dim}: bf16 decode error {sse_auto_k1 / sse_beam}")
        enc_s = host_s(lambda: qq.encode(x), 3)
        dec_s = host_s(lambda: qq.decode(codes, use_kernel=True), 5)
        # where the encode time goes: the problem (the init, and the tables
        # where the cache misses), then the kernel (the rest is packing and
        # Python)
        prep_ms = device_ms(lambda: make(qq.params, qq.config, x, passes=passes, **sem), 3)
        kernel_ms = device_ms(lambda: run(problem), 3)
        if auto["name"] in GRAM_STAGE_RUNGS:
            from quantization_tpu_torch.experiments.gramv3_times import \
                stage_breakdown as gram_stages

            st = gram_stages(problem)
            # the timed build takes the shipped bound too: its clock reads
            # make each load group land, so at 16 codebooks its load share
            # does not track the untimed kernel's time
            main_stage_lines.append(f"{auto['name']} (timed build, not comparable to the "
                                    f"untimed kernel's time: {st['summary']})")
        path = {
            "dim": dim, "bytes_per_frame": qq.config.bytes_per_frame, "config": auto["name"],
            "batch": TIME_B, "launches": {kernel: n_enc, "decode": n_dec},
            "search_vs_plain": (main_k3_checks if gram else k2_checks)[-1],
            "decode_bit_exact": True,
            "quality_delta_pct": (ratio - 1.0) * 100.0,
            "quality_delta_pct_bf16_decode": (sse_auto_k1 / sse_beam - 1.0) * 100.0,
            "encode_vec_per_s": TIME_B / enc_s, "decode_vec_per_s": TIME_B / dec_s,
            "encode_ms": enc_s * 1e3, "encode_init_and_tables_ms": prep_ms,
            "encode_kernel_ms": kernel_ms,
        }
        paths.append(path)
        print(f"[main d{dim}/{qq.config.bytes_per_frame}B] auto -> {auto['name']}; "
              f"{path['encode_vec_per_s']:,.0f} vec/s encode, "
              f"{path['decode_vec_per_s']:,.0f} vec/s decode; quality "
              f"{path['quality_delta_pct']:+.3f}% vs beam-5 on {CHECK_B} frames; "
              f"encode {path['encode_ms']:.3f} ms = init+tables {prep_ms:.3f} + kernel "
              f"{kernel_ms:.3f} + rest; launches {path['launches']}", flush=True)

    # the initial indexes' kernel alone
    k_init = logits_phase(quantizers, frames)

    # ---- 5. K3 on the serving path; 6. training at full width
    gram_paths, k3_configs, k3_checks, n_k3, k3_stages = gram_phase(quantizers, main_frames)
    k3_checks = main_k3_checks + k3_checks
    k3_stages = k3_stages + main_stage_lines
    print("[gramv3 stages] share of the warps' cycles, us a frame-step: " + "; ".join(k3_stages),
          flush=True)
    train_paths, train_checks = train_phase(samplers[512], dev)
    for c in train_checks:
        (k3_checks if c["kernel"] == "gramv3" else k2_checks).append(c)
        launches[c["kernel"]] = launches.get(c["kernel"], 0) + c["launches"]
    launches["gramv3"] += n_k3
    # ---- 7. the rest of seqbeam
    rest = rest_phase(quantizers, main_frames)
    print("[seqbeam stages] share of the warps' cycles, us a block-step: "
          + "; ".join(rest["stage_lines"]), flush=True)
    for kernel, n in rest["launches"].items():
        launches[kernel] = launches.get(kernel, 0) + n
    k2_configs += rest["configs"]["seqbeam_v2"]
    k2_checks += rest["checks"]["seqbeam_v2"]
    # the beams that take the spill layout (ROADMAP C2)
    spill = spill_phase(dev)
    for kernel, entries in spill.items():
        for e in entries:
            (k2_configs if kernel == "seqbeam_v2" else rest["configs"]["seqbeam_v1"]).append(e)
            (k2_checks if kernel == "seqbeam_v2" else rest["checks"]["seqbeam_v1"]).append(
                {"where": f"spill layout {e['config']}", "shape": e["shape"],
                 **{k: e[k] for k in CHECK_KEYS}})
    # ---- 8. the primitive probes
    probes = probe_phase(dev)
    # ---- 9. the CLI at full width, and traces of training steps
    cli = cli_phase(quantizers[FIRST[512]], samplers[512], paths[0], dev)
    # ---- 10. the aux models at full width (its CLI run is in phase 9's corpus)
    aux = aux_phase(samplers, dev)
    for c in aux["checks"]:
        (k3_checks if c["kernel"] == "gramv3" else k2_checks).append(c)
        launches[c["kernel"]] = launches.get(c["kernel"], 0) + c["launches"]
    print(f"[aux] phase 10 took {aux['phase_s'] + cli['train_multi_kmeans']['train_s']:.1f} s "
          f"({cli['train_multi_kmeans']['train_s']:.1f} s of it the CLI's train in phase 9)",
          flush=True)
    # ---- 11. multi-device runs: one rank over NCCL, two ranks over gloo
    par = parallel_phase(quantizers[FIRST[512]], main_frames[FIRST[512]][0], samplers[512], dev)
    for kernel, n in par["launches"].items():
        launches[kernel] += n
    # ---- 12. the quality-parity run
    parity = parity_phase(smi)
    for kernel, n in parity["launches"].items():
        launches[kernel] += n

    # times are those of d512's first seqbeam rung; max_abs_err is the
    # largest over the paths' own checks, each listed with its shape
    head = k2_configs[0]
    k2 = {
        "name": "seqbeam_v2", "route": "cuda", "source": "quantization_tpu_torch/csrc/seqbeam.cu",
        "replaces": "quantization_tpu/ops/seqbeam.py:454",
        **{k: head[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(c["max_abs_err"] for c in k2_checks),
        "library_ms": None, "launches": launches["seqbeam_v2"], "checks": k2_checks,
        "configs": k2_configs,
    }
    # v1's times are those of d512
    v1_configs, v1_checks = rest["configs"]["seqbeam_v1"], rest["checks"]["seqbeam_v1"]
    k_v1 = {
        "name": "seqbeam_v1", "route": "cuda", "source": "quantization_tpu_torch/csrc/seqbeam.cu",
        "replaces": "quantization_tpu/ops/seqbeam.py:179",
        **{k: v1_configs[0][k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(c["max_abs_err"] for c in v1_checks),
        "library_ms": None, "launches": launches["seqbeam_v1"], "checks": v1_checks,
        "configs": v1_configs,
    }
    k1.update(launches=launches["decode"], checks=k1_checks,
              max_abs_err=max(c["max_abs_err"] for c in k1_checks))
    # K3's times are those of d512 with bf16 tables on the serving path
    k3 = {
        "name": "gramv3", "route": "cuda", "source": "quantization_tpu_torch/csrc/gramv3.cu",
        "replaces": "quantization_tpu/ops/gramv3.py:257,379",
        **{k: k3_configs[0][k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(c["max_abs_err"] for c in k3_checks),
        "library_ms": None, "launches": launches["gramv3"], "checks": k3_checks,
        "configs": k3_configs,
    }
    # rule 2's ranking: first the kernels slower than their library call, by
    # how many times; then the rest by launches x (kernel ms - bound ms),
    # for K2, K3 and B4 summed over the paths' runs, each at its own config
    bounds = {c["config"]: c["bound_ms"] for c in k2_configs + k3_configs + v1_configs}
    bounds.update(main_bounds)
    runs = [(k, n, p["encode_kernel_ms"], bounds[p["config"]])
            for p in paths for k, n in p["launches"].items() if k != "decode"]
    runs += [("gramv3", p["launches"]["gramv3"], p["encode_kernel_ms"], bounds[p["config"]])
             for p in gram_paths]
    runs += [(c["kernel"], c["launches"], c["ms"], c["bound_ms"])
             for c in train_checks + aux["checks"]]
    runs += [(k, n, p["encode_kernel_ms"], bounds[p["config"]])
             for p in rest["paths"] for k, n in p["launches"].items()]
    k_init["launches"] = launches["logits_argmax"]
    kernels = [k1, k2, k3, k_v1, k_init, *probes]
    for k in kernels:
        k["launches_x_excess_ms"] = (
            sum(n * (ms - b) for name, n, ms, b in runs if name == k["name"])
            if k in (k2, k3, k_v1) else k["launches"] * (k["ms"] - k["bound_ms"]))
    slower = sorted((k for k in kernels if k["library_ms"] and k["ms"] > k["library_ms"]),
                    key=lambda k: -k["ms"] / k["library_ms"])
    rest_k = sorted((k for k in kernels if k not in slower),
                    key=lambda k: -k["launches_x_excess_ms"])
    print("[rule 2] slower than their library call (ms / library ms): " + (", ".join(
        f"{k['name']} {k['ms'] / k['library_ms']:.3f}x" for k in slower) or "none")
        + "; then launches x (ms - bound ms): " + ", ".join(
        f"{k['name']} {k['launches_x_excess_ms']:.6g}" for k in rest_k), flush=True)
    print(json.dumps({"paths": paths + gram_paths + train_paths + rest["paths"] + [cli]
                      + aux["paths"] + par["paths"] + parity["paths"]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


@torch.no_grad()
def logits_phase(quantizers: dict, frames) -> dict:
    """The initial indexes' kernel (``ops.logits_argmax``) at
    :data:`LOGITS_SHAPES`, on the trained quantizers' frames: its indexes
    and its plain version's equal the f64 argmax wherever that is decided,
    and each at least 99.95% of the other's and of the f32 GEMM chain's it
    replaced; its time, its plain version's, the chain's (``library_ms``:
    f32 ``torch.matmul``, bias, argmax, cast), its tables' build (one kernel,
    equal to their plain build bit for bit) and its bound (3 x 2 B D K
    TF32 operations, or the frames, both weight halves, the bias and the
    indexes at the memory rate).  ``max_abs_err`` is the largest difference
    of the f64 logits at the kernel's and at the plain version's index.
    Returns its ``kernels`` entry, the times those of the first shape; its
    launches are counted by the caller, from the main path's runs."""
    from quantization_tpu_torch.core import search
    from quantization_tpu_torch.ops import logits_argmax as LA
    from quantization_tpu_torch.utils.device import device_ms

    configs, checks = [], []
    for key, B in LOGITS_SHAPES:
        q, dim = quantizers[key], key[0]
        x = frames(dim, 14, B)
        nc, K = q.num_codebooks, q.num_codebooks * q.codebook_size
        inputs = LA.table_inputs(q.params, q.config.scale_speed)
        tables, tables_plain = LA.logits_tables(*inputs), LA.logits_tables_plain(*inputs)
        check(all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in (
            (tables.w_hi, tables_plain.w_hi), (tables.w_lo, tables_plain.w_lo))),
              f"logits_argmax d{dim}: the tables' kernel differs from their plain build")
        got = LA.logits_argmax_cuda(x, tables)
        plain = LA.logits_argmax_plain(x, tables)
        want, decided = LA.f64_argmax(q.params, q.config, x)
        shape = f"B={B} D={dim} nc={nc}"
        check(bool(torch.equal(got[decided], want[decided])),
              f"logits_argmax {shape}: differs from the f64 argmax where decided")
        check(bool(torch.equal(plain[decided], want[decided])),
              f"logits_argmax {shape}: the plain version differs from the f64 argmax where "
              f"decided")

        def chain():
            return search.compute_logits(q.params, q.config, x).argmax(-1).to(torch.int32)

        agreement = float((got == chain()).float().mean())
        check(agreement >= 0.9995, f"logits_argmax {shape}: {agreement} equal to the f32 GEMM")
        plain_agreement = float((got == plain).float().mean())
        check(plain_agreement >= 0.9995,
              f"logits_argmax {shape}: {plain_agreement} equal to its plain version")
        w, b = LA.scaled_logits(q.params, q.config.scale_speed)
        logits = (x.double() @ w.double().t() + b.double()).reshape(B, nc, -1)
        err = float((logits.gather(2, got.long()[..., None])
                     - logits.gather(2, plain.long()[..., None])).abs().max())
        del logits
        entry = {
            "config": f"d{dim}_b{nc}", "shape": shape, "decided": float(decided.float().mean()),
            "gemm_agreement": agreement, "plain_agreement": plain_agreement,
            "max_abs_err": err,
            "ms": device_ms(lambda: LA.logits_argmax_cuda(x, tables), 20),
            "plain_ms": device_ms(lambda: LA.logits_argmax_plain(x, tables), 3),
            "library_ms": device_ms(chain, 20),
            "tables_ms": device_ms(lambda: LA.logits_tables(*inputs), 20),
            "tables_plain_ms": device_ms(lambda: LA.logits_tables_plain(*inputs), 20),
            **_bound(B * dim * 4 + 2 * K * tables.padded_dim * 4 + K * 4 + B * nc * 4,
                     {"tf32": 3 * 2 * B * dim * K}),
        }
        configs.append(entry)
        checks.append({"where": "logits_argmax", "shape": shape, "frames": B,
                       "index_agreement": plain_agreement, "max_abs_err": err})
        print(f"[logits_argmax d{dim}_b{nc}] {shape}: kernel and plain equal to the f64 argmax where "
              f"decided ({entry['decided']:.6f} of entries); kernel {agreement:.6f} equal to "
              f"the f32 GEMM, {plain_agreement:.6f} to plain (f64 logit gap {err:.3g}); kernel "
              f"{entry['ms']:.4f} ms, library chain {entry['library_ms']:.4f} ms, plain "
              f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}); tables built {entry['tables_ms']:.4f} ms (equal to the "
              f"plain build's, {entry['tables_plain_ms']:.4f} ms)", flush=True)
    return {
        "name": "logits_argmax", "route": "cuda",
        "source": "quantization_tpu_torch/csrc/logits_argmax.cu",
        "replaces": "none (the f32 GEMM, bias and argmax chain of the initial indexes)",
        **{k: configs[0][k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")},
        "max_abs_err": max(c["max_abs_err"] for c in checks), "checks": checks,
        "configs": configs,
    }


@torch.no_grad()
def stage_breakdown(problem) -> dict:
    """Where K2's or B4's time goes on ``problem``, from its stage-timed
    build (``ops.seqbeam.seqbeam_stages``), whose indexes must equal the shipped
    kernel's: per stage, its share of the warps' summed cycles and its
    microseconds a block-step (that share of a block's mean lifetime, over
    passes x nc steps), the clock rate the blocks' own cycles over their
    nanoseconds give, and the timed build's device time beside the shipped
    kernel's."""
    from quantization_tpu_torch.ops import seqbeam as K2
    from quantization_tpu_torch.utils.device import device_ms

    got, stages = K2.seqbeam_stages(problem)
    check(torch.equal(got, K2.seqbeam_cuda(problem)),
          "the stage-timed seqbeam's indexes differ from the shipped kernel's")
    st = stages.double().cpu()
    n = len(K2.STAGES)
    share = st[:, :n].sum(0) / st[:, :n].sum()
    steps = problem.passes * problem.tables.centers_bf16.shape[0]
    us = share * float(st[:, n + 1].mean()) / 1e3 / steps
    out = {
        "blocks": st.shape[0], "ghz": float(st[:, n].sum() / st[:, n + 1].sum()), "steps": steps,
        "timed_ms": device_ms(lambda: K2.seqbeam_stages(problem), 3),
        "kernel_ms": device_ms(lambda: K2.seqbeam_cuda(problem), 3),
        "share": {k: float(v) for k, v in zip(K2.STAGES, share)},
        "us_per_block_step": {k: float(v) for k, v in zip(K2.STAGES, us)},
    }
    out["summary"] = (
        f"{out['blocks']} blocks, {out['ghz']:.3f} GHz, timed {out['timed_ms']:.3f} ms vs "
        f"{out['kernel_ms']:.3f} ms: " + ", ".join(
            f"{k} {100 * out['share'][k]:.1f}% {out['us_per_block_step'][k]:.3f}"
            for k in K2.STAGES) + f", total {float(us.sum()):.3f} us")
    return out


@torch.no_grad()
def gram_phase(quantizers: dict, main_frames: dict):
    """Phase 5: ``encode(search_method="gramv3")`` on the main path's frames
    of both trained quantizers, for each of GRAM_CONFIGS.  Returns the path
    entries, K3's per-config entries, its checks, its launches and the stage
    lines."""
    from quantization_tpu_torch.core import codec
    from quantization_tpu_torch.experiments.gramv3_times import (STAGE_CONFIGS, precompute_split,
                                                                 stage_breakdown)
    from quantization_tpu_torch.ops import gramv3 as K3
    from quantization_tpu_torch.ops.quality_guard import against_plain
    from quantization_tpu_torch.utils.device import device_ms

    paths, configs, checks, launches, stage_lines = [], [], [], 0, []
    for dim, g_dtype, pool_mask in GRAM_CONFIGS:
        qq = quantizers[FIRST[dim]]
        nc = qq.num_codebooks
        x, sse_beam = main_frames[FIRST[dim]]
        kw = dict(g_dtype=g_dtype, pool_mask=pool_mask)
        name = f"gramv3_{g_dtype}{'_' + pool_mask if pool_mask else ''}_d{dim}"
        K3.GRAMV3_KERNEL.launches = 0
        codes = qq.encode(x, search_method="gramv3", **kw)
        torch.cuda.synchronize()
        n = K3.GRAMV3_KERNEL.launches
        check(n > 0, f"{name}: encode(search_method='gramv3') did not launch the gramv3 kernel")
        launches += n
        check(codes.dtype == torch.uint8 and codes.shape == (TIME_B, qq.config.bytes_per_frame),
              f"{name}: codes {codes.dtype} {tuple(codes.shape)}")
        problem = K3.gramv3_problem(qq.params, qq.config, x, passes=GRAM_PASSES, **kw)
        indexes = codec.unpack_indexes(codes, qq.codebook_size, nc)
        chk = against_plain(problem, qq.get_centers().detach(), got=indexes)
        check(chk["index_agreement"] == 1.0, f"{name}: encode indexes vs the plain gramv3: {chk}")
        shape = f"B={TIME_B} D={dim} nc={nc} passes={GRAM_PASSES} M=8 R=4"
        checks.append({"where": f"serving path {name}", "shape": shape,
                       **{k: chk[k] for k in CHECK_KEYS}})
        xs = x[:CHECK_B]
        ratio = float(((qq.decode(codes[:CHECK_B]) - xs) ** 2).sum()) / sse_beam
        check(ratio <= BAR, f"{name}: gramv3/beam-5 squared error {ratio} > {BAR}")
        enc_s = host_s(lambda: qq.encode(x, search_method="gramv3", **kw), 3)
        prep_ms = device_ms(lambda: K3.gramv3_problem(qq.params, qq.config, x,
                                                    passes=GRAM_PASSES, **kw), 3)
        entry = {"config": name, "shape": shape, "g_dtype": g_dtype, "pool_mask": pool_mask,
                 **{k: chk[k] for k in CHECK_KEYS},
                 "ms": device_ms(lambda: K3.gramv3_cuda(problem), 5),
                 "plain_ms": device_ms(lambda: K3.gramv3_plain(problem), 2)}
        entry.update(_gramv3_bound(TIME_B, nc, GRAM_PASSES, 8, g_dtype))
        entry["precompute_split"] = split = precompute_split(qq, x, g_dtype)
        if (dim, g_dtype) in STAGE_CONFIGS and not pool_mask:
            entry["stages"] = stage_breakdown(problem)
            stage_lines.append(f"{name} ({entry['stages']['summary']})")
        configs.append(entry)
        paths.append({
            "path": "encode(search_method='gramv3')", "dim": dim,
            "bytes_per_frame": qq.config.bytes_per_frame, "config": name, "batch": TIME_B,
            "launches": {"gramv3": n}, "quality_delta_pct": (ratio - 1.0) * 100.0,
            "encode_vec_per_s": TIME_B / enc_s, "encode_ms": enc_s * 1e3,
            "encode_precompute_ms": prep_ms, "encode_kernel_ms": entry["ms"],
            "encode_rest_ms": enc_s * 1e3 - prep_ms - entry["ms"]})
        print(f"[gramv3 {name}] {shape}: agreement with plain {chk['index_agreement']:.6f}; "
              f"quality {(ratio - 1.0) * 100.0:+.3f}% vs beam-5; kernel {entry['ms']:.3f} ms, "
              f"plain {entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}); encode {enc_s * 1e3:.3f} ms = precompute {prep_ms:.3f} + "
              f"kernel {entry['ms']:.3f} + rest; precompute by part: " + ", ".join(
                  f"{k[:-3]} {v:.3f}" for k, v in split.items()) + f" ms; launches {n}",
              flush=True)
    # K3 at 16 codebooks on seeded codebooks; its log lines print the build
    # that staged the shared rows in bf16 too beside them, its entry holds
    # this run's numbers, and only its checks' launches are counted
    from quantization_tpu_torch.experiments import gramv3_nc16

    nc16 = gramv3_nc16.report(log=lambda line: print(line, flush=True))
    launches += nc16["check_launches"]
    head = nc16["times"][0]
    configs.append({"config": "gramv3_nc16_bf16_alt3_seeded_d1280",
                    "shape": f"B={head['B']} D=1280 nc=16 passes=3 M=8 R=4",
                    "g_dtype": "bf16", "pool_mask": "altparity", "bound_by": "operations",
                    **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "registers",
                                            "blocks_per_sm", "smem_bytes")},
                    "times": [{k: t[k] for k in ("g_dtype", "passes", "ms", "bound_ms",
                                                 "registers", "blocks_per_sm", "smem_bytes")}
                              for t in nc16["times"]]})
    return paths, configs, checks, launches, stage_lines


def train_phase(sampler, dev):
    """Phase 6: TRAIN at full width on TRAIN_BATCH-frame batches for each of
    TRAIN_SEARCHES.  Returns the path entries and, per kernel search, a
    check entry with the kernel's phase-2 launches and its times at the
    training shape."""
    from quantization_tpu_torch import QuantizerTrainer
    from quantization_tpu_torch.core.types import scaled_centers
    from quantization_tpu_torch.ops import gramv3 as K3
    from quantization_tpu_torch.ops import seqbeam as K2
    from quantization_tpu_torch.ops.quality_guard import against_plain
    from quantization_tpu_torch.utils.device import device_ms
    from quantization_tpu_torch.utils.torch_interop import PARAM_FIELDS

    p1, p2 = TRAIN["phase_one_iters"], TRAIN["phase_two_iters"]
    dim, nc_bytes = TRAIN["dim"], TRAIN["bytes_per_frame"]
    n = p1 + p2 + 1  # the steps of a whole run
    xs = sampler(torch.Generator().manual_seed(11), n * TRAIN_BATCH).reshape(n, TRAIN_BATCH, dim)
    paths, checks = [], []
    # untimed warm-up: the first steps on a card pay one-time set-up (library
    # handles, allocator growth), which would otherwise land on "auto"
    QuantizerTrainer(device=dev, **TRAIN).step_many(xs[:p1 + 2])
    kernels = {"gramv3": "gramv3", "gramv3-int8": "gramv3", "seqbeam": "seqbeam_v2"}

    def new_trainer(search):
        kw = dict(TRAIN, train_search=search)
        if search in kernels:
            kw["beam_finetune_iters"] = 0  # else every step of this short phase 2 is beam
        return QuantizerTrainer(device=dev, **kw)

    for search in TRAIN_SEARCHES:
        kernel = kernels.get(search)
        counter = launch_counters().get(kernel)
        t = new_trainer(search)
        check((t.config.num_codebooks, t.config.codebook_size) == (2 * nc_bytes, 16),
              f"train {search}: phase-1 config {t.config}")
        if counter:
            counter.launches = 0
        # one call across the phase switch: p1 + 1 phase-1 steps, 3 of phase 2
        losses = t.step_many(xs[:p1 + 4])
        torch.cuda.synchronize()
        n_k = counter.launches if counter else 0
        check(not kernel or n_k == 3,
              f"train {search}: {n_k} {kernel} launches, not one in each of 3 phase-2 steps")
        check((t.config.num_codebooks, t.config.codebook_size) == (nc_bytes, 256),
              f"train {search}: phase-2 config {t.config}")
        # mid-phase-2 checkpoint, then two more steps on both trainers
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            path = pathlib.Path(d) / "ckpt.npz"
            t.save_checkpoint(path)
            t2 = QuantizerTrainer.load_checkpoint(path, device=dev, diagnostics=False)
        check(t2.cur_iter == t.cur_iter == p1 + 4, f"train {search}: resumed at {t2.cur_iter}")
        for x in xs[p1 + 4:p1 + 6]:
            losses.append(t.step(x))
            t2.step(x)
        diffs = {f: float((getattr(t.params, f) - getattr(t2.params, f)).detach().abs().max())
                 for f in PARAM_FIELDS}
        check(all(torch.equal(getattr(t.params, f), getattr(t2.params, f)) for f in PARAM_FIELDS),
              f"train {search}: resumed parameters differ: {diffs}")
        check(all(bool(torch.isfinite(v).all()) for step in losses for v in step),
              f"train {search}: a loss term is not finite")
        entry = {"path": "QuantizerTrainer.step_many", "train_search": search,
                 "batch": TRAIN_BATCH, **TRAIN, "launches": {kernel: n_k} if kernel else {},
                 "final_losses": {k: float(v) for k, v in losses[-1]._asdict().items()},
                 "resume_equal": True}
        if kernel:
            # the kernel against its plain version on a phase-2 batch, at the
            # trainer's own search shape
            xb, params, cfg = xs[p1 + 5], t.params.detach(), t.config
            centers = scaled_centers(params, cfg.scale_speed)
            if kernel == "gramv3":
                g_dtype = "int8" if search == "gramv3-int8" else "bf16"
                problem = K3.gramv3_problem(params, cfg, xb, passes=1, g_dtype=g_dtype)
                shape = f"B={TRAIN_BATCH} D={dim} nc={cfg.num_codebooks} passes=1 M=8 R=4"
                bound = _gramv3_bound(TRAIN_BATCH, cfg.num_codebooks, 1, 8, g_dtype)
            else:
                problem = K2.seqbeam_problem(params, cfg, xb, M=16, R=8, passes=1)
                shape = f"B={TRAIN_BATCH} D={dim} nc={cfg.num_codebooks} passes=1 M=16 R=8 f32 E"
                bound = _seqbeam_bound(TRAIN_BATCH, dim, cfg.num_codebooks, 1, 16, "f32")
            chk = against_plain(problem, centers)
            check(chk["ok"] and (kernel != "gramv3" or chk["index_agreement"] == 1.0),
                  f"train {search}: kernel vs plain on a phase-2 batch: {chk}")
            checks.append({"where": f"training {search}", "kernel": kernel, "shape": shape,
                           "launches": n_k, **{k: chk[k] for k in CHECK_KEYS},
                           "ms": device_ms(lambda: problem.kernel.cuda(problem), 20),
                           "plain_ms": device_ms(lambda: problem.kernel.plain(problem), 3),
                           **bound})
            entry["kernel_vs_plain"] = checks[-1]
        paths.append(entry)
        print(f"[train {search}] d{dim}/{nc_bytes}B batch {TRAIN_BATCH}: launches "
              f"{entry['launches']}; resume equal; final losses {entry['final_losses']}"
              + (f"; kernel {checks[-1]['ms']:.3f} ms vs plain {checks[-1]['plain_ms']:.3f} ms, "
                 f"agreement {checks[-1]['index_agreement']:.6f}" if kernel else ""), flush=True)

    # step times: whole runs of fresh trainers (their launches are not
    # counted above), one step_many call a phase, the searches interleaved
    # round by round so that the host's noise falls on all alike; per search
    # and phase, the median over the runs, with their range
    runs = {(s, ph): [] for s in TRAIN_SEARCHES for ph in (1, 2)}
    for _ in range(TRAIN_TIME_ROUNDS):
        for search in TRAIN_SEARCHES:
            t3 = new_trainer(search)
            runs[search, 1].append(step_ms(t3, xs[:p1 + 1]))
            runs[search, 2].append(step_ms(t3, xs[p1 + 1:]))
    for entry in paths:
        for ph in (1, 2):
            ms = runs[entry["train_search"], ph]
            med = statistics.median(ms)
            entry.update({f"phase{ph}_step_ms": med, f"phase{ph}_steps_per_s": 1e3 / med,
                          f"phase{ph}_step_ms_range": [min(ms), max(ms)]})
        print(f"[train {entry['train_search']}] steps/s over {TRAIN_TIME_ROUNDS} runs: phase 1 "
              f"{entry['phase1_steps_per_s']:.2f} ({entry['phase1_step_ms']:.3f} ms, runs "
              f"{entry['phase1_step_ms_range'][0]:.3f}-{entry['phase1_step_ms_range'][1]:.3f}), "
              f"phase 2 {entry['phase2_steps_per_s']:.2f} ({entry['phase2_step_ms']:.3f} ms, runs "
              f"{entry['phase2_step_ms_range'][0]:.3f}-{entry['phase2_step_ms_range'][1]:.3f})",
              flush=True)
    return paths, checks


@torch.no_grad()
def probe_phase(dev) -> list:
    """Phase 8: the primitive probes (``experiments/prim_bench.py`` and
    ``experiments/int8_mxu_probe.py``) at the JAX scripts' shapes and K.
    The probes' own path (the slope of each of P1-P4 through its
    dispatcher, one timed run of each chain) runs with the launch counts
    set to 0 just before and read just after; then each kernel is held
    against its plain version on the same inputs at both K.  Returns the
    ``kernels`` entries."""
    from quantization_tpu_torch.experiments import int8_mxu_probe as P56
    from quantization_tpu_torch.experiments import prim_bench as P14
    from quantization_tpu_torch.utils.device import device_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products (default)
    entries = []
    for p in P14.probes(dev):
        counter = P14.KERNELS[p.name]
        counter.launches = 0
        us = P14.slope_us(p.run, *p.Ks)
        torch.cuda.synchronize()
        n = counter.launches
        check(n > 0, f"probe {p.name}: the kernel was not launched")
        errs = []
        for K in p.Ks:
            got, want = p.run(K), p.plain(K)
            if p.name == "matmul":
                check(P14.matmul_close(got, want, *p.inputs, K),
                      f"probe matmul K={K}: beyond {P14.MATMUL_RTOL} of the sum of |terms|")
            else:
                check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                      f"probe {p.name} K={K}: not bit-exact against its plain version")
            errs.append(float(torch.where(got == want, 0.0, (got - want).abs()).max()))
        K1, K2 = p.Ks
        entry = {
            "name": p.name, "route": "cuda",
            "source": "quantization_tpu_torch/csrc/prim_bench.cu",
            "replaces": PROBE_REPLACES[p.name],
            "shape": f"{' x '.join(str(tuple(t.shape)) for t in p.inputs)}, K={K1},{K2}",
            "unit": f"ms an iteration: device time at K={K2} less K={K1}, over {K2 - K1}",
            "launches": n, "max_abs_err": max(errs), "ms": us * 1e-3,
            "plain_ms": P14.slope_us(p.plain, *p.Ks, reps=3) * 1e-3,
            # an iteration moves no bytes off chip: the slope cancels the
            # call's one read of the inputs and write of the output
            **_bound(0, _probe_ops(p.name, p.inputs)),
            "library_ms": PROBE_LIBRARY[p.name](*p.inputs) if p.name in PROBE_LIBRARY else None,
        }
        entries.append(entry)
        floor_line = None
        if p.name == "minround":
            # the floor of one warp-wide reduction a round, measured; the
            # fixed cost a call, which the slope does not see
            floor_line, fl = P14.minround_floor_line(p.inputs[0], us, p.Ks)
            entry.update(floor_ms=fl["floor_us"] * 1e-3, fixed_ms=fl["fixed_us"] * 1e-3)
        elif p.name == "gather":
            # the floor of one shared-memory load a gather, measured
            floor_line, fl = P14.gather_floor_line(*p.inputs, us, p.Ks)
            entry["floor_ms"] = fl["floor_us"] * 1e-3
        print(f"[probe {p.name}] {p.label}: {us:.5f} {p.unit} (plain "
              f"{entry['plain_ms'] * 1e3:.5f}, bound {entry['bound_ms'] * 1e3:.5f}"
              + (f", floor {entry['floor_ms'] * 1e3:.5f}" if "floor_ms" in entry else "")
              + (f", fixed {entry['fixed_ms'] * 1e3:.3f} us a call" if "fixed_ms" in entry
                 else "")
              + (f", {PROBE_LIBRARY_CALL[p.name]} {entry['library_ms'] * 1e3:.5f}"
                 if entry["library_ms"] else "")
              + f"); launches {n}; max_abs_err {max(errs):.3g}", flush=True)
        if floor_line:
            print(floor_line, flush=True)
        if p.name == "matmul":
            # the stage-timed build, whose output must equal the kernel's
            line, st = P14.stages_line(*p.inputs, p.Ks)
            entry["stages"] = st
            print(line, flush=True)
            print(f"[probe matmul] {st['registers']} registers a thread, {st['blocks_per_sm']} "
                  f"block(s) of {st['threads_per_block']} threads an SM, {st['blocks']} blocks",
                  flush=True)
    for ch in P56.chains(dev):
        counter = P56.KERNELS[ch.name]
        counter.launches = 0
        ms = device_ms(ch.run, 20)
        torch.cuda.synchronize()
        n = counter.launches
        check(n > 0, f"probe {ch.name}: the kernel was not launched")
        got, want = ch.run(), ch.plain()
        e, c = ch.inputs
        if ch.name == "bf16_chain":
            chk = P56.bf16_chain_agreement(got, want, e)
            check(chk["ok"], f"probe bf16_chain vs its plain version: {chk}")
            err, agreement = chk["max_abs_err"], chk
        else:
            check(torch.equal(got, want), "probe int8_chain: not bit-exact against its plain version")
            err, agreement = 0.0, {"bit_exact": True}
        mb, d = e.shape
        cs = c.shape[0]
        prods = [(mb, d, cs), (mb, cs, d)]  # the two products of a step
        dtype = torch.float32 if ch.name == "bf16_chain" else torch.int8
        library = sum(device_ms(_mm(m, k, n2, dtype, dev), 20) for m, k, n2 in prods)
        entry = {
            "name": ch.name, "route": "cuda",
            "source": "quantization_tpu_torch/csrc/int8_mxu_probe.cu",
            "replaces": PROBE_REPLACES[ch.name],
            "shape": f"E {tuple(e.shape)} x c {tuple(c.shape)} f32, {P56.STEPS} steps",
            "unit": "ms a chain (one launch)", "launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": device_ms(ch.plain, 3),
            # E and c read once, the output written once
            **_bound((2 * e.numel() + c.numel()) * 4, _chain_ops(ch.name, mb, d, cs)),
            "library_ms": library * P56.STEPS, "agreement": agreement,
            "tflops": P56.FLOPS / (ms * 1e-3) / 1e12,
        }
        if ch.name == "bf16_chain":
            entry.update(bf16_chain_extras(e, c))
        else:
            entry.update(int8_chain_extras(e, c))
        entries.append(entry)
        print(f"[probe {ch.name}] {ch.label}: {ms:.4f} ms/chain {entry['tflops']:.1f} TFLOP/s "
              f"(plain {entry['plain_ms']:.4f}, bound {entry['bound_ms']:.4f} "
              f"({entry['bound_by']})"
              + (f", barrier floor {entry['barrier_floor_ms']:.4f}" if ch.name == "int8_chain"
                 else "") + f", library {entry['library_ms']:.4f}); launches {n}; "
              f"vs plain {json.dumps(agreement)}", flush=True)
        if ch.name == "bf16_chain":
            print(f"[probe bf16_chain] bounds: split-c bf16 products {entry['bound_ms']:.4f} ms, "
                  f"f32 FMAs {entry['bound_f32_ms']:.4f} ms; a chain launches "
                  f"{entry['profiled_kernels']}", flush=True)
        else:
            print(entry.pop("stages_line"), flush=True)
            print(f"[probe int8_chain] a chain launches {entry['profiled_kernels']}", flush=True)
    return entries


def bf16_chain_extras(e, c) -> dict:
    """P5 beside its plain arithmetic's bound (the f32-FMA bound), and the
    device kernels a chain launches (by ``torch.profiler``), which
    must be P5's own two, so that no library call computes its products."""
    from quantization_tpu_torch.experiments import int8_mxu_probe as P56

    mb, d = e.shape
    cs = c.shape[0]
    out = {"bound_f32_ms": _bound(
        0, {"f32": P56.STEPS * (2 * mb * d * cs + mb * cs + 3 * mb * d)})["bound_ms"]}
    out["profiled_kernels"] = _chain_kernels(
        "bf16_chain", lambda: P56.bf16_chain_cuda(e, c), ("split_kernel", "bf16_chain_tc_kernel"))
    return out


def int8_chain_extras(e, c) -> dict:
    """P6's stage-timed build (``[int8_chain stages]``, whose output must
    equal the shipped kernel's), its barrier floor (the chain's grid running
    its barriers and nothing else: what no design that keeps the per-step
    global max removes; beside the bound, not in its place), and the device
    kernels a chain launches, which must be its own one."""
    from quantization_tpu_torch.experiments import int8_mxu_probe as P56

    line, b = P56.stages_line(e, c)
    return {"stages_line": line, "stages": b, "barrier_floor_ms": b["barrier_floor_ms"],
            "profiled_kernels": _chain_kernels(
                "int8_chain", lambda: P56.int8_chain_cuda(e, c), ("int8_chain_kernel",))}


def _chain_kernels(name: str, run, own) -> list:
    """The device kernels one call of ``run`` launches (by
    ``profile_device_ops``, which traces a call after a warm-up call); it
    fails unless they are the chain's ``own`` kernels, each at least once,
    and no other."""
    from quantization_tpu_torch.utils.profiling import profile_device_ops

    names = sorted(r["source"] for r in profile_device_ops(run))
    # an empty list (a profiler that saw no device activity) proves nothing
    check(all(any(k in n for n in names) for k in own)
          and all(any(k in n for k in own) for n in names),
          f"probe {name}: a chain must launch its own kernels and no other: {names}")
    return names


def _matmul_library_ms(a, b) -> float:
    """One bf16 ``torch.matmul`` of P3's shape, per product."""
    from quantization_tpu_torch.utils.device import device_ms

    a16, bt = a.to(torch.bfloat16), b.T
    return device_ms(lambda: a16 @ bt, 50)


def _gather_library_ms(table, idx) -> float:
    """One ``torch.gather(table, 0, idx)`` of P2's table: an iteration's
    gather (the index widened to int64 outside the timing)."""
    from quantization_tpu_torch.utils.device import device_ms

    idx64 = idx.long()
    return device_ms(lambda: torch.gather(table, 0, idx64), 50)


# the one PyTorch call that computes a probe's iteration, where there is one
PROBE_LIBRARY = {"matmul": _matmul_library_ms, "gather": _gather_library_ms}
PROBE_LIBRARY_CALL = {"matmul": "torch.matmul bf16", "gather": "torch.gather"}


def _mm(m: int, k: int, n: int, dtype, dev):
    """One library product of (m, k) by (k, n): f32 ``torch.matmul`` (TF32
    off) or int8 ``torch._int_mm``; returns the call to time."""
    gen = torch.Generator().manual_seed(m + k + n)
    if dtype == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).to(dev)
        b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8).to(dev)
        return lambda: torch._int_mm(a, b)
    a, b = torch.randn(m, k, generator=gen).to(dev), torch.randn(k, n, generator=gen).to(dev)
    return lambda: a @ b


PROBE_REPLACES = {
    "minround": "experiments/prim_bench.py:35", "gather": "experiments/prim_bench.py:49",
    "matmul": "experiments/prim_bench.py:57", "assembly": "experiments/prim_bench.py:68",
    "bf16_chain": "experiments/int8_mxu_probe.py:39",
    "int8_chain": "experiments/int8_mxu_probe.py:57",
}


def _probe_ops(name: str, inputs) -> dict:
    """Operations of ONE iteration of a prim_bench probe, by type.  minround:
    a min, a compare and a select an element a round; gather: one add an
    element; matmul: 2 M N D bf16 products-and-sums, plus M D adds of i and
    M N adds into the sum; assembly: 5 operations an element (the products
    by 2 included)."""
    x = inputs[0]
    if name == "minround":
        return {"f32": 3 * x.numel()}
    if name == "gather":
        return {"f32": x.numel()}
    if name == "matmul":
        (M, D), N = x.shape, inputs[1].shape[0]
        return {"bf16": 2 * M * N * D, "f32": M * D + M * N}
    return {"f32": 5 * x.numel()}


def _chain_ops(name: str, mb: int, d: int, cs: int) -> dict:
    """Operations of one chain of STEPS steps, by type.  "bf16" (c in f32,
    split exactly into three bf16 parts): 3 x 2 mb d cs bf16 multiply-adds a
    step, two operations each, plus the bf16 rounding of cross and the scale,
    add and rounding of E (the f32 FMAs of the plain arithmetic are
    ``bound_f32_ms``); int8: 2 x 2 mb d cs int8 operations a
    step, plus 7 elementwise f32 operations an element of cross (dequantize
    2, |.| and max 2, divide, scale and round 3) and of E (scale upd 1, ef
    2, |.| and max 2, divide and round 2)."""
    from quantization_tpu_torch.experiments.int8_mxu_probe import STEPS

    if name == "bf16_chain":
        # the least work of an exact scheme: c split into three bf16 parts,
        # three bf16 products a product on the tensor cores
        return {"bf16": STEPS * 3 * 2 * 2 * mb * d * cs, "f32": STEPS * (mb * cs + 3 * mb * d)}
    return {"int8": STEPS * 2 * 2 * mb * d * cs, "f32": STEPS * 7 * (mb * cs + mb * d)}


@torch.no_grad()
def rest_phase(quantizers: dict, main_frames: dict) -> dict:
    """Phase 7: seqbeam v1 and v2's pass/bound/lazy semantics through
    ``encode(search_method="seqbeam")`` on the main path's frames.  Returns
    the path entries and, per kernel ("seqbeam_v1", "seqbeam_v2"), its
    per-config entries, checks and launches."""
    from quantization_tpu_torch.core import codec
    from quantization_tpu_torch.ops import seqbeam as K2
    from quantization_tpu_torch.ops.ladder import LADDERS, Rung
    from quantization_tpu_torch.ops.quality_guard import CANDIDATES, against_plain
    from quantization_tpu_torch.utils.device import device_ms

    cand = {r.name: r for r in CANDIDATES[FIRST[512]]}
    _, int8e, hl, _ = LADDERS[(512, 8)]
    # (dim, rung, what it is held to)
    configs = [
        (512, Rung("seqbeam_v1_d512", K2.SEQBEAM, V1_PASSES, V1), "v2"),
        (256, Rung("seqbeam_v1_d256", K2.SEQBEAM, V1_PASSES, V1), "v2"),
        (512, int8e._replace(name="seqbeam_int8e_pass_d512",
                             beam=dict(int8e.beam, requant="pass")), "init"),
        (512, cand["seqbeam_int8e_bound_d512"], "init"),
        (512, cand["seqbeam_int8e_bound_fi_d512"], "init"),
        (512, cand["seqbeam_int8e_lazy_d512"], "eager"),
        (512, hl._replace(name="seqbeam_hl_lazy_d512", beam=dict(hl.beam, lazy_r1=True)),
         "eager"),
    ]
    out = {"paths": [], "configs": {"seqbeam_v1": [], "seqbeam_v2": []},
           "checks": {"seqbeam_v1": [], "seqbeam_v2": []},
           "launches": {"seqbeam_v1": 0, "seqbeam_v2": 0}, "stage_lines": []}
    for dim, rung, twin in configs:
        name, passes, sem, kw = rung.name, rung.passes, rung.beam, rung.kwargs()
        qq = quantizers[FIRST[dim]]
        nc = qq.num_codebooks
        x, sse_beam = main_frames[FIRST[dim]]
        centers = qq.get_centers().detach()
        kernel = "seqbeam_v1" if sem.get("impl") == "v1" else "seqbeam_v2"
        counter, other = ((K2.SEQBEAM_V1_KERNEL, K2.SEQBEAM_KERNEL) if kernel == "seqbeam_v1"
                          else (K2.SEQBEAM_KERNEL, K2.SEQBEAM_V1_KERNEL))
        counter.launches = other.launches = 0
        codes = qq.encode(x, search_method="seqbeam", refine_indexes_iters=passes, **kw)
        torch.cuda.synchronize()
        n = counter.launches
        check(n > 0 and other.launches == 0,
              f"{name}: {n} {kernel} launches, {other.launches} of the other kernel")
        out["launches"][kernel] += n
        check(codes.dtype == torch.uint8 and codes.shape == (TIME_B, qq.config.bytes_per_frame),
              f"{name}: codes {codes.dtype} {tuple(codes.shape)}")
        problem = K2.seqbeam_problem(qq.params, qq.config, x, passes=passes, **sem)
        indexes = codec.unpack_indexes(codes, qq.codebook_size, nc)
        chk = against_plain(problem, centers, got=indexes)
        check(chk["ok"], f"{name}: encode indexes vs the plain version: {chk}")
        shape = (f"B={TIME_B} D={dim} nc={nc} passes={passes} M={sem['M']} R={sem['R']} "
                 f"{sem.get('e_dtype', 'f32')} E")
        sse = float(((codec.decode_indexes(centers, indexes) - x) ** 2).sum())
        if twin == "init":
            sse_twin = float(((codec.decode_indexes(centers, problem.idx0) - x) ** 2).sum())
            check(sse < sse_twin, f"{name}: squared error {sse} not below the init's {sse_twin}")
            relation = {"held_to": "initial indexes", "sse_init": sse_twin}
        else:
            # v1 against ported v2 at the same M, R and passes (f32 E,
            # all-pool); a lazy config against its eager twin
            tw = (dict(M=sem["M"], R=sem["R"]) if twin == "v2"
                  else {k: v for k, v in sem.items() if k != "lazy_r1"})
            other_idx = K2.seqbeam_cuda(K2.seqbeam_problem(qq.params, qq.config, x,
                                                            passes=passes, **tw))
            sse_twin = float(((codec.decode_indexes(centers, other_idx) - x) ** 2).sum())
            agree = float((other_idx == indexes).float().mean())
            # the JAX tests' bars (tests/test_search_alternatives.py:195-211,
            # :698-731)
            min_agree, max_rel = (0.95, 1e-3) if twin == "v2" else (0.98, 2e-3)
            check(agree >= min_agree and abs(sse / sse_twin - 1.0) <= max_rel,
                  f"{name}: vs {twin} twin {tw}: agreement {agree}, squared error {sse} vs "
                  f"{sse_twin}")
            relation = {"held_to": f"{twin} twin", "twin": tw, "agreement": agree,
                        "sse_rel_diff": sse / sse_twin - 1.0}
        xs = x[:CHECK_B]
        ratio = float(((qq.decode(codes[:CHECK_B]) - xs) ** 2).sum()) / sse_beam
        check(ratio <= BAR, f"{name}: seqbeam/beam-5 squared error {ratio} > {BAR}")
        enc_s = host_s(lambda: qq.encode(x, search_method="seqbeam",
                                         refine_indexes_iters=passes, **kw), 3)
        entry = {"config": name, "shape": shape, **sem, **{k: chk[k] for k in CHECK_KEYS},
                 "ms": device_ms(lambda: K2.seqbeam_cuda(problem), 3),
                 "plain_ms": device_ms(lambda: K2.seqbeam_plain(problem), 1),
                 **_seqbeam_bound(TIME_B, dim, nc, passes, sem["M"], sem.get("e_dtype", "f32"))}
        if kernel == "seqbeam_v1":
            entry["stages"] = stage_breakdown(problem)
            out["stage_lines"].append(f"{name} ({entry['stages']['summary']})")
        out["configs"][kernel].append(entry)
        out["checks"][kernel].append({"where": f"encode path {name}", "shape": shape,
                                      "launches": n, **{k: chk[k] for k in CHECK_KEYS}})
        out["paths"].append({
            "path": "encode(search_method='seqbeam')", "dim": dim,
            "bytes_per_frame": qq.config.bytes_per_frame, "config": name, "batch": TIME_B,
            "launches": {kernel: n}, "quality_delta_pct": (ratio - 1.0) * 100.0,
            "encode_vec_per_s": TIME_B / enc_s, "encode_ms": enc_s * 1e3,
            "encode_kernel_ms": entry["ms"], **relation})
        print(f"[rest {name}] {shape}: agreement with plain {chk['index_agreement']:.6f}; "
              f"vs {relation['held_to']} {json.dumps(relation)}; quality "
              f"{(ratio - 1.0) * 100.0:+.3f}% vs beam-5; kernel {entry['ms']:.3f} ms, plain "
              f"{entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}); {TIME_B / enc_s:,.0f} encode vec/s; launches {n}",
              flush=True)
    return out


@torch.no_grad()
def spill_phase(dev) -> dict:
    """The beams no block fits beside E, X and a ring (SPILL_BEAMS), which
    take the spill layout: each on SPILL_B frames near seeded codebooks,
    held against its plain version with the bars of phase 3.  Returns, per
    kernel ("seqbeam_v2", "seqbeam_v1"), the per-config entries with kernel,
    plain and bound ms."""
    from quantization_tpu_torch.experiments.seqbeam_times import NC, PASSES, R, seeded_problem
    from quantization_tpu_torch.ops import seqbeam as K2
    from quantization_tpu_torch.ops.quality_guard import against_plain
    from quantization_tpu_torch.utils.device import device_ms

    out = {"seqbeam_v2": [], "seqbeam_v1": []}
    for impl, e_dtype, M, dim in SPILL_BEAMS:
        problem, centers = seeded_problem(impl, e_dtype, M, dim, SPILL_B, dev)
        layout = K2.seqbeam_layout(problem)
        check(layout["kind"] == "spill", f"spill beam {impl} {e_dtype} M={M} d{dim}: {layout}")
        chk = against_plain(problem, centers)
        name = f"spill_{impl}_{e_dtype}_m{M}_d{dim}"
        check(chk["ok"], f"{name}: kernel vs plain at B={SPILL_B}: {chk}")
        entry = {"config": name, "shape": (f"B={SPILL_B} D={dim} nc={NC} passes={PASSES} M={M} "
                                           f"R={R} {e_dtype} E"),
                 "layout": layout, **{k: chk[k] for k in CHECK_KEYS},
                 "ms": device_ms(lambda: K2.seqbeam_cuda(problem), 3),
                 "plain_ms": device_ms(lambda: K2.seqbeam_plain(problem), 1),
                 **_seqbeam_bound(SPILL_B, dim, NC, PASSES, M, e_dtype)}
        out["seqbeam_v1" if impl == "v1" else "seqbeam_v2"].append(entry)
        print(f"[spill {name}] {entry['shape']}: agreement with plain "
              f"{chk['index_agreement']:.6f}, sse rel diff {chk['sse_rel_diff']:+.2e}; kernel "
              f"{entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, bound "
              f"{entry['bound_ms']:.4f} ms; {layout['frames']} frames a block, "
              f"{layout['smem_bytes']} B shared, {layout['spill_bytes']} B a slot", flush=True)
    return out


def cli_phase(q, sampler, main_path: dict, dev) -> dict:
    """Phase 9: train, encode and decode through the CLI on a shard corpus
    at d512, and ``profile_device_ops`` over a CLI encode and over training
    steps.  ``q`` is the committed d512 quantizer, ``main_path`` phase 4's
    d512 entry.  Returns the ``cli`` entry of the ``paths`` line."""
    import logging
    import re
    import subprocess

    import numpy as np

    from quantization_tpu_torch import cli, load_quantizer
    from quantization_tpu_torch.core import codec
    from quantization_tpu_torch.data.shards import ShardStream, iter_shards_sequential, write_shards
    from quantization_tpu_torch.ops.quality_guard import against_plain
    from quantization_tpu_torch.utils.profiling import profile_device_ops

    t_phase = time.perf_counter()
    stats = []

    class KeepStats(logging.Handler):
        """The numbers each CLI command logs with its last line."""

        def emit(self, record):
            if hasattr(record, "stats"):
                stats.append(record.stats)

    handler = KeepStats()
    logging.getLogger("quantization_tpu_torch.cli").addHandler(handler)
    out = {"path": "cli (python -m quantization_tpu_torch)", "dim": 512, "bytes_per_frame": 8,
           "frames": CLI_FRAMES, "batch": CLI_BATCH}
    try:
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            d = pathlib.Path(d)
            corpus = d / "corpus"
            gen = torch.Generator().manual_seed(11)
            t0 = time.perf_counter()
            manifest = write_shards(corpus, (sampler(gen, 65536).cpu().numpy()
                                             for _ in range(CLI_FRAMES // 65536)), CLI_SHARD)
            out["corpus_write_s"] = time.perf_counter() - t0
            sizes = [e["frames"] for e in manifest["shards"]]
            check(sizes == [200000, 200000, 124288], f"cli: shard sizes {sizes}")
            stream = ShardStream(corpus, TRAIN_BATCH)
            check(stream.native, f"cli: the native shard loader did not run: {stream.native_error}")
            stream.close()

            # train
            qpath = d / "q.npz"
            t0 = time.perf_counter()
            cli.main(["train", "--data", str(corpus), "--dim", "512", "--bytes-per-frame", "8",
                      "--iters", "4", "--batch", str(TRAIN_BATCH), "--chunk", "4", "--quiet",
                      "--out", str(qpath)])
            out["train_s"] = time.perf_counter() - t0
            tq = load_quantizer(qpath, device=dev)
            check((tq.num_codebooks, tq.codebook_size) == (8, 256),
                  f"cli train: config {tq.config}")
            x600 = next(iter_shards_sequential(corpus, TRAIN_BATCH, dtype=np.float16))
            losses = tq.compute_loss(torch.from_numpy(x600).to(dev).float())
            out["train_losses"] = {k: float(v) for k, v in losses._asdict().items()}
            check(all(np.isfinite(v) for v in out["train_losses"].values()),
                  f"cli train: a loss term is not finite: {out['train_losses']}")
            out["train_multi_kmeans"] = cli_train_multi_kmeans(corpus, d, torch.from_numpy(
                x600).to(dev).float(), dev)

            # encode, the whole corpus with the CLI's defaults
            codes_path = d / "codes.npy"
            auto = auto_search(q.config, torch.empty(CLI_BATCH, q.dim, device=dev))
            auto["counter"].launches = 0
            cli.main(["encode", "--quantizer", str(TRAINED[FIRST[512]]), "--data", str(corpus),
                      "--out", str(codes_path)])
            torch.cuda.synchronize()
            n_k2 = auto["counter"].launches
            enc = stats.pop()
            check(n_k2 == CLI_FRAMES // CLI_BATCH,
                  f"cli encode: {n_k2} {auto['kernel']} launches, not one for each of "
                  f"{CLI_FRAMES // CLI_BATCH} batches")
            codes = np.load(codes_path)
            check(codes.dtype == np.uint8 and codes.shape == (CLI_FRAMES, 8),
                  f"cli encode: codes {codes.dtype} {codes.shape}")
            # the CLI's codes against Quantizer.encode of the same batches,
            # read back and upcast on the card
            keep = {i for a, b in ENCODE_ROWS for i in range(a // CLI_BATCH, b // CLI_BATCH)}
            xs = {}
            for i, b in enumerate(iter_shards_sequential(corpus, CLI_BATCH, dtype=np.float16)):
                if i in keep:
                    xs[i] = torch.from_numpy(b).to(dev).float()
                    want = q.encode(xs[i]).cpu().numpy()
                    check(np.array_equal(codes[i * CLI_BATCH:(i + 1) * CLI_BATCH], want),
                          f"cli encode: batch {i} differs from Quantizer.encode")
            x0 = torch.cat([xs[i] for i in range(ENCODE_ROWS[0][1] // CLI_BATCH)])
            auto = auto_search(q.config, x0)
            name = auto["name"]
            problem = auto["problem"](q.params, q.config, x0, passes=auto["passes"], **auto["kw"])
            indexes = codec.unpack_indexes(torch.from_numpy(codes[:x0.shape[0]]).to(dev),
                                           q.codebook_size, q.num_codebooks)
            chk = against_plain(problem, q.get_centers().detach(), got=indexes)
            check(chk["ok"], f"cli encode: rows 0-{x0.shape[0] - 1} vs the plain "
                             f"{auto['kernel']}: {chk}")
            xb = x0[:CHECK_B]
            sse_beam = float(((q.decode(q.encode(xb, search_method="beam")) - xb) ** 2).sum())
            sse = float(((q.decode(torch.from_numpy(codes[:CHECK_B]).to(dev)) - xb) ** 2).sum())
            ratio = sse / sse_beam
            check(ratio <= BAR, f"cli encode: squared error {ratio} x beam-5 > {BAR}")
            out.update({"config": name, "encode_launches": {auto["kernel"]: n_k2},
                        "encode_vec_per_s": enc["steady_vec_per_s"],
                        "encode_steady_s": enc["steady_seconds"],
                        "in_memory_encode_vec_per_s": main_path["encode_vec_per_s"],
                        "search_vs_plain": {k: chk[k] for k in CHECK_KEYS},
                        "quality_delta_pct": (ratio - 1.0) * 100.0})
            print(f"[cli encode] {CLI_FRAMES} frames from {len(sizes)} shards, batch {CLI_BATCH}: "
                  f"{enc['steady_vec_per_s']:,.0f} vec/s steady-state (phase 4's in-memory "
                  f"encode {main_path['encode_vec_per_s']:,.0f}, "
                  f"{enc['steady_vec_per_s'] / main_path['encode_vec_per_s']:.3f}x); launches "
                  f"{n_k2}; rows {ENCODE_ROWS} equal to Quantizer.encode; agreement with plain "
                  f"{chk['index_agreement']:.6f}; quality {(ratio - 1.0) * 100.0:+.3f}% vs beam-5",
                  flush=True)

            # the host's share: the sequential read alone, then the read with
            # the CLI's pinned upload of every batch (no encode)
            t0 = time.perf_counter()
            for _ in iter_shards_sequential(corpus, CLI_BATCH, dtype=np.float16):
                pass
            read_s = time.perf_counter() - t0
            upload = cli._Upload(dev)
            t0 = time.perf_counter()
            for b in iter_shards_sequential(corpus, CLI_BATCH, dtype=np.float16):
                upload(b)
            torch.cuda.synchronize()
            read_upload_s = time.perf_counter() - t0
            out.update({"read_s": read_s, "read_and_upload_s": read_upload_s})
            print(f"[cli encode] host split, {CLI_FRAMES} frames: sequential read {read_s:.3f} s "
                  f"({CLI_FRAMES / read_s:,.0f} frames/s), read and pinned upload "
                  f"{read_upload_s:.3f} s ({CLI_FRAMES / read_upload_s:,.0f} frames/s); the "
                  f"CLI's encode {(CLI_FRAMES - CLI_BATCH) / enc['steady_vec_per_s']:.3f} s "
                  "from the second batch", flush=True)

            # the card's busy share over one traced CLI encode
            walls = []

            def encode_16():
                t = time.perf_counter()
                cli.main(["encode", "--quantizer", str(TRAINED[FIRST[512]]), "--data", str(corpus),
                          "--out", str(d / "codes_p.npy"), "--limit", str(CLI_PROFILE_LIMIT)])
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)

            rows = profile_device_ops(encode_16)
            del stats[:]
            device_ms = sum(r["ms"] for r in rows)
            busy = device_ms / (walls[-1] * 1e3)
            check(any(auto["op"] in r["source"] for r in rows[:5]),
                  f"cli encode: the {auto['kernel']} kernel is not among the top 5 rows: "
                  f"{rows[:5]}")
            out.update({"profile_frames": CLI_PROFILE_LIMIT, "profile_wall_ms": walls[-1] * 1e3,
                        "profile_device_ms": device_ms, "device_busy_share": busy,
                        "profile_top5": _short(rows[:5])})
            print(f"[cli encode] device busy {100 * busy:.1f}%: {device_ms:.3f} ms of "
                  f"{walls[-1] * 1e3:.1f} ms ({CLI_PROFILE_LIMIT} frames, traced); top 5: "
                  + "; ".join(f"{r['source'][:70]} {r['ms']:.3f} ms x{r['count']}"
                              for r in rows[:5]), flush=True)

            # decode, through the module entry point
            recon_path = d / "recon.npy"
            run = subprocess.run(
                [sys.executable, "-m", "quantization_tpu_torch", "decode", "--quantizer",
                 str(TRAINED[FIRST[512]]), "--codes", str(codes_path), "--out", str(recon_path)],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            check(run.returncode == 0, f"cli decode exited {run.returncode}: {run.stderr[-3000:]}")
            m = re.search(r"decoded (\d+) frames .*\((\d+) vec/s", run.stderr)
            check(m is not None and int(m.group(1)) == CLI_FRAMES,
                  f"cli decode: no summary line: {run.stderr[-1000:]}")
            recon = np.load(recon_path, mmap_mode="r")
            check(recon.dtype == np.float32 and recon.shape == (CLI_FRAMES, 512),
                  f"cli decode: recon {recon.dtype} {recon.shape}")
            for a, b in DECODE_ROWS:
                want = q.decode(torch.from_numpy(codes[a:b]).to(dev)).cpu().numpy()
                check(np.array_equal(recon[a:b], want),
                      f"cli decode: rows {a}-{b - 1} differ from Quantizer.decode")
            num = den = 0.0
            for i, b in enumerate(iter_shards_sequential(corpus, 65536, dtype=np.float16)):
                x = torch.from_numpy(b).to(dev).float()
                r = torch.from_numpy(np.array(recon[i * 65536:i * 65536 + x.shape[0]])).to(dev)
                num += float(((r - x) ** 2).sum())
                den += float((x ** 2).sum())
            out.update({"decode_vec_per_s": float(m.group(2)), "decode_rel_err": num / den})
            print(f"[cli decode] {CLI_FRAMES} frames: {float(m.group(2)):,.0f} vec/s (upload, "
                  f"decode, fetch); rows {DECODE_ROWS} equal to Quantizer.decode; relative "
                  f"error {num / den:.6f} against the corpus", flush=True)
    finally:
        logging.getLogger("quantization_tpu_torch.cli").removeHandler(handler)

    out["profile_train"] = profile_train(sampler, dev)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[cli] phase 9 took {out['phase_s']:.1f} s (corpus write {out['corpus_write_s']:.1f} s,"
          f" train {out['train_s']:.1f} s)", flush=True)
    return out


def cli_train_multi_kmeans(corpus, d, x600, dev) -> dict:
    """Phase 10 (d): ``train --init multi_kmeans`` on phase 9's corpus (4 + 4
    steps, batch 600; the first batch fits the phase-1 codebooks).  The
    quantizer it writes must load, be 8 x 256 and give finite losses on
    ``x600``."""
    from quantization_tpu_torch import cli, load_quantizer

    qpath = d / "q_multi_kmeans.npz"
    t0 = time.perf_counter()
    cli.main(["train", "--data", str(corpus), "--dim", "512", "--bytes-per-frame", "8",
              "--iters", "4", "--batch", str(TRAIN_BATCH), "--chunk", "4", "--quiet",
              "--init", "multi_kmeans", "--out", str(qpath)])
    torch.cuda.synchronize()
    out = {"path": "cli train --init multi_kmeans", "train_s": time.perf_counter() - t0}
    tq = load_quantizer(qpath, device=dev)
    check((tq.num_codebooks, tq.codebook_size) == (8, 256),
          f"cli train --init multi_kmeans: config {tq.config}")
    out["train_losses"] = {k: float(v) for k, v in tq.compute_loss(x600)._asdict().items()}
    check(all(math.isfinite(v) for v in out["train_losses"].values()),
          f"cli train --init multi_kmeans: a loss term is not finite: {out['train_losses']}")
    print(f"[aux cli] train --init multi_kmeans (4 + 4 steps, batch {TRAIN_BATCH}): "
          f"{out['train_s']:.2f} s; wrote an 8 x 256 quantizer that loads; losses on a batch "
          f"{out['train_losses']}", flush=True)
    return out


def aux_phase(samplers: dict, dev) -> dict:
    """Phase 10: the aux models at full width.  (a) ``QuantizerTrainer(...,
    init="multi_kmeans", train_search="gramv3")`` at d512 / 8 B; (b) the
    staged ``MultiKmeansTrainer`` 16 x 4 -> 8 x 16 -> 4 x 256 at d512; (c)
    ``PredictorTrainer`` against the d512 and d256 quantizers (K2 once a step),
    with the checkpointed predictor's gradients against the plain ones and a
    traced step.  Returns the ``paths`` entries and, per kernel launched, a
    check entry (launches in the counted window, held against its plain
    version, times and bound at the path's shape)."""
    import numpy as np

    from quantization_tpu_torch import JointCodebookLoss, QuantizerTrainer, load_quantizer
    from quantization_tpu_torch.core.types import scaled_centers
    from quantization_tpu_torch.models import multi_kmeans as mk
    from quantization_tpu_torch.ops import gramv3 as K3
    from quantization_tpu_torch.ops.quality_guard import against_plain, eval_frames
    from quantization_tpu_torch.train import MultiKmeansTrainer, PredictorTrainer
    from quantization_tpu_torch.utils.device import device_ms
    from quantization_tpu_torch.utils.profiling import profile_device_ops

    t_phase = time.perf_counter()
    paths, checks = [], []
    guard = eval_frames(512, dev)  # the guard's key-42 frames, seeds 7, 8, 9
    fit_data, held_out = guard[7], guard[8]

    # (a) the multi-kmeans init, then training across the phase switch
    p1 = TRAIN["phase_one_iters"]
    kw = dict(TRAIN, train_search="gramv3", beam_finetune_iters=0, init="multi_kmeans",
              init_data=fit_data, init_iters=AUX_INIT_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = QuantizerTrainer(device=dev, **kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    w, c = t.params.to_logits_w, t.params.centers
    check(bool(torch.equal(w, c.reshape(w.shape))) and w.data_ptr() != c.data_ptr(),
          "aux init: to_logits_w is not a separate copy of the fitted centers")
    # the fit's start: its trainer, seeded as the QuantizerTrainer seeds it
    rng = np.random.default_rng(TRAIN["seed"])
    rng.integers(0, 2**31)  # the parameters' seed
    start = MultiKmeansTrainer(512, 16, 2 * TRAIN["bytes_per_frame"], num_stages=1,
                               iters_per_stage=AUX_INIT_ITERS, seed=int(rng.integers(0, 2**31)),
                               device=dev).get_quantizer()
    fitted = mk.MultiKmeansQuantizer(512, 16, 2 * TRAIN["bytes_per_frame"], device=dev,
                                     params=mk.MultiKmeansParams(c.detach(), torch.zeros(())))
    err0, err1 = float(start.compute_ref_loss(held_out)), float(fitted.compute_ref_loss(held_out))
    check(err1 < err0, f"aux init: the fit's ref loss went {err0} -> {err1}")
    xs = samplers[512](torch.Generator().manual_seed(11), (p1 + 4) * TRAIN_BATCH).reshape(
        p1 + 4, TRAIN_BATCH, 512)
    K3.GRAMV3_KERNEL.launches = 0
    losses = t.step_many(xs)
    torch.cuda.synchronize()
    n_k3 = K3.GRAMV3_KERNEL.launches
    check(n_k3 == 3, f"aux init: {n_k3} gramv3 launches, not one in each of 3 phase-2 steps")
    check((t.config.num_codebooks, t.config.codebook_size) == (8, 256),
          f"aux init: phase-2 config {t.config}")
    check(all(bool(torch.isfinite(v).all()) for step in losses for v in step),
          "aux init: a loss term is not finite")
    params, cfg = t.params.detach(), t.config
    problem = K3.gramv3_problem(params, cfg, xs[-1], passes=1, g_dtype="bf16")
    chk = against_plain(problem, scaled_centers(params, cfg.scale_speed))
    check(chk["ok"] and chk["index_agreement"] == 1.0,
          f"aux init: gramv3 vs plain on a phase-2 batch: {chk}")
    checks.append({"where": "training gramv3 from the multi-kmeans init", "kernel": "gramv3",
                   "shape": f"B={TRAIN_BATCH} D=512 nc=8 passes=1 M=8 R=4", "launches": n_k3,
                   **{k: chk[k] for k in CHECK_KEYS},
                   "ms": device_ms(lambda: K3.gramv3_cuda(problem), 20),
                   "plain_ms": device_ms(lambda: K3.gramv3_plain(problem), 3),
                   **_gramv3_bound(TRAIN_BATCH, 8, 1, 8, "bf16")})
    paths.append({"path": "QuantizerTrainer(init='multi_kmeans').step_many", "train_search":
                  "gramv3", "batch": TRAIN_BATCH, **{k: v for k, v in kw.items()
                                                     if k != "init_data"},
                  "init_frames": fit_data.shape[0], "fit_s": fit_s, "fit_ref_loss": [err0, err1],
                  "launches": {"gramv3": n_k3},
                  "final_losses": {k: float(v) for k, v in losses[-1]._asdict().items()}})
    print(f"[aux init] multi_kmeans fit ({AUX_INIT_ITERS} steps, batch 512, 16 x 16 at d512) and "
          f"construction {fit_s:.2f} s; ref loss on 8,192 held-out frames {err0:.4f} -> "
          f"{err1:.4f} ({(err1 / err0 - 1) * 100:+.1f}%); to_logits_w a separate copy; gramv3 "
          f"launches {n_k3} in 3 phase-2 steps, every index equal to plain", flush=True)

    # (b) the staged multi-kmeans trainer, the growth of the reference's script
    mt = MultiKmeansTrainer(dim=512, codebook_size=4, num_codebooks=16, num_stages=3,
                            iters_per_stage=AUX_STAGE_ITERS, seed=0, device=dev)
    xb = samplers[512](torch.Generator().manual_seed(12), 3 * AUX_STAGE_ITERS * 512).reshape(
        3 * AUX_STAGE_ITERS, 512, 512)
    stages = []
    for stage, shape in enumerate(((16, 4), (8, 16), (4, 256))):
        check(tuple(mt.params.centers.shape) == (*shape, 512),
              f"aux staged: stage {stage} centers {tuple(mt.params.centers.shape)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [mt.step(x) for x in xb[stage * AUX_STAGE_ITERS:(stage + 1) * AUX_STAGE_ITERS]]
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        check(bool(torch.isfinite(torch.stack([torch.stack(o[1:]) for o in outs])).all()),
              f"aux staged: a loss of stage {stage} is not finite")
        stages.append({"num_codebooks": shape[0], "codebook_size": shape[1],
                       "steps_per_s": AUX_STAGE_ITERS / s})
    check(mt.done(), "aux staged: not done after 3 stages")
    mq = mt.get_quantizer()
    codes = mq.encode(held_out, as_bytes=True)
    check(codes.dtype == torch.uint8 and tuple(codes.shape) == (8192, 4),
          f"aux staged: codes {codes.dtype} {tuple(codes.shape)}")
    check(bool(torch.equal(mq.decode(codes), mq.decode(mq.encode(held_out)))),
          "aux staged: the decode of the packed codes differs from the unpacked one's")
    ref = float(mq.compute_ref_loss(held_out))
    paths.append({"path": "MultiKmeansTrainer.step", "dim": 512, "batch": 512,
                  "iters_per_stage": AUX_STAGE_ITERS, "stages": stages, "ref_loss": ref})
    print("[aux staged] d512 batch 512, " + ", ".join(
        f"{e['num_codebooks']} x {e['codebook_size']} {e['steps_per_s']:.1f} steps/s"
        for e in stages) + f"; codes (8192, 4) uint8, decode bit-equal; ref loss {ref:.4f}",
        flush=True)

    # (c) the predictor against the d512 and d256 quantizers
    for dim in PRED_DIMS:
        q = load_quantizer(TRAINED[FIRST[dim]], device=dev)
        tr = PredictorTrainer(q, predictor_channels=dim, seed=0)
        xp = samplers[dim](torch.Generator().manual_seed(13), AUX_PRED_STEPS * 512).reshape(
            AUX_PRED_STEPS, 512, dim)
        auto = auto_search(q.config, xp[0], tr.encode_refine_iters)
        auto["counter"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ce = [tr.step(x) for x in xp]
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        n_k2 = auto["counter"].launches
        check(n_k2 == AUX_PRED_STEPS,
              f"aux predictor d{dim}: {n_k2} {auto['kernel']} launches in {AUX_PRED_STEPS} steps")
        check(all(math.isfinite(v) for v in ce),
              f"aux predictor d{dim}: a loss is not finite")
        first, last = statistics.mean(ce[:10]), statistics.mean(ce[-10:])
        check(last < first, f"aux predictor d{dim}: mean CE {first} -> {last}")
        # the targets' kernel against its plain version on the path's batch
        x = xp[-1]
        passes = auto["passes"]
        problem = auto["problem"](q.params, q.config, x, passes=passes, **auto["kw"])
        chk = against_plain(problem, q.get_centers().detach(),
                            got=q.encode(x, refine_indexes_iters=tr.encode_refine_iters,
                                         as_bytes=False))
        check(chk["ok"], f"aux predictor d{dim}: the targets vs the plain {auto['kernel']}: "
                         f"{chk}")
        checks.append({"where": f"predictor targets d{dim}", "kernel": auto["kernel"],
                       "config": auto["name"], "shape": f"B=512 D={dim} nc={q.num_codebooks} "
                       f"passes={passes}", "launches": n_k2, **{k: chk[k] for k in CHECK_KEYS},
                       "ms": device_ms(lambda: auto["cuda"](problem), 20),
                       "plain_ms": device_ms(lambda: auto["plain"](problem), 3),
                       **auto["bound"](512)})
        entry = {"path": "PredictorTrainer.step", "dim": dim, "quantizer": TRAINED[FIRST[dim]].name,
                 "batch": 512, "hidden_channels": 512, "steps": AUX_PRED_STEPS,
                 "launches": {auto["kernel"]: n_k2}, "steps_per_s": AUX_PRED_STEPS / s,
                 "mean_ce_first10": first, "mean_ce_last10": last}
        line = (f"[aux predictor d{dim}] {q.num_codebooks} x 256, batch 512, hidden 512: "
                f"{entry['steps_per_s']:.1f} steps/s; {auto['kernel']} launches {n_k2} in "
                f"{AUX_PRED_STEPS} steps; mean CE a frame {first:.3f} -> {last:.3f}; targets "
                f"vs plain agreement {chk['index_agreement']:.6f}")
        if dim == 512:
            # the checkpointed predictor's gradients against the plain ones
            idx = q.encode(x, as_bytes=False)
            grads = []
            for ckpt in (True, False):
                mod = JointCodebookLoss(dim, q.num_codebooks, 512, 256, checkpoint=ckpt,
                                        params=tr.params, device=dev)
                with torch.enable_grad():
                    mod(x, idx).backward()
                grads.append({f: p.grad for f, p in mod.named_parameters()})
            rel = {f: float((grads[0][f] - grads[1][f]).abs().max()
                            / grads[1][f].abs().max().clamp(min=1e-30)) for f in grads[1]}
            check(all(v <= 1e-6 for v in rel.values()) and all(
                float(g.abs().max()) > 0 for g in grads[0].values()),
                f"aux predictor d{dim}: checkpointed vs plain gradients: {rel}")
            entry["checkpoint_grad_rel_diff"] = max(rel.values())
            # one traced step
            walls = []

            def step():
                t1 = time.perf_counter()
                tr.step(xp[0])
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)

            rows = profile_device_ops(step)
            check(any(auto["op"] in r["source"] for r in rows[:5]),
                  f"aux predictor d{dim}: the {auto['kernel']} kernel is not among the top 5 "
                  f"rows: {rows[:5]}")
            busy = sum(r["ms"] for r in rows) / (walls[-1] * 1e3)
            entry.update({"profile_step_ms": walls[-1] * 1e3, "device_busy_share": busy,
                          "profile_top5": _short(rows[:5])})
            line += (f"; checkpointed vs plain gradients within {max(rel.values()):.2e}; a "
                     f"traced step {walls[-1] * 1e3:.3f} ms, device busy {100 * busy:.1f}%, "
                     "top 5: " + "; ".join(f"{r['source'][:50]} {r['ms']:.3f} ms x{r['count']}"
                                           for r in rows[:5]))
        paths.append(entry)
        print(line, flush=True)
    return {"paths": paths, "checks": checks, "phase_s": time.perf_counter() - t_phase}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_trainer(t, xs, rows=slice(None)) -> float:
    """``t.step_many`` over this rank's ``rows`` of the global batches
    ``xs``; returns the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.step_many(xs[:, rows])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _max_param_diff(a: dict, b) -> dict:
    from quantization_tpu_torch.utils.torch_interop import PARAM_FIELDS

    return {f: float((a[f].to(getattr(b, f).device) - getattr(b, f).detach()).abs().max())
            for f in PARAM_FIELDS}


def _lockstep(t, ref, xs, rows) -> list:
    """Step the mesh trainer ``t`` on this rank's ``rows`` of each global
    batch in ``xs`` and the one-process trainer ``ref`` on the whole batch,
    from the same state at every step (``ref`` takes ``t``'s parameters,
    Adam moments and count after each step, so that no step inherits
    another's rounding).  Per step: the agreement of the training indexes
    on this rank's rows, both found from the same parameters; and where
    every index agrees, whether the four loss terms and the summed
    gradients (not at the phase switch, which replaces the parameters) are
    within the CPU tests' ``rtol=2e-4, atol=2e-5`` of ``ref``'s."""
    import numpy as np

    from quantization_tpu_torch.core.losses import _train_indexes
    from quantization_tpu_torch.core.types import LOCAL, QuantizerParams
    from quantization_tpu_torch.parallel import gather_params
    from quantization_tpu_torch.utils.torch_interop import PARAM_FIELDS

    tol = dict(rtol=2e-4, atol=2e-5)
    steps = []
    for x in xs:
        peek = np.random.default_rng()
        peek.bit_generator.state = t._rng.bit_generator.state
        iters = 2 if peek.random() < t.two_iter_prob else 1
        search = t._search_for_config(t.cur_iter)
        switch = t.cur_iter == t.phase_one_iters
        mine = _train_indexes(t.params, t.config, t._cols(x[rows]), iters, search, t._reducer)
        want = _train_indexes(ref.params, ref.config, x, iters, search, LOCAL)[rows]
        agreement = float((mine == want).float().mean())
        got, exp = t.step(x[rows]), ref.step(x)
        step = {"iter": t.cur_iter - 1, "search": search, "index_agreement": agreement}
        if agreement == 1.0:
            step["losses_close"] = all(torch.allclose(a, b, **tol) for a, b in zip(got, exp))
            if not switch:
                grads = gather_params(QuantizerParams(**{
                    f: getattr(t.params, f).grad for f in PARAM_FIELDS}), t.mesh)
                step["grads_close"] = all(torch.allclose(getattr(grads, f),
                                                         getattr(ref.params, f).grad, **tol)
                                          for f in PARAM_FIELDS)
        ref._load_state_leaves(t._state_leaves())
        steps.append(step)
    return steps


def parallel_phase(q, x, sampler, dev) -> dict:
    """Phase 11: multi-device runs at full width, held against one process.
    (a) One rank over NCCL in this process: ``encode_sharded`` (auto, K2)
    and ``decode_sharded(use_kernel=True)`` (K1) on phase 4's frames equal
    ``Quantizer.encode`` and ``decode`` bit for bit, and the trainer under
    the mesh (gramv3, K3 once a phase-2 step) ends equal to the run without
    a mesh.  (b), (c) Two ranks, two processes on the one card over gloo
    (NCCL refuses two ranks on one device): the 2 x 1 mesh's encode (16,384
    frames a rank) and decode, its data-parallel trainer (300 + 300 frames a
    step), then the 1 x 2 model mesh's trainer (beam), each held to one
    process (the trainers step by step, :func:`_lockstep`).  Returns the
    ``paths`` entry and the launches."""
    import multiprocessing
    import queue

    import torch.distributed as dist

    from quantization_tpu_torch import QuantizerTrainer
    from quantization_tpu_torch.ops import logits_argmax as LA
    from quantization_tpu_torch.parallel import (decode_sharded, encode_sharded,
                                                 init_distributed, make_mesh)
    from quantization_tpu_torch.utils.torch_interop import PARAM_FIELDS

    t_phase = time.perf_counter()
    counters = launch_counters()
    n = PARALLEL_TRAIN["phase_one_iters"] + PARALLEL_TRAIN["phase_two_iters"] + 1
    xs = sampler(torch.Generator().manual_seed(11), n * TRAIN_BATCH).reshape(
        n, TRAIN_BATCH, PARALLEL_TRAIN["dim"])
    searches = {"gramv3": dict(train_search="gramv3", beam_finetune_iters=0),
                "auto": dict(train_search="auto")}
    # the one-process references
    codes_ref = q.encode(x)
    recon_ref = q.decode(codes_ref, use_kernel=True)
    ref = {}
    for name, kw in searches.items():
        ref[name] = QuantizerTrainer(device=dev, **PARALLEL_TRAIN, **kw)
        _run_trainer(ref[name], xs)
    out = {"path": "parallel", "frames": x.shape[0], "batch": TRAIN_BATCH, **PARALLEL_TRAIN,
           "scaling": "not measured: the ranks of (b) and (c) share one card"}
    launches = dict.fromkeys(counters, 0)
    auto_kernel = auto_search(q.config, x)["kernel"]

    def launches_as_expected(got, kernel):
        """auto's encode launched its kernel once and K1 at least once, and
        the trainer K3 once a phase-2 step."""
        return (got["decode"] >= 1 and got[kernel] >= 1 and got["gramv3"]
                == PARALLEL_TRAIN["phase_two_iters"] + (kernel == "gramv3"))

    # (a) one rank over NCCL
    init_distributed("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                     world_size=1)
    try:
        check(dist.get_backend() == "nccl", f"phase 11 (a): backend {dist.get_backend()}")
        mesh = make_mesh(device=dev)
        for c in counters.values():
            c.launches = 0
        n_init = LA.LOGITS_ARGMAX_KERNEL.launches
        codes = encode_sharded(q.params, q.config, x, mesh)
        recon = decode_sharded(q.params, q.config, codes, mesh, use_kernel=True)
        t = QuantizerTrainer(mesh=mesh, **PARALLEL_TRAIN, **searches["gramv3"])
        train_s = _run_trainer(t, xs)
        got = {k: c.launches for k, c in counters.items()}
        check(launches_as_expected(got, auto_kernel),
              f"phase 11 (a): launches {got}: auto's {auto_kernel} and K1, and K3 once a "
              f"phase-2 step")
        n_init = LA.LOGITS_ARGMAX_KERNEL.launches - n_init
        check(n_init == got["seqbeam_v2"] + got["gramv3"],
              f"phase 11 (a): {n_init} initial-index launches, not one a search ({got})")
        check(bool(torch.equal(codes, codes_ref)), "phase 11 (a): encode_sharded codes differ")
        check(bool(torch.equal(recon, recon_ref)), "phase 11 (a): decode_sharded differs")
        diffs = {f: float((getattr(t.params, f) - getattr(ref["gramv3"].params, f)).detach().abs().max())
                 for f in PARAM_FIELDS}
        check(all(torch.equal(getattr(t.params, f), getattr(ref["gramv3"].params, f))
                  for f in PARAM_FIELDS), f"phase 11 (a): trainer differs from one process {diffs}")
        enc_s = host_s(lambda: encode_sharded(q.params, q.config, x, mesh), 3)
    finally:
        dist.destroy_process_group()
    for k, v in got.items():
        launches[k] += v
    launches["logits_argmax"] = n_init
    out["nccl_1_rank"] = {"launches": got, "codes_equal": True, "decode_equal": True,
                          "trainer_params_equal": True, "encode_s": enc_s,
                          "train_steps_s": train_s}
    print(f"[parallel nccl 1 rank] launches {got}; encode_sharded codes and decode_sharded "
          f"equal to Quantizer.encode/decode bit for bit; trainer (gramv3, {n} steps) "
          f"equal to one process; encode {enc_s:.4f} s for {x.shape[0]} frames, "
          f"training {train_s:.3f} s", flush=True)

    # (b), (c) two ranks over gloo, one process each
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        inputs = pathlib.Path(d) / "inputs.pt"
        torch.save({"x": x.cpu(), "xs": xs.cpu(), "codes": codes_ref.cpu(),
                    "recon": recon_ref.cpu(), "quantizer": str(TRAINED[FIRST[512]])}, inputs)
        port = _free_port()
        procs = [ctx.Process(target=_parallel_rank,
                             args=(r, 2, port, str(inputs), str(dev), results))
                 for r in range(2)]
        for p in procs:
            p.start()
        ranks = {}
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        try:
            while len(ranks) < 2:
                try:
                    r, value, error = results.get(
                        timeout=max(deadline - time.monotonic(), 0.1))
                except queue.Empty:
                    raise RuntimeError(f"phase 11: ranks {sorted({0, 1} - set(ranks))} did "
                                       f"not finish in {PARALLEL_TIMEOUT_S} s") from None
                check(error is None, f"phase 11: rank {r} failed:\n{error}")
                value["codes"] = torch.from_numpy(value["codes"])
                for key in ("data", "model"):
                    value[key] = {k: torch.from_numpy(v) for k, v in value[key].items()}
                ranks[r] = value
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        codes_ok = [bool(torch.equal(v["codes"], codes_ref.cpu())) for v in ranks.values()]
    check([p.exitcode for p in procs] == [0, 0],
          f"phase 11: the ranks exited {[p.exitcode for p in procs]}")
    r0, r1 = ranks[0], ranks[1]
    for r, v in ranks.items():
        got = v["launches"]
        check(launches_as_expected(got, auto_kernel), f"phase 11 rank {r}: launches {got}")
        for k, c in got.items():
            launches[k] += c
        check(v["rows"] == x.shape[0] // 2, f"phase 11 rank {r}: encoded {v['rows']} rows")
        check(v["decode_equal"], f"phase 11 rank {r}: decode_sharded differs")
    agreement = float((r0["codes"] == codes_ref.cpu()).all(dim=1).float().mean())
    check(all(codes_ok), f"phase 11 (b): encode_sharded codes differ from phase 4's "
                         f"(frames agreeing on every byte: {agreement:.6f})")
    for name, key in (("gramv3", "data"), ("auto", "model")):
        check(all(torch.equal(r0[key][f], r1[key][f]) for f in PARAM_FIELDS),
              f"phase 11 ({key} mesh): the two ranks' parameters differ")
        # one process and the mesh sum in other orders; Adam turns the
        # sign of a gradient near 0 into a whole step of lr, and a frame
        # near a tie may take another index, so whole runs are compared
        # step by step from the same state (_lockstep), and their final
        # parameters' distance is printed, not held (a one-process run on
        # the same rows reordered is as far off: PERF.md, phase 11)
        steps = r0[f"{key}_lockstep"] + r1[f"{key}_lockstep"]
        full = [s for s in steps if s["index_agreement"] == 1.0]
        check(all(s["index_agreement"] >= 0.995 for s in steps),
              f"phase 11 ({key} mesh): index agreement below phase 3's 99.5%: {steps}")
        check(len(full) * 2 >= len(steps) and all(
            s["losses_close"] and s.get("grads_close", True) for s in full),
              f"phase 11 ({key} mesh): a step off one process's: {steps}")
        diffs = _max_param_diff(r0[key], ref[name].params)
        out[f"gloo_2_ranks_{key}"] = {
            "train_search": name, "lockstep": steps, "final_max_abs_diff_free_run": diffs,
            "train_steps_s": r0[f"{key}_train_s"]}
        print(f"[parallel {key} mesh lockstep] {len(full)} of {len(steps)} rank-steps with "
              f"every index equal to one process's, their losses and gradients within rtol "
              f"2e-4 atol 2e-5; lowest agreement "
              f"{min(s['index_agreement'] for s in steps):.6f}; a free run's final "
              f"parameters off one process's by at most {max(diffs.values()):.3g}",
              flush=True)
    out["gloo_2_ranks_data"].update(codes_equal=True, encode_s=r0["encode_s"],
                                    launches=[r0["launches"], r1["launches"]])
    print(f"[parallel gloo 2 ranks, one card] 2 x 1: encode_sharded {r0['rows']} frames a "
          f"rank, codes equal to phase 4's, decode equal; launches "
          f"{[r0['launches'], r1['launches']]}; encode {r0['encode_s']:.4f} s, data-parallel "
          f"training (gramv3, {TRAIN_BATCH // 2} + {TRAIN_BATCH // 2} frames a step) "
          f"{r0['data_train_s']:.3f} s; 1 x 2: model-parallel training (beam) "
          f"{r0['model_train_s']:.3f} s; two ranks on one card measure no scaling", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[parallel] phase 11 took {out['phase_s']:.1f} s", flush=True)
    return {"paths": [out], "launches": launches}


def _parallel_rank(rank: int, world: int, port: int, inputs: str, device: str,
                   results) -> None:
    """One rank of phase 11's gloo runs, in a process of its own on the card:
    the 2 x 1 mesh's encode, decode and data-parallel trainer, then the
    1 x 2 mesh's trainer.  Puts ``(rank, result, error)`` on ``results``."""
    import datetime
    import traceback

    import torch.distributed as dist

    try:
        from quantization_tpu_torch import QuantizerTrainer, load_quantizer
        from quantization_tpu_torch.core import codec
        from quantization_tpu_torch.parallel import (decode_sharded, encode_sharded,
                                                     gather_params, init_distributed,
                                                     make_mesh)
        from quantization_tpu_torch.utils.torch_interop import params_to_numpy

        dev = torch.device(device)
        init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                         world_size=world, timeout=datetime.timedelta(seconds=120))
        data = torch.load(inputs)
        q = load_quantizer(data["quantizer"], device=dev)
        x, xs = data["x"].to(dev), data["xs"].to(dev)
        counters = launch_counters()
        out = {}
        mesh = make_mesh(num_data=world, device=dev)
        b = xs.shape[1] // world
        mine = slice(rank * b, (rank + 1) * b)
        kw = dict(PARALLEL_TRAIN, train_search="gramv3", beam_finetune_iters=0)
        # untimed and uncounted: a first encode (the kernels' libraries, the
        # gate's tables), then the step-by-step comparison, which warms the
        # trainer's path
        encode_sharded(q.params, q.config, x, mesh)
        out["data_lockstep"] = _lockstep(QuantizerTrainer(mesh=mesh, **kw),
                                         QuantizerTrainer(device=dev, **kw), xs, mine)
        for c in counters.values():
            c.launches = 0
        rows, encode = [], codec.encode

        def counting(p, c, xl, *args, **kwargs):  # the rows this rank encodes
            rows.append(xl.shape[0])
            return encode(p, c, xl, *args, **kwargs)

        codec.encode = counting
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            codes = encode_sharded(q.params, q.config, x, mesh)
            torch.cuda.synchronize()
            out["encode_s"] = time.perf_counter() - t0
        finally:
            codec.encode = encode
        out["rows"] = rows[0]
        out["codes"] = codes.cpu().numpy()  # numpy: a torch tensor would be sent by a
        # file descriptor that dies with this process
        recon = decode_sharded(q.params, q.config, codes, mesh, use_kernel=True)
        out["decode_equal"] = bool(torch.equal(recon.cpu(), data["recon"]))
        t = QuantizerTrainer(mesh=mesh, **kw)
        out["data_train_s"] = _run_trainer(t, xs, mine)
        out["launches"] = {k: c.launches for k, c in counters.items()}
        out["data"] = params_to_numpy(gather_params(t.params.detach(), mesh))
        mesh = make_mesh(num_data=1, num_model=world, device=dev)
        kw = dict(PARALLEL_TRAIN, train_search="auto")
        out["model_lockstep"] = _lockstep(QuantizerTrainer(mesh=mesh, **kw),
                                          QuantizerTrainer(device=dev, **kw), xs, slice(None))
        t = QuantizerTrainer(mesh=mesh, **kw)
        out["model_train_s"] = _run_trainer(t, xs)
        out["model"] = params_to_numpy(gather_params(t.params.detach(), mesh))
        results.put((rank, out, None))
    except Exception:  # the parent fails the phase with this traceback
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def parity_phase(smi: str) -> dict:
    """Phase 12: the quality-parity run at ``PARITY``, through the function
    the entry point calls, held to bars (i)-(iii) against the JAX package's
    and the reference's recorded runs (both must exist).  Returns the
    ``paths`` entry and the launches of the run and its eval."""
    from quantization_tpu_torch.experiments import head_to_head as h2h

    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    result, _ = h2h.run(*PARITY, device="cuda")
    got = {k: c.launches for k, c in counters.items()}
    # the run trains with the exact beam; its eval's encode(auto) launches a
    # search kernel
    check(got["seqbeam_v2"] + got["gramv3"] >= 1 and got["decode"] >= 1,
          f"phase 12: the eval's encode(auto) and kernel decode launched {got}")
    out = h2h.hold(result)
    name = h2h.stem(*PARITY[:4])[len("head_to_head_"):]
    print(f"[parity {name} batch {PARITY[4]}] rel_err={out['rel_err']:.6f} "
          f"jax={out['jax_rel_err']} ref={out['ref_rel_err']} ratio_ref={out['ratio_ref']} "
          f"ratio_jax={out['ratio_jax']} auto_delta_pct={out['auto_delta_pct']:+.4f} "
          f"wall_s={out['wall_s']:.1f} steps_per_s={out['steps_per_s']:.1f} | {smi}", flush=True)
    check(all(isinstance(b, dict) for b in out["bars"].values()),
          f"phase 12: a record is missing: {out['bars']}")
    check(out["ok"], f"phase 12: a bar failed: {out['bars']}")
    return {"paths": [{"path": "parity", **out, "launches": got}], "launches": got}


def profile_train(sampler, dev) -> list:
    """``profile_device_ops`` over one phase-1 and one phase-2 step of
    phase 6's trainer and batches, for train_search "auto" and "gramv3":
    per step its top 8 rows and the card's busy share of the traced step's
    host time (the step ends in a synchronize)."""
    from quantization_tpu_torch import QuantizerTrainer
    from quantization_tpu_torch.utils.profiling import profile_device_ops

    p1, p2, dim = TRAIN["phase_one_iters"], TRAIN["phase_two_iters"], TRAIN["dim"]
    n = p1 + p2 + 1
    xs = sampler(torch.Generator().manual_seed(11), n * TRAIN_BATCH).reshape(n, TRAIN_BATCH, dim)
    out = []
    for search in ("auto", "gramv3"):
        kw = dict(TRAIN, train_search=search)
        if search == "gramv3":
            kw["beam_finetune_iters"] = 0  # phase 2 runs the kernel
        t = QuantizerTrainer(device=dev, **kw)
        for phase in (1, 2):
            if phase == 2:
                t.step_many(xs[t.cur_iter:p1 + 1])  # through the phase switch
            walls = []

            def step():
                t0 = time.perf_counter()
                t.step(xs[t.cur_iter])
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)

            rows = profile_device_ops(step)  # two steps: a warm-up and the traced one
            check(rows, f"profile train {search} phase {phase}: no device activity")
            if search == "gramv3" and phase == 2:
                check(any("gramv3_kernel" in r["source"] for r in rows),
                      f"profile train gramv3 phase 2: no gramv3 kernel in {rows[:8]}")
            busy = sum(r["ms"] for r in rows) / (walls[-1] * 1e3)
            entry = {"train_search": search, "phase": phase, "step_ms": walls[-1] * 1e3,
                     "device_busy_share": busy, "kernels": len(rows),
                     "launches": sum(r["count"] for r in rows), "top8": _short(rows[:8])}
            out.append(entry)
            print(f"[profile train {search} phase {phase}] step {entry['step_ms']:.3f} ms, device "
                  f"busy {100 * busy:.1f}%, {entry['launches']} device ops of {len(rows)} kinds; "
                  "top 8: " + "; ".join(f"{r['source'][:60]} {r['ms']:.3f} ms x{r['count']}"
                                       for r in rows[:8]), flush=True)
    return out


def _short(rows: list) -> list:
    """Profile rows with their names cut to 120 characters."""
    return [dict(r, source=r["source"][:120]) for r in rows]


def step_ms(trainer, batches) -> float:
    """Host milliseconds a step of one ``step_many`` call over ``batches``,
    ending in a synchronize (the steps run ahead of the card as in training)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.step_many(batches)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(batches)


def _gramv3_bound(B: int, nc: int, passes: int, M: int, g_dtype: str) -> dict:
    """Per frame and pass, one root row and M rows for each later codebook,
    each the sum of nc table rows of 256, counted at the f32 add rate (the
    int8 tables' integer sums are exact in f32 too).  bf16 sums each row in
    codebook order, so every candidate adds all nc rows: B x passes x (1 +
    (nc-1) M) x nc x 256 adds.  int8 sums are exact in any order, so at step
    t the rows s >= t that every candidate shares need adding once: M t +
    (nc - t) rows a step, and nc for the root row.  The bytes are XC, the
    initial indexes, the root scores, the table and the output."""
    cs = 256
    K = nc * cs
    if g_dtype == "int8":
        rows = nc + sum(M * t + nc - t for t in range(1, nc))
    else:
        rows = (1 + (nc - 1) * M) * nc
    adds = B * passes * rows * cs
    nbytes = B * K * 4 + B * nc * 4 + B * 4 + K * K * (1 if g_dtype == "int8" else 2) + B * nc * 4
    return _bound(nbytes, {"f32": adds})


def _bound(nbytes: float, ops_by_type: dict) -> dict:
    """The least time for the work: bytes over the memory rate, or the
    operations over each type's peak rate, whichever is larger."""
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[t] for t, n in ops_by_type.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _seqbeam_bound(B: int, D: int, nc: int, passes: int, M: int, e_dtype: str) -> dict:
    """Per frame and pass, the rescore is one root row (bf16) and M rows
    for each later codebook (int8 or bf16) against 256 codewords of D; the
    bytes are the frames and indexes in, the indexes out and the tables."""
    cs = 256
    root = B * passes * 2 * D * cs
    beam = B * passes * (nc - 1) * M * 2 * D * cs
    ops = {"bf16": root + (0 if e_dtype == "int8" else beam)}
    if e_dtype == "int8":
        ops["int8"] = beam
    nbytes = B * D * 4 + 2 * B * nc * 4 + nc * cs * D * 2 + nc * cs * cs * 2
    if e_dtype == "int8":
        nbytes += nc * cs * D + nc * 4
    return _bound(nbytes, ops)


if __name__ == "__main__":
    sys.exit(main())
