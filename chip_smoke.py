#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``quantization_tpu_torch``) on one H100.

Phases, each of which raises (and exits nonzero) when its check fails:

1. build the five CUDA sources of ``quantization_tpu_torch/csrc``, one
   ``nvcc`` per source, started together;
2. decode (K1) at B=65,536, d512: bit-exact against its plain PyTorch
   version on the card; kernel, plain and ``F.embedding_bag`` times;
3. seqbeam v2 encode (K2) at the auto configs (d512 int8 E, d512 bf16 E,
   d256 bf16 E), each on 32,768 in-distribution frames: at least 99.5% of
   indexes equal to the plain version and summed squared error within 0.1%
   (``ops.quality_guard.against_plain``); kernel and plain times on the
   same inputs.  At auto's two rungs (d512 int8 E, d256 bf16 E) the
   stage-timed build (``ops.seqbeam.seqbeam_stages``) gives the same
   indexes and prints the ``[seqbeam stages]`` line: each stage's share of
   the warps' cycles and its microseconds a block-step;
4. the main path, for the two committed trained quantizers:
   ``load_quantizer`` -> ``Quantizer.encode(x)`` (``search_method="auto"``)
   -> ``decode(codes, use_kernel=True)`` on 32,768 frames, with the launch
   counts set to 0 just before and read just after.  The path's own outputs
   are held against the plain versions on its own inputs: its indexes
   against the plain seqbeam (the bars of phase 3) and its reconstruction
   against the plain decode of those indexes (bit-exact).  The squared
   error on 8,192 of the frames must be within 1.012 x the port's beam-5 on
   the same frames; encode and decode vectors/s;
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
   its microseconds a frame-step, with registers and blocks an SM;
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
   only).  Each floor kernel's output is checked before it is timed.

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
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 33.5e12}
ROOT = pathlib.Path(__file__).resolve().parent
TRAINED = {512: ROOT / "experiments/q512_8_full.npz", 256: ROOT / "experiments/q256_4_full.npz"}
ENC_CONFIGS = (  # (guard name, dim): every config on the auto ladder
    ("seqbeam_int8e_d512", 512),
    ("seqbeam_hl_d512", 512),
    ("seqbeam_m16_d512", 512),
    ("seqbeam_hl_d256", 256),
)
STAGE_CONFIGS = ("seqbeam_int8e_d512", "seqbeam_hl_d256")  # auto's rungs: the timed build
DECODE_B = 65536
CHECK_B = 8192
TIME_B = 32768
BAR = 1.012
V1 = dict(impl="v1", M=16, R=8)  # the JAX wrapper's defaults
V1_PASSES = 3
GRAM_CONFIGS = ((512, "bf16", None), (512, "int8", None), (512, "bf16", "altparity"),
                (256, "bf16", None), (256, "int8", None))  # (dim, g_dtype, pool_mask)
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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
    from quantization_tpu_torch.ops import seqbeam as K2
    from quantization_tpu_torch.ops.quality_guard import SEMANTIC_KEYS, against_plain
    from quantization_tpu_torch.utils.device import device_ms, nvidia_smi_line

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {smi}", flush=True)

    # ---- 1. build
    sources = ("decode", "seqbeam", "gramv3", "prim_bench", "int8_mxu_probe")
    build_s = cuda_build.build(sources)
    print(f"[build] {build_s:.1f} s", flush=True)
    for name in sources:
        regs = [l.strip() for l in cuda_build.build_log(name).splitlines() if "registers" in l]
        print(f"[build] {name}: {len(regs)} kernels; {regs[0] if regs else ''}", flush=True)

    quantizers = {dim: load_quantizer(path, device=dev) for dim, path in TRAINED.items()}
    samplers = {dim: make_mlp_sampler(dim, device=dev) for dim in TRAINED}

    def frames(dim, seed, n):
        return samplers[dim](torch.Generator().manual_seed(seed), n)

    # ---- 2. decode, K1
    q = quantizers[512]
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

    # ---- 3. encode, K2, at the auto configs
    ladder = {}
    for dim, qq in quantizers.items():
        for name, passes, kw in codec._auto_candidates(qq.config):
            ladder[name.rstrip("!")] = (passes, kw)
    k2_configs, stage_lines = [], []
    for name, dim in ENC_CONFIGS:
        qq = quantizers[dim]
        passes, kw = ladder[name]
        sem = {k: v for k, v in kw.items() if k in SEMANTIC_KEYS}
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

    # ---- 4. the main path, per trained quantizer
    paths = []
    main_frames = {}  # dim -> (frames, beam-5 squared error on the first CHECK_B)
    launches = {"decode": 0, "seqbeam_v2": 0}
    k1_checks = [{"where": "phase 2", "shape": k1["shape"], "max_abs_err": k1["max_abs_err"]}]
    k2_checks = []
    for dim, qq in quantizers.items():
        x = frames(dim, 9, TIME_B)
        K1.DECODE_KERNEL.launches = 0
        K2.SEQBEAM_KERNEL.launches = 0
        codes = qq.encode(x)
        recon = qq.decode(codes, use_kernel=True)
        torch.cuda.synchronize()
        n_dec, n_enc = K1.DECODE_KERNEL.launches, K2.SEQBEAM_KERNEL.launches
        check(n_enc > 0, f"d{dim}: encode(auto) did not launch the seqbeam kernel")
        check(n_dec > 0, f"d{dim}: decode(use_kernel=True) did not launch the decode kernel")
        launches["decode"] += n_dec
        launches["seqbeam_v2"] += n_enc
        check(codes.dtype == torch.uint8 and codes.shape == (TIME_B, qq.config.bytes_per_frame),
              f"d{dim}: codes {codes.dtype} {tuple(codes.shape)}")
        check(recon.shape == x.shape and bool(torch.isfinite(recon).all()),
              f"d{dim}: reconstruction {tuple(recon.shape)} not finite")
        # the main path's own outputs against the plain versions on its inputs
        chosen = codec.auto_choice(qq.config, x, 5)
        passes, kw = ladder[chosen[0]]
        sem = {k: v for k, v in kw.items() if k in SEMANTIC_KEYS}
        problem = K2.seqbeam_problem(qq.params, qq.config, x, passes=passes, **sem)
        indexes = codec.unpack_indexes(codes, qq.codebook_size, qq.num_codebooks)
        shape = f"B={TIME_B} D={dim} nc={qq.num_codebooks} passes={passes}"
        chk = against_plain(problem, qq.get_centers().detach(), got=indexes)
        check(chk["ok"], f"d{dim}: encode(auto) indexes vs the plain seqbeam: {chk}")
        k2_checks.append({"where": f"main path d{dim}", "config": chosen[0], "shape": shape,
                          **{k: chk[k] for k in CHECK_KEYS}})
        cb = scaled_centers(qq.params, qq.config.scale_speed).detach().to(torch.bfloat16)
        want = K1.decode_plain(indexes, cb)
        dec_err = float((recon - want).abs().max())
        check(bool(torch.equal(recon, want)),
              f"d{dim}: decode(use_kernel=True) is not bit-exact against the plain decode")
        k1_checks.append({"where": f"main path d{dim}", "max_abs_err": dec_err,
                          "shape": f"B={TIME_B} nc={qq.num_codebooks} cs={qq.codebook_size} D={dim}"})
        print(f"[main d{dim}] vs plain on the path's own inputs ({shape}): seqbeam agreement "
              f"{chk['index_agreement']:.6f}, sse rel diff {chk['sse_rel_diff']:+.2e}; "
              f"decode bit-exact", flush=True)
        xs, cs_ = x[:CHECK_B], codes[:CHECK_B]
        beam5 = qq.encode(xs, search_method="beam")
        sse_beam = float(((qq.decode(beam5) - xs) ** 2).sum())
        main_frames[dim] = (x, sse_beam)
        sse_auto = float(((qq.decode(cs_) - xs) ** 2).sum())
        sse_auto_k1 = float(((recon[:CHECK_B] - xs) ** 2).sum())
        ratio = sse_auto / sse_beam
        check(ratio <= BAR, f"d{dim}: auto/beam-5 squared error {ratio} > {BAR}")
        check(sse_auto_k1 / sse_beam <= BAR, f"d{dim}: bf16 decode error {sse_auto_k1 / sse_beam}")
        enc_s = host_s(lambda: qq.encode(x), 3)
        dec_s = host_s(lambda: qq.decode(codes, use_kernel=True), 5)
        # where the encode time goes: the logits-argmax init and the tables,
        # then the kernel (the rest is packing and Python)
        prep_ms = device_ms(lambda: K2.seqbeam_problem(qq.params, qq.config, x, passes=passes,
                                                     **sem), 3)
        kernel_ms = device_ms(lambda: K2.seqbeam_cuda(problem), 3)
        path = {
            "dim": dim, "bytes_per_frame": qq.config.bytes_per_frame, "config": chosen[0],
            "batch": TIME_B, "launches": {"seqbeam_v2": n_enc, "decode": n_dec},
            "seqbeam_vs_plain": k2_checks[-1], "decode_bit_exact": True,
            "quality_delta_pct": (ratio - 1.0) * 100.0,
            "quality_delta_pct_bf16_decode": (sse_auto_k1 / sse_beam - 1.0) * 100.0,
            "encode_vec_per_s": TIME_B / enc_s, "decode_vec_per_s": TIME_B / dec_s,
            "encode_ms": enc_s * 1e3, "encode_init_and_tables_ms": prep_ms,
            "encode_kernel_ms": kernel_ms,
        }
        paths.append(path)
        print(f"[main d{dim}/{qq.config.bytes_per_frame}B] auto -> {chosen[0]}; "
              f"{path['encode_vec_per_s']:,.0f} vec/s encode, "
              f"{path['decode_vec_per_s']:,.0f} vec/s decode; quality "
              f"{path['quality_delta_pct']:+.3f}% vs beam-5 on {CHECK_B} frames; "
              f"encode {path['encode_ms']:.3f} ms = init+tables {prep_ms:.3f} + kernel "
              f"{kernel_ms:.3f} + rest; launches {path['launches']}", flush=True)

    # ---- 5. K3 on the serving path; 6. training at full width
    gram_paths, k3_configs, k3_checks, n_k3, k3_stages = gram_phase(quantizers, main_frames)
    print("[gramv3 stages] share of the warps' cycles, us a frame-step: " + "; ".join(k3_stages),
          flush=True)
    train_paths, train_checks = train_phase(samplers[512], dev)
    for c in train_checks:
        (k3_checks if c["kernel"] == "gramv3" else k2_checks).append(c)
        launches[c["kernel"]] = launches.get(c["kernel"], 0) + c["launches"]
    launches["gramv3"] = launches.get("gramv3", 0) + n_k3
    # ---- 7. the rest of seqbeam
    rest = rest_phase(quantizers, main_frames, ladder)
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

    # times are those of the d512 main path's config; max_abs_err is the
    # largest over the main path's own checks, each listed with its shape
    head = next(c for c in k2_configs if c["config"] == paths[0]["config"])
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
    runs = [("seqbeam_v2", p["launches"]["seqbeam_v2"], p["encode_kernel_ms"], bounds[p["config"]])
            for p in paths]
    runs += [("gramv3", p["launches"]["gramv3"], p["encode_kernel_ms"], bounds[p["config"]])
             for p in gram_paths]
    runs += [(c["kernel"], c["launches"], c["ms"], c["bound_ms"]) for c in train_checks]
    runs += [(k, n, p["encode_kernel_ms"], bounds[p["config"]])
             for p in rest["paths"] for k, n in p["launches"].items()]
    kernels = [k1, k2, k3, k_v1, *probes]
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
    print(json.dumps({"paths": paths + gram_paths + train_paths + rest["paths"]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
        qq = quantizers[dim]
        nc = qq.num_codebooks
        x, sse_beam = main_frames[dim]
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
        counter = {"gramv3": K3.GRAMV3_KERNEL, "seqbeam_v2": K2.SEQBEAM_KERNEL}.get(kernel)
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
                run, plain = K3.gramv3_cuda, K3.gramv3_plain
                shape = f"B={TRAIN_BATCH} D={dim} nc={cfg.num_codebooks} passes=1 M=8 R=4"
                bound = _gramv3_bound(TRAIN_BATCH, cfg.num_codebooks, 1, 8, g_dtype)
            else:
                problem = K2.seqbeam_problem(params, cfg, xb, M=16, R=8, passes=1)
                run, plain = K2.seqbeam_cuda, K2.seqbeam_plain
                shape = f"B={TRAIN_BATCH} D={dim} nc={cfg.num_codebooks} passes=1 M=16 R=8 f32 E"
                bound = _seqbeam_bound(TRAIN_BATCH, dim, cfg.num_codebooks, 1, 16, "f32")
            chk = against_plain(problem, centers)
            check(chk["ok"] and (kernel != "gramv3" or chk["index_agreement"] == 1.0),
                  f"train {search}: kernel vs plain on a phase-2 batch: {chk}")
            checks.append({"where": f"training {search}", "kernel": kernel, "shape": shape,
                           "launches": n_k, **{k: chk[k] for k in CHECK_KEYS},
                           "ms": device_ms(lambda: run(problem), 20),
                           "plain_ms": device_ms(lambda: plain(problem), 3), **bound})
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
            "library_ms": _matmul_library_ms(*p.inputs) if p.name == "matmul" else None,
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
              + (f", torch.matmul bf16 {entry['library_ms'] * 1e3:.5f}" if entry["library_ms"]
                 else "") + f"); launches {n}; max_abs_err {max(errs):.3g}", flush=True)
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
    ``torch.profiler``, after a warm-up call); it fails unless they are the
    chain's ``own`` kernels, each at least once, and no other."""
    run()
    torch.cuda.synchronize()
    # one chain traced after a warm-up step: the tracer has been seen to miss
    # the first kernel of a window it starts cold
    seen = set()

    def keep(prof):
        seen.update(ev.name for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                                on_trace_ready=keep) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    names = sorted(seen)
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
def rest_phase(quantizers: dict, main_frames: dict, ladder: dict) -> dict:
    """Phase 7: seqbeam v1 and v2's pass/bound/lazy semantics through
    ``encode(search_method="seqbeam")`` on the main path's frames.  Returns
    the path entries and, per kernel ("seqbeam_v1", "seqbeam_v2"), its
    per-config entries, checks and launches."""
    from quantization_tpu_torch.core import codec
    from quantization_tpu_torch.ops import seqbeam as K2
    from quantization_tpu_torch.ops.quality_guard import CANDIDATES, SEMANTIC_KEYS, against_plain
    from quantization_tpu_torch.utils.device import device_ms

    cand = {name: (passes, kw) for name, passes, kw in CANDIDATES[512]}
    int8e, hl = ladder["seqbeam_int8e_d512"], ladder["seqbeam_hl_d512"]
    # (name, dim, passes, encode kwargs, what it is held to)
    configs = [
        ("seqbeam_v1_d512", 512, V1_PASSES, V1, "v2"),
        ("seqbeam_v1_d256", 256, V1_PASSES, V1, "v2"),
        ("seqbeam_int8e_pass_d512", 512, int8e[0], dict(int8e[1], requant="pass"), "init"),
        ("seqbeam_int8e_bound_d512", 512, *cand["seqbeam_int8e_bound_d512"], "init"),
        ("seqbeam_int8e_bound_fi_d512", 512, *cand["seqbeam_int8e_bound_fi_d512"], "init"),
        ("seqbeam_int8e_lazy_d512", 512, *cand["seqbeam_int8e_lazy_d512"], "eager"),
        ("seqbeam_hl_lazy_d512", 512, hl[0], dict(hl[1], lazy_r1=True), "eager"),
    ]
    out = {"paths": [], "configs": {"seqbeam_v1": [], "seqbeam_v2": []},
           "checks": {"seqbeam_v1": [], "seqbeam_v2": []},
           "launches": {"seqbeam_v1": 0, "seqbeam_v2": 0}, "stage_lines": []}
    for name, dim, passes, kw, twin in configs:
        qq = quantizers[dim]
        nc = qq.num_codebooks
        x, sse_beam = main_frames[dim]
        centers = qq.get_centers().detach()
        kernel = "seqbeam_v1" if kw.get("impl") == "v1" else "seqbeam_v2"
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
        sem = {k: v for k, v in kw.items() if k in SEMANTIC_KEYS}
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
