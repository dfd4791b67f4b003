"""Write the GPU tables behind ``search_method="auto"``.

For each kernel configuration on the auto ladder (``ops.ladder``), and for
the promotion candidates in :data:`CANDIDATES` that auto does not run, on
the committed trained quantizers and 8,192 in-distribution frames per eval
seed (7, 8, 9) from the shipped MLP sampler of their dim (key 42; d1280's
seeded, ``data/synthetic.py``), this measures on the card:

* ``verified.json`` (smoke): the kernel builds, launches, agrees with its
  plain PyTorch version on the card (at least 99.5% of indexes equal, summed
  squared error within 0.1%), and improves on its initial indexes;
* ``quality.json``: the relative reconstruction error against the port's
  exact beam-5 search on the same frames, per seed, and the worst delta.

The candidates are seqbeam's (:data:`CANDIDATES`) and the Gram-table
beam's at auto's beam shape (:data:`GRAMV3_CANDIDATES`).

Each file records the card's name, count and power limit.  The factor
``train_ratio_vs_torch`` is a property of the trained artifact, not of a
chip, and carries over from the JAX package with its source.

Run on an H100:  python -m quantization_tpu_torch.ops.quality_guard [--out DIR]
[--configs 1280x16 ...]; with ``--configs`` only those trained quantizers
are measured, and their entries are added to the files beside this module,
whose other entries are written back as they are.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Optional

import torch

from ..core import search
from ..core.codec import decode_indexes
from ..data.synthetic import make_mlp_sampler
from ..utils.device import device_record
from ..utils.serialization import load_quantizer
from . import cuda_build, ladder, verify
from .gramv3 import GRAMV3
from .ladder import Rung
from .seqbeam import SEQBEAM

KEYS = (7, 8, 9)
FRAMES = 8192
EXPERIMENTS = pathlib.Path(__file__).resolve().parents[2] / "experiments"
PORT_EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"
# the committed trained quantizers by (dim, num_codebooks): the JAX package's
# d512 and d256, and the port's d1280 / 8 B and d1280 / 16 B (compact int8
# tables, experiments/head_to_head.py::save_int8)
TRAINED = {(512, 8): EXPERIMENTS / "q512_8_full.npz", (256, 4): EXPERIMENTS / "q256_4_full.npz",
           (1280, 8): PORT_EXPERIMENTS / "q1280_8_full.npz",
           (1280, 16): PORT_EXPERIMENTS / "q1280_16_full.npz"}
TRAIN_RATIO = 1.0001091779448747
TRAIN_RATIO_SOURCE = (
    "experiments/head_to_head_d512_b8_10000+10000.json (beam-trained flagship "
    "vs torch reference, identical data + schedule)")
MIN_AGREEMENT = 0.995
MAX_SSE_REL = 1e-3
# Promotion candidates measured beside the ladder, as the JAX package's
# guard lists them (experiments/quality_guard.py:55-87): each needs its own
# measured rows before it may join the ladder.
_INT8E = dict(M=8, R=4, pool_mask="altparity", e_dtype="int8")
_KNOBS = dict(block_b=512, interleave=2, reorder="select")
CANDIDATES = {
    (512, 8): [Rung(f"seqbeam_int8e_{tag}_d512", SEQBEAM, 3, dict(_INT8E, **beam), dict(_KNOBS, **knobs))
          for tag, beam, knobs in (
              ("fi", dict(init_precision="default"), {}), ("bound", dict(requant="bound"), {}),
              ("bound_fi", dict(requant="bound", init_precision="default"), {}),
              ("lazy", dict(lazy_r1=True), dict(zip_skew=1)))],
    (256, 4): [Rung("seqbeam_int8e_d256", SEQBEAM, 2, _INT8E, dict(_KNOBS, block_b=256))],
    (1280, 8): [],
    (1280, 16): [],
}
# the Gram-table beam (K3) at auto's beam shape, M=8 and R=4: each table
# dtype, all-pool and altparity, 3-5 passes, named
# gramv3_<g>_<pool><passes>_<config tag> (ladder.config_tag)
GRAMV3_CANDIDATES = {
    key: [Rung(f"gramv3_{g}_{'alt' if mask else 'pool'}{passes}_{ladder.config_tag(*key)}",
               GRAMV3, passes, dict(M=8, R=4, pool_mask=mask, g_dtype=g))
          for g in ("bf16", "int8") for mask in ("altparity", None) for passes in (3, 4, 5)]
    for key in TRAINED
}


def eval_frames(dim: int, device) -> dict:
    """The guard's frames: seed -> (FRAMES, dim) f32 on ``device``."""
    sampler = make_mlp_sampler(dim, device=device)
    return {k: sampler(torch.Generator().manual_seed(k), FRAMES) for k in KEYS}


def sse(centers: torch.Tensor, indexes: torch.Tensor, x: torch.Tensor) -> float:
    """Summed squared reconstruction error of ``indexes`` (f32 gather)."""
    return float(((decode_indexes(centers, indexes) - x) ** 2).sum())


@torch.no_grad()
def against_plain(problem, centers: torch.Tensor, got: Optional[torch.Tensor] = None) -> dict:
    """Hold a search kernel's (B, nc) indexes on ``problem`` (``got``, else
    a new launch) against its plain version on the same inputs, with the f32
    ``centers`` (nc, cs, D) scoring both: the problem's own kernel
    (``problem.kernel``, K2's or K3's descriptor).  Returns
    the share of equal indexes, the summed squared errors and their relative
    difference, the largest per-frame difference of squared error
    (``max_abs_err``), and ``ok``: agreement >= MIN_AGREEMENT and |relative
    difference| <= MAX_SSE_REL."""
    if got is None:
        got = problem.kernel.cuda(problem)
    plain = problem.kernel.plain(problem)
    x = problem.x
    err = ((decode_indexes(centers, got) - x) ** 2).sum(-1)
    err_plain = ((decode_indexes(centers, plain) - x) ** 2).sum(-1)
    agree = float((got == plain).float().mean())
    e, e_plain = float(err.sum()), float(err_plain.sum())
    rel = e / e_plain - 1.0
    return {
        "frames": x.shape[0], "index_agreement": agree, "sse": e, "sse_plain": e_plain,
        "sse_rel_diff": rel, "max_abs_err": float((err - err_plain).abs().max()),
        "ok": agree >= MIN_AGREEMENT and abs(rel) <= MAX_SSE_REL,
    }


@torch.no_grad()
def guard_config(key: tuple, device) -> tuple:
    """(smoke entries, quality entries) of the ladder and the candidates of
    the trained quantizer ``TRAINED[key]``, ``key`` its (dim,
    num_codebooks)."""
    dim = key[0]
    q = load_quantizer(TRAINED[key], device=device)
    params, config = q.params, q.config
    centers, mean = q.get_centers(), q.get_data_mean()
    xs = eval_frames(dim, device)
    denom = {k: float(((x - mean) ** 2).sum()) for k, x in xs.items()}
    beam5 = {k: sse(centers, search.compute_indexes(params, config, x, 5, "beam"), x)
             / denom[k] for k, x in xs.items()}
    smoke, quality = {}, {}
    for rung in ladder.rungs(config) + tuple(CANDIDATES[key] + GRAMV3_CANDIDATES[key]):
        name, kernel = rung.name, rung.kernel
        if name in smoke:  # a ladder's rung among the candidates
            continue
        t0, launches = time.perf_counter(), kernel.entry.launches
        deltas = {}
        for k, x in xs.items():
            problem = kernel.problem(params, config, x, passes=rung.passes, **rung.beam)
            idx = kernel.cuda(problem)
            e = sse(centers, idx, x)
            deltas[str(k)] = round(100.0 * (e / denom[k] / beam5[k] - 1.0), 4)
            if k == KEYS[0]:
                chk = against_plain(problem, centers, idx)
                e_init = sse(centers, problem.idx0, x)
                smoke[name] = {
                    "ok": chk["ok"] and e < e_init,
                    "detail": (f"err {e_init:.1f} -> {e:.1f} (plain {chk['sse_plain']:.1f}), "
                               f"index agreement with plain {chk['index_agreement']:.5f}"),
                }
        smoke[name]["launches"] = kernel.entry.launches - launches
        smoke[name]["elapsed_s"] = round(time.perf_counter() - t0, 2)
        quality[name] = {
            "dim": dim, "bpf": config.bytes_per_frame, "frames_per_key": FRAMES,
            "beam5_by_key": {str(k): round(v, 6) for k, v in beam5.items()},
            "delta_pct_by_key": deltas,
            "max_delta_pct": max(deltas.values()),
        }
        print(f"{name:26s} {smoke[name]['detail']}  deltas {deltas}", flush=True)
    return smoke, quality


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=verify.VERIFIED.parent,
                    help="directory for verified.json and quality.json")
    ap.add_argument("--configs", nargs="+", default=None, metavar="DIMxNC",
                    help="measure only these trained quantizers (e.g. 1280x16) and add their "
                         "entries to the files beside this module")
    args = ap.parse_args(argv)
    keys = list(TRAINED) if args.configs is None else [
        tuple(int(v) for v in c.split("x")) for c in args.configs]
    unknown = [k for k in keys if k not in TRAINED]
    if unknown:
        raise SystemExit(f"no trained quantizer for {unknown}; have {list(TRAINED)}")
    if not torch.cuda.is_available():
        raise SystemExit("quality_guard measures the kernels on a CUDA card; none is available")
    device = torch.device("cuda")
    dev = device_record()
    print(dev["nvidia_smi"], flush=True)
    built_s = cuda_build.build(["seqbeam", "gramv3", "logits_argmax"])
    print(f"built the search kernels and their initial indexes' in {built_s:.1f} s", flush=True)
    smoke, quality = {}, {}
    for key in keys:
        s, q = guard_config(key, device)
        smoke.update(s)
        quality.update(q)
    now = round(time.time(), 1)
    verified = {"generated_unix": now, "device": dev, "results": smoke}
    qual = {"generated_unix": now, "device": dev, "train_ratio_vs_torch": TRAIN_RATIO,
            "train_ratio_source": TRAIN_RATIO_SOURCE, "results": quality}
    if args.configs is not None:  # the other entries as the files hold them
        verified, qual = (dict(old, results={**old["results"], **new["results"]})
                          for old, new in ((json.loads(verify.VERIFIED.read_text()), verified),
                                           (json.loads(verify.QUALITY.read_text()), qual)))
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / verify.VERIFIED.name).write_text(json.dumps(verified, indent=1) + "\n")
    (args.out / verify.QUALITY.name).write_text(json.dumps(qual, indent=1) + "\n")
    if not all(e["ok"] for e in smoke.values()):
        raise SystemExit(f"a kernel configuration failed its smoke check: {smoke}")


if __name__ == "__main__":
    main()
