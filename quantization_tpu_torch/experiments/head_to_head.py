"""Quality parity of the port's trainer: train a quantizer at a head-to-head
config and hold its final relative error to the JAX package's and the
reference's recorded runs.

The port's counterpart of the "ours" side of the JAX package's
``experiments/head_to_head.py``: the same trainer arguments
(``QuantizerTrainer(dim, bpf, phase_one_iters=P1, phase_two_iters=P2,
lr=0.005, seed=SEED, diagnostics=False, train_search=SEARCH,
beam_finetune_iters=FT)``, stepped until ``done()``), the same data
distribution (the shipped key-42 MLP sampler, ``data/synthetic.py``), the
same eval (2,048 frames, ``encode`` with the beam when ``FT`` is set, else
with ``SEARCH``, an f32 decode) and the same formula,
``sum((recon - x)^2) / sum((x - get_data_mean())^2)``.  The port cannot
replay ``jax.random``: its training batches come from a ``torch.Generator``
seeded 1, drawn in chunks of 200 batches as the JAX script draws them, and
its eval frames from one seeded 2, so the stream is the same distribution,
not the same frames.  The reference's side needs the reference's checkout;
its numbers, and the JAX package's, are read from the committed
``experiments/head_to_head_*.json`` of the same config (dim, bytes, steps,
batch, search and finetune; every seed).

Beside the eval it reports the same quantizer under the main path,
``encode`` with ``search_method="auto"`` (K2 on a card) and ``decode(...,
use_kernel=True)`` (K1), and that error's delta over the beam's.

    python -m quantization_tpu_torch.experiments.head_to_head DIM BPF P1 P2 BATCH \\
        [--search beam|auto|seqbeam|gramv3] [--ft N] [--seed N] [--ranks 1|2] \\
        [--device cpu] [--out q.npz [--int8]]

It runs on the card unless ``--device`` says otherwise; without CUDA and
without ``--device`` it exits nonzero.  ``--ranks 2`` trains under a 2 x 1
data mesh: two spawned gloo ranks on the one device, each stepping half the
rows of every batch; the eval runs on rank 0's quantizer.  The result, one
JSON object, is printed and written to ``h2h/<stem>.json`` beside this
module (the JAX script's stem, ``_ranks2`` appended for two ranks); ``--out``
saves the trained quantizer, with ``--int8`` as :func:`save_int8`'s compact
file.  The run exits nonzero when a bar fails:

(i) ``rel_err <= 1.01 x`` the reference's recorded error;
(ii) ``rel_err`` within 1% of the JAX package's recorded errors (their
     range where several seeds are recorded), and under ``--ranks 2`` within
     1% of the one-process run's JSON where it exists;
(iii) ``auto_delta_pct <= 1.2`` (``chip_smoke.py``'s bar).

(i) and (ii) apply where a record exists; otherwise the run prints "no
record" and holds (iii) alone.
"""

from __future__ import annotations

import argparse
import datetime
import json
import pathlib
import queue
import re
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from ..core.types import resolve_device
from ..data.synthetic import make_mlp_sampler
from ..models.quantizer import Quantizer
from ..utils.torch_interop import params_from_numpy, params_to_numpy

ROOT = pathlib.Path(__file__).resolve().parents[2]
RECORDS = ROOT / "experiments"  # the JAX package's head-to-head JSONs
H2H_DIR = pathlib.Path(__file__).resolve().parent / "h2h"
EVAL_N = 2048
CHUNK = 200  # batches drawn at once (experiments/head_to_head.py:64-73)
DATA_SEED, EVAL_SEED = 1, 2
REF_BAR = 1.01  # (i): PERF.md's "within 1% of the reference's"
JAX_BAR = 0.01  # (ii): two-sided, relative
AUTO_BAR_PCT = 1.2  # (iii): chip_smoke.py's BAR, tests/test_kernel_quality.py:32
RANK_TIMEOUT_S = 300  # one collective
_STEM = re.compile(r"head_to_head_d(\d+)_b(\d+)_(\d+)\+(\d+)"
                   r"(?:_(?!ft\d|seed\d)([a-z][a-z0-9-]*))?(?:_ft(\d+))?(?:_seed(\d+))?")


def stem(dim: int, bpf: int, p1: int, p2: int, search: str = "beam", ft: int = 0,
         seed: int = 0, ranks: int = 1) -> str:
    """The JAX script's file stem for a config, ``_ranks2`` appended for a
    mesh run."""
    return (f"head_to_head_d{dim}_b{bpf}_{p1}+{p2}" + ("" if search == "beam" else f"_{search}")
            + (f"_ft{ft}" if ft else "") + (f"_seed{seed}" if seed else "")
            + (f"_ranks{ranks}" if ranks > 1 else ""))


def records(dim: int, bpf: int, p1: int, p2: int, batch: int, search: str = "beam",
            ft: int = 0) -> dict:
    """The recorded errors of a config: ``jax``, the JAX package's
    ``ours_rel_err`` of every seed with the same search and finetune
    (sorted; empty where none), and ``ref``, the reference's
    ``ref_rel_err`` (its leg does not depend on the search; None where
    none).  A record counts only at the same batch, and where it names its
    search (``ours_search``), only under the same name."""
    jax_errs, ref = [], None
    for path in sorted(RECORDS.glob("head_to_head_*.json")):
        m = _STEM.fullmatch(path.stem)
        if m is None:  # the one-side partials (.ours, .torch) and others
            continue
        rec = json.loads(path.read_text())
        if ([int(v) for v in m.group(1, 2, 3, 4)] != [dim, bpf, p1, p2]
                or rec.get("batch") != batch):
            continue
        if rec.get("ref_rel_err") is not None:
            ref = float(rec["ref_rel_err"])
        if ((m.group(5) or "beam") == search and int(m.group(6) or 0) == ft
                and rec.get("ours_search", search) == search
                and rec.get("ours_beam_finetune", ft) == ft and "ours_rel_err" in rec):
            jax_errs.append(float(rec["ours_rel_err"]))
    return {"jax": sorted(jax_errs), "ref": ref}


def eval_frames(dim: int, device) -> torch.Tensor:
    """The 2,048 eval frames (generator seeded 2)."""
    return make_mlp_sampler(dim, device=device)(torch.Generator().manual_seed(EVAL_SEED), EVAL_N)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> dict:
    """The launch counts so far of the kernels a training run or its eval
    reaches: K1, K2 (the training search's too), B4 and K3."""
    from ..ops import decode, gramv3, seqbeam

    return {"decode": decode.DECODE_KERNEL.launches,
            "seqbeam_v2": seqbeam.SEQBEAM_KERNEL.launches,
            "seqbeam_v1": seqbeam.SEQBEAM_V1_KERNEL.launches,
            "gramv3": gramv3.GRAMV3_KERNEL.launches}


def _since(before: dict) -> dict:
    return {k: n - before[k] for k, n in launches().items()}


def train(trainer, sampler, batch: int, rows: slice = slice(None)) -> dict:
    """Step ``trainer`` until ``done()`` on this process's ``rows`` of
    batches drawn ``CHUNK`` at a time from one generator seeded 1.  Returns
    the seconds of the steps (``train_s``) and of the draws (``data_s``),
    the count of steps and the kernels' launches."""
    device = trainer.device
    gen = torch.Generator().manual_seed(DATA_SEED)
    total = trainer.phase_one_iters + trainer.phase_two_iters + 1
    drawn, data_s = 0, 0.0
    before = launches()
    _sync(device)
    t0 = time.perf_counter()
    while not trainer.done():
        k = min(CHUNK, total - drawn)
        if k <= 0:
            raise RuntimeError(f"the trainer needs more than {total} steps")
        d0 = time.perf_counter()
        chunk = sampler(gen, batch * k).reshape(k, batch, -1)[:, rows]
        _sync(device)
        data_s += time.perf_counter() - d0
        drawn += k
        for x in chunk:
            trainer.step(x)
    _sync(device)
    return {"train_s": time.perf_counter() - t0 - data_s, "data_s": data_s, "steps": drawn,
            "launches": _since(before)}


@torch.no_grad()
def evaluate(q: Quantizer, search: str, ft: int) -> dict:
    """Relative errors of ``q`` on the eval frames: the JAX script's eval
    (``rel_err``), the exact beam's, and the main path's (auto encode,
    kernel decode) with its delta over the beam's in percent."""
    x = eval_frames(q.dim, q.device)
    denom = ((x - q.get_data_mean()) ** 2).double().sum()

    def rel(recon):
        return float(((recon - x) ** 2).double().sum() / denom)

    eval_search = "beam" if ft else search
    rel_err = rel(q.decode(q.encode(x, search_method=eval_search)))
    if eval_search != "beam":
        rel_beam = rel(q.decode(q.encode(x, search_method="beam")))
    else:
        rel_beam = rel_err
    rel_auto = rel(q.decode(q.encode(x, search_method="auto"), use_kernel=True))
    return {"rel_err": rel_err, "rel_err_beam": rel_beam, "rel_err_auto_k1": rel_auto,
            "auto_delta_pct": (rel_auto / rel_beam - 1.0) * 100.0}


def _trainer_kwargs(p1: int, p2: int, search: str, ft: int, seed: int) -> dict:
    """The JAX script's trainer arguments (experiments/head_to_head.py:88-92)."""
    return dict(phase_one_iters=p1, phase_two_iters=p2, lr=0.005, seed=seed, diagnostics=False,
                train_search=search, beam_finetune_iters=ft)


def run(dim: int, bpf: int, p1: int, p2: int, batch: int, search: str = "beam", ft: int = 0,
        seed: int = 0, device=None, ranks: int = 1):
    """Train and evaluate one config; returns ``(result, quantizer)``, the
    result without the records and bars (see :func:`hold`)."""
    from ..train.trainer import QuantizerTrainer

    device = resolve_device(device)
    build_s = 0.0
    if device.type == "cuda":  # the kernels the run can reach, built before it is timed
        from ..ops import cuda_build

        build_s = cuda_build.build(("decode", "seqbeam", "gramv3"))
    t0 = time.perf_counter()
    if ranks == 1:
        trainer = QuantizerTrainer(dim, bpf, device=device,
                                   **_trainer_kwargs(p1, p2, search, ft, seed))
        times = train(trainer, make_mlp_sampler(dim, device=device), batch)
        q = trainer.get_quantizer()
    else:
        times, arrays, ident = _run_ranks(ranks, dict(dim=dim, bpf=bpf, p1=p1, p2=p2,
                                                      batch=batch, search=search, ft=ft,
                                                      seed=seed), device)
        nc, cs, _ = arrays["centers"].shape
        q = Quantizer(dim, cs, nc, params=params_from_numpy(arrays, device), id_str=ident,
                      device=device)
    e0, before = time.perf_counter(), launches()
    result = {"dim": dim, "bytes_per_frame": bpf, "p1": p1, "p2": p2, "batch": batch,
              "search": search, "ft": ft, "seed": seed, "ranks": ranks, **evaluate(q, search, ft)}
    eval_s = time.perf_counter() - e0
    result.update(
        # the JAX script's wall: training and eval; the data drawn and the
        # kernels built before
        wall_s=time.perf_counter() - t0 - times["data_s"], train_s=times["train_s"],
        eval_s=eval_s, data_s=times["data_s"], build_s=build_s, steps=times["steps"],
        steps_per_s=times["steps"] / times["train_s"],
        launches={"train": times["launches"], "eval": _since(before)},
        device=_device_name(device), nvidia_smi=_smi(device))
    return result, q


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _smi(device: torch.device) -> Optional[str]:
    if device.type != "cuda":
        return None
    from ..utils.device import nvidia_smi_line

    return nvidia_smi_line()


def hold(result: dict, own: pathlib.Path = H2H_DIR) -> dict:
    """``result`` with the recorded errors of its config beside it, both
    ratios, and the bars (i)-(iii): each bar's limits and whether it holds,
    or "no record"; ``ok`` is every bar that applies.  A two-rank run is
    also held to the one-process run's JSON in ``own``."""
    cfg = [result[k] for k in ("dim", "bytes_per_frame", "p1", "p2", "batch", "search", "ft")]
    rec = records(*cfg)
    err = result["rel_err"]
    out = dict(result, jax_rel_err=rec["jax"] or None, ref_rel_err=rec["ref"],
               ratio_jax=err / float(np.mean(rec["jax"])) if rec["jax"] else None,
               ratio_ref=err / rec["ref"] if rec["ref"] is not None else None)
    bars = {}
    if rec["ref"] is not None:
        limit = REF_BAR * rec["ref"]
        bars["i_ref"] = {"max": limit, "ok": err <= limit}
    else:
        bars["i_ref"] = "no record"
    if rec["jax"]:
        lo, hi = (1.0 - JAX_BAR) * rec["jax"][0], (1.0 + JAX_BAR) * rec["jax"][-1]
        bars["ii_jax"] = {"min": lo, "max": hi, "ok": lo <= err <= hi}
    else:
        bars["ii_jax"] = "no record"
    if result["ranks"] > 1:
        one = own / f"{stem(*cfg[:4], result['search'], result['ft'], result['seed'])}.json"
        if one.exists():
            one_err = json.loads(one.read_text())["rel_err"]
            out["one_process_rel_err"] = one_err
            bars["ii_one_process"] = {"min": (1.0 - JAX_BAR) * one_err,
                                      "max": (1.0 + JAX_BAR) * one_err,
                                      "ok": abs(err / one_err - 1.0) <= JAX_BAR}
        else:
            bars["ii_one_process"] = "no record"
    bars["iii_auto"] = {"max": AUTO_BAR_PCT, "ok": result["auto_delta_pct"] <= AUTO_BAR_PCT}
    out["bars"] = bars
    out["ok"] = all(b["ok"] for b in bars.values() if isinstance(b, dict))
    return out


# ----------------------------------------------------------- two ranks


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, cfg: dict, device: torch.device):
    """Train ``cfg`` under a ``world`` x 1 data mesh of spawned gloo ranks
    on ``device``; returns rank 0's times, parameters (numpy) and id.  The
    ranks' parameters must be equal; a rank that fails or exits without a
    result fails the run, and every rank is stopped before this returns."""
    import multiprocessing

    if cfg["batch"] % world:
        raise ValueError(f"batch {cfg['batch']} does not split over {world} ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, cfg, str(device), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            try:
                r, value, error = results.get(timeout=5)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if i not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a result") from None
                continue
            if error is not None:
                raise RuntimeError(f"rank {r} failed:\n{error}")
            got[r] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if any(not all(np.array_equal(got[0]["params"][k], v) for k, v in got[r]["params"].items())
           for r in got):
        raise RuntimeError("the ranks' parameters differ")
    return got[0]["times"], got[0]["params"], got[0]["id"]


def _rank(rank: int, world: int, port: int, cfg: dict, device: str, results) -> None:
    """One rank of a ``--ranks`` run: this rank's rows of every batch under a
    ``world`` x 1 mesh.  Puts ``(rank, result, error)`` on ``results``."""
    import torch.distributed as dist

    try:
        from ..parallel import init_distributed, make_mesh
        from ..train.trainer import QuantizerTrainer

        dev = torch.device(device)
        if dev.type == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                         world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        mesh = make_mesh(num_data=world, device=dev)
        trainer = QuantizerTrainer(cfg["dim"], cfg["bpf"], mesh=mesh, **_trainer_kwargs(
            cfg["p1"], cfg["p2"], cfg["search"], cfg["ft"], cfg["seed"]))
        b = cfg["batch"] // world
        times = train(trainer, make_mlp_sampler(cfg["dim"], device=dev), cfg["batch"],
                      slice(rank * b, (rank + 1) * b))
        q = trainer.get_quantizer()
        results.put((rank, {"times": times, "params": params_to_numpy(q.params),
                            "id": q.get_id()}, None))
    except Exception:  # the parent fails the run with this traceback
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def save_int8(path, quantizer):
    """Save ``quantizer`` as a compressed ``.npz`` a quarter of the size:
    ``centers`` and ``to_logits_w`` each rounded to whole multiples of one
    step (their largest magnitude over 127) and stored as int8, the step
    folded into ``centers_scale`` and ``logits_scale`` (which multiply them
    through ``exp(scale * scale_speed)``).  The file is an ordinary quantizer
    of the same layout whose two tables hold whole numbers; its scaled
    codebooks and logits are ``quantizer``'s up to that rounding.  Returns
    the quantizer as saved, loaded back onto ``quantizer``'s device.  (The
    d1280 / 8 B quantizer in this directory is such a file.)"""
    import numpy as np

    from ..utils.serialization import load_quantizer, save_quantizer

    save_quantizer(path, quantizer)
    with np.load(path) as z:
        arrays = dict(z)
    speed = float(quantizer.config.scale_speed)
    for table, scale in (("centers", "centers_scale"), ("to_logits_w", "logits_scale")):
        a = arrays[table].astype(np.float64)
        step = float(np.abs(a).max()) / 127.0 or 1.0
        arrays[table] = np.clip(np.rint(a / step), -127, 127).astype(np.int8)
        arrays[scale] = np.asarray(float(arrays[scale]) + np.log(step) / speed, np.float32)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return load_quantizer(path, device=quantizer.device)


# ---------------------------------------------------------------- entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name in ("dim", "bpf", "p1", "p2", "batch"):
        ap.add_argument(name, type=int)
    ap.add_argument("--search", default="beam",
                    help="train_search: beam, auto, seqbeam, gramv3 or gramv3-int8")
    ap.add_argument("--ft", type=int, default=0, help="beam_finetune_iters")
    ap.add_argument("--seed", type=int, default=0, help="the trainer's seed")
    ap.add_argument("--ranks", type=int, default=1, choices=(1, 2))
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the GPU; 'cpu' runs the kernels' plain "
                         "versions)")
    ap.add_argument("--out", default=None, help="save the trained quantizer (.npz or .pt)")
    ap.add_argument("--int8", action="store_true",
                    help="save --out (.npz) with int8 tables (save_int8)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"head_to_head: {e}") from None
    result, q = run(args.dim, args.bpf, args.p1, args.p2, args.batch, args.search, args.ft,
                    args.seed, device, args.ranks)
    if args.out:
        from ..utils.serialization import save_quantizer

        (save_int8 if args.int8 else save_quantizer)(args.out, q)
    out = hold(result)
    H2H_DIR.mkdir(exist_ok=True)
    path = H2H_DIR / (stem(args.dim, args.bpf, args.p1, args.p2, args.search, args.ft,
                           args.seed, args.ranks) + ".json")
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out), flush=True)
    for name, bar in out["bars"].items():
        print(f"[{name}] " + ("no record" if isinstance(bar, str) else
                              ("ok" if bar["ok"] else "FAILED") + f" {bar}"), flush=True)
    if not out["ok"]:
        print(f"head_to_head: a bar failed; rel_err {out['rel_err']}, written to {path}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
