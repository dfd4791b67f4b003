"""Ranks of a gloo process group on the CPU, for ``tests/test_torch_parallel.py``.

This module imports torch and the port only, so that a spawned worker loads
neither JAX nor the tests' ``conftest.py``.  :func:`start` starts one process
a rank, each of which builds a mesh and runs :func:`layout_job`;
:func:`collect` fails when a worker fails or when the ranks do not finish
in time (a deadlocked collective fails its case instead of running the
suite into its limit).
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import socket
import time
import traceback

import numpy as np
import torch

TIMEOUT_S = 150  # the parent's wait for all ranks
COLLECTIVE_TIMEOUT_S = 90  # each rank's wait in one collective


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(world: int, num_model: int, job: dict):
    """Start ``layout_job(mesh, job)`` on ``world`` ranks of a
    (world // num_model) x num_model mesh; :func:`collect` waits for them."""
    ctx = multiprocessing.get_context("spawn")
    jobs, results = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, num_model, port, jobs, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    # through a queue, not as an argument: a start would wait for the child
    # to read a large argument, so the ranks would start one after another
    for _ in procs:
        jobs.put(job)
    return procs, jobs, results, time.monotonic()


def collect(started, timeout: float = TIMEOUT_S) -> list:
    """The ranks' results in rank order; raises when a rank fails or when
    they have not all finished ``timeout`` seconds after the start."""
    procs, _, results, t0 = started  # the job queue lives until the ranks end
    world, out = len(procs), {}
    try:
        while len(out) < world:
            try:
                rank, value, error = results.get(timeout=max(t0 + timeout - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} did not "
                                   f"finish in {timeout} s") from None
            if error is not None:
                raise RuntimeError(f"rank {rank} failed:\n{error}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


def _worker(rank, world, num_model, port, jobs, results):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from quantization_tpu_torch.parallel import init_distributed, make_mesh

    try:
        init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                         world_size=world,
                         timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mesh = make_mesh(num_model=num_model, device="cpu")
        results.put((rank, layout_job(mesh, jobs.get(timeout=COLLECTIVE_TIMEOUT_S)), None))
    except Exception:  # reported to the parent, which fails the case
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _numpy(params) -> dict:
    from quantization_tpu_torch.utils.torch_interop import params_to_numpy

    return params_to_numpy(params)


def layout_job(mesh, job: dict) -> dict:
    """Everything one layout checks, on this rank: the mesh's description,
    bulk encode and decode, and the trainers."""
    from quantization_tpu_torch.core import codec, search
    from quantization_tpu_torch.core.types import QuantizerConfig, QuantizerParams
    from quantization_tpu_torch.parallel import (decode_sharded, encode_sharded, gather_params,
                                                 shard_params)
    from quantization_tpu_torch.parallel.mesh import AXES
    from quantization_tpu_torch.train.trainer import QuantizerTrainer
    from quantization_tpu_torch.utils.torch_interop import PARAM_FIELDS, params_from_numpy

    out = {"shape": dict(mesh.shape), "coords": dict(mesh.coords), "rank": mesh.rank,
           "members": {a: mesh.members(a) for a in AXES}}

    # bulk encode and decode, counting the rows each rank encodes
    config = QuantizerConfig(*job["config"])
    params = params_from_numpy(job["params"])
    x = torch.from_numpy(job["x"])
    rows, encode = [], codec.encode

    def counting(p, c, xl, *args, **kwargs):
        rows.append(xl.shape[0])
        return encode(p, c, xl, *args, **kwargs)

    codec.encode = counting
    try:
        out["encode"] = {}
        for name, method, iters, kw in job["searches"]:
            try:
                codes = encode_sharded(params, config, x, mesh, iters, method, **kw)
                out["encode"][name] = codes.numpy()
            except ValueError as e:
                out["encode"][name] = f"ValueError: {e}"
    finally:
        codec.encode = encode
    out["rows"] = rows
    codes = torch.from_numpy(job["codes"])
    out["decode"] = {k: decode_sharded(params, config, codes, mesh, use_kernel=k).numpy()
                     for k in (False, True)}

    # the trainers: this rank's rows of each global batch
    nd, d = mesh.shape["data"], mesh.coords["data"]
    out["train"] = {}
    for name, kw, init, xs in job["trainers"]:
        t = QuantizerTrainer(mesh=mesh, **kw)
        local = shard_params(params_from_numpy(init), mesh)
        with torch.no_grad():
            for f in PARAM_FIELDS:
                getattr(t.params, f).copy_(getattr(local, f))
        b = xs.shape[1] // nd
        mine = torch.from_numpy(xs[:, d * b:(d + 1) * b])
        losses = [t.step(mine[0])]
        # the first step's gradients, summed over the ranks, before Adam
        grads = gather_params(QuantizerParams(**{f: getattr(t.params, f).grad
                                                 for f in PARAM_FIELDS}), mesh)
        losses += [t.step(mine[1])] + t.step_many(mine[2:])
        q = t.get_quantizer()
        # the indexes every rank takes on one batch, searched on its slices
        probe = t._cols(torch.from_numpy(xs[0]))
        indexes = search.compute_indexes(t.params.detach(), t.config, probe, 2,
                                         reducer=t._reducer)
        path = f"{job['ckpt_dir']}/{name}.npz"
        t.save_checkpoint(path)
        t2 = QuantizerTrainer.load_checkpoint(path, mesh=mesh, diagnostics=False)
        resumed = all(torch.equal(getattr(t.params, f), getattr(t2.params, f))
                      and all(torch.equal(t.opt.state[getattr(t.params, f)][k],
                                          t2.opt.state[getattr(t2.params, f)][k])
                              for k in ("exp_avg", "exp_avg_sq"))
                      for f in PARAM_FIELDS)
        out["train"][name] = {
            "params": _numpy(q.params), "grads": _numpy(grads), "cur_iter": t.cur_iter,
            "losses": np.array([[float(v) for v in step] for step in losses]),
            "indexes": indexes.numpy(), "ckpt": path, "resume_equal": resumed,
            "local_centers_shape": tuple(t.params.centers.shape),
        }
    return out
