"""Command-line interface of the PyTorch port.

The counterpart of ``quantization_tpu/cli.py``, with its commands, flags and
defaults::

    python -m quantization_tpu_torch train  --data corpus/ --dim 512 --bytes-per-frame 8 \\
        --out quantizer.npz [--iters 10000] [--batch 600] [--train-search auto]
    python -m quantization_tpu_torch encode --quantizer quantizer.npz --data corpus/ \\
        --out codes.npy [--search auto]
    python -m quantization_tpu_torch decode --quantizer quantizer.npz --codes codes.npy \\
        --out recon.npy
    python -m quantization_tpu_torch convert --hdf5 training_data.hdf5 --out corpus/

``--data`` accepts a shard directory (``data/shards.py``) or a
reference-format ``.hdf5`` archive (`quantization/quantization.py:755-761`).
train, encode and decode run on the GPU unless ``--device`` names another
device (``--device cpu``); without CUDA and without ``--device`` they exit
nonzero.  convert runs on the host and needs ``h5py``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import pathlib
import queue
import sys
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from .core.types import resolve_device

logger = logging.getLogger("quantization_tpu_torch.cli")

PREFETCH_THREAD = "quantization_tpu_torch.cli prefetch"


def _train_batches(data: str, batch: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Shuffled training batches from a shard directory (the native
    ``ShardStream``, closed when this generator is) or an .hdf5 archive."""
    p = pathlib.Path(data)
    if p.is_dir():
        from .data.shards import ShardStream

        stream = ShardStream(p, batch_size=batch, seed=seed)
        try:
            yield from stream
        finally:
            stream.close()
        return
    from .data.hdf5 import minibatch_iterator, read_hdf5_data

    train, _ = read_hdf5_data(str(p), seed=seed)
    yield from minibatch_iterator(train, batch, seed=seed)


def _iter_sequential(data: str, batch: int, limit: Optional[int] = None):
    """Order-preserving batches (row k of the output is corpus frame k):
    shard files in manifest order, raw f16 with no host-side conversion, or
    HDF5 datasets in key order; no shuffling, no duplication."""
    p = pathlib.Path(data)
    if p.is_dir():
        from .data.shards import iter_shards_sequential

        it = iter_shards_sequential(p, batch_size=batch, dtype=np.float16)
    else:
        from .data.hdf5 import iter_hdf5_sequential

        it = iter_hdf5_sequential(str(p), batch)
    tot = 0
    for b in it:
        if limit is not None and tot + b.shape[0] > limit:
            b = b[: limit - tot]
        if b.shape[0]:
            tot += b.shape[0]
            yield b
        if limit is not None and tot >= limit:
            return


def _prefetch(it, depth: int = 4):
    """Batches of ``it``, read ahead by a worker thread (``np.fromfile``
    releases the interpreter lock, so disk reads overlap the consumer's
    dispatches).  The worker's exceptions reach the consumer.  When the
    consumer stops early (an exception, a ``close``), its ``finally`` sets
    a stop event; the worker puts with a timeout, sees the event, closes
    ``it`` and ends."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    err = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except Exception as e:  # noqa: BLE001 - forwarded to the consumer
            err.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            put(done)

    threading.Thread(target=worker, name=PREFETCH_THREAD, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


class _Upload:
    """Host batches onto ``device``, upcast to float32 there.  On a card
    each batch is copied into one of a ring of pinned host buffers and
    uploaded with ``non_blocking=True``; a buffer is written again only
    after its last copy has ended (an event a buffer)."""

    def __init__(self, device: torch.device, slots: int = 4):
        self.device = device
        self.buffers = [None] * slots
        self.events = [None] * slots
        self.count = 0

    def __call__(self, x: np.ndarray) -> torch.Tensor:
        x = np.ascontiguousarray(x)
        if self.device.type != "cuda":
            return torch.from_numpy(x).to(self.device).float()
        k = self.count % len(self.buffers)
        self.count += 1
        if self.events[k] is not None:
            self.events[k].synchronize()
        buf = self.buffers[k]
        dtype = torch.from_numpy(x[:0]).dtype
        if buf is None or buf.dtype != dtype or buf.shape[1:] != x.shape[1:] \
                or buf.shape[0] < x.shape[0]:
            buf = self.buffers[k] = torch.empty(x.shape, dtype=dtype, pin_memory=True)
        host = buf[: x.shape[0]]
        host.numpy()[...] = x
        on_card = host.to(self.device, non_blocking=True)
        self.events[k] = torch.cuda.Event()
        self.events[k].record()
        return on_card.float()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_train(args, device: torch.device) -> None:
    from .train.trainer import QuantizerTrainer
    from .utils.serialization import save_quantizer

    with contextlib.closing(_train_batches(args.data, args.batch, args.seed)) as it:
        kw = {}
        if args.init == "multi_kmeans":
            kw = dict(init="multi_kmeans", init_data=next(it))
        trainer = QuantizerTrainer(
            dim=args.dim,
            bytes_per_frame=args.bytes_per_frame,
            device=device,
            phase_one_iters=args.iters,
            phase_two_iters=args.iters,
            lr=args.lr,
            seed=args.seed,
            diagnostics=not args.quiet,
            train_search=args.train_search,
            beam_finetune_iters=args.beam_finetune_iters,
            **kw,
        )
        t0 = time.time()
        total = 2 * args.iters + 1
        while not trainer.done():
            n = min(args.chunk, total - trainer.cur_iter)
            trainer.step_many(np.stack([next(it) for _ in range(n)]))
            if not args.quiet:
                logger.info("iter %d/%d (%.0fs)", trainer.cur_iter, total, time.time() - t0)
    q = trainer.get_quantizer()
    save_quantizer(args.out, q)
    logger.info("saved %s (id=%s) after %.0fs", args.out, q.get_id(), time.time() - t0)


def cmd_encode(args, device: torch.device) -> None:
    from .utils.serialization import load_quantizer

    q = load_quantizer(args.quantizer, device=device)
    # --block-b and --interleave are the TPU kernel's scheduling knobs: they
    # are accepted and change nothing
    search_kwargs = {k: v for k, v in (("M", args.M), ("R", args.R),
                                       ("pool_mask", args.pool_mask)) if v is not None}
    upload = _Upload(device)
    # at most 3 batches in flight: batch k+1's read and upload overlap batch
    # k's encode; the rate is timed from the second batch on (the first
    # builds and loads the kernels)
    codes, pending = [], []
    t0 = None
    after_first = 0
    for x in _prefetch(_iter_sequential(args.data, args.batch, args.limit)):
        pending.append(q.encode(upload(x), refine_indexes_iters=args.refine_iters,
                                search_method=args.search, **search_kwargs))
        if t0 is None:
            _sync(device)
            t0 = time.perf_counter()
        else:
            after_first += x.shape[0]
        if len(pending) > 3:
            codes.append(pending.pop(0).cpu().numpy())
    codes.extend(c.cpu().numpy() for c in pending)
    _sync(device)
    seconds = time.perf_counter() - t0 if t0 is not None else 0.0
    out = np.concatenate(codes)
    np.save(args.out, out)
    stats = {"frames": int(out.shape[0]), "steady_frames": after_first,
             "steady_seconds": seconds,
             "steady_vec_per_s": after_first / seconds if after_first else None}
    logger.info("encoded %d frames -> %s (%s vec/s steady-state)", out.shape[0], args.out,
                f"{stats['steady_vec_per_s']:.0f}" if after_first else "not timed",
                extra={"stats": stats})


def cmd_decode(args, device: torch.device) -> None:
    from .utils.serialization import load_quantizer

    q = load_quantizer(args.quantizer, device=device)
    codes = np.load(args.codes)
    recon = []
    _sync(device)
    t0 = time.perf_counter()
    for start in range(0, codes.shape[0], args.batch):
        batch = torch.from_numpy(np.ascontiguousarray(codes[start : start + args.batch]))
        recon.append(q.decode(batch.to(device)).cpu().numpy())
    seconds = time.perf_counter() - t0
    out = np.concatenate(recon)
    np.save(args.out, out)
    stats = {"frames": int(out.shape[0]), "seconds": seconds,
             "vec_per_s": out.shape[0] / seconds}
    logger.info("decoded %d frames -> %s (%.0f vec/s: upload, decode and fetch)",
                out.shape[0], args.out, stats["vec_per_s"], extra={"stats": stats})


def cmd_convert(args, device=None) -> None:
    from .data.shards import convert_hdf5_to_shards

    manifest = convert_hdf5_to_shards(args.hdf5, args.out, args.frames_per_shard)
    logger.info(
        "wrote %d shards, %d frames, dim=%d -> %s",
        len(manifest["shards"]),
        sum(s["frames"] for s in manifest["shards"]),
        manifest["dim"],
        args.out,
    )


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="device to run on (default: the GPU; 'cpu' runs the kernels' "
                        "plain versions on the CPU)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="quantization_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="two-phase quantizer training")
    p.add_argument("--data", required=True, help="shard dir or .hdf5 archive")
    p.add_argument("--dim", type=int, required=True)
    p.add_argument("--bytes-per-frame", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--iters", type=int, default=10000, help="per phase")
    p.add_argument("--batch", type=int, default=600)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=100, help="steps per step_many call")
    p.add_argument("--init", choices=["default", "multi_kmeans"], default="default")
    p.add_argument("--train-search", default="auto",
                   help="auto (the exact beam in both phases; default) | beam | seqbeam | "
                        "gramv3 | gramv3-int8 (that kernel for the phase-2 search, with an "
                        "exact-beam tail, see --beam-finetune-iters)")
    p.add_argument("--beam-finetune-iters", type=int, default=None,
                   help="run the FINAL N steps with the exact beam search regardless of "
                        "--train-search (default: 1000 when --train-search is a kernel, "
                        "0 otherwise)")
    p.add_argument("--quiet", action="store_true")
    _add_device(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("encode", help="bulk encode a corpus to byte codes")
    p.add_argument("--quantizer", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--refine-iters", type=int, default=5)
    p.add_argument("--search", default="auto",
                   help="auto (the fastest config within 1%% of beam-5 on the GPU; "
                        "default) | beam | seqbeam | cdN+seqbeam | cd | gramv3")
    p.add_argument("--M", type=int, default=None, help="beam width of the seqbeam kernel")
    p.add_argument("--R", type=int, default=None,
                   help="per-beam-entry expansion of the seqbeam kernel")
    p.add_argument("--block-b", type=int, default=None,
                   help="the TPU kernel's batch tile: accepted, no effect here")
    p.add_argument("--pool-mask", default=None,
                   help="seqbeam step schedule, e.g. 'altparity' (pool selection on half "
                        "the codebook steps)")
    p.add_argument("--interleave", type=int, default=None,
                   help="the TPU kernel's sub-tile interleave: accepted, no effect here")
    _add_device(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help="reconstruct frames from byte codes")
    p.add_argument("--quantizer", required=True)
    p.add_argument("--codes", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=65536)
    _add_device(p)
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("convert", help="HDF5 archive -> raw-f16 shards (needs h5py)")
    p.add_argument("--hdf5", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--frames-per-shard", type=int, default=1 << 20)
    p.set_defaults(fn=cmd_convert)

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    device = None
    if args.cmd != "convert":
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(f"quantization_tpu_torch {args.cmd}: {e}") from None
    args.fn(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
