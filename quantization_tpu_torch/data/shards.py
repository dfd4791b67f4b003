"""Sharded raw-f16 corpus format and its streaming loader.

PyTorch port's copy of ``quantization_tpu/data/shards.py`` (the module
imports no JAX there either; the port keeps its own copy):

* **Format**: a directory of raw little-endian float16 shard files
  ((frames, dim) row-major) plus a ``manifest.json``::

      {"dim": 512, "dtype": "float16",
       "shards": [{"file": "shard_00000.raw", "frames": 1048576}, ...]}

* **Loader**: a C++ shared library (``csrc/qtz_loader.cc``, built with
  ``g++`` by ``ops/cuda_build.py`` into ``csrc/_build/``) with reader
  threads filling a bounded shuffle pool; consumers draw uniformly random
  pooled frames without replacement (each draw backfilled by freshly
  streamed data, a sliding-window shuffle in O(pool) memory) and receive
  float32 batches.  ``ShardStream(force_python=True)`` runs a NumPy stream
  with the same sharding and shuffling semantics instead.

* **Multi-host**: shards are assigned ``host_index::num_hosts``, so each
  host streams a disjoint partition of the corpus.

The order-preserving readers (:func:`iter_shards_sequential`,
:func:`rebatch`) are for bulk encode and decode, where output row k must
correspond to corpus frame k.
"""

from __future__ import annotations

import ctypes
import json
import logging
import pathlib
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def write_shards(
    outdir,
    arrays: Iterable[np.ndarray],
    frames_per_shard: int = 1 << 20,
) -> dict:
    """Write (*, dim) float arrays into raw-f16 shards + manifest; returns
    the manifest dict."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    dim = None
    shards = []
    cur = []
    cur_frames = 0

    def flush():
        nonlocal cur, cur_frames
        if cur_frames == 0:
            return
        name = f"shard_{len(shards):05d}.raw"
        with open(outdir / name, "wb") as f:
            f.write(np.concatenate(cur, axis=0).astype("<f2").tobytes())
        shards.append({"file": name, "frames": int(cur_frames)})
        cur, cur_frames = [], 0

    for x in arrays:
        x = np.asarray(x)
        x = x.reshape(-1, x.shape[-1])
        if dim is None:
            dim = int(x.shape[-1])
        if x.shape[-1] != dim:
            raise ValueError(f"array of shape {x.shape} in a corpus of dim {dim}")
        pos = 0
        while pos < x.shape[0]:
            take = min(frames_per_shard - cur_frames, x.shape[0] - pos)
            cur.append(x[pos : pos + take])
            cur_frames += take
            pos += take
            if cur_frames == frames_per_shard:
                flush()
    flush()
    manifest = {"dim": dim, "dtype": "float16", "shards": shards}
    with open(outdir / "manifest.json", "w") as f:
        json.dump(manifest, f)
    return manifest


def convert_hdf5_to_shards(hdf5_path, outdir, frames_per_shard: int = 1 << 20):
    """Convert a reference-format HDF5 archive
    (`quantization/quantization.py:755-761`), datasets in sorted key order,
    into raw shards.  Needs ``h5py``."""
    import h5py

    def gen():
        with h5py.File(hdf5_path, "r") as hf:
            for key in sorted(hf.keys()):
                yield np.asarray(hf[key])

    return write_shards(outdir, gen(), frames_per_shard)


def rebatch(
    arrays: Iterable[np.ndarray], batch_size: int, dtype=np.float32
) -> Iterator[np.ndarray]:
    """Re-chunk an order-preserving stream of (*, dim) arrays into
    ``batch_size``-row batches (one final partial batch; no shuffling, no
    duplication).  The one batching path of every sequential reader
    (shards, HDF5, CLI)."""
    buf = None
    for data in arrays:
        data = np.asarray(data)
        data = data.reshape(-1, data.shape[-1])
        if buf is not None and buf.shape[0]:
            data = np.concatenate([buf, data])
        n_full = (data.shape[0] // batch_size) * batch_size
        for start in range(0, n_full, batch_size):
            yield data[start : start + batch_size].astype(dtype, copy=False)
        buf = data[n_full:]
    if buf is not None and buf.shape[0]:
        yield buf.astype(dtype, copy=False)


def _read_manifest(shard_dir: pathlib.Path) -> dict:
    with open(shard_dir / "manifest.json") as f:
        manifest = json.load(f)
    if manifest["dtype"] != "float16":
        raise ValueError(f"{shard_dir}: shards of dtype {manifest['dtype']}, not float16")
    return manifest


def iter_shards_sequential(
    shard_dir,
    batch_size: int,
    *,
    host_index: int = 0,
    num_hosts: int = 1,
    dtype=np.float32,
) -> Iterator[np.ndarray]:
    """Order-preserving batch iterator: shard files in manifest order, rows
    in file order, no shuffling and no duplication.  Use this for bulk
    encode/decode; the shuffling :class:`ShardStream` is for training.

    ``dtype=np.float16`` yields the raw storage dtype with no host-side
    conversion (views of the file read), for a caller that uploads f16 and
    upcasts on the card."""
    shard_dir = pathlib.Path(shard_dir)
    manifest = _read_manifest(shard_dir)
    dim = int(manifest["dim"])

    def files():
        for entry in manifest["shards"][host_index::num_hosts]:
            yield np.fromfile(shard_dir / entry["file"], dtype="<f2").reshape(-1, dim)

    yield from rebatch(files(), batch_size, dtype)


def _native_loader() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """The native loader's library, built into ``csrc/_build/`` at first
    use, and None; or None and why it could not be built or loaded."""
    from ..ops import cuda_build

    try:
        lib = cuda_build.library("qtz_loader")
    except (OSError, RuntimeError) as e:  # no g++, a failed build, a library that does not load
        return None, str(e)
    lib.qtz_loader_create.restype = ctypes.c_void_p
    lib.qtz_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_uint64,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.qtz_loader_next.restype = ctypes.c_int64
    lib.qtz_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.qtz_loader_destroy.restype = None
    lib.qtz_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib, None


class ShardStream:
    """Iterator of (batch, dim) float32 batches from a shard directory.

    Runs the native C++ loader; ``force_python=True`` asks for the NumPy
    stream.  ``native`` says which one runs.  Where the native loader cannot
    be built, the NumPy stream runs, ``native`` is False and
    ``native_error`` holds the compiler's or loader's message (also
    logged as a warning)."""

    _handle = None  # set once the native loader is created; close() clears it

    def __init__(
        self,
        shard_dir,
        batch_size: int,
        *,
        host_index: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        pool_frames: int = 1 << 18,
        num_threads: int = 4,
        repeat: bool = True,
        force_python: bool = False,
    ):
        shard_dir = pathlib.Path(shard_dir)
        manifest = _read_manifest(shard_dir)
        if batch_size > pool_frames:
            raise ValueError(
                f"batch_size ({batch_size}) must not exceed pool_frames "
                f"({pool_frames}): batches are drawn from the shuffle pool "
                "without replacement"
            )
        self.dim = int(manifest["dim"])
        self.batch_size = batch_size
        entries = manifest["shards"][host_index::num_hosts]
        self._paths = [str(shard_dir / e["file"]) for e in entries]
        self._frames = [int(e["frames"]) for e in entries]
        self._repeat = repeat
        self._seed = seed + host_index
        self._pool_frames = pool_frames
        self._lib = None
        self.native_error = None
        if not force_python:
            self._lib, self.native_error = _native_loader()
            if self.native_error is not None:
                logger.warning("native shard loader unavailable, running the NumPy "
                               "stream: %s", self.native_error)
        if self._lib is not None:
            arr_paths = (ctypes.c_char_p * len(self._paths))(*[p.encode() for p in self._paths])
            arr_frames = (ctypes.c_int64 * len(self._frames))(*self._frames)
            self._handle = self._lib.qtz_loader_create(
                arr_paths, arr_frames, len(self._paths), self.dim, pool_frames, batch_size,
                self._seed, num_threads, 1 if repeat else 0,
            )
        self.native = self._handle is not None

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.native:
            out = np.empty((self.batch_size, self.dim), dtype=np.float32)
            ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            while self._handle is not None:
                n = self._lib.qtz_loader_next(self._handle, ptr)
                if n < self.batch_size:
                    if n > 0:  # final partial batch (non-repeat end)
                        yield out[:n].copy()
                    return
                yield out.copy()
        else:
            yield from self._python_stream()

    def _python_stream(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self._seed)
        pool = np.empty((self._pool_frames, self.dim), dtype=np.float16)
        fill = 0
        while True:
            for si in rng.permutation(len(self._paths)):
                data = np.fromfile(self._paths[si], dtype="<f2").reshape(-1, self.dim)
                pos = 0
                while pos < data.shape[0]:
                    take = min(self._pool_frames - fill, data.shape[0] - pos)
                    pool[fill : fill + take] = data[pos : pos + take]
                    fill += take
                    pos += take
                    while fill == self._pool_frames:
                        # draw without replacement, as the native loader:
                        # every frame exactly once an epoch
                        sel = rng.choice(fill, self.batch_size, replace=False)
                        batch = pool[sel].astype(np.float32)
                        keep_mask = np.ones(fill, dtype=bool)
                        keep_mask[sel] = False
                        keep = np.flatnonzero(keep_mask)
                        fill = keep.size
                        pool[:fill] = pool[keep]
                        yield batch
            if not self._repeat:
                # drain the pool in batch_size chunks (shuffled), as the
                # native loader: full batches, then one final partial
                perm = rng.permutation(fill)
                for start in range(0, fill, self.batch_size):
                    yield pool[perm[start : start + self.batch_size]].astype(np.float32)
                return

    def close(self) -> None:
        """Stop the native loader's reader threads and free its pool."""
        if self._handle is not None:
            self._lib.qtz_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
