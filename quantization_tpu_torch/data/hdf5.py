"""HDF5 out-of-core data path.

The PyTorch port's copy of ``quantization_tpu/data/hdf5.py``.  It
reimplements the reference's corpus reader (`quantization/quantization.py:746-821`)
and writer example (`quantization/test_write_hdf5.py:7-34`), plus the piece the
reference lacks: a sharded streaming iterator for multi-host training, where
each host reads only its share of the datasets and shuffles within a bounded
buffer instead of materializing and `np.random.shuffle`-ing the whole corpus
in RAM (SURVEY.md section 7 "hard parts").

File format (same as the reference): an HDF5 archive whose datasets all share
the same final dimension; names are arbitrary but distinct::

    hf = h5py.File(filename, 'w')
    for i in range(...):
        hf.create_dataset(f'dataset_{i}', data=x)   # x: (*, dim) float16

Note: the reference's uncapped validation split uses a float as a slice bound
(`quantization/quantization.py:813-820`) and crashes for corpora under 200k
frames; this implementation rounds it properly.
"""

from __future__ import annotations

import logging
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def write_hdf5_data(filename: str, arrays: Iterable[np.ndarray]) -> int:
    """Write an iterable of (*, dim) arrays as one dataset each; returns the
    total number of frames written."""
    import h5py

    tot = 0
    with h5py.File(filename, "w") as hf:
        for i, x in enumerate(arrays):
            x = np.asarray(x)
            hf.create_dataset(f"dataset_{i}", data=x)
            tot += int(np.prod(x.shape[:-1]))
    return tot


def read_hdf5_data(
    filename: str,
    valid_proportion: float = 0.05,
    max_valid_frames: int = 10000,
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Read the full archive into one (tot_frames, dim) array (dtype preserved,
    e.g. float16), shuffle rows, split off validation frames
    (min(valid_proportion * tot, max_valid_frames)).

    Returns (train, valid) numpy arrays; the trainer takes their slices as
    they are (``QuantizerTrainer.step`` casts to float32 on its device).
    """
    import h5py

    logger.info("Opening file %s", filename)
    with h5py.File(filename, "r") as hf:
        tot_frames = 0
        dim = -1
        for key in hf.keys():
            shape = list(hf[key].shape)
            if dim == -1:
                dim = shape[-1]
            elif dim != shape[-1]:
                raise ValueError(
                    "Dataset must have consistent dimension (last element of shape)")
            tot_frames += int(np.prod(shape[:-1]))
        logger.info("read_hdf5_data: tot_frames = %d", tot_frames)

        first = next(iter(hf.keys()))
        ans = np.empty((tot_frames, dim), dtype=hf[first].dtype)
        cur = 0
        for key in hf.keys():
            arr = np.ascontiguousarray(hf[key][:]).reshape(-1, dim)
            ans[cur : cur + arr.shape[0]] = arr
            cur += arr.shape[0]

    rng = np.random.default_rng(seed)
    rng.shuffle(ans)

    valid_frames = min(int(round(valid_proportion * tot_frames)), max_valid_frames)
    logger.info(
        "read_hdf5_data: train_frames=%d, valid_frames=%d",
        tot_frames - valid_frames,
        valid_frames,
    )
    return ans[valid_frames:], ans[:valid_frames]


def stream_hdf5_frames(
    filenames,
    batch_size: int,
    *,
    host_index: int = 0,
    num_hosts: int = 1,
    seed: int = 0,
    shuffle_buffer_frames: int = 1 << 20,
    repeat: bool = True,
    dtype=np.float16,
) -> Iterator[np.ndarray]:
    """Out-of-core, multi-host frame stream.

    Datasets (across one or more archive files) are assigned round-robin to
    hosts; each host reads its datasets in a per-epoch shuffled order, fills a
    bounded shuffle buffer, and yields shuffled (batch_size, dim) arrays.
    Memory is O(shuffle_buffer_frames * dim), independent of corpus size —
    unlike `quantization/quantization.py:798-809`, which loads and shuffles
    the whole corpus.

    Each host should construct this with its own ``host_index`` (e.g.
    ``torch.distributed.get_rank()``) so the corpus is partitioned, not
    duplicated.
    """
    import h5py

    if isinstance(filenames, str):
        filenames = [filenames]
    rng = np.random.default_rng(seed + host_index)

    # Enumerate (file, key) pairs once; assignment must be identical on all
    # hosts, so sort keys.
    entries = []
    dim = -1
    for fname in filenames:
        with h5py.File(fname, "r") as hf:
            for key in sorted(hf.keys()):
                shape = hf[key].shape
                if dim == -1:
                    dim = shape[-1]
                if dim != shape[-1]:
                    raise ValueError(f"{fname}:{key} has shape {shape}, not (*, {dim})")
                entries.append((fname, key))
    my_entries = entries[host_index::num_hosts]
    if not my_entries:
        return

    buf = np.empty((shuffle_buffer_frames, dim), dtype=dtype)
    fill = 0

    def drain_batches(final: bool):
        nonlocal fill
        # shuffle the buffer, then emit batches from it
        rng.shuffle(buf[:fill])
        emit_end = fill if final else max(fill - shuffle_buffer_frames // 2, 0)
        pos = 0
        while emit_end - pos >= batch_size:
            yield buf[pos : pos + batch_size].copy()
            pos += batch_size
        if final:
            pos = fill  # drop the ragged tail
        buf[: fill - pos] = buf[pos:fill]
        fill = fill - pos

    while True:
        order = rng.permutation(len(my_entries))
        for ei in order:
            fname, key = my_entries[ei]
            with h5py.File(fname, "r") as hf:
                arr = np.ascontiguousarray(hf[key][:]).reshape(-1, dim)
            taken = 0
            while taken < arr.shape[0]:
                room = shuffle_buffer_frames - fill
                take = min(room, arr.shape[0] - taken)
                buf[fill : fill + take] = arr[taken : taken + take]
                fill += take
                taken += take
                if fill == shuffle_buffer_frames:
                    yield from drain_batches(final=False)
        if not repeat:
            yield from drain_batches(final=True)
            return


def iter_hdf5_sequential(filename: str, batch_size: int) -> Iterator[np.ndarray]:
    """Order-preserving batch iterator over an HDF5 archive: datasets in key
    order (the reference's read order, `quantization/quantization.py:788`),
    rows in storage order, no shuffling.  For bulk encode/decode, where
    output row k must correspond to corpus frame k."""
    import h5py

    from .shards import rebatch

    def datasets():
        with h5py.File(filename, "r") as hf:
            for key in hf.keys():
                yield np.ascontiguousarray(hf[key][:])

    yield from rebatch(datasets(), batch_size)


def minibatch_iterator(
    data: np.ndarray, batch_size: int, seed: int = 0, repeat: bool = True
) -> Iterator[np.ndarray]:
    """Shuffled minibatches from an in-memory (N, dim) array (the
    `quantization/test_train_hdf5.py:22-30` pattern, without the device copy
    — pass batches straight to ``trainer.step``)."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    while True:
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            yield data[order[start : start + batch_size]]
        if not repeat:
            return
