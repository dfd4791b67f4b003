"""The port's HDF5 data path (``quantization_tpu_torch/data/hdf5.py``) held
to the JAX package's ``data/hdf5.py``: each function gives equal arrays on
the same file and seed."""

import numpy as np
import pytest

import quantization_tpu_torch as qtt
from quantization_tpu.data import hdf5 as jh5
from quantization_tpu_torch.data import hdf5 as th5

h5py = pytest.importorskip("h5py")


def _arrays(n_datasets=10, frames=100, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((frames, dim)).astype(np.float16) for _ in range(n_datasets)]


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_hdf5") / "corpus.hdf5"
    jh5.write_hdf5_data(str(path), _arrays())
    return path


def test_write_hdf5_data_writes_what_jax_writes(tmp_path):
    arrays = _arrays(n_datasets=3, seed=4) + [np.zeros((4, 5, 16), np.float16)]
    tot_j = jh5.write_hdf5_data(str(tmp_path / "j.hdf5"), arrays)
    tot_t = th5.write_hdf5_data(str(tmp_path / "t.hdf5"), arrays)
    assert tot_t == tot_j == 320
    with h5py.File(tmp_path / "j.hdf5", "r") as hj, h5py.File(tmp_path / "t.hdf5", "r") as ht:
        assert list(ht.keys()) == list(hj.keys())
        for k in hj.keys():
            assert ht[k].dtype == hj[k].dtype
            np.testing.assert_array_equal(ht[k][:], hj[k][:])


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, valid_proportion=0.2),
                                dict(seed=1, max_valid_frames=7)])
def test_read_hdf5_data_equal(archive, kw):
    jt, jv = jh5.read_hdf5_data(str(archive), **kw)
    tt, tv = th5.read_hdf5_data(str(archive), **kw)
    assert tt.dtype == jt.dtype == np.float16
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tv, jv)


def test_small_corpus_split_rounds_its_bound(tmp_path):
    # 1,000 frames: 5% validation; the reference's float slice bound crashes here
    path = tmp_path / "small.hdf5"
    th5.write_hdf5_data(str(path), [a.reshape(4, 25, 16) for a in _arrays()])
    train, valid = th5.read_hdf5_data(str(path), seed=0)
    assert (train.shape, valid.shape) == ((950, 16), (50, 16))
    assert qtt.read_hdf5_data is th5.read_hdf5_data  # exported lazily, as in the JAX package


@pytest.mark.parametrize("host_index,num_hosts,repeat", [(0, 1, False), (0, 1, True),
                                                         (1, 2, False)])
def test_stream_hdf5_frames_equal(archive, tmp_path, host_index, num_hosts, repeat):
    second = tmp_path / "second.hdf5"
    jh5.write_hdf5_data(str(second), _arrays(n_datasets=3, frames=70, seed=5))
    kw = dict(batch_size=64, host_index=host_index, num_hosts=num_hosts, seed=2,
              shuffle_buffer_frames=256, repeat=repeat)
    files = [str(archive), str(second)]
    n = 50 if repeat else 10**6
    want = [b for _, b in zip(range(n), jh5.stream_hdf5_frames(files, **kw))]
    got = [b for _, b in zip(range(n), th5.stream_hdf5_frames(files, **kw))]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("batch", [64, 100, 333])
def test_iter_hdf5_sequential_equal(archive, batch):
    want = list(jh5.iter_hdf5_sequential(str(archive), batch))
    got = list(th5.iter_hdf5_sequential(str(archive), batch))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("repeat", [False, True])
def test_minibatch_iterator_equal(repeat):
    data = np.concatenate(_arrays(n_datasets=2))
    kw = dict(batch_size=48, seed=6, repeat=repeat)
    n = 13 if repeat else 10**6
    want = [b for _, b in zip(range(n), jh5.minibatch_iterator(data, **kw))]
    got = [b for _, b in zip(range(n), th5.minibatch_iterator(data, **kw))]
    assert len(got) == len(want) == (13 if repeat else 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_multidim_datasets_read_as_frames(tmp_path):
    path = tmp_path / "nd.hdf5"
    rng = np.random.default_rng(1)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("a", data=rng.standard_normal((4, 5, 8)).astype(np.float16))
        hf.create_dataset("b", data=rng.standard_normal((20, 8)).astype(np.float16))
    for fn in (th5.read_hdf5_data, jh5.read_hdf5_data):
        train, valid = fn(str(path), seed=0)
        assert train.shape[0] + valid.shape[0] == 40 and train.shape[1] == 8
    np.testing.assert_array_equal(np.concatenate(list(th5.iter_hdf5_sequential(str(path), 7))),
                                  np.concatenate(list(jh5.iter_hdf5_sequential(str(path), 7))))
