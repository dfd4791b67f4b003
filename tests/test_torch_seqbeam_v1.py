"""B4, the first sequential-beam kernel (seqbeam ``impl="v1"``): the port's
plain version against the JAX package's Pallas kernel in interpret mode
(the CUDA kernel is held against the plain version on a card in
``test_torch_gpu.py``).

On the JAX package's own NumPy-mirror problem (PRNG key 5, dim 128, nc 4,
B=128, 2 passes, ``tests/test_search_alternatives.py:81-193``) every index
must be equal.  Elsewhere both sides get the same numpy-seeded parameters
and frames; the bar there is at least 99% of indexes equal and the summed
squared error within 1e-4 relative, because the root error's sum of squares
and the bf16 rescores are f32 sums taken in another order and can flip a
near tie.  Observed: every index equal.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantization_tpu import core as jcore
from quantization_tpu.data.synthetic import make_mlp_sampler as jax_mlp_sampler
from quantization_tpu.ops import seqbeam as jseq
from quantization_tpu.utils.serialization import load_quantizer as jax_load
import quantization_tpu_torch as qtt
from quantization_tpu_torch import core as tcore
from quantization_tpu_torch.core import codec as tcodec
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.utils.torch_interop import params_from_numpy

CS = 256
FIELDS = ("centers", "to_logits_w", "to_logits_b", "logits_scale", "centers_scale")
Q256 = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "q256_4_full.npz"


def _sse(centers, idx, x):
    nc = centers.shape[0]
    return float(((centers[np.arange(nc)[None], idx].sum(1) - x) ** 2).sum())


def _close(centers, x, got, want):
    assert (got == want).mean() >= 0.99
    e_got, e_want = _sse(centers, got, x), _sse(centers, want, x)
    assert abs(e_got / e_want - 1.0) <= 1e-4, (e_got, e_want)


@pytest.fixture(scope="module")
def mirror():
    """The JAX NumPy mirror's problem, as numpy arrays for both sides."""
    config = jcore.QuantizerConfig(dim=128, codebook_size=CS, num_codebooks=4)
    key = jax.random.PRNGKey(5)
    params = jcore.init_quantizer_params(key, config)
    x = np.array(jax.random.normal(jax.random.fold_in(key, 1), (128, 128)))
    arrays = {k: np.array(getattr(params, k)) for k in FIELDS}
    return config, params, arrays, x


def _numpy_problem(nc, seed, B=128, dim=128):
    """Trained-like codebooks: frames are sums of codewords plus noise, and
    the prediction weights point at the codewords."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, CS, dim)).astype(np.float32) * 0.5
    arrays = {
        "centers": centers,
        "to_logits_w": (centers.reshape(nc * CS, dim)
                        + 0.5 * rng.standard_normal((nc * CS, dim))).astype(np.float32),
        "to_logits_b": (0.1 * rng.standard_normal(nc * CS)).astype(np.float32),
        "logits_scale": np.float32(0.0), "centers_scale": np.float32(0.0),
    }
    x = (centers[np.arange(nc)[None], rng.integers(0, CS, (B, nc))].sum(1)
         + 2.0 * rng.standard_normal((B, dim))).astype(np.float32)
    init = rng.integers(0, CS, (B, nc)).astype(np.int32)
    return arrays, x, init


def test_v1_plain_equals_jax_mirror_problem(mirror):
    config, params, arrays, x = mirror
    want = np.asarray(jseq.seqbeam_encode_indexes(
        params, config, jnp.asarray(x), passes=2, interpret=True, impl="v1"))
    tc = tcore.QuantizerConfig(dim=128, codebook_size=CS, num_codebooks=4)
    before = tseq.SEQBEAM_V1_KERNEL.launches
    got = tseq.seqbeam_encode_indexes(params_from_numpy(arrays), tc, torch.from_numpy(x),
                                      passes=2, impl="v1")
    assert tseq.SEQBEAM_V1_KERNEL.launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.int32 and got.shape == (128, 4)
    np.testing.assert_array_equal(got.numpy(), want)  # every index


@pytest.mark.parametrize("nc,kw", [
    (2, dict(M=16, R=8, passes=3)),  # from the caller's initial indexes
    (4, dict(M=24, R=4, passes=2)),  # an M that v1 takes and v2 does not
])
def test_v1_plain_matches_jax_interpret(nc, kw):
    arrays, x, init = _numpy_problem(nc, 3)
    use_init = nc == 2
    jc = jcore.QuantizerConfig(dim=128, codebook_size=CS, num_codebooks=nc)
    jp = jcore.QuantizerParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want = np.asarray(jseq.seqbeam_encode_indexes(
        jp, jc, jnp.asarray(x), interpret=True, impl="v1",
        init_indexes=jnp.asarray(init) if use_init else None, **kw))
    got = tseq.seqbeam_encode_indexes(
        params_from_numpy(arrays), tcore.QuantizerConfig(dim=128, codebook_size=CS,
                                                         num_codebooks=nc),
        torch.from_numpy(x), impl="v1",
        init_indexes=torch.from_numpy(init) if use_init else None, **kw).numpy()
    _close(arrays["centers"], x, got, want)
    assert _sse(arrays["centers"], got, x) < _sse(arrays["centers"], init, x)


def test_v1_relates_to_v2_as_in_jax(mirror):
    # the JAX relation (tests/test_search_alternatives.py:195-211): v2
    # reassociates the score and packs the pool otherwise, so not bit-equal,
    # but >95% of indexes equal and the squared error within 1e-3 relative
    _, _, arrays, x = mirror
    tc = tcore.QuantizerConfig(dim=128, codebook_size=CS, num_codebooks=4)
    p, xt = params_from_numpy(arrays), torch.from_numpy(x)
    o1 = tseq.seqbeam_encode_indexes(p, tc, xt, passes=2, impl="v1").numpy()
    o2 = tseq.seqbeam_encode_indexes(p, tc, xt, passes=2, impl="v2").numpy()
    centers = tcore.scaled_centers(p, tc.scale_speed).numpy()
    e1, e2 = _sse(centers, o1, x), _sse(centers, o2, x)
    assert abs(e2 - e1) / e1 < 1e-3, (e1, e2)
    assert (o1 == o2).mean() > 0.95


def test_quantizer_encode_v1_matches_jax_quantizer():
    # end to end on the committed trained d256 / 4 B quantizer, frames from
    # the JAX package's key-42 sampler
    jq = jax_load(Q256)
    tq = qtt.load_quantizer(Q256, device="cpu")
    x = np.array(jax_mlp_sampler(256, jax.random.PRNGKey(42))(jax.random.PRNGKey(3), 128))
    want = np.array(jq.encode(jnp.asarray(x), refine_indexes_iters=2, search_method="seqbeam",
                              impl="v1", interpret=True))
    got = tq.encode(torch.from_numpy(x), refine_indexes_iters=2, search_method="seqbeam",
                    impl="v1")
    assert got.dtype == torch.uint8 and got.shape == (128, 4)
    centers = tq.get_centers().detach().numpy()
    _close(centers, x, tcodec.unpack_indexes(got, CS, 4).numpy(),
           tcodec.unpack_indexes(torch.from_numpy(want), CS, 4).numpy())


@pytest.mark.parametrize("kw", [
    dict(impl="v1", e_dtype="bf16"), dict(impl="v1", e_dtype="int8"),
    dict(impl="v1", requant="pass"), dict(impl="v1", lazy_r1=True),
    dict(impl="v1", pool_mask="altparity"), dict(impl="v1", zip_skew=1),
    dict(impl="v1", sel_impl="fold"), dict(impl="v1", block_b=256),
    dict(impl="v1", M=12), dict(impl="v1", M=72, R=1), dict(impl="v1", M=32, R=16),
    dict(impl="v1", R=0), dict(impl="v3"),
])
def test_v1_refuses_what_jax_refuses(mirror, kw):
    _, _, arrays, x = mirror
    tc = tcore.QuantizerConfig(dim=128, codebook_size=CS, num_codebooks=4)
    with pytest.raises(ValueError):
        tseq.seqbeam_encode_indexes(params_from_numpy(arrays), tc, torch.from_numpy(x), **kw)


@pytest.mark.parametrize("nc,dim", [(4, 128), (2, 512)])
def test_v1_ring_chunks_hold_every_codeword_element_once(nc, dim):
    # f32 E's ring reads 32 KB chunk s of a pass as [8 16-byte K pieces][256
    # codewords][16 bytes]: codebook s // (dim / 64), row bytes [128 c, 128
    # c + 128) for c = s % (dim / 64); the wgmma descriptor of k step h < 4
    # reads pieces 2 h and 2 h + 1 of codeword n at byte 16 (256 p + n)
    arrays, _, _ = _numpy_problem(nc, 11, dim=dim)
    tables = tseq.seqbeam_tables(torch.from_numpy(arrays["centers"]), impl="v1")
    rows = tables.centers_bf16.contiguous().view(torch.int16)  # (nc, 256, dim)
    # every element's place (codebook, codeword, element) as one id
    ids = torch.arange(nc * CS * dim, dtype=torch.int64).reshape(nc, CS, dim)
    chunks = tables.chunks_bf16.view(torch.int16).reshape(-1, 8, CS, 8)  # 32 KB chunks
    assert chunks.shape[0] == nc * dim // 64 and tables.chunks_bf16.is_contiguous()
    place = torch.empty(chunks.shape, dtype=torch.int64)
    for s in range(chunks.shape[0]):
        t, c = divmod(s, dim // 64)
        for p in range(8):
            k0 = 64 * c + 8 * p
            place[s, p] = ids[t, :, k0:k0 + 8]
            assert torch.equal(chunks[s, p], rows[t, :, k0:k0 + 8])
    assert torch.equal(place.flatten().sort().values, ids.flatten())  # each exactly once


def test_v1_stage_timed_build_refuses_cpu_and_other_beams(mirror):
    _, _, arrays, x = mirror
    tc = tcore.QuantizerConfig(dim=128, codebook_size=CS, num_codebooks=4)
    p, xt = params_from_numpy(arrays), torch.from_numpy(x)
    with pytest.raises(ValueError, match="CUDA"):
        tseq.seqbeam_stages(tseq.seqbeam_problem(p, tc, xt, 16, 8, 3, impl="v1"))
    for M, R in ((8, 8), (16, 4), (24, 8), (32, 8)):
        with pytest.raises(ValueError, match="M=16 and R=8"):
            tseq.seqbeam_stages(tseq.seqbeam_problem(p, tc, xt, M, R, 3, impl="v1"))
