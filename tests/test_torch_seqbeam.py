"""K2, the sequential-beam encode (seqbeam v2): the port's plain version
against the JAX package's Pallas kernel in interpret mode (the CUDA kernel
is held against the plain version on a card in ``test_torch_gpu.py``).

Both sides get the same parameters and frames (numpy, seeded).  Exact
index equality is the goal; the bar is at least 99% of indexes equal and
the summed squared error within 1e-4 relative, because the root error's
sum of squares and the bf16 rescores are f32 sums taken in another order
and can flip a near tie.  Observed on this suite: every index equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantization_tpu import core as jcore
from quantization_tpu.ops import seqbeam as jseq
from quantization_tpu_torch import core as tcore
from quantization_tpu_torch.ops import beam_common as tbeam
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.ops.quality_guard import MAX_SSE_REL, MIN_AGREEMENT, against_plain
from quantization_tpu_torch.utils.torch_interop import params_from_numpy

DIM, CS, B = 128, 256, 128


def _problem(nc, seed):
    """Trained-like codebooks: frames are sums of codewords plus noise, and
    the prediction weights point at the codewords."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, CS, DIM)).astype(np.float32) * 0.5
    arrays = {
        "centers": centers,
        "to_logits_w": (centers.reshape(nc * CS, DIM)
                        + 0.5 * rng.standard_normal((nc * CS, DIM))).astype(np.float32),
        "to_logits_b": (0.1 * rng.standard_normal(nc * CS)).astype(np.float32),
        "logits_scale": np.float32(0.0),
        "centers_scale": np.float32(0.0),
    }
    pick = rng.integers(0, CS, (B, nc))
    x = (centers[np.arange(nc)[None], pick].sum(1)
         + 2.0 * rng.standard_normal((B, DIM))).astype(np.float32)
    init = rng.integers(0, CS, (B, nc)).astype(np.int32)
    return arrays, x, init


def _sse(centers, idx, x):
    nc = centers.shape[0]
    return float(((centers[np.arange(nc)[None], idx].sum(1) - x) ** 2).sum())


def _run_both(nc, seed, use_init, **kw):
    arrays, x, init = _problem(nc, seed)
    jc = jcore.QuantizerConfig(dim=DIM, codebook_size=CS, num_codebooks=nc)
    tc = tcore.QuantizerConfig(dim=DIM, codebook_size=CS, num_codebooks=nc)
    jp = jcore.QuantizerParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    reorder = "gather" if kw.get("e_dtype", "f32") == "f32" else "select"
    want = np.asarray(jseq.seqbeam_encode_indexes(
        jp, jc, jnp.asarray(x), interpret=True, reorder=reorder,
        init_indexes=jnp.asarray(init) if use_init else None, **kw))
    before = tseq.SEQBEAM_KERNEL.launches
    got = tseq.seqbeam_encode_indexes(
        params_from_numpy(arrays), tc, torch.from_numpy(x), reorder=reorder,
        init_indexes=torch.from_numpy(init) if use_init else None, **kw)
    assert tseq.SEQBEAM_KERNEL.launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.int32 and got.shape == (B, nc)
    return arrays["centers"], x, init, got.numpy(), want


@pytest.mark.parametrize("e_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("pool_mask", ["altparity", None])
def test_plain_matches_jax_interpret(e_dtype, pool_mask):
    centers, x, init, got, want = _run_both(
        4, 0, True, M=8, R=4, passes=2, pool_mask=pool_mask, e_dtype=e_dtype)
    assert (got == want).mean() >= 0.99
    e_got, e_want = _sse(centers, got, x), _sse(centers, want, x)
    assert abs(e_got / e_want - 1.0) <= 1e-4, (e_got, e_want)
    assert e_got < _sse(centers, init, x)  # the search did work


@pytest.mark.parametrize("nc,kw", [
    (4, dict(M=16, R=4, passes=2, e_dtype="bf16")),
    (2, dict(M=8, R=4, passes=3, pool_mask="altparity", e_dtype="int8")),
])
def test_plain_matches_jax_interpret_logits_init(nc, kw):
    # initialised from the logits argmax on both sides (f32 matmuls)
    centers, x, _, got, want = _run_both(nc, 1, False, **kw)
    assert (got == want).mean() >= 0.99
    e_got, e_want = _sse(centers, got, x), _sse(centers, want, x)
    assert abs(e_got / e_want - 1.0) <= 1e-4, (e_got, e_want)


@pytest.mark.parametrize("pool_mask", [
    "altparity", "allfirst", "alllast", (True, False, True, False),
    ((True, True, False, False), (False, True, True, True), (True,) * 4)])
def test_pool_mask_normalizes_like_jax(pool_mask):
    assert tbeam.normalize_pool_mask(pool_mask, 4, 3) == jseq._normalize_pool_mask(
        pool_mask, 4, 3)
    bits = tbeam.pool_bits(pool_mask, 4, 3)
    for word, mask in zip(bits, jseq._normalize_pool_mask(pool_mask, 4, 3)):
        assert word == sum(1 << t for t in range(4) if mask[t])
    assert tbeam.pool_bits(None, 4, 2) == (15, 15)


def test_unported_options_raise():
    arrays, x, _ = _problem(4, 2)
    tc = tcore.QuantizerConfig(dim=DIM, codebook_size=CS, num_codebooks=4)
    p, xt = params_from_numpy(arrays), torch.from_numpy(x)
    # combinations the TPU wrapper refuses: v1 takes f32 E only, lazy_r1 a
    # static schedule, and "pass"/"bound" int8 E only
    for kw, what in ((dict(impl="v1", e_dtype="int8"), "v1"), (dict(lazy_r1=True), "lazy_r1"),
                     (dict(requant="bound"), "int8"), (dict(requant="pass", e_dtype="bf16"),
                                                       "int8")):
        with pytest.raises(ValueError, match=what):
            tseq.seqbeam_encode_indexes(p, tc, xt, **kw)
    for kw in (dict(M=12), dict(M=64, R=16), dict(e_dtype="fp8"), dict(passes=0),
               dict(pool_mask="nope"), dict(init_indexes=torch.full((B, 4), CS)),
               dict(init_indexes=torch.zeros(B, 2, dtype=torch.int32))):
        with pytest.raises(ValueError):
            tseq.seqbeam_encode_indexes(p, tc, xt, **kw)
    with pytest.raises(ValueError, match="CUDA"):  # the kernel takes no CPU tensor
        tseq.seqbeam_cuda(tseq.seqbeam_problem(p, tc, xt, M=8, R=4, passes=1))
    with pytest.raises(ValueError):
        tseq.seqbeam_encode_indexes(
            p, tcore.QuantizerConfig(dim=DIM, codebook_size=16, num_codebooks=4), xt)


def test_against_plain_holds_indexes_to_the_bars():
    # the check chip_smoke.py and the quality guard apply to the kernel's
    # indexes, here given the plain version's own and a damaged copy
    arrays, x, init = _problem(4, 2)
    tc = tcore.QuantizerConfig(dim=DIM, codebook_size=CS, num_codebooks=4)
    problem = tseq.seqbeam_problem(
        params_from_numpy(arrays), tc, torch.from_numpy(x), M=8, R=4, passes=2,
        pool_mask="altparity", e_dtype="int8", init_indexes=torch.from_numpy(init))
    centers = torch.from_numpy(arrays["centers"])
    plain = tseq.seqbeam_plain(problem)
    same = against_plain(problem, centers, plain)
    assert same["ok"] and same["frames"] == B
    assert same["index_agreement"] == 1.0 and same["sse_rel_diff"] == 0.0
    assert same["max_abs_err"] == 0.0
    bad = against_plain(problem, centers, problem.idx0)  # the unsearched init
    assert not bad["ok"] and bad["index_agreement"] < MIN_AGREEMENT
    assert bad["sse_rel_diff"] > MAX_SSE_REL and bad["max_abs_err"] > 0.0


def test_scheduling_knobs_do_not_change_results():
    arrays, x, init = _problem(4, 3)
    tc = tcore.QuantizerConfig(dim=DIM, codebook_size=CS, num_codebooks=4)
    p, xt, it = params_from_numpy(arrays), torch.from_numpy(x), torch.from_numpy(init)
    base = tseq.seqbeam_encode_indexes(p, tc, xt, M=8, R=4, passes=2, init_indexes=it,
                                       e_dtype="bf16", pool_mask="altparity", reorder="select")
    knobs = tseq.seqbeam_encode_indexes(
        p, tc, xt, M=8, R=4, passes=2, init_indexes=it, e_dtype="bf16",
        pool_mask="altparity", block_b=512, interleave=2, zip_skew=1, reorder="select",
        sel_impl="fold", cross_value=True)
    assert torch.equal(base, knobs)


@pytest.mark.parametrize("e_dtype", ["bf16", "int8"])
def test_ring_chunks_hold_the_codebooks_in_wgmma_order(e_dtype):
    # the v2 kernel's ring reads chunk k of codebook t as [8 16-byte K
    # pieces][256 codewords][16 bytes] of row bytes [128 k, 128 k + 128);
    # f32 E streams the same bf16 chunks
    arrays, _, _ = _problem(4, 5)
    tables = tseq.seqbeam_tables(torch.from_numpy(arrays["centers"]), e_dtype)
    assert torch.equal(
        tseq.seqbeam_tables(torch.from_numpy(arrays["centers"]), "f32").chunks_bf16,
        tables.chunks_bf16)
    pairs = [(tables.centers_bf16, tables.chunks_bf16)]
    if e_dtype == "int8":
        pairs.append((tables.centers_i8, tables.chunks_i8))
    else:
        assert tables.chunks_i8 is None
    for centers, chunks in pairs:
        rows = centers.contiguous().view(torch.uint8)  # (nc, 256, row bytes)
        nc, cs, nbytes = rows.shape
        assert chunks.shape == (nc, nbytes // 128, 8, cs, 16) and chunks.is_contiguous()
        for t, k, p, n in ((0, 0, 0, 0), (1, nbytes // 128 - 1, 7, 255), (3, 0, 5, 17)):
            start = 128 * k + 16 * p
            assert torch.equal(chunks[t, k, p, n], rows[t, n, start:start + 16])
