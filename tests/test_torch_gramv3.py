"""K3, the Gram-table encode (gramv3): the port's plain version against the
JAX package's Pallas kernel in interpret mode (the CUDA kernel is held
against the plain version on a card in ``test_torch_gpu.py``).

Both sides get the same parameters and frames (numpy, seeded).  Given the
JAX wrapper's own precomputes, the plain version must equal the kernel on
every index: the table rows are summed in codebook order on both sides
(exact in int32 for int8 tables), and every later step is the same f32
arithmetic.  End to end, the port computes its precomputes itself (f32
matmuls and sums in another order than XLA's), so a near tie may flip:
there the bar is at least 99% of indexes equal and the summed squared error
within 1e-4 relative, the bars of ``test_torch_seqbeam.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantization_tpu import core as jcore
from quantization_tpu.core import codec as jcodec
from quantization_tpu.core import search as jsearch
from quantization_tpu.ops import gramv3 as jg3
from quantization_tpu_torch import core as tcore
from quantization_tpu_torch.core import codec as tcodec
from quantization_tpu_torch.ops import beam_common as tbeam
from quantization_tpu_torch.ops import gramv3 as tg3
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.utils.torch_interop import params_from_numpy

CS = 256


def _arrays(nc, dim, seed):
    """Trained-like codebooks: the prediction weights point at the
    codewords; frames are sums of codewords plus noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, CS, dim)).astype(np.float32) * 0.5
    arrays = {
        "centers": centers,
        "to_logits_w": (centers.reshape(nc * CS, dim)
                        + 0.5 * rng.standard_normal((nc * CS, dim))).astype(np.float32),
        "to_logits_b": (0.1 * rng.standard_normal(nc * CS)).astype(np.float32),
        "logits_scale": np.float32(0.0),
        "centers_scale": np.float32(0.0),
    }
    return arrays, rng


def _frames(arrays, rng, B):
    centers = arrays["centers"]
    nc, _, dim = centers.shape
    pick = rng.integers(0, CS, (B, nc))
    return (centers[np.arange(nc)[None], pick].sum(1)
            + 2.0 * rng.standard_normal((B, dim))).astype(np.float32)


def _both(nc, dim, seed, B):
    arrays, rng = _arrays(nc, dim, seed)
    x = _frames(arrays, rng, B)
    jc = jcore.QuantizerConfig(dim=dim, codebook_size=CS, num_codebooks=nc)
    tc = tcore.QuantizerConfig(dim=dim, codebook_size=CS, num_codebooks=nc)
    jp = jcore.QuantizerParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return arrays, x, jc, jp, tc, params_from_numpy(arrays)


def _jax_problem(jp, jc, x, g_dtype, M, R, passes, pool_mask):
    """The JAX wrapper's precomputes (``gramv3.py:675-710``, the same
    expressions as ``tests/test_search_alternatives.py:404-439``) as a port
    problem."""
    nc, dim = jc.num_codebooks, jc.dim
    K = nc * CS
    x = jnp.asarray(x)
    centers = jcore.scaled_centers(jp, jc.scale_speed)
    ctab = centers.reshape(K, dim).astype(jnp.bfloat16)
    csq = jnp.sum(centers.astype(jnp.bfloat16).astype(jnp.float32) ** 2, axis=-1)
    g = jnp.dot(ctab, ctab.T, preferred_element_type=jnp.float32)
    blk = jnp.repeat(jnp.arange(nc), CS)
    eye = (blk[:, None] == blk[None, :]).astype(jnp.float32)
    gtil_f32 = g * (1.0 - eye) + eye * (csq.reshape(K) / 2.0)[None, :]
    if g_dtype == "int8":
        amax = jnp.max(jnp.abs(gtil_f32))
        scale = jnp.where(amax > 0, amax / 127.0, 1.0)
        gtil = torch.from_numpy(np.array(jnp.round(gtil_f32 / scale).astype(jnp.int8)))
        inv = 1.0 / scale
    else:
        gtil = torch.from_numpy(np.array(gtil_f32.astype(jnp.bfloat16).astype(jnp.float32)))
        gtil = gtil.to(torch.bfloat16)
        inv = jnp.float32(1.0)
    xc = jnp.dot(x.astype(jnp.bfloat16), ctab.T, preferred_element_type=jnp.float32)
    init = jnp.argmax(jsearch.compute_logits(jp, jc, x), axis=-1).astype(jnp.int32)
    recon0 = jnp.take_along_axis(centers[None], init[:, :, None, None], axis=2)[:, :, 0, :].sum(1)
    ss0 = jnp.sum((recon0 - x) ** 2, axis=-1)
    gt = gtil.reshape(K, nc, CS).permute(1, 0, 2).contiguous()
    return tg3.Gramv3Problem(
        torch.from_numpy(np.array(x)), torch.from_numpy(np.array(xc * inv)),
        torch.from_numpy(np.array(init)), torch.from_numpy(np.array(ss0 * inv)), gt,
        M, R, passes, tbeam.pool_bits(pool_mask, nc, passes), g_dtype)


def _sse(centers, idx, x):
    nc = centers.shape[0]
    return float(((centers[np.arange(nc)[None], idx].sum(1) - x) ** 2).sum())


@pytest.mark.parametrize("g_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("nc,B,R,pool_mask", [
    (2, 64, 2, ((True, True), (True, False))),  # pool + R1, the JAX NumPy mirror's case
    (4, 128, 4, ((True,) * 4, (False,) * 4)),   # all-pool, then an all-R1 pass
])
def test_plain_on_jax_precomputes_equals_interpret(g_dtype, nc, B, R, pool_mask):
    arrays, x, jc, jp, _, _ = _both(nc, 128, 30 + nc, B)
    kw = dict(M=8, R=R, passes=2, pool_mask=pool_mask)
    want = np.asarray(jg3.gramv3_encode_indexes(
        jp, jc, jnp.asarray(x), g_dtype=g_dtype, block_b=64, interpret=True, **kw))
    problem = _jax_problem(jp, jc, x, g_dtype, **kw)
    before = tg3.GRAMV3_KERNEL.launches
    got = tg3.gramv3_plain(problem).numpy()
    assert tg3.GRAMV3_KERNEL.launches == before
    np.testing.assert_array_equal(got, want)
    init = problem.idx0.numpy()
    assert _sse(arrays["centers"], got, x) < _sse(arrays["centers"], init, x)


@pytest.mark.parametrize("g_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("pool_mask", [None, "altparity"])
def test_port_end_to_end_tracks_jax(g_dtype, pool_mask):
    arrays, x, jc, jp, tc, tp = _both(4, 128, 5, 128)
    kw = dict(M=8, R=4, passes=3, pool_mask=pool_mask, g_dtype=g_dtype)
    want = np.asarray(jg3.gramv3_encode_indexes(jp, jc, jnp.asarray(x), interpret=True,
                                                block_b=64, **kw))
    got = tg3.gramv3_encode_indexes(tp, tc, torch.from_numpy(x), **kw)
    assert got.dtype == torch.int32 and got.shape == (128, 4)
    got = got.numpy()
    assert (got == want).mean() >= 0.99
    e_got, e_want = _sse(arrays["centers"], got, x), _sse(arrays["centers"], want, x)
    assert abs(e_got / e_want - 1.0) <= 1e-4, (e_got, e_want)


def test_supported_gate_matches_jax_and_any_dim_works():
    for dim in (96, 128, 512):
        for cs in (16, 256):
            for nc in (1, 2, 4, 8, 16):
                jc = jcore.QuantizerConfig(dim=dim, codebook_size=cs, num_codebooks=nc)
                tc = tcore.QuantizerConfig(dim=dim, codebook_size=cs, num_codebooks=nc)
                # the JAX gate's, and 16 codebooks of 256 beside it (the card's
                # kernel takes them; the TPU's Gram table stops at 8)
                want = jg3.GRAMV3_SUPPORTED(jc) or (cs, nc) == (256, 16)
                assert tg3.GRAMV3_SUPPORTED(tc) == want, (dim, cs, nc)
    # dim 96 is no multiple of 128: seqbeam refuses it, gramv3 takes it
    arrays, x, jc, jp, tc, tp = _both(2, 96, 32, 64)
    assert not tseq.SEQBEAM_SUPPORTED(tc)
    kw = dict(M=8, R=2, passes=1)
    want = np.asarray(jg3.gramv3_encode_indexes(jp, jc, jnp.asarray(x), interpret=True,
                                                block_b=64, **kw))
    got = tg3.gramv3_encode_indexes(tp, tc, torch.from_numpy(x), **kw).numpy()
    assert (got == want).mean() >= 0.99
    init = tbeam.initial_indexes(tp, tc, torch.from_numpy(x)).numpy()
    assert _sse(arrays["centers"], got, x) <= _sse(arrays["centers"], init, x)


def test_loop_fori_refuses_a_mixed_schedule_and_bad_shapes_raise():
    arrays, x, jc, jp, tc, tp = _both(4, 128, 35, 64)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError):  # as the JAX wrapper (gramv3.py:715-720)
        jg3.gramv3_encode_indexes(jp, jc, jnp.asarray(x), loop="fori", pool_mask="altparity",
                                  M=8, R=2, passes=2, block_b=64, interpret=True)
    with pytest.raises(ValueError, match="fori"):
        tg3.gramv3_encode_indexes(tp, tc, xt, loop="fori", pool_mask="altparity", M=8, R=2,
                                  passes=2)
    # uniform schedules run under either loop, with equal results
    mask = ((True,) * 4, (False,) * 4)
    a = tg3.gramv3_encode_indexes(tp, tc, xt, loop="fori", pool_mask=mask, M=8, R=2, passes=2)
    b = tg3.gramv3_encode_indexes(tp, tc, xt, loop="unroll", pool_mask=mask, M=8, R=2, passes=2,
                                  block_b=512, interleave=2)
    assert torch.equal(a, b)
    for kw in (dict(M=12), dict(M=64, R=8), dict(g_dtype="fp8"), dict(passes=-1),
               dict(loop="scan"), dict(init_indexes=torch.full((64, 4), CS))):
        with pytest.raises(ValueError):
            tg3.gramv3_encode_indexes(tp, tc, xt, **kw)
    with pytest.raises(ValueError):  # 32 codebooks: past the kernel's 16
        tg3.gramv3_encode_indexes(
            tp, tcore.QuantizerConfig(dim=128, codebook_size=256, num_codebooks=32),
            torch.zeros(4, 128))
    with pytest.raises(ValueError, match="CUDA"):  # the kernel takes no CPU tensor
        tg3.gramv3_cuda(tg3.gramv3_problem(tp, tc, xt))
    # zero passes return the initial indexes, as the TPU kernel does
    init = torch.from_numpy(np.array(
        jsearch.compute_indexes(jp, jc, jnp.asarray(x), 0)))
    assert torch.equal(tg3.gramv3_encode_indexes(tp, tc, xt, passes=0), init.to(torch.int32))


@pytest.mark.parametrize("as_bytes", [True, False])
def test_codec_gramv3_branch_matches_jax(as_bytes):
    arrays, x, jc, jp, tc, tp = _both(2, 128, 36, 64)
    want = np.asarray(jcodec.encode(jp, jc, jnp.asarray(x), 2, as_bytes,
                                    search_method="gramv3", M=8, R=2, g_dtype="int8",
                                    interpret=True, block_b=64))
    got = tcodec.encode(tp, tc, torch.from_numpy(x), 2, as_bytes, search_method="gramv3",
                        M=8, R=2, g_dtype="int8", block_b=64).numpy()
    assert got.shape == want.shape and str(got.dtype) == str(want.dtype)
    assert (got == want).mean() >= 0.99
    q = tcodec.decode(tp, tc, torch.from_numpy(got))
    assert q.shape == x.shape


def test_stage_timed_build_refuses_cpu_tensors_and_other_beams():
    arrays, x, jc, jp, tc, tp = _both(4, 128, 37, 64)
    problem = tg3.gramv3_problem(tp, tc, torch.from_numpy(x), M=8, R=4)
    before = tg3.GRAMV3_TIMED_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        tg3.gramv3_stages(problem)
    with pytest.raises(ValueError, match="M=8"):  # built for the serving path's beam only
        tg3.gramv3_stages(tg3.gramv3_problem(tp, tc, torch.from_numpy(x), M=16, R=4))
    assert tg3.GRAMV3_TIMED_KERNEL.launches == before
    assert tg3.STAGES == ("root", "load", "score", "topr", "pool", "reorder", "pass_end")


@pytest.mark.parametrize("g_dtype", ["bf16", "int8"])
def test_cpu_precompute_is_the_f32_formulas(g_dtype):
    """On the CPU the precompute's parts are the f32 expressions of the JAX
    wrapper as the port has always written them (the card takes the tensor
    cores for XC and the Gram table, and a sparse product for ss0)."""
    arrays, x, jc, jp, tc, tp = _both(4, 128, 38, 96)
    xt = torch.from_numpy(x)
    problem = tg3.gramv3_problem(tp, tc, xt, g_dtype=g_dtype)
    nc, K = 4, 4 * CS
    centers = torch.from_numpy(arrays["centers"])
    ctab = centers.reshape(K, 128).to(torch.bfloat16).float()
    csq = (ctab * ctab).sum(dim=-1)
    blk = torch.arange(nc).repeat_interleave(CS)
    gtil = torch.where(blk[:, None] == blk[None, :], (csq / 2.0)[None, :], ctab @ ctab.t())
    xc = xt.to(torch.bfloat16).float() @ ctab.t()
    recon0 = centers[torch.arange(nc)[None, :], problem.idx0.long()].sum(dim=1)
    ss0 = ((recon0 - xt) ** 2).sum(dim=-1)
    if g_dtype == "int8":
        scale = gtil.abs().max() / 127.0
        gtil = torch.round(gtil / scale).to(torch.int8)
        xc, ss0 = xc * (1.0 / scale), ss0 * (1.0 / scale)
    else:
        gtil = gtil.to(torch.bfloat16)
    assert torch.equal(problem.xc, xc) and torch.equal(problem.ss0, ss0)
    assert torch.equal(problem.gt, gtil.reshape(K, nc, CS).permute(1, 0, 2))
    # the layout: gt[t, s*cs + i, j] = Gt[s*cs + i, t*cs + j]
    assert torch.equal(tg3.table_layout(gtil, nc)[2, 1 * CS + 5], gtil[1 * CS + 5, 2 * CS:3 * CS])
