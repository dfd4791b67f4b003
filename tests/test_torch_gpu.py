"""The port's CUDA kernels on a card, each held against its plain PyTorch
version on the same inputs, the main path through them, and trainer steps
on the card.

These tests need a CUDA card and skip without one.  The file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""

import pathlib

import numpy as np
import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu_torch.core import QuantizerConfig
from quantization_tpu_torch.data.synthetic import make_mlp_sampler
from quantization_tpu_torch.experiments import int8_mxu_probe as tprobe
from quantization_tpu_torch.experiments import prim_bench as tprim
from quantization_tpu_torch.ops import decode as tdecode
from quantization_tpu_torch.ops import gramv3 as tg3
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.ops.quality_guard import against_plain
from quantization_tpu_torch.utils.torch_interop import params_from_numpy

Q256 = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "q256_4_full.npz"
BAR = 1.012  # vs beam-5, as tests/test_kernel_quality.py


def _trained_like(rng, nc, cs, dim):
    """Parameters whose prediction weights point near the codewords."""
    centers = (rng.standard_normal((nc, cs, dim)) * 0.5).astype(np.float32)
    return {
        "centers": centers,
        "to_logits_w": (centers.reshape(nc * cs, dim)
                        + 0.5 * rng.standard_normal((nc * cs, dim))).astype(np.float32),
        "to_logits_b": np.zeros(nc * cs, np.float32),
        "logits_scale": np.float32(0.0), "centers_scale": np.float32(0.0),
    }


@pytest.fixture
def cuda():
    """The card; without one the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nc,dim", [(8, 512), (4, 256)])  # the two trained quantizers
def test_cuda_decode_bit_exact_vs_plain(cuda, nc, dim):
    cb = torch.randn(nc, 256, dim, generator=torch.Generator().manual_seed(0))
    cb = cb.to(torch.bfloat16).to(cuda)
    idx = torch.randint(0, 256, (4099, nc), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    before = tdecode.DECODE_KERNEL.launches
    got = tdecode.decode_cuda(idx, cb)
    torch.cuda.synchronize()
    assert tdecode.DECODE_KERNEL.launches == before + 1
    assert torch.equal(got, tdecode.decode_plain(idx, cb))  # bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("e_dtype", ["f32", "bf16", "int8"])
def test_cuda_seqbeam_matches_plain(cuda, e_dtype):
    rng = np.random.default_rng(4)
    nc, cs, dim, B = 4, 256, 128, 512
    arrays = _trained_like(rng, nc, cs, dim)
    centers = arrays["centers"]
    x = (centers[np.arange(nc)[None], rng.integers(0, cs, (B, nc))].sum(1)
         + 2.0 * rng.standard_normal((B, dim))).astype(np.float32)
    problem = tseq.seqbeam_problem(
        params_from_numpy(arrays, device=cuda), QuantizerConfig(dim, cs, nc),
        torch.from_numpy(x).to(cuda), M=8, R=4, passes=2, pool_mask="altparity",
        e_dtype=e_dtype)
    before = tseq.SEQBEAM_KERNEL.launches
    got = tseq.seqbeam_cuda(problem)
    torch.cuda.synchronize()
    assert tseq.SEQBEAM_KERNEL.launches == before + 1
    # the bf16 root error and rescores are f32 sums in another order than
    # the plain version's matmul, so a near tie may flip: the bars of
    # against_plain (>= 99.5% of indexes equal, squared error within 0.1%)
    chk = against_plain(problem, torch.from_numpy(centers).to(cuda), got)
    assert chk["ok"], chk


def _seqbeam_case(cuda, seed, nc, dim, B, **kw):
    """A seqbeam problem on trained-like codebooks, and the f32 centers."""
    rng = np.random.default_rng(seed)
    arrays = _trained_like(rng, nc, 256, dim)
    centers = arrays["centers"]
    x = (centers[np.arange(nc)[None], rng.integers(0, 256, (B, nc))].sum(1)
         + 2.0 * rng.standard_normal((B, dim))).astype(np.float32)
    problem = tseq.seqbeam_problem(
        params_from_numpy(arrays, device=cuda), QuantizerConfig(dim, 256, nc),
        torch.from_numpy(x).to(cuda), passes=2, **kw)
    return problem, torch.from_numpy(centers).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("M,R,dim", [(16, 8, 128), (24, 4, 256), (40, 4, 128), (64, 4, 128)])
def test_cuda_seqbeam_v1_matches_plain(cuda, M, R, dim):
    # v1 has its own entry point and count; M=24 and 40 leave a partial
    # 16-row tile, B=257 a ragged last block
    problem, centers = _seqbeam_case(cuda, 6, 4, dim, 257, M=M, R=R, impl="v1")
    v1, v2 = tseq.SEQBEAM_V1_KERNEL.launches, tseq.SEQBEAM_KERNEL.launches
    got = tseq.seqbeam_cuda(problem)
    torch.cuda.synchronize()
    assert tseq.SEQBEAM_V1_KERNEL.launches == v1 + 1 and tseq.SEQBEAM_KERNEL.launches == v2
    # f32 E: the bf16 rescores sum in mma.sync order on the card, in the
    # plain matmul's order in the plain version; the bars of against_plain
    chk = against_plain(problem, centers, got)
    assert chk["ok"], chk


@pytest.mark.gpu
@pytest.mark.parametrize("nc,dim,kw", [
    (4, 256, dict(e_dtype="int8", requant="pass")),
    (4, 256, dict(e_dtype="int8", requant="bound", pool_mask="altparity")),
    (8, 128, dict(e_dtype="int8", lazy_r1=True, pool_mask="altparity")),
    (8, 128, dict(e_dtype="f32", lazy_r1=True, pool_mask="altparity")),
    (4, 256, dict(e_dtype="bf16", lazy_r1=True,
                  pool_mask=((True, False, True, True), (True, True, False, True)))),
])
def test_cuda_seqbeam_b3_matches_plain(cuda, nc, dim, kw):
    problem, centers = _seqbeam_case(cuda, 7, nc, dim, 513, M=8, R=4, **kw)
    before = tseq.SEQBEAM_KERNEL.launches
    got = tseq.seqbeam_cuda(problem)
    torch.cuda.synchronize()
    assert tseq.SEQBEAM_KERNEL.launches == before + 1
    chk = against_plain(problem, centers, got)
    assert chk["ok"], chk


@pytest.mark.gpu
def test_main_path_on_card_launches_both_kernels(cuda):
    q = qtt.load_quantizer(Q256, device=cuda)
    x = make_mlp_sampler(256, device=cuda)(torch.Generator().manual_seed(7), 2048)
    k2, k1 = tseq.SEQBEAM_KERNEL.launches, tdecode.DECODE_KERNEL.launches
    codes = q.encode(x)  # search_method="auto"
    recon = q.decode(codes, use_kernel=True)
    torch.cuda.synchronize()
    assert tseq.SEQBEAM_KERNEL.launches == k2 + 1
    assert tdecode.DECODE_KERNEL.launches == k1 + 1
    beam5 = float(((q.decode(q.encode(x, search_method="beam")) - x) ** 2).sum())
    assert float(((recon - x) ** 2).sum()) <= beam5 * BAR



@pytest.mark.gpu
@pytest.mark.parametrize("g_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("nc,dim,M,R,pool_mask", [
    (4, 128, 8, 4, None), (8, 96, 16, 8, "altparity"), (2, 256, 64, 4, None)])
def test_cuda_gramv3_equals_plain(cuda, g_dtype, nc, dim, M, R, pool_mask):
    rng = np.random.default_rng(5)
    cs, B = 256, 1001  # a ragged last block
    arrays = _trained_like(rng, nc, cs, dim)
    x = (arrays["centers"][np.arange(nc)[None], rng.integers(0, cs, (B, nc))].sum(1)
         + 2.0 * rng.standard_normal((B, dim))).astype(np.float32)
    problem = tg3.gramv3_problem(
        params_from_numpy(arrays, device=cuda), QuantizerConfig(dim, cs, nc),
        torch.from_numpy(x).to(cuda), M=M, R=R, passes=3, pool_mask=pool_mask, g_dtype=g_dtype)
    before = tg3.GRAMV3_KERNEL.launches
    got = tg3.gramv3_cuda(problem)
    torch.cuda.synchronize()
    assert tg3.GRAMV3_KERNEL.launches == before + 1
    # the same f32 (bf16 table) or int32 (int8 table) sums in the same order
    assert torch.equal(got, tg3.gramv3_plain(problem))


@pytest.mark.gpu
@pytest.mark.parametrize("train_search,kernel", [("gramv3", "gramv3"), ("seqbeam", "seqbeam")])
def test_trainer_steps_on_card_launch_the_kernel(cuda, train_search, kernel):
    counter = tg3.GRAMV3_KERNEL if kernel == "gramv3" else tseq.SEQBEAM_KERNEL
    t = qtt.QuantizerTrainer(256, 2, device=cuda, phase_one_iters=2, phase_two_iters=3, seed=0,
                             diagnostics=False, train_search=train_search, beam_finetune_iters=0)
    xs = make_mlp_sampler(256, device=cuda)(torch.Generator().manual_seed(1), 6 * 256)
    before = counter.launches
    losses = t.step_many(xs.reshape(6, 256, 256))
    torch.cuda.synchronize()
    assert t.done() and (t.config.codebook_size, t.config.num_codebooks) == (256, 2)
    assert counter.launches - before == 3  # one search per phase-2 step
    assert all(bool(torch.isfinite(v).all()) for step in losses for v in step)


def _uniform(cuda, seed, *shape, low=0.0, high=1.0):
    u = torch.rand(*shape, generator=torch.Generator().manual_seed(seed))
    return (u * (high - low) + low).to(cuda)


def _launched_once(counter, fn):
    before = counter.launches
    out = fn()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    return out


# the primitive probes at the JAX scripts' shapes, and at a ragged shape each
@pytest.mark.gpu
@pytest.mark.parametrize("rows,low", [(1024, 1.0), (1001, 1.0), (1001, -0.5)])
def test_cuda_minround_bit_exact_vs_plain(cuda, rows, low):
    # [-0.5, 2) gives keys of the lane alone (denormal floats): unsigned
    # order on both sides
    x = _uniform(cuda, 1, rows, 128, low=low, high=2.0)
    for K in (32, 96, 130):
        got = _launched_once(tprim.MINROUND_KERNEL, lambda: tprim.minround_cuda(x, K))
        assert torch.equal(got.view(torch.int32), tprim.minround_plain(x, K).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [65536, 1000])
@pytest.mark.parametrize("kind", ["zero", "random", "negative"])
def test_cuda_gather_bit_exact_vs_plain(cuda, N, kind):
    x = _uniform(cuda, 2, 8, N)
    gen = torch.Generator().manual_seed(3)
    idx = {"zero": torch.zeros(8, N, dtype=torch.int32),
           "random": torch.randint(0, 8, (8, N), generator=gen, dtype=torch.int32),
           "negative": torch.randint(-1000, 0, (8, N), generator=gen, dtype=torch.int32)}[kind]
    idx = idx.to(cuda)
    for K in (16, 48):
        got = _launched_once(tprim.GATHER_KERNEL, lambda: tprim.gather_cuda(x, idx, K))
        assert torch.equal(got, tprim.gather_plain(x, idx, K))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1024, 1000])
def test_cuda_matmul_matches_plain(cuda, M):
    a = _uniform(cuda, 4, M, 512)
    b = _uniform(cuda, 5, 256, 512).to(torch.bfloat16)
    for K in (16, 48):
        got = _launched_once(tprim.MATMUL_KERNEL, lambda: tprim.matmul_cuda(a, b, K))
        # the same products in mma.sync order: within 1e-5 of the sum of |terms|
        assert tprim.matmul_close(got, tprim.matmul_plain(a, b, K), a, b, K)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1024, 1001])
def test_cuda_assembly_bit_exact_vs_plain(cuda, rows):
    x = _uniform(cuda, 6, rows, 256)
    for K in (32, 96):  # 96 overflows to +-inf
        got = _launched_once(tprim.ASSEMBLY_KERNEL, lambda: tprim.assembly_cuda(x, K))
        assert torch.equal(got, tprim.assembly_plain(x, K))


def _chain_inputs(cuda, MB):
    gen = torch.Generator().manual_seed(7)
    e = torch.randn(MB, 512, generator=gen).to(cuda)
    return e, (torch.randn(256, 512, generator=gen) * 0.05).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("MB", [2048, 1000])  # 1000: not a multiple of the 16-row block
def test_cuda_bf16_chain_matches_plain(cuda, MB):
    e, c = _chain_inputs(cuda, MB)
    got = _launched_once(tprobe.BF16_CHAIN_KERNEL, lambda: tprobe.bf16_chain_cuda(e, c))
    chk = tprobe.bf16_chain_agreement(got, tprobe.bf16_chain_plain(e, c), e)
    assert chk["ok"], chk


@pytest.mark.gpu
@pytest.mark.parametrize("MB", [2048, 1000])
def test_cuda_int8_chain_bit_exact_vs_plain(cuda, MB):
    e, c = _chain_inputs(cuda, MB)
    got = _launched_once(tprobe.INT8_CHAIN_KERNEL, lambda: tprobe.int8_chain_cuda(e, c))
    assert torch.equal(got, tprobe.int8_chain_plain(e, c))
