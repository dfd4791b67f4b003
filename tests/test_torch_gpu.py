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
from probe_inputs import above_inf

Q256 = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "q256_4_full.npz"
Q512 = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "q512_8_full.npz"
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


def _seqbeam_case(cuda, seed, nc, dim, B, passes=2, **kw):
    """A seqbeam problem on trained-like codebooks, and the f32 centers."""
    rng = np.random.default_rng(seed)
    arrays = _trained_like(rng, nc, 256, dim)
    centers = arrays["centers"]
    x = (centers[np.arange(nc)[None], rng.integers(0, 256, (B, nc))].sum(1)
         + 2.0 * rng.standard_normal((B, dim))).astype(np.float32)
    problem = tseq.seqbeam_problem(
        params_from_numpy(arrays, device=cuda), QuantizerConfig(dim, 256, nc),
        torch.from_numpy(x).to(cuda), passes=passes, **kw)
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
def test_cuda_seqbeam_f32_training_search_shape_matches_plain(cuda):
    # the trainer's seqbeam search: v2 with f32 E, M=16, R=8, one pass, a
    # batch of 600 at d512 (19 blocks of 32 frames, the last ragged)
    problem, centers = _seqbeam_case(cuda, 12, 8, 512, 600, passes=1, M=16, R=8)
    assert problem.e_dtype == "f32" and tseq.seqbeam_layout(problem)["kind"] == "full"
    got = _launched_once(tseq.SEQBEAM_KERNEL, lambda: tseq.seqbeam_cuda(problem))
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


# the auto ladder's two rungs on the committed trained quantizers
AUTO_RUNGS = {"int8": (Q512, 3, dict(M=8, R=4, pool_mask="altparity", e_dtype="int8")),
              "bf16": (Q256, 2, dict(M=8, R=4, pool_mask="altparity", e_dtype="bf16"))}


def _auto_problem(cuda, e_dtype, B, **kw):
    path, passes, sem = AUTO_RUNGS[e_dtype]
    q = qtt.load_quantizer(path, device=cuda)
    x = make_mlp_sampler(q.dim, device=cuda)(torch.Generator().manual_seed(3), B)
    problem = tseq.seqbeam_problem(q.params, q.config, x, passes=passes, **dict(sem, **kw))
    return problem, q.get_centers().detach()


@pytest.mark.gpu
@pytest.mark.parametrize("e_dtype", ["int8", "bf16"])
@pytest.mark.parametrize("B", [1, 9, 32768 + 3])  # one frame, F + 1 (a second block), ragged
def test_cuda_seqbeam_auto_rungs_ragged(cuda, e_dtype, B):
    problem, centers = _auto_problem(cuda, e_dtype, B)
    got = tseq.seqbeam_cuda(problem)
    torch.cuda.synchronize()
    chk = against_plain(problem, centers, got)
    # int8 E: the steps' rescores are exact int32 sums, but the root's is a
    # bf16 product summed on the tensor cores, not in the plain matmul's
    # order, so a near tie at the fan-out may flip (6 of 262,168 indexes at
    # B=32,771 on the H100, with the wgmma root and with the earlier mma.sync
    # one alike: experiments/seqbeam_agreement.py); bf16 E: every rescore
    # sums on the tensor cores.  The bars of against_plain, and for int8 at
    # most one index in 10,000 apart
    assert chk["ok"] and (e_dtype == "bf16" or chk["index_agreement"] >= 0.9999), chk


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 16, 32, 64])
def test_cuda_seqbeam_int8_beam_widths(cuda, M):
    # F = 64 / M frames a block down to one; a ragged last block
    problem, centers = _seqbeam_case(cuda, 8, 8, 512, 301, M=M, R=4, e_dtype="int8",
                                     pool_mask="altparity")
    chk = against_plain(problem, centers, tseq.seqbeam_cuda(problem))
    assert chk["ok"], chk


@pytest.mark.gpu
@pytest.mark.parametrize("e_dtype,M,dim", [
    ("bf16", 64, 512), ("bf16", 32, 1024), ("int8", 64, 640), ("int8", 64, 1024)])
def test_cuda_seqbeam_compact_layout(cuda, e_dtype, M, dim):
    # wide beams at large D, where the ring and the staged codeword rows do
    # not fit beside E and X: the ring lies in X's space, loaded only while
    # its rescore runs, and the extensions read their rows from L2
    problem, centers = _seqbeam_case(cuda, 9, 8, dim, 301, M=M, R=4, e_dtype=e_dtype,
                                     pool_mask="altparity")
    chk = against_plain(problem, centers, tseq.seqbeam_cuda(problem))
    assert chk["ok"], chk


@pytest.mark.gpu
@pytest.mark.parametrize("impl,M,dim", [("v2", 32, 640), ("v1", 40, 512), ("v1", 24, 896)])
def test_cuda_seqbeam_f32_compact_layout(cuda, impl, M, dim):
    # f32-E beams whose staged codeword rows do not fit beside E and X: one
    # ring slot in X's space, the extensions' rows read from L2
    kw = dict(pool_mask="altparity") if impl == "v2" else {}
    problem, centers = _seqbeam_case(cuda, 9, 8, dim, 301, M=M, R=4, impl=impl, **kw)
    assert tseq.seqbeam_layout(problem)["kind"] == "compact"
    chk = against_plain(problem, centers, tseq.seqbeam_cuda(problem))
    assert chk["ok"], chk


# the beams no block fits beside E, X and a ring: their E leaves the block
# (bf16: E's reorder copy; f32: both E buffers, in a global scratch slot)
SPILL_BEAMS = [("v2", "bf16", 64, 640), ("v2", "bf16", 64, 1024), ("v2", "f32", 64, 512),
               ("v2", "f32", 64, 1024), ("v2", "f32", 32, 768), ("v1", "f32", 24, 1024),
               ("v1", "f32", 64, 384)]


@pytest.mark.gpu
@pytest.mark.parametrize("impl,e_dtype,M,dim,lazy", [
    *(b + (False,) for b in SPILL_BEAMS),
    ("v2", "bf16", 64, 640, True), ("v2", "f32", 64, 512, True)])  # lazy_r1's deferred delta
def test_cuda_seqbeam_spill_layout_matches_plain(cuda, impl, e_dtype, M, dim, lazy):
    kw = dict(pool_mask="altparity", lazy_r1=lazy) if impl == "v2" else {}
    problem, centers = _seqbeam_case(cuda, 9, 8, dim, 301, M=M, R=4, e_dtype=e_dtype,
                                     impl=impl, **kw)
    assert tseq.seqbeam_layout(problem)["kind"] == "spill"
    counter = tseq.SEQBEAM_V1_KERNEL if impl == "v1" else tseq.SEQBEAM_KERNEL
    got = _launched_once(counter, lambda: tseq.seqbeam_cuda(problem))
    chk = against_plain(problem, centers, got)
    assert chk["ok"], chk


# (e_dtype, M, dim, nc, R, lazy_r1) -> (frames a block, kind, shared-memory
# bytes) as before the spill layout: the ladder's rungs, the training
# search, v1's and phase 7's lazy configs; the f32 rows as f32 E's ring and
# staged rows made them (v1 at d512 and the training search: 175,984 bytes
# before; v1 at d256: 214,672)
LAYOUTS_BEFORE = {
    ("int8", 8, 512, 8, 4, False): (8, "full", 231344),
    ("int8", 8, 512, 8, 4, True): (8, "full", 231600),
    ("bf16", 8, 512, 8, 4, False): (4, "full", 186848),
    ("bf16", 8, 512, 8, 4, True): (4, "full", 186976),
    ("bf16", 16, 512, 8, 4, False): (2, "full", 178560),
    ("bf16", 8, 256, 4, 4, False): (8, "full", 220976),
    ("f32", 16, 512, 8, 8, False): (2, "full", 213888),
    ("f32", 16, 256, 4, 8, False): (4, "full", 220832),
}


@pytest.mark.gpu
@pytest.mark.parametrize("key", list(LAYOUTS_BEFORE))
def test_cuda_seqbeam_layout_unchanged(cuda, key):
    e_dtype, M, dim, nc, R, lazy = key
    kw = dict(lazy_r1=True, pool_mask="altparity") if lazy else {}
    problem, _ = _seqbeam_case(cuda, 9, nc, dim, 17, M=M, R=R, e_dtype=e_dtype, **kw)
    got = tseq.seqbeam_layout(problem)
    assert (got["frames"], got["kind"], got["smem_bytes"]) == LAYOUTS_BEFORE[key]
    assert got["spill_bytes"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("e_dtype", ["int8", "bf16"])
def test_cuda_seqbeam_stage_timed_build_same_indexes(cuda, e_dtype):
    problem, _ = _auto_problem(cuda, e_dtype, 1000)
    got, stages = tseq.seqbeam_stages(problem)
    assert torch.equal(got, tseq.seqbeam_cuda(problem))
    assert stages.shape[1] == len(tseq.STAGES) + 2
    assert bool((stages > 0).all())  # every stage ran in every block, and the clocks moved


@pytest.mark.gpu
@pytest.mark.parametrize("nc,dim", [(8, 512), (4, 256)])  # phase 7's two v1 widths
def test_cuda_seqbeam_v1_stage_timed_build_same_indexes(cuda, nc, dim):
    problem, _ = _seqbeam_case(cuda, 10, nc, dim, 1000, M=16, R=8, impl="v1")
    before = tseq.SEQBEAM_V1_KERNEL.launches
    got, stages = tseq.seqbeam_stages(problem)
    assert tseq.SEQBEAM_V1_KERNEL.launches == before  # the timed build has its own count
    assert torch.equal(got, tseq.seqbeam_cuda(problem))
    blocks = -(-1000 // tseq.seqbeam_layout(problem)["frames"])
    assert stages.shape == (blocks, len(tseq.STAGES) + 2)
    assert bool((stages > 0).all())  # every stage ran in every block, and the clocks moved


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



def _gramv3_case(cuda, nc, dim, B, seed=5, **kw):
    rng = np.random.default_rng(seed)
    cs = 256
    arrays = _trained_like(rng, nc, cs, dim)
    x = (arrays["centers"][np.arange(nc)[None], rng.integers(0, cs, (B, nc))].sum(1)
         + 2.0 * rng.standard_normal((B, dim))).astype(np.float32)
    return tg3.gramv3_problem(params_from_numpy(arrays, device=cuda), QuantizerConfig(dim, cs, nc),
                              torch.from_numpy(x).to(cuda), **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("g_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("nc,dim,M,R,pool_mask,passes", [  # every (nc, M) the kernel has
    (4, 128, 8, 4, None, 3), (8, 96, 16, 8, "altparity", 3), (2, 256, 64, 4, None, 3),
    (8, 512, 8, 4, "altparity", 5), (8, 128, 32, 8, None, 3), (8, 128, 64, 4, None, 2),
    (4, 128, 16, 4, "altparity", 3), (4, 96, 32, 8, None, 3), (4, 128, 64, 2, None, 2),
    (2, 128, 8, 4, None, 3), (2, 96, 16, 8, None, 3), (2, 128, 32, 8, "altparity", 3)])
def test_cuda_gramv3_equals_plain(cuda, g_dtype, nc, dim, M, R, pool_mask, passes):
    problem = _gramv3_case(cuda, nc, dim, 1001, M=M, R=R, passes=passes,  # a ragged last block
                           pool_mask=pool_mask, g_dtype=g_dtype)
    before = tg3.GRAMV3_KERNEL.launches
    got = tg3.gramv3_cuda(problem)
    torch.cuda.synchronize()
    assert tg3.GRAMV3_KERNEL.launches == before + 1
    # the same f32 (bf16 table) or int32 (int8 table) sums in the same order
    assert torch.equal(got, tg3.gramv3_plain(problem))


@pytest.mark.gpu
@pytest.mark.parametrize("g_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("nc,dim", [(8, 512), (4, 256)])  # phase 5's two widths
def test_cuda_gramv3_stage_timed_build_same_indexes(cuda, g_dtype, nc, dim):
    problem = _gramv3_case(cuda, nc, dim, 1000, M=8, R=4, passes=2, g_dtype=g_dtype)
    before, timed = tg3.GRAMV3_KERNEL.launches, tg3.GRAMV3_TIMED_KERNEL.launches
    got, stages = tg3.gramv3_stages(problem)
    assert tg3.GRAMV3_KERNEL.launches == before  # the timed build has its own count
    assert tg3.GRAMV3_TIMED_KERNEL.launches == timed + 1
    assert torch.equal(got, tg3.gramv3_cuda(problem))
    assert stages.shape == (1000 // tg3.FRAMES_PER_BLOCK, len(tg3.STAGES) + 2)
    assert bool((stages > 0).all())  # every stage ran in every block, and the clocks moved


@pytest.mark.gpu
@pytest.mark.parametrize("nc,dim", [(8, 512), (4, 256)])
def test_cuda_gramv3_precompute_on_tensor_cores(cuda, nc, dim):
    rng = np.random.default_rng(6)
    cs, B = 256, 4096
    arrays = _trained_like(rng, nc, cs, dim)
    ctab = torch.from_numpy(arrays["centers"].reshape(nc * cs, dim)).to(cuda).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((B, dim)).astype(np.float32)).to(cuda)
    xb = x.to(torch.bfloat16)
    # XC: the same exact products, summed in another order than the f32 product's
    got, want = tg3.cross_terms(x, ctab), xb.float() @ ctab.float().t()
    scale = xb.float().abs() @ ctab.float().abs().t()  # the sum of |terms|
    err = (got - want).abs()
    print(f"nc={nc} d{dim}: XC error / sum|terms| max {float((err / scale).max()):.3e} median "
          f"{float((err / scale).median()):.3e}; max|err| / max|XC| "
          f"{float(err.max() / want.abs().max()):.3e}; Frobenius "
          f"{float(err.norm() / want.norm()):.3e}")
    assert float((err / scale).max()) <= 1e-6
    # the bf16 Gram table: off its diagonal blocks (which hold csq / 2) the
    # card's f32 sums within the same reordering error of the f32
    # product's, the table their rounding, so the two tables differ only
    # where a bf16 rounding boundary lies between them
    gt, _ = tg3.gram_table(ctab, nc, "bf16")
    g32, g_tc = ctab.float() @ ctab.float().t(), tg3.bf16_product(ctab, ctab)
    gscale = ctab.float().abs() @ ctab.float().abs().t()
    csq = (ctab.float() ** 2).sum(-1)
    blk = torch.arange(nc, device=cuda).repeat_interleave(cs)
    diag = blk[:, None] == blk[None, :]
    assert float(((g_tc - g32).abs() / gscale)[~diag].max()) <= 1e-6
    assert torch.equal(gt, torch.where(diag, (csq / 2.0)[None, :], g_tc).to(torch.bfloat16))
    ref = torch.where(diag, (csq / 2.0)[None, :], g32).to(torch.bfloat16)
    print(f"nc={nc} d{dim}: {int((gt != ref).sum())} of {gt.numel()} bf16 Gram elements differ "
          "from the f32 product's table")
    # ss0 on the card (a sparse product) against the gather-sum, and the
    # precompute repeats itself exactly
    centers = torch.from_numpy(arrays["centers"]).to(cuda)
    idx0 = torch.randint(0, cs, (B, nc), generator=torch.Generator().manual_seed(1)).to(cuda)
    recon = centers[torch.arange(nc, device=cuda)[None, :], idx0].sum(1)
    want = ((recon - x) ** 2).sum(-1)
    got = tg3.root_scores(centers, idx0, x)
    assert float(((got - want).abs() / want).max()) <= 1e-5
    assert torch.equal(got, tg3.root_scores(centers, idx0, x))
    assert torch.equal(tg3.cross_terms(x, ctab), tg3.cross_terms(x, ctab))


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
@pytest.mark.parametrize("rows", [1024, 1001])
def test_cuda_minround_above_inf_vs_plain(cuda, rows):
    # a taken key counts as 1e30, so keys above it are taken only before
    # any other key of their row, and a round whose least key is 1e30 takes
    # nothing
    x = torch.from_numpy(above_inf(rows, 8)).to(cuda)
    for K in (1, 2, 5, 32, 96, 130):
        got = _launched_once(tprim.MINROUND_KERNEL, lambda: tprim.minround_cuda(x, K))
        assert torch.equal(got.view(torch.int32), tprim.minround_plain(x, K).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [65536, 1000])
@pytest.mark.parametrize("kind", ["zero", "random", "negative", "large"])
def test_cuda_gather_bit_exact_vs_plain(cuda, N, kind):
    x = _uniform(cuda, 2, 8, N)
    gen = torch.Generator().manual_seed(3)
    # large: idx + i wraps past 2**31 - 1 in int32
    idx = {"zero": torch.zeros(8, N, dtype=torch.int32),
           "random": torch.randint(0, 8, (8, N), generator=gen, dtype=torch.int32),
           "negative": torch.randint(-1000, 0, (8, N), generator=gen, dtype=torch.int32),
           "large": torch.randint(2**31 - 64, 2**31, (8, N), generator=gen,
                                  dtype=torch.int32)}[kind]
    idx = idx.to(cuda)
    # 1, 11 and 13 end in the unrolled loop's tail
    for K in (1, 11, 13, 16, 48):
        got = _launched_once(tprim.GATHER_KERNEL, lambda: tprim.gather_cuda(x, idx, K))
        assert torch.equal(got, tprim.gather_plain(x, idx, K))


@pytest.mark.gpu
def test_cuda_minround_floor_below_the_kernel(cuda):
    x = _uniform(cuda, 1, 1024, 128, low=1.0, high=2.0)
    got = _launched_once(tprim.REDUX_CHAIN_KERNEL, lambda: tprim.redux_chain_cuda(x, 5))
    assert torch.equal(got, tprim.row_least_key(x))
    floor = tprim.minround_floor_us(x)
    assert 0.0 < floor < tprim.slope_us(lambda K: tprim.minround_cuda(x, K), 32, 96)


@pytest.mark.gpu
def test_cuda_gather_floor_below_the_kernel(cuda):
    x = _uniform(cuda, 2, 8, 65536)
    idx = torch.zeros(8, 65536, dtype=torch.int32, device=cuda)
    got = _launched_once(tprim.GATHER_FLOOR_KERNEL, lambda: tprim.gather_floor_cuda(x, idx, 13))
    assert torch.equal(got, tprim.gather_floor_plain(x, idx, 13))
    floor = tprim.gather_floor_us(x, idx)
    assert 0.0 < floor < tprim.slope_us(lambda K: tprim.gather_cuda(x, idx, K), 16, 48)


@pytest.mark.gpu
# 256 and 400: fewer k-steps a warp, and dimensions past D in a warp's slice
@pytest.mark.parametrize("M,D", [(1024, 512), (1000, 512), (1024, 256), (1000, 400)])
def test_cuda_matmul_matches_plain(cuda, M, D):
    a = _uniform(cuda, 4, M, D)
    b = _uniform(cuda, 5, 256, D).to(torch.bfloat16)
    for K in (16, 48):
        got = _launched_once(tprim.MATMUL_KERNEL, lambda: tprim.matmul_cuda(a, b, K))
        # the same products in mma.sync order: within 1e-5 of the sum of |terms|
        assert tprim.matmul_close(got, tprim.matmul_plain(a, b, K), a, b, K)


@pytest.mark.gpu
@pytest.mark.parametrize("N,D", [(192, 512), (256, 520), (256, 8), (256, 640)])
def test_cuda_matmul_refuses_shapes_it_does_not_take(cuda, N, D):
    a = _uniform(cuda, 4, 64, D)
    b = _uniform(cuda, 5, N, D).to(torch.bfloat16)
    before = tprim.MATMUL_KERNEL.launches
    with pytest.raises(ValueError, match="matmul_cuda takes"):
        tprim.matmul_cuda(a, b, 2)
    assert tprim.MATMUL_KERNEL.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1024, 1000])
def test_cuda_matmul_stage_timed_build_same_output(cuda, M):
    a = _uniform(cuda, 4, M, 512)
    b = _uniform(cuda, 5, 256, 512).to(torch.bfloat16)
    for K in (16, 48):
        got, br = _launched_once(tprim.MATMUL_TIMED_KERNEL, lambda: tprim.matmul_stages(a, b, K))
        assert torch.equal(got, tprim.matmul_cuda(a, b, K))
        assert set(br["share"]) == set(tprim.MATMUL_STAGES)
        assert all(br["warp_cycles"][k] > 0 for k in ("load", "convert", "mma"))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1024, 1001])
def test_cuda_assembly_bit_exact_vs_plain(cuda, rows):
    x = _uniform(cuda, 6, rows, 256)
    for K in (32, 96):  # 96 overflows to +-inf
        got = _launched_once(tprim.ASSEMBLY_KERNEL, lambda: tprim.assembly_cuda(x, K))
        assert torch.equal(got, tprim.assembly_plain(x, K))


def _chain_inputs(cuda, MB, D=512, CS=256, c_scale=0.05):
    gen = torch.Generator().manual_seed(7)
    e = torch.randn(MB, D, generator=gen).to(cuda)
    return e, (torch.randn(CS, D, generator=gen) * c_scale).to(cuda)


# 1000: not a multiple of a block's rows; 2112: 132 blocks of 16 rows, 66
# pairs of 32; 320 and 64: groups of tiles past D or CS
CHAIN_SHAPES = [(2048, 512, 256), (1000, 512, 256), (2112, 512, 256), (2048, 256, 128),
                (1000, 320, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("MB,D,CS", CHAIN_SHAPES)
def test_cuda_bf16_chain_matches_plain(cuda, MB, D, CS):
    e, c = _chain_inputs(cuda, MB, D, CS)
    got = _launched_once(tprobe.BF16_CHAIN_KERNEL, lambda: tprobe.bf16_chain_cuda(e, c))
    chk = tprobe.bf16_chain_agreement(got, tprobe.bf16_chain_plain(e, c), e)
    assert chk["ok"], chk


@pytest.mark.gpu
@pytest.mark.parametrize("MB,D,CS", [(1000, 512, 256), (2048, 256, 128)])
def test_cuda_bf16_chain_one_step_on_tiny_elements(cuda, MB, D, CS):
    # a quarter of E's elements scaled by 1e-5, so that a step changes most
    # of them (where no f32 summation order but the plain one's own meets
    # the agreement bar): one step of the kernel within the bounds that
    # products within 4 ulps of their sums of |terms| allow
    rng = np.random.default_rng(50)
    e = rng.standard_normal((MB, D)).astype(np.float32)
    c = (rng.standard_normal((CS, D)) * 0.05).astype(np.float32)
    e = np.where(rng.random(e.shape) < 0.25, e * 1e-5, e).astype(np.float32)
    e, c = torch.from_numpy(e).to(cuda), torch.from_numpy(c).to(cuda)
    got = _launched_once(tprobe.BF16_CHAIN_KERNEL, lambda: tprobe.bf16_chain_cuda(e, c, 1))
    lo, hi = tprobe.bf16_step_bounds(e, c)
    assert bool(((got >= lo) & (got <= hi)).all())
    assert int((got != e.to(torch.bfloat16).float()).sum()) > 0.2 * e.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [0, 1, 24])
@pytest.mark.parametrize("MB,D,CS", CHAIN_SHAPES)
def test_cuda_int8_chain_bit_exact_vs_plain(cuda, MB, D, CS, steps):
    e, c = _chain_inputs(cuda, MB, D, CS)
    got = _launched_once(tprobe.INT8_CHAIN_KERNEL, lambda: tprobe.int8_chain_cuda(e, c, steps))
    assert torch.equal(got, tprobe.int8_chain_plain(e, c, steps))


@pytest.mark.gpu
@pytest.mark.parametrize("MB,D,CS", [(2048, 512, 256), (1000, 320, 64)])
def test_cuda_int8_chain_saturates_c8_as_plain(cuda, MB, D, CS):
    # c = 0.5 N(0, 1): c * 127 leaves int8's range, and the prologue
    # saturates c8 as the plain version (and JAX) do
    e, c = _chain_inputs(cuda, MB, D, CS, c_scale=0.5)
    assert int(((c * 127.0).round().abs() > 127).sum()) > 100
    got = _launched_once(tprobe.INT8_CHAIN_KERNEL, lambda: tprobe.int8_chain_cuda(e, c))
    assert torch.equal(got, tprobe.int8_chain_plain(e, c))


@pytest.mark.gpu
@pytest.mark.parametrize("MB,D,CS", [(2048, 512, 256), (1000, 320, 64)])
def test_cuda_int8_chain_stage_timed_build_same_output(cuda, MB, D, CS):
    e, c = _chain_inputs(cuda, MB, D, CS)
    got, stages = _launched_once(tprobe.INT8_CHAIN_TIMED_KERNEL,
                                 lambda: tprobe.int8_chain_stages(e, c))
    assert torch.equal(got, tprobe.int8_chain_cuda(e, c))
    assert stages.shape == (-(-MB // 16), len(tprobe.INT8_STAGES) + 2)
    assert bool((stages > 0).all())
    # the barrier floor's maxima: the largest block index plus the step
    floor = _launched_once(tprobe.INT8_BARRIER_KERNEL,
                           lambda: tprobe.int8_barrier_floor(MB, cuda))
    assert torch.equal(floor.cpu(), torch.arange(24, dtype=torch.float32) + stages.shape[0] - 1)


@pytest.mark.gpu
def test_cuda_int8_chain_refuses_graph_capture(cuda):
    # its barrier tags come from the host at each launch, so a graph replay
    # would meet its own old tags: capture raises before anything is recorded
    e, c = _chain_inputs(cuda, 64, 512, 256)
    before = tprobe.INT8_CHAIN_KERNEL.launches
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            tprobe.int8_chain_cuda(e, c, 2)
    assert tprobe.INT8_CHAIN_KERNEL.launches == before
    assert torch.equal(tprobe.int8_chain_cuda(e, c, 2), tprobe.int8_chain_plain(e, c, 2))


@pytest.mark.gpu
def test_cuda_int8_chain_refuses_a_grid_the_card_cannot_hold(cuda):
    # one block of 16 rows an SM: one block more than the card holds fails
    # the cooperative launch and raises; the card is left usable
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    e, c = _chain_inputs(cuda, 16 * (sms + 1), 512, 256)
    with pytest.raises(RuntimeError, match="qtt_int8_chain_launch failed"):
        tprobe.int8_chain_cuda(e, c, 2)
    e, c = _chain_inputs(cuda, 16 * sms, 512, 256)
    assert torch.equal(tprobe.int8_chain_cuda(e, c, 2), tprobe.int8_chain_plain(e, c, 2))
