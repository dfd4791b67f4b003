"""The slice end to end: the port's ``Quantizer`` on the committed trained
dim=256 / 4 B quantizer, held against the JAX package on frames sampled by
the JAX package's own key-42 MLP sampler (the distribution the quantizer
was trained on).

On the CPU, ``search_method="auto"`` is the exact pair-tree beam in both
packages, so the byte codes must agree; the seqbeam config that auto runs on
a card is held to the 1.012 x beam-5 bar of ``tests/test_kernel_quality.py``
through its plain version.
"""

import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu.core import codec as jcodec
from quantization_tpu.data.synthetic import make_mlp_sampler as jax_mlp_sampler
from quantization_tpu.ops import seqbeam as jseq
from quantization_tpu.ops.decode import decode_kernel as jax_decode_kernel
from quantization_tpu.utils.serialization import load_quantizer as jax_load
from quantization_tpu_torch.core import codec as tcodec
from quantization_tpu_torch.data import synthetic as tsynth
from quantization_tpu_torch.ops import decode as tdecode
from quantization_tpu_torch.ops import gramv3 as tg3
from quantization_tpu_torch.ops import ladder as tladder
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.ops import verify as tverify

ROOT = pathlib.Path(__file__).resolve().parents[1]
Q256 = ROOT / "experiments" / "q256_4_full.npz"
N_FRAMES = 512
BAR = 1.012  # vs beam-5, as tests/test_kernel_quality.py
HL_D256 = dict(M=8, R=4, pool_mask="altparity", e_dtype="bf16", reorder="select")


@pytest.fixture(scope="module")
def trained():
    jq = jax_load(Q256)
    tq = qtt.load_quantizer(Q256, device="cpu")
    x = np.asarray(jax_mlp_sampler(256, jax.random.PRNGKey(42))(jax.random.PRNGKey(7), N_FRAMES))
    return jq, tq, x


def _sse(tq, codes, x):
    recon = tq.decode(codes)
    return float(((recon - torch.from_numpy(x)) ** 2).sum())


def test_auto_encode_equals_jax_on_cpu(trained):
    jq, tq, x = trained
    want = np.asarray(jq.encode(jnp.asarray(x)))  # auto -> beam-5 off the TPU
    before = tseq.SEQBEAM_KERNEL.launches
    got = tq.encode(torch.from_numpy(x))  # auto -> beam-5 on a CPU tensor
    assert tseq.SEQBEAM_KERNEL.launches == before
    assert got.dtype == torch.uint8 and got.shape == (N_FRAMES, 4)
    # the same search on the same f32 inputs; the f32 sums run in another
    # order, so a near tie may flip a frame (observed: every frame equal)
    same = (got.numpy() == want).all(axis=1)
    assert same.mean() >= 0.99
    if not same.all():
        np.testing.assert_allclose(
            _sse(tq, got[torch.from_numpy(~same)], x[~same]),
            _sse(tq, torch.from_numpy(want[~same]), x[~same]), rtol=1e-3)
    # unpacked indexes and the decode of the JAX codes
    idx = tq.encode(torch.from_numpy(x), as_bytes=False)
    assert idx.dtype == torch.int32
    assert torch.equal(tcodec.pack_indexes(idx, 256), got)
    np.testing.assert_allclose(
        tq.decode(torch.from_numpy(want)).numpy(), np.asarray(jq.decode(jnp.asarray(want))),
        rtol=1e-6, atol=1e-6)  # f32 sums of 4 rows, another order


def test_seqbeam_auto_config_within_bar(trained):
    # the d256 config that auto runs on a card, through its plain version
    jq, tq, x = trained
    xt = torch.from_numpy(x)
    beam5 = _sse(tq, tq.encode(xt, search_method="beam"), x)
    codes = tq.encode(xt, refine_indexes_iters=2, search_method="seqbeam", **HL_D256)
    kernel = _sse(tq, codes, x)
    assert kernel <= beam5 * BAR, (kernel / beam5, kernel, beam5)
    # and the same codes as the JAX kernel in interpret mode on a slice of
    # the frames (observed: every index equal)
    n = 128
    want = np.asarray(jseq.seqbeam_encode_indexes(
        jq.params, jq.config, jnp.asarray(x[:n]), passes=2,
        interpret=True, **HL_D256))
    got = tcodec.unpack_indexes(codes[:n], 256, 4).numpy()
    assert (got == want).mean() >= 0.99


def test_cd_warm_start_and_cd_match_quality(trained):
    jq, tq, x = trained
    xt = torch.from_numpy(x)
    beam5 = _sse(tq, tq.encode(xt, search_method="beam"), x)
    warm = _sse(tq, tq.encode(xt, refine_indexes_iters=2, search_method="cd2+seqbeam",
                              **HL_D256), x)
    assert warm <= beam5 * BAR, warm / beam5
    cd = tq.encode(xt, refine_indexes_iters=2, search_method="cd")
    want = np.asarray(jcodec.encode(jq.params, jq.config, jnp.asarray(x), 2,
                                    search_method="cd"))
    assert (cd.numpy() == want).all(axis=1).mean() >= 0.99
    with pytest.raises(ValueError, match="seqbeam"):
        tq.encode(xt, M=16)  # kernel kwargs with auto on the CPU


def test_decode_kernel_path_matches_jax(trained):
    jq, tq, x = trained
    codes = tq.encode(torch.from_numpy(x[:256]))
    want = np.asarray(jax_decode_kernel(jq.params, jq.config, jnp.asarray(codes.numpy()),
                                        interpret=True))
    before = tdecode.DECODE_KERNEL.launches
    got = tq.decode(codes, use_kernel=True)
    assert tdecode.DECODE_KERNEL.launches == before  # plain version on the CPU
    np.testing.assert_array_equal(got.numpy(), want)  # bit for bit
    # bf16 codebooks vs the f32 gather: each of the 4 rows rounds by at
    # most 2**-9 of the largest codeword entry
    bound = 4 * 2.0 ** -9 * float(tq.get_centers().detach().abs().max())
    np.testing.assert_allclose(got.numpy(), tq.decode(codes).numpy(), rtol=0, atol=bound)


def test_quantizer_surface_matches_jax(trained):
    jq, tq, _ = trained
    assert (tq.dim, tq.codebook_size, tq.num_codebooks) == (256, 256, 4)
    assert tq.get_id() == jq.get_id()
    assert tq.config.bytes_per_frame == jq.config.bytes_per_frame == 4
    np.testing.assert_allclose(tq.get_centers().detach().numpy(), np.asarray(jq.get_centers()),
                               rtol=1e-6)
    np.testing.assert_allclose(tq.get_data_mean().numpy(), np.asarray(jq.get_data_mean()),
                               rtol=1e-5, atol=1e-6)
    assert tq.show_init_invocation() == jq.show_init_invocation().replace(
        "quantization_tpu.", "quantization_tpu_torch.")


def _gate(monkeypatch, verified, quality):
    tables = {tverify.VERIFIED: {"results": verified}, tverify.QUALITY: quality}
    monkeypatch.setattr(tverify, "_read", lambda path: tables[path])


def test_auto_ladder_and_gate(monkeypatch):
    d512 = qtt.core.QuantizerConfig(dim=512, codebook_size=256, num_codebooks=8)
    d256 = qtt.core.QuantizerConfig(dim=256, codebook_size=256, num_codebooks=4)
    on_card = types.SimpleNamespace(is_cuda=True, shape=(8192, 512))  # a bulk call's frames
    ok = {"ok": True}
    gram = tladder.LADDERS[(512, 8)][0].name
    names = (gram, "seqbeam_int8e_d512", "seqbeam_hl_d512", "seqbeam_m16_d512",
             "seqbeam_hl_d256")
    quality = {"train_ratio_vs_torch": 1.000109,
               "results": {n: {"max_delta_pct": 0.9} for n in names}}
    _gate(monkeypatch, {n: ok for n in names}, quality)
    # the Gram-table rung first: M=8, R=4, altparity, as the seqbeam rung it displaces
    name, passes, kw = tcodec.auto_choice(d512, on_card, 5)
    assert (name, kw["M"], kw["R"], kw["pool_mask"]) == (gram, 8, 4, "altparity")
    first = tladder.rungs(d512)[0]
    assert (first.name, first.kernel, first.needs_quality) == (gram, tg3.GRAMV3, True)
    # below the frames it pays off at, the K2 rung beside it, with as many passes
    least = first.min_frames
    for frames, want in ((1, "seqbeam_int8e_d512"), (least - 1, "seqbeam_int8e_d512"),
                         (least, gram)):
        got = tcodec.auto_choice(d512, types.SimpleNamespace(is_cuda=True, shape=(frames, 512)), 5)
        assert got[:2] == (want, passes), frames
    assert tcodec.auto_choice(d256, on_card, 5)[:2] == ("seqbeam_hl_d256", 2)
    # off the card, or with fewer than 3 iterations: the exact beam
    assert tcodec.auto_choice(d512, types.SimpleNamespace(is_cuda=False, shape=(8192, 512)),
                              5) is None
    assert tcodec.auto_choice(d512, on_card, 2) is None
    # a margin past 1% demotes the Gram-table rung to K2's int8 rung
    quality["results"][gram]["max_delta_pct"] = 0.995
    name, passes, kw = tcodec.auto_choice(d512, on_card, 5)
    assert (name, passes, kw["e_dtype"], kw["M"]) == ("seqbeam_int8e_d512", 3, "int8", 8)
    # needs_quality: without its row the Gram-table rung is passed over,
    # even with a smoke entry
    del quality["results"][gram]
    assert tcodec.auto_choice(d512, on_card, 5)[0] == "seqbeam_int8e_d512"
    quality["results"]["seqbeam_int8e_d512"]["max_delta_pct"] = 0.995
    assert tcodec.auto_choice(d512, on_card, 5)[0] == "seqbeam_hl_d512"
    del quality["results"]["seqbeam_int8e_d512"]
    del quality["results"]["seqbeam_hl_d512"]
    assert tcodec.auto_choice(d512, on_card, 5)[0] == "seqbeam_hl_d512"  # unmeasured: allowed
    # no smoke entry, no kernel
    _gate(monkeypatch, {"seqbeam_m16_d512": {"ok": False}}, quality)
    assert tcodec.auto_choice(d512, on_card, 5) is None


# auto's choice on the card with the committed gate tables, recorded from the
# ladder's output before it became one table of rung records, so that the
# table is held to the choices it replaced: (passes, kwargs) of each rung...
PINNED_RUNGS = {
    "gramv3_bf16_alt3_d512": (3, {"M": 8, "R": 4, "pool_mask": "altparity", "g_dtype": "bf16"}),
    "gramv3_bf16_alt3_d1280": (3, {"M": 8, "R": 4, "pool_mask": "altparity", "g_dtype": "bf16"}),
    "seqbeam_int8e_d512": (3, {"M": 8, "R": 4, "pool_mask": "altparity", "block_b": 512,
                               "interleave": 2, "reorder": "select", "e_dtype": "int8",
                               "zip_skew": 1}),
    "seqbeam_int8e_d1280": (3, {"M": 8, "R": 4, "pool_mask": "altparity", "block_b": 512,
                                "interleave": 2, "reorder": "select", "e_dtype": "int8",
                                "zip_skew": 1}),
    "seqbeam_hl_d256": (2, {"M": 8, "R": 4, "pool_mask": "altparity", "block_b": 256,
                            "interleave": 2, "reorder": "select", "e_dtype": "bf16"}),
}
PINNED_FRAMES = (1, 767, 768, 1535, 1536, 8192)
# ...and its name at each of PINNED_FRAMES with 5 refinement iterations (with
# 2, None everywhere), by (dim, num_codebooks)
_I8, _G3 = "seqbeam_int8e_d512", "gramv3_bf16_alt3_d512"
PINNED_AUTO = {
    (128, 2): (_I8,) * 6,
    (256, 4): ("seqbeam_hl_d256",) * 6,
    (256, 8): (_I8,) * 6,
    (512, 8): (_I8,) * 4 + (_G3,) * 2,
    (512, 16): (_I8,) * 6,
    (1024, 16): (_I8,) * 6,
    (1152, 8): (None,) * 6,
    (1280, 4): (None,) * 6,
    (1280, 8): ("seqbeam_int8e_d1280",) * 2 + ("gramv3_bf16_alt3_d1280",) * 4,
}


@pytest.mark.parametrize("iters", [2, 5])
@pytest.mark.parametrize("frames", PINNED_FRAMES)
@pytest.mark.parametrize("dim,nc", list(PINNED_AUTO))
def test_auto_choice_is_pinned_over_configs_and_call_sizes(dim, nc, frames, iters):
    config = qtt.core.QuantizerConfig(dim=dim, codebook_size=256, num_codebooks=nc)
    x = types.SimpleNamespace(is_cuda=True, shape=(frames, dim))
    name = PINNED_AUTO[(dim, nc)][PINNED_FRAMES.index(frames)] if iters >= 3 else None
    want = None if name is None else (name, *PINNED_RUNGS[name])
    assert tcodec.auto_choice(config, x, iters) == want


@pytest.mark.parametrize("as_bytes", [True, False])
def test_auto_routes_a_gramv3_rung_to_the_gram_table_kernel(monkeypatch, as_bytes):
    """encode(auto) on a rung of the Gram-table kernel runs
    gramv3_encode_indexes with the rung's passes and kwargs (on the CPU, its
    plain version) and names the rung on the codec.choose span."""
    from quantization_tpu_torch.utils import spans

    config = qtt.core.QuantizerConfig(dim=128, codebook_size=256, num_codebooks=4)
    q = qtt.Quantizer(128, 256, 4, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(24, 128, generator=torch.Generator().manual_seed(1))
    rung = tladder.Rung("gramv3_int8_pool3_d128", tg3.GRAMV3, 3,
                        dict(M=8, R=4, pool_mask=None, g_dtype="int8"))
    monkeypatch.setattr(tladder, "pick", lambda c, xx, iters: rung)
    seen = []
    real = tg3.gramv3_encode_indexes

    def recording(params, cfg, xx, **kw):
        seen.append(kw)
        return real(params, cfg, xx, **kw)

    monkeypatch.setattr(tg3, "gramv3_encode_indexes", recording)
    plain = tg3.GRAMV3_KERNEL.launches
    spans.start()
    got = tcodec.encode(q.params, config, x, as_bytes=as_bytes, search_method="auto")
    records = spans.stop()
    assert seen == [dict(passes=3, M=8, R=4, pool_mask=None, g_dtype="int8")]
    assert tg3.GRAMV3_KERNEL.launches == plain  # the CPU runs the plain version
    want = real(q.params, config, x, passes=3, M=8, R=4, g_dtype="int8")
    if as_bytes:
        want = tcodec.pack_indexes(want, 256)
    assert torch.equal(got, want)
    assert [r.attrs for r in records if r.name == "codec.choose"] == [{"rung": rung.name}]


def test_committed_gate_tables_hold_card_runs():
    # the port's tables are written on a card by ops/quality_guard.py
    import json

    for path in (tverify.VERIFIED, tverify.QUALITY):
        table = json.loads(path.read_text())
        assert table["device"]["platform"] == "gpu" and "H100" in table["device"]["kind"]
        assert "W" in table["device"]["nvidia_smi"]
    quality = json.loads(tverify.QUALITY.read_text())["results"]
    smoke = json.loads(tverify.VERIFIED.read_text())["results"]
    for name in ("seqbeam_int8e_d512", "seqbeam_hl_d512", "seqbeam_m16_d512", "seqbeam_hl_d256"):
        assert set(quality[name]["delta_pct_by_key"]) == {"7", "8", "9"}
    # every Gram-table candidate of the guard, auto's rungs among them, on seeds 7-9
    from quantization_tpu_torch.ops.quality_guard import GRAMV3_CANDIDATES

    rows = [r.name for c in GRAMV3_CANDIDATES.values() for r in c]
    for name in rows:
        assert set(quality[name]["delta_pct_by_key"]) == {"7", "8", "9"}, name
        assert quality[name]["max_delta_pct"] == max(quality[name]["delta_pct_by_key"].values())
        assert name in smoke, name
    grams = [r.name for ladder in tladder.LADDERS.values() for r in ladder
             if r.kernel is tg3.GRAMV3]
    assert len(grams) == 3
    for gram in grams:
        assert gram in rows and smoke[gram]["ok"], gram
