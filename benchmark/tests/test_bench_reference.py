"""The plain reference agrees with the program at a small size on the CPU:
its beam-5 and decode with ``search_method="beam"`` and ``decode``, its
packing with the program's bytes, and its error with the program's
relative reconstruction loss."""

import _paths  # noqa: F401
import pytest
import torch

from benchmark.reference import quantizer as R


def _quantizer(dim, cs, nc, seed):
    import quantization_tpu_torch as qtt

    q = qtt.Quantizer(dim, cs, nc, generator=torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():  # move off the init (codebooks equal to the logits rows)
        g = torch.Generator().manual_seed(seed + 1)
        q.centers.add_(0.3 * torch.randn(q.centers.shape, generator=g))
        q.centers_scale.fill_(0.02)
        q.logits_scale.fill_(0.03)
    p = {k: getattr(q.params, k).detach().clone() for k in R.PARAMS}
    p["scale_speed"] = q.config.scale_speed
    return q, p


@pytest.mark.parametrize("dim,cs,nc", [(32, 16, 8), (64, 256, 4), (32, 4, 8)])
def test_beam5_and_decode_match_the_program(dim, cs, nc):
    q, p = _quantizer(dim, cs, nc, seed=dim + cs + nc)
    x = torch.randn(200, dim, generator=torch.Generator().manual_seed(7))
    codes = q.encode(x, search_method="beam")
    ref = R.encode_indexes(p, x, passes=5)
    assert torch.equal(R.pack(ref, cs), codes)
    idx = R.unpack(codes, cs, nc)
    assert torch.equal(idx, ref)
    assert torch.allclose(R.decode(p, idx), q.decode(codes), atol=1e-5, rtol=1e-5)


def test_rel_err_formula():
    q, p = _quantizer(32, 16, 8, seed=3)
    x = torch.randn(300, 32, generator=torch.Generator().manual_seed(8))
    idx = R.encode_indexes(p, x)
    rel = float(R.frame_sse(p, x, idx).sum() / R.spread_sumsq(p, x))
    losses = q.compute_loss(x, refine_indexes_iters=5)
    assert rel == pytest.approx(float(losses.rel_reconstruction_loss.detach()), rel=1e-5)


@pytest.mark.parametrize("allow_tf32", [False, True])
def test_reference_sets_tf32_itself(monkeypatch, allow_tf32):
    """Whatever the process set before, the reference's search runs with
    TF32 off (on only where the control asks for it) and leaves the
    setting as it found it."""
    seen = []
    refine = R.refine

    def spy(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return refine(*args, **kw)

    monkeypatch.setattr(R, "refine", spy)
    _, p = _quantizer(32, 16, 8, seed=4)
    x = torch.randn(50, 32, generator=torch.Generator().manual_seed(9))
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with R.tf32(not allow_tf32):
        R.encode_indexes(p, x, passes=2, allow_tf32=allow_tf32)
        assert torch.backends.cuda.matmul.allow_tf32 is (not allow_tf32)
    assert seen == [(allow_tf32, allow_tf32)] * 2
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
