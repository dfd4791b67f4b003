"""K1, the fused decode: the port's plain version against the JAX package's
Pallas kernel in interpret mode (the CUDA kernel is held against the plain
version on a card in ``test_torch_gpu.py``).

The TPU kernel sums, per frame and in codebook order, one-hot products that
each pick a single bf16 row; so it computes the f32 sum of bf16-rounded
rows, and the port must equal it bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantization_tpu import core as jcore
from quantization_tpu.ops.decode import decode_kernel as jax_decode_kernel
from quantization_tpu_torch import core as tcore
from quantization_tpu_torch.ops import decode as tdecode
from quantization_tpu_torch.utils.torch_interop import params_from_numpy


def _setup(cs, nc, dim, seed):
    jc = jcore.QuantizerConfig(dim=dim, codebook_size=cs, num_codebooks=nc)
    tc = tcore.QuantizerConfig(dim=dim, codebook_size=cs, num_codebooks=nc)
    rng = np.random.default_rng(seed)
    arrays = {
        "centers": rng.standard_normal((nc, cs, dim)).astype(np.float32),
        "to_logits_w": np.zeros((nc * cs, dim), np.float32),
        "to_logits_b": np.zeros(nc * cs, np.float32),
        "logits_scale": np.float32(0.0),
        "centers_scale": np.float32(-0.05),
    }
    jp = jcore.QuantizerParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    idx = rng.integers(0, cs, size=(300, nc)).astype(np.int32)
    return jc, tc, jp, params_from_numpy(arrays), idx


@pytest.mark.parametrize("cs,nc", [(256, 4), (16, 8)])
@pytest.mark.parametrize("packed", [False, True])
def test_plain_decode_bit_exact_vs_jax_interpret(cs, nc, packed):
    jc, tc, jp, tp, idx = _setup(cs, nc, 128, seed=cs + nc)
    codes = np.asarray(jcore.pack_indexes(jnp.asarray(idx), cs)) if packed else idx
    want = np.asarray(jax_decode_kernel(jp, jc, jnp.asarray(codes), interpret=True))
    before = tdecode.DECODE_KERNEL.launches
    got = tdecode.decode_kernel(tp, tc, torch.from_numpy(codes))
    assert tdecode.DECODE_KERNEL.launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.float32 and got.shape == (300, 128)
    np.testing.assert_array_equal(got.numpy(), want)  # bit for bit
    # and through the public decode(use_kernel=True)
    np.testing.assert_array_equal(
        tcore.decode(tp, tc, torch.from_numpy(codes), use_kernel=True).numpy(), want)


def test_decode_kernel_guards():
    tc = tcore.QuantizerConfig(dim=96, codebook_size=256, num_codebooks=4)
    assert not tdecode.DECODE_KERNEL_SUPPORTED(tc)
    p = tcore.init_quantizer_params(torch.Generator().manual_seed(0), tc)
    with pytest.raises(ValueError, match="does not support"):
        tdecode.decode_kernel(p, tc, torch.zeros(3, 4, dtype=torch.uint8))
    cb = torch.zeros(4, 256, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.decode_cuda(torch.zeros(3, 4, dtype=torch.int32), cb)
    # an index outside the codebook adds nothing, as a one-hot row would not
    idx = torch.tensor([[0, 1, 2, 300]], dtype=torch.int32)
    cb = torch.ones(4, 256, 128, dtype=torch.bfloat16)
    assert torch.equal(tdecode.decode_plain(idx, cb), torch.full((1, 128), 3.0))
