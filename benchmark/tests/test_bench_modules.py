"""The check on loaded modules compares whole top-level names."""

import _paths  # noqa: F401

from benchmark.lib.common import forbidden_modules


def test_planted_jax_is_found():
    assert forbidden_modules({"jax": None, "jax.numpy": None, "torch": None}) == ["jax"]
    assert forbidden_modules({"flax.linen": None, "jaxlib": None}) == ["flax", "jaxlib"]
    assert forbidden_modules({"quantization_tpu.core": None}) == ["quantization_tpu"]


def test_the_port_alone_passes():
    assert forbidden_modules({"quantization_tpu_torch": None,
                              "quantization_tpu_torch.core": None, "torch": None,
                              "jaxtyping": None, "benchmark.lib": None}) == []


def test_this_process():
    import quantization_tpu_torch  # noqa: F401

    from benchmark.reference import quantizer  # noqa: F401

    assert forbidden_modules() == []
