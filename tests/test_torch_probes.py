"""The primitive probes P1-P6: the port's plain versions against the JAX
package's Pallas kernels in interpret mode (the CUDA kernels are held
against the plain versions on a card in ``test_torch_gpu.py``).

``experiments/prim_bench.py`` times its kernels on the TPU when imported,
so its kernel functions and constants are taken out of the source with
``ast`` and run here through ``pl.pallas_call(..., interpret=True)``.
``experiments/int8_mxu_probe.py`` turns on a persistent compilation cache
at import unless ``QUANTIZATION_TPU_NO_CACHE`` is set, so it is imported
with that set.

Tolerances: bit for bit for minround, gather, assembly and the int8 chain;
matmul within 1e-5 of the sum of |terms| (the sums run in another order);
the "bf16" chain on every element (the same products, and c in f32 on both
sides), on inputs where the chain changes elements and where a bf16 c would
give another result.
"""

import ast
import functools
import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from quantization_tpu_torch.experiments import int8_mxu_probe as tprobe
from quantization_tpu_torch.experiments import prim_bench as tprim
from probe_inputs import above_inf

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"


@functools.lru_cache(maxsize=None)
def _prim_kernels() -> dict:
    """The kernel functions, ``_INF`` and ``MASK`` of
    ``experiments/prim_bench.py``, without running the script."""
    tree = ast.parse((EXPERIMENTS / "prim_bench.py").read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name.endswith("_kernel"))
            or (isinstance(n, ast.Assign) and n.targets[0].id in ("_INF", "MASK"))]
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "prim_bench_kernels", "exec"), ns)
    return ns


@functools.lru_cache(maxsize=None)
def _mxu_probe():
    os.environ["QUANTIZATION_TPU_NO_CACHE"] = "1"
    spec = importlib.util.spec_from_file_location("int8_mxu_probe",
                                                  EXPERIMENTS / "int8_mxu_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(kernel, args, out_shape):
    """One Pallas call in interpret mode, every operand whole in VMEM, as
    the script's ``run`` builds it."""
    return np.array(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM) for _ in args],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )(*[jnp.asarray(a) for a in args]))


def test_prim_constants_match_the_script():
    ns = _prim_kernels()
    assert (tprim.INF, tprim.MASK) == (ns["_INF"], ns["MASK"])
    assert tprim.INF_BITS == int(np.float32(ns["_INF"]).view(np.uint32))


@pytest.mark.parametrize("low", [1.0, 0.0])  # the script's [1, 2), and [0, 2)
@pytest.mark.parametrize("K", [1, 5, 130])  # 130 > 128 lanes: the last rounds do nothing
def test_minround_plain_bit_exact_vs_jax(K, low):
    rng = np.random.default_rng(10 + K)
    x = (rng.random((16, 128)) * (2.0 - low) + low).astype(np.float32)
    want = _interpret(functools.partial(_prim_kernels()["minround_kernel"], K=K, rows=16),
                      (x,), (16, 128))
    got = tprim.minround(torch.from_numpy(x), K).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert ((got == np.float32(tprim.INF)).sum(1) == min(K, 128)).all()


@pytest.mark.parametrize("K", [1, 2, 5, 130])
def test_minround_plain_bit_exact_vs_jax_above_inf(K):
    x = above_inf(16, 11 + K)
    want = _interpret(functools.partial(_prim_kernels()["minround_kernel"], K=K, rows=16),
                      (x,), (16, 128))
    got = tprim.minround(torch.from_numpy(x), K).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    taken = (got == np.float32(tprim.INF)).sum(1)
    # a row with at most one key below 1e30 loses one key, whatever K
    assert taken[0] == 1 and taken[1] == 1
    assert (taken <= min(K, 128)).all()


@pytest.mark.parametrize("kind", ["zero", "random", "negative", "large"])
def test_gather_plain_bit_exact_vs_jax(kind):
    rng = np.random.default_rng(20)
    x = rng.random((8, 256)).astype(np.float32)
    # large: idx + i wraps past 2**31 - 1 in int32
    idx = {"zero": np.zeros((8, 256)), "random": rng.integers(0, 8, (8, 256)),
           "negative": rng.integers(-40, 0, (8, 256)),
           "large": rng.integers(2**31 - 64, 2**31, (8, 256))}[kind].astype(np.int32)
    K = 11
    want = _interpret(functools.partial(_prim_kernels()["gather_kernel"], K=K, N=256),
                      (x, idx), (8, 256))
    got = tprim.gather(torch.from_numpy(x), torch.from_numpy(idx), K).numpy()
    np.testing.assert_array_equal(got, want)


def test_matmul_plain_vs_jax():
    rng = np.random.default_rng(30)
    a = rng.random((16, 128)).astype(np.float32)
    b = jnp.asarray(rng.random((32, 128)), jnp.bfloat16)
    K = 4
    want = _interpret(functools.partial(_prim_kernels()["matmul_kernel"], K=K), (a, b), (16, 32))
    at = torch.from_numpy(a)
    bt = torch.from_numpy(np.array(b.astype(jnp.float32))).to(torch.bfloat16)
    got = tprim.matmul(at, bt, K)
    # the sums run in another order: within 1e-5 of the sum of |terms|
    assert tprim.matmul_close(got, torch.from_numpy(want), at, bt, K)
    assert not tprim.matmul_close(got, torch.from_numpy(want) * 1.001, at, bt, K)


@pytest.mark.parametrize("K", [8, 96])  # finite, and past the overflow to +-inf
def test_assembly_plain_bit_exact_vs_jax(K):
    rng = np.random.default_rng(40)
    x = rng.random((16, 32)).astype(np.float32)
    want = _interpret(functools.partial(_prim_kernels()["assembly_kernel"], K=K, rows=16, cs=32),
                      (x,), (16, 32))
    got = tprim.assembly(torch.from_numpy(x), K).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(want).all() == (K == 8)


def _chain_inputs(seed, tiny_frac=0.0, shape=(64, 128, 32), c_scale=0.05):
    """E (MB, D) normal and c (CS, D) normal x ``c_scale`` (0.05: the
    script's distributions), with a share ``tiny_frac`` of E's elements
    scaled by 1e-5; ``shape`` is (MB, D, CS)."""
    mb, d, cs = shape
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((mb, d)).astype(np.float32)
    c = (rng.standard_normal((cs, d)) * c_scale).astype(np.float32)
    if tiny_frac:
        e = np.where(rng.random(e.shape) < tiny_frac, e * 1e-5, e).astype(np.float32)
    return e, c


def _chain_interpret(kernel, e, c):
    return np.array(pl.pallas_call(
        kernel, grid=(1,),
        in_specs=[pl.BlockSpec(e.shape, lambda i: (0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec(c.shape, lambda i: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(e.shape, lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(e.shape, jnp.float32), interpret=True,
    )(jnp.asarray(e), jnp.asarray(c)))


@pytest.mark.parametrize("chain,shape", [
    pytest.param("bf16", (64, 128, 32), id="bf16"), pytest.param("int8", (64, 128, 32), id="int8"),
    # the chain's second test shape on the card (D = 256, CS = 128)
    pytest.param("int8", (48, 256, 128), id="int8-d256-cs128")])
def test_chain_plain_vs_jax(chain, shape):
    mod = _mxu_probe()
    assert mod.STEPS == tprobe.STEPS
    # upd (about 1e-7 here) is far below half a bf16 ulp of |e| ~ 1: the
    # "bf16" chain moves only small elements, so a quarter of E is small
    e, c = _chain_inputs(50, tiny_frac=0.25 if chain == "bf16" else 0.0, shape=shape)
    kernel = mod.bf16_kernel if chain == "bf16" else mod.int8_kernel
    want = _chain_interpret(kernel, e, c)
    plain = tprobe.bf16_chain if chain == "bf16" else tprobe.int8_chain
    got = plain(torch.from_numpy(e), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    if chain == "bf16":
        # the chain changed elements: returning bf16(e) would not pass
        start = torch.from_numpy(e).to(torch.bfloat16).float().numpy()
        assert (want != start).sum() > 1000
        # and c stays f32 in the JAX kernel: with bf16(c) the chain ends elsewhere
        c16 = torch.from_numpy(c).to(torch.bfloat16).float()
        assert (plain(torch.from_numpy(e), c16).numpy() != want).sum() > 100


@pytest.mark.parametrize("c_scale", [0.5, 1.0])
def test_int8_chain_plain_saturates_c8_as_jax(c_scale):
    # c * 127 beyond int8's range: JAX saturates c8 (200 -> 127), and so
    # must the port, where a bare cast would keep the low byte (200 -> -56)
    e, c = _chain_inputs(50, shape=(64, 128, 32), c_scale=c_scale)
    assert (np.abs(np.round(c * np.float32(127.0))) > 127).sum() > 100
    want = _chain_interpret(_mxu_probe().int8_kernel, e, c)
    got = tprobe.int8_chain(torch.from_numpy(e), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)


def test_round_to_int8_saturates_as_jax():
    x = np.array([200.0, -200.0, 128.6, -128.6, 127.5, -127.5, 1e10, -1e10, 3.5, -2.5],
                 np.float32)
    want = np.array(jnp.round(jnp.asarray(x)).astype(jnp.int8))
    got = tprobe.round_to_int8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [127, -128, 127, -128, 127, -128, 127, -128, 4, -2])


def test_dispatch_runs_the_plain_version_on_the_cpu():
    x = torch.rand(8, 128, generator=torch.Generator().manual_seed(0)) + 1.0
    e = torch.randn(32, 64, generator=torch.Generator().manual_seed(1))
    c = torch.randn(64, 64, generator=torch.Generator().manual_seed(2)) * 0.05
    counts = [k.launches for k in (*tprim.KERNELS.values(), *tprobe.KERNELS.values())]
    assert torch.equal(tprim.minround(x, 3), tprim.minround_plain(x, 3))
    assert torch.equal(tprobe.int8_chain(e, c, 2), tprobe.int8_chain_plain(e, c, 2))
    assert counts == [k.launches for k in (*tprim.KERNELS.values(), *tprobe.KERNELS.values())]
    # a wrapper given a CPU tensor raises: it launches the kernel or nothing
    with pytest.raises(ValueError, match="CUDA"):
        tprim.minround_cuda(x, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tprobe.int8_chain_cuda(e, c, 2)


def test_int8_chain_stages_refuses_cpu_tensors():
    # the stage-timed build exists only on the card: no plain version stands in
    e = torch.randn(32, 64, generator=torch.Generator().manual_seed(1))
    c = torch.randn(64, 64, generator=torch.Generator().manual_seed(2)) * 0.05
    counts = [k.launches for k in (tprobe.INT8_CHAIN_TIMED_KERNEL, tprobe.INT8_BARRIER_KERNEL)]
    with pytest.raises(ValueError, match="CUDA"):
        tprobe.int8_chain_stages(e, c, 2)
    assert counts == [k.launches
                      for k in (tprobe.INT8_CHAIN_TIMED_KERNEL, tprobe.INT8_BARRIER_KERNEL)]


def test_matmul_stages_refuses_cpu_tensors():
    # the stage-timed build exists only on the card: no plain version stands in
    a = torch.rand(32, 64, generator=torch.Generator().manual_seed(1))
    b = torch.rand(64, 64, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    counts = [k.launches for k in (tprim.MATMUL_TIMED_KERNEL, tprim.MATMUL_KERNEL)]
    with pytest.raises(ValueError, match="CUDA"):
        tprim.matmul_stages(a, b, 2)
    assert counts == [k.launches for k in (tprim.MATMUL_TIMED_KERNEL, tprim.MATMUL_KERNEL)]


def test_probes_exit_nonzero_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without a CUDA card")
    assert tprim.main() != 0 and tprobe.main() != 0
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and err.out == ""


def test_probe_inputs_have_the_scripts_shapes():
    ps = tprim.probes(torch.device("cpu"))
    assert [p.name for p in ps] == ["minround", "gather", "matmul", "assembly"]
    assert [tuple(t.shape) for p in ps for t in p.inputs] == [
        (1024, 128), (8, 65536), (8, 65536), (1024, 512), (256, 512), (1024, 256)]
    assert [p.Ks for p in ps] == [(32, 96), (16, 48), (16, 48), (32, 96)]
    assert float(ps[0].inputs[0].min()) >= 1.0 and not ps[1].inputs[1].any()
    chs = tprobe.chains(torch.device("cpu"))
    assert [tuple(t.shape) for t in chs[0].inputs] == [(2048, 512), (256, 512)]
    assert tprobe.FLOPS == 2.0 * 24 * 2 * 2048 * 512 * 256  # the script's count (:116)
