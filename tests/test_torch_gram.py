"""The port's Gram ops (their plain PyTorch versions on the CPU) against the
JAX package: the XLA composition (``ops/gram.py``) and the Pallas kernels in
interpret mode (``ops/pallas/gram_kernel.py``), on the same numpy inputs.

Tolerances: f32 rtol/atol 1e-4 (as tests/test_pallas_kernels.py: only the
summation order differs); bf16 2e-2 of max|G| (the XLA path rounds P and
the projection to bf16, the port keeps them f32 as the Pallas kernel does).
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.ops.gram import gram_matrix_nhwc as j_gram
from heuristique_style_transfer_code_tpu.ops.gram import pooled_gram_nhwc as j_pooled
from heuristique_style_transfer_code_tpu.ops.pallas.gram_kernel import (
    gram_pallas,
    pooled_gram_pallas,
)
from heuristique_style_transfer_code_tpu_torch.ops import gram as tgram
from heuristique_style_transfer_code_tpu_torch.ops.kernels import gram as kgram

F32 = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


@pytest.mark.parametrize("shape", [(2, 7, 7, 64), (1, 8, 8, 128)])
def test_gram_matches_xla_and_pallas(shape):
    x = _x(shape, 0)
    got = tgram.gram_matrix_nhwc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_gram(jnp.asarray(x))), **F32)
    np.testing.assert_allclose(got, np.asarray(gram_pallas(jnp.asarray(x), interpret=True)), **F32)


@pytest.mark.parametrize("shape,s", [((2, 7, 7, 256), 7), ((1, 14, 14, 64), 4),
                                     ((2, 4, 4, 256), 7)])
def test_pooled_gram_matches_xla_and_pallas(shape, s):
    x = _x(shape, 1)  # C=256, S=7: overlapping bins
    got = tgram.pooled_gram_nhwc(torch.from_numpy(x), s).numpy()
    assert got.shape == (shape[0], s, s)
    np.testing.assert_allclose(got, np.asarray(j_pooled(jnp.asarray(x), s)), **F32)
    np.testing.assert_allclose(
        got, np.asarray(pooled_gram_pallas(jnp.asarray(x), s, interpret=True)), **F32
    )


@pytest.mark.parametrize("op", ["gram", "pooled"])
def test_bf16_within_tolerance_of_xla(op):
    x = _x((2, 8, 8, 64), 2)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    if op == "gram":
        want = np.asarray(j_gram(jx), np.float32)
        got = tgram.gram_matrix_nhwc(tx)
    else:
        want = np.asarray(j_pooled(jx, 7), np.float32)
        got = tgram.pooled_gram_nhwc(tx, 7)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("shape", [(2, 6, 5, 16), (1, 7, 7, 64)])
def test_gram_backward_matches_jax_grad(shape):
    """The Function's backward dF = F (dG + dGᵀ) / HW against jax.grad of a
    Gram MSE with the same (non-symmetric) target, so the cotangent dG is
    the same and not symmetric."""
    x = _x(shape, 3)
    c = shape[-1]
    target = _x((shape[0], c, c), 4) * 0.1

    def j_loss(v):
        return jnp.mean(jnp.square(j_gram(v) - target))

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    torch.mean(torch.square(tgram.gram_matrix_nhwc(tx) - torch.from_numpy(target))).backward()
    scale = np.abs(want).max()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-4, atol=1e-5 * scale)


def test_gram_function_gradcheck_f64():
    f = torch.randn(2, 5, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    assert torch.autograd.gradcheck(kgram.GramFunction.apply, (f,))


def test_plain_versions_do_not_count_launches():
    kgram.reset_launch_counts()
    f = torch.randn(2, 9, 8, requires_grad=True)
    kgram.GramFunction.apply(f).sum().backward()
    kgram.gram_fwd(f)
    kgram.gram_bwd(f, torch.randn(2, 8, 8))
    kgram.pooled_gram_fwd(f, torch.rand(3, 8))
    assert kgram.LAUNCHES == {name: 0 for name in kgram.KERNELS}


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor takes the plain version: any other device launches
    the kernel or raises (here a meta tensor raises before any build)."""
    f = torch.empty(2, 9, 8, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kgram.gram_fwd(f)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kgram.gram_bwd(f, torch.empty(2, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kgram.pooled_gram_fwd(f, torch.empty(3, 8, device="meta"))
