"""K3's plain version (``ops/kernels/instance_norm.py``), which the port
runs on CPU tensors and holds the CUDA kernel against on the card, against
the JAX package: the Pallas kernel in interpret mode and the XLA
composition of ``nn/transformer_net._in_apply``.

Tolerances: f32 rtol = atol = 1e-5 (the same arithmetic in another order);
bf16 0.05 absolute (one bf16 rounding of outputs of size up to about 10,
as the JAX package's own bf16 test); the mean-1e3 channel rtol 1e-4 with
atol 1e-4 against a float64 numpy two-pass result (an f32 mean of values
near 1e3 carries about 3e-5 of rounding, and a one-pass variance would be
off by far more)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.nn.transformer_net import _in_apply as j_in_apply
from heuristique_style_transfer_code_tpu.ops.pallas.instance_norm_kernel import (
    instance_norm_pallas,
)
from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin

# tests/test_pallas_kernels.py's shapes, plus an H*W*C / 128 that is prime
SHAPES = [(3, 8, 8, 32), (2, 8, 12, 64), (1, 16, 12, 128), (1, 4, 149, 32)]


def _inputs(shape, seed):
    """Signed inputs like conv outputs, per-channel offsets, and per-image
    affine rows that differ."""
    rng = np.random.RandomState(seed)
    b, c = shape[0], shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5 + rng.randn(c)).astype(np.float32)
    scale = rng.randn(b, c).astype(np.float32)
    bias = rng.randn(b, c).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, relu=False, dtype=torch.float32):
    b, h, w, c = x.shape
    y = kin.instance_norm_fwd(torch.tensor(x).to(dtype).reshape(b, h * w, c),
                              torch.tensor(scale), torch.tensor(bias), relu=relu)
    assert y.dtype == dtype
    return y.float().reshape(b, h, w, c).numpy()


def _jax_xla(x, scale, bias, relu=False, dtype=jnp.float32):
    """_in_apply with a (B, C) table and one-hot rows: exactly the per-image
    rows (a one-hot w @ table is the row)."""
    b = x.shape[0]
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    y = j_in_apply(p, jnp.asarray(x, dtype), jnp.eye(b, dtype=jnp.float32), relu=relu,
                   backend="xla")
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape, relu):
    x, s, b = _inputs(shape, 3)
    want = np.asarray(instance_norm_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                           relu=relu, interpret=True))
    np.testing.assert_allclose(_port(x, s, b, relu), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(3, 37, 29, 48)])  # C = 48: the TPU kernel rejects it
def test_plain_matches_xla_composition(shape, relu):
    x, s, b = _inputs(shape, 4)
    np.testing.assert_allclose(_port(x, s, b, relu), _jax_xla(x, s, b, relu),
                               rtol=1e-5, atol=1e-5)


def test_shared_affine_matches_xla_composition():
    """A single-style (C,) affine, which the port repeats to (B, C)."""
    x, s, b = _inputs((2, 8, 8, 32), 5)
    p = {"scale": jnp.asarray(s[0]), "bias": jnp.asarray(b[0])}
    want = np.asarray(j_in_apply(p, jnp.asarray(x), relu=True, backend="xla"))
    got = _port(x, np.repeat(s[:1], 2, 0), np.repeat(b[:1], 2, 0), relu=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("relu", [False, True])
def test_bf16_matches_xla_composition(relu):
    x, s, b = _inputs((2, 8, 8, 32), 6)
    got = _port(x, s, b, relu, torch.bfloat16)
    want = _jax_xla(x, s, b, relu, jnp.bfloat16)
    assert np.abs(got - want).max() < 0.05


def test_mean_1e3_channel_is_two_pass_accurate():
    rng = np.random.RandomState(7)
    b, hw, c = 2, 4096, 8
    x = (rng.randn(b, hw, c) + 1e3).astype(np.float32)
    s = rng.randn(b, c).astype(np.float32)
    bias = rng.randn(b, c).astype(np.float32)
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=1, keepdims=True)
    var = np.square(x64 - mean).mean(axis=1, keepdims=True)
    want = (x64 - mean) / np.sqrt(var + kin.EPS) * s[:, None] + bias[:, None]
    got = kin.instance_norm_fwd(torch.tensor(x), torch.tensor(s), torch.tensor(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_plain_version_does_not_count_launches():
    kin.reset_launch_counts()
    x, s, b = torch.randn(2, 9, 5), torch.randn(2, 5), torch.randn(2, 5)
    kin.instance_norm_fwd(x, s, b, relu=True)
    kin.instance_norm_bwd(x, torch.randn(2, 9, 5), s, b, relu=True)
    assert kin.LAUNCHES == {"instance_norm_fwd": 0, "instance_norm_bwd": 0}


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor takes the plain version: any other device launches
    the kernel or raises (here a meta tensor raises before any build)."""
    x = torch.empty(2, 9, 8, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kin.instance_norm_fwd(x, torch.empty(2, 8, device="meta"),
                              torch.empty(2, 8, device="meta"))
