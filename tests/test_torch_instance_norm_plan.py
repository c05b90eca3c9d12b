"""The cluster route of ``instance_norm_fwd`` (csrc/instance_norm.cu
``in_cluster_kernel``) on the CPU: its launch plan, and a plain emulation of
its decomposition held against the JAX package.

The plan is computed from an occupancy model of the H100 SXM (the
cudaOccupancyMaxActiveClusters counts that
``tools/instance_norm_sweep.py`` printed on the card), so that the choices
it makes for the fast-style net's shapes are checked here. The emulation
follows the kernel's order of work: per block, the streamed rows stage by
stage (two-pass within the stage, Chan-merged in stage order), the resident
rows' sums, the blocks' sums in block order, the mean, per block the
resident rows' squared deviations plus the streamed rows' merged M2, the
blocks in order, then the apply. It is held against ``instance_norm_pallas
(..., interpret=True)`` where the TPU kernel takes the shape and against the
XLA composition ``nn/transformer_net._in_apply(..., backend="xla")``
everywhere, at tests/test_torch_instance_norm.py's tolerances: f32 1e-5,
bf16 0.05 absolute, the mean-1e3 channel 1e-4 against float64."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.nn.transformer_net import _in_apply as j_in_apply
from heuristique_style_transfer_code_tpu.ops.pallas.instance_norm_kernel import (
    instance_norm_pallas,
)
from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin

# cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3 for k = 1..16
# blocks a cluster, by the shared memory a block asks for
_ONE_PER_SM = [132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7]  # > 116 KB
_TWO_PER_SM = [264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14]  # <= 113 KB
_THREE_PER_SM = [396, 198, 124, 92, 69, 62, 47, 45, 37, 30, 28, 28, 23, 21, 21, 21]  # <= 64 KB


def _h100(plan: kin.Plan) -> int:
    table = (_ONE_PER_SM if plan.smem > 116 * 1024
             else _TWO_PER_SM if plan.smem > 64 * 1024 else _THREE_PER_SM)
    return table[plan.k - 1]


NET_SHAPES = [(8, 224, 224, 32), (8, 112, 112, 64), (8, 56, 56, 128)]
OTHER_SHAPES = [(1, 512, 512, 32), (3, 37, 29, 48), (2, 13, 11, 5), (4, 224, 224, 32),
                (1, 224, 224, 32), (5, 1, 1009, 16), (16, 56, 56, 128)]  # 1009: a prime HW
_ELEM = {"float32": 4, "bfloat16": 2}


def _plan(shape, dtype, aligned=True):
    b, h, w, c = shape
    return kin._plan(b, h * w, c, _ELEM[dtype], aligned, _h100)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NET_SHAPES + OTHER_SHAPES)
def test_plan_covers_every_row_once_within_the_card(shape, dtype):
    """The blocks cover every HW row of an image once; each block's rows
    are its streamed ones then its resident ones; a block's shared memory
    stays within 227 KB; k <= 16, at most 16 chunks and 4 ring stages."""
    b, h, w, c = shape
    hw, elem = h * w, _ELEM[dtype]
    plan = _plan(shape, dtype)
    if plan.route == "split":
        assert plan == kin.SPLIT
        return
    assert 1 <= plan.k <= 16
    covered = []
    for (s0, s1), (r0, r1) in kin._block_split(hw, plan.k, plan.res_rows):
        assert s1 == r0 and r1 - r0 <= plan.res_rows
        covered += list(range(s0, s1)) + list(range(r0, r1))
        streamed = s1 - s0
        if streamed:
            assert plan.stage_rows >= 1 and 1 <= plan.slots <= 4
            assert math.ceil(streamed / plan.stage_rows) >= 1
    assert covered == list(range(hw))
    assert math.ceil(plan.res_rows / plan.chunk_rows) <= 16
    used = kin._cluster_smem(c, elem, plan.k, plan.res_rows, plan.stage_rows, plan.slots)
    assert used <= plan.smem <= 227 * 1024
    assert plan.clusters == _h100(plan)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NET_SHAPES)
def test_net_shapes_take_one_cluster_per_image_all_at_once(shape, dtype):
    """B = 8 at the net's shapes: the cluster route, 8 blocks an image
    (at most 7 clusters of 16 one-block-an-SM blocks fit an H100), all 8
    clusters resident at once, whole images resident where they fit."""
    b, h, w, c = shape
    plan = _plan(shape, dtype)
    assert plan.route == "cluster" and plan.k == 8 and plan.clusters >= b
    share, reread = kin.plan_traffic(plan, b, h * w, c, _ELEM[dtype])
    fits = h * w * c * _ELEM[dtype] <= 8 * 200 * 1024
    assert (share == 1.0 and reread == 0) == fits


@pytest.mark.parametrize("shape,dtype,aligned", [
    ((1, 512, 512, 32), "bfloat16", True),  # one image: a cluster would leave most SMs idle
    ((2, 13, 11, 5), "float32", True),  # C not a whole number of 16-byte vectors
    ((8, 56, 56, 128), "bfloat16", False),  # a misaligned pointer
    ((8, 56, 56, 512), "float32", True),  # C > 256
])
def test_plan_takes_the_split_route_where_a_cluster_cannot_serve(shape, dtype, aligned):
    assert _plan(shape, dtype, aligned) == kin.SPLIT


def test_plan_traffic_of_the_split_route_rereads_everything():
    assert kin.plan_traffic(kin.SPLIT, 2, 100, 8, 4) == (0.0, 2 * 100 * 8 * 4)


# --------------------------------------------- the decomposition, emulated


def _as_kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, relu: bool,
               plan: kin.Plan, eps: float = kin.EPS) -> torch.Tensor:
    """in_cluster_kernel's arithmetic on the CPU, block by block (f32, or
    f64 for f64 input): u = x - K (K the image's first row); per block the
    streamed stages two-pass and Chan-merged in stage order, the resident
    rows summed; the mean of u from the block sums in block order; per
    block sum (u - mean)^2 over its resident rows plus its streamed rows'
    M2 + n (m - mean)^2, added in block order; y = (x - K) a + (bias - mean
    a), ReLU, one cast."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    b, hw, c = x.shape
    out = torch.empty_like(x)
    blocks = kin._block_split(hw, plan.k, plan.res_rows)
    for i in range(b):
        u = x[i].to(acc) - x[i, :1].to(acc)
        sums, streamed = [], []
        for (s0, s1), (r0, r1) in blocks:
            n_s = 0
            m_s = torch.zeros(c, dtype=acc)
            q_s = torch.zeros(c, dtype=acc)
            s_all = torch.zeros(c, dtype=acc)
            for g0 in range(s0, s1, max(plan.stage_rows, 1)):
                stage = u[g0:min(s1, g0 + plan.stage_rows)]
                n_g = stage.shape[0]
                m_g = stage.sum(0) / n_g
                q_g = torch.square(stage - m_g).sum(0)
                d = m_g - m_s
                m_s = m_s + d * (n_g / (n_s + n_g))
                q_s = q_s + q_g + d * d * (n_s * n_g / (n_s + n_g))
                n_s += n_g
                s_all = s_all + stage.sum(0)
            s_all = s_all + u[r0:r1].sum(0)
            sums.append(s_all)
            streamed.append((n_s, m_s, q_s))
        mean = torch.zeros(c, dtype=acc)
        for s in sums:
            mean = mean + s
        inv_hw = 1.0 / hw
        mean = mean * inv_hw
        m2 = torch.zeros(c, dtype=acc)
        for ((_, _), (r0, r1)), (n_s, m_s, q_s) in zip(blocks, streamed):
            m2 = m2 + (torch.square(u[r0:r1] - mean).sum(0) + q_s + n_s * torch.square(m_s - mean))
        a = scale[i].to(acc) * torch.rsqrt(m2 * inv_hw + eps)
        y = u * a + (bias[i].to(acc) - mean * a)
        if relu:
            y = torch.clamp_min(y, 0.0)
        out[i] = y.to(x.dtype)
    return out


def _plans(hw: int):
    """Whole images in 3 blocks; one block; and 2 blocks that keep a third
    of their rows, streaming the rest in stages of 7 rows (the last ragged)."""
    half = -(-hw // 2)
    return [kin.Plan("cluster", 3, -(-hw // 3), 16, 0, 0),
            kin.Plan("cluster", 1, hw, 16, 0, 0),
            kin.Plan("cluster", 2, half // 3, 16, 7, 2)]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    b, c = shape[0], shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5 + rng.randn(c)).astype(np.float32)
    return x, rng.randn(b, c).astype(np.float32), rng.randn(b, c).astype(np.float32)


def _emulate(x, scale, bias, relu, plan, dtype=torch.float32):
    b, h, w, c = x.shape
    y = _as_kernel(torch.tensor(x).to(dtype).reshape(b, h * w, c), torch.tensor(scale),
                   torch.tensor(bias), relu, plan)
    return y.float().reshape(b, h, w, c).numpy()


def _jax_xla(x, scale, bias, relu=False, dtype=jnp.float32):
    b = x.shape[0]
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    y = j_in_apply(p, jnp.asarray(x, dtype), jnp.eye(b, dtype=jnp.float32), relu=relu,
                   backend="xla")
    return np.asarray(y.astype(jnp.float32))


# tests/test_torch_instance_norm.py's shapes that the TPU kernel takes
PALLAS_SHAPES = [(3, 8, 8, 32), (2, 8, 12, 64), (1, 16, 12, 128), (1, 4, 149, 32)]


@pytest.mark.parametrize("plan_index", [0, 1, 2])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
def test_decomposition_matches_pallas_interpret(shape, relu, plan_index):
    x, s, b = _inputs(shape, 13)
    want = np.asarray(instance_norm_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                           relu=relu, interpret=True))
    plan = _plans(shape[1] * shape[2])[plan_index]
    np.testing.assert_allclose(_emulate(x, s, b, relu, plan), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("plan_index", [0, 1, 2])
@pytest.mark.parametrize("shape", PALLAS_SHAPES + [(3, 37, 29, 48), (2, 1, 1009, 8)])
def test_decomposition_matches_xla_composition(shape, plan_index):
    x, s, b = _inputs(shape, 14)
    plan = _plans(shape[1] * shape[2])[plan_index]
    np.testing.assert_allclose(_emulate(x, s, b, True, plan), _jax_xla(x, s, b, True),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("plan_index", [0, 2])
def test_decomposition_bf16_matches_xla_composition(plan_index):
    x, s, b = _inputs((2, 12, 10, 32), 15)
    plan = _plans(120)[plan_index]
    got = _emulate(x, s, b, True, plan, torch.bfloat16)
    assert np.abs(got - _jax_xla(x, s, b, True, jnp.bfloat16)).max() < 0.05


@pytest.mark.parametrize("plan_index", [0, 2])
def test_decomposition_is_two_pass_accurate_at_mean_1e3(plan_index):
    """Channels of mean 1e3 and std 1: the shifted, two-pass statistics and
    the apply hold to 1e-4 of a float64 two-pass result."""
    rng = np.random.RandomState(16)
    b, hw, c = 2, 4096, 8
    x = (rng.randn(b, hw, c) + 1e3).astype(np.float32)
    s = rng.randn(b, c).astype(np.float32)
    bias = rng.randn(b, c).astype(np.float32)
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=1, keepdims=True)
    var = np.square(x64 - mean).mean(axis=1, keepdims=True)
    want = (x64 - mean) / np.sqrt(var + kin.EPS) * s[:, None] + bias[:, None]
    plan = _plans(hw)[plan_index]
    got = _as_kernel(torch.tensor(x), torch.tensor(s), torch.tensor(bias), False, plan).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NET_SHAPES)
def test_net_plans_decompose_like_the_plain_version(shape, dtype):
    """The plan chosen for each net shape, emulated at that shape's row
    split on a cut-down image (the same k, stage rows and resident share
    scaled to HW = 3136), against the plain version."""
    b, h, w, c = shape
    plan = _plan(shape, dtype)
    hw = 3136
    per_block = -(-hw // plan.k)
    share, _ = kin.plan_traffic(plan, b, h * w, c, _ELEM[dtype])
    small = plan._replace(res_rows=max(1, int(per_block * share)),
                          stage_rows=max(1, plan.stage_rows * hw // (h * w)))
    x, s, bias = _inputs((2, 1, hw, 16), 17)
    t = torch.float32 if dtype == "float32" else torch.bfloat16
    got = _emulate(x, s, bias, True, small, t)
    xt = torch.tensor(x).to(t).reshape(2, hw, 16)
    want = kin.instance_norm_fwd_plain(xt, torch.tensor(s), torch.tensor(bias), relu=True)
    tol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got.reshape(2, hw, 16), want.float().numpy(), rtol=tol, atol=tol)


def test_profile_tool_names_both_routes():
    """tools/profile_main_path.py sums the instance-norm kernels by name:
    it must know the cluster route's kernel, the split route's three, the
    backward's cluster-route kernel and its split route's three."""
    from heuristique_style_transfer_code_tpu_torch.tools import profile_main_path as pm

    assert set(pm.IN_KERNELS) == {"in_cluster_kernel", "in_stats_kernel", "in_finalize_kernel",
                                  "in_apply_kernel", "in_bwd_cluster_kernel",
                                  "in_bwd_reduce_kernel", "in_bwd_finalize_kernel",
                                  "in_bwd_apply_kernel"}
