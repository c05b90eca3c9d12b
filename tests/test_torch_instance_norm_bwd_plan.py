"""The cluster route of ``instance_norm_bwd`` (csrc/instance_norm.cu
``in_bwd_cluster_kernel``) on the CPU: its launch plan, and a plain emulation
of its decomposition held against the JAX package.

The plan is computed from an occupancy model of the H100 SXM for this kernel
(cudaOccupancyMaxActiveClusters as tools/instance_norm_bwd_sweep.py printed
it: the forward's counts a cluster size for one, two or three blocks an SM,
three at most, since the kernel's 72 registers a thread allow no more).
The emulation follows the kernel's order of work: per (image, channel group)
and per block in rank order, u = x - K (K the image's first row), the
block's sums of u and g, its mean u_b, M2 = sum (u - u_b)^2 and H = sum g
(u - u_b); the blocks merged in rank order (Chan's M2 and the cross term);
then the apply. It is held against ``jax.vjp`` of the JAX package's
compositions at tests/test_torch_instance_norm_bwd.py's tolerances: f32
1e-5, bf16 2e-2 (dx), dscale and dbias 1e-4 from bf16; the mean-1e3 case
1e-4 against a float64 two-pass backward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.nn.transformer_net import _in_apply as j_in_apply
from heuristique_style_transfer_code_tpu.ops import norm as jnorm
from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin

# cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3 for k = 1..16
# blocks a cluster, by how many blocks share an SM
_ONE_PER_SM = [132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7]
_TWO_PER_SM = [264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14]
_THREE_PER_SM = [396, 198, 124, 92, 69, 62, 47, 45, 37, 30, 28, 28, 23, 21, 21, 21]
_SM_SMEM, _RESERVED = 228 * 1024, 1024  # an SM's shared memory, and what each block costs beside


def _h100(plan: kin.BwdPlan) -> int:
    per_sm = min(3, _SM_SMEM // (plan.smem + _RESERVED))
    return (_ONE_PER_SM, _TWO_PER_SM, _THREE_PER_SM)[per_sm - 1][plan.k - 1]


B1_SHAPES = [(1, 112, 112, 64), (1, 56, 56, 128), (1, 55, 55, 256), (1, 28, 28, 256),
             (1, 14, 14, 512), (1, 13, 13, 1024)]
OTHER_SHAPES = [(8, 56, 56, 128), (4, 28, 28, 256), (3, 37, 29, 48), (2, 1, 1009, 16),
                (1, 3, 3, 8)]
_ELEM = {"float32": 4, "bfloat16": 2}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_AFFINE = {"float32": 1e-5, "bfloat16": 1e-4}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _plan(shape, dtype, relu=True, aligned=True):
    b, h, w, c = shape
    return kin._bwd_plan(b, h * w, c, _ELEM[dtype], aligned, relu, _h100)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", B1_SHAPES + OTHER_SHAPES)
def test_plan_covers_every_image_channel_and_row_once_within_the_card(shape, dtype, relu):
    """The tiles of a cluster-route plan cover every (channel, row) of an
    image once (each image has its own clusters); g is a power-of-two
    number of 16-byte vectors, at most 32 (csrc/instance_norm.cu
    MAX_BWD_GV); k <= 16 and k <= HW; a block's shared memory is what its
    strips and exchange take, within 227 KB; every cluster is resident at
    once."""
    b, h, w, c = shape
    hw, elem = h * w, _ELEM[dtype]
    plan = _plan(shape, dtype, relu)
    if plan.route == "split":
        assert plan == kin.BWD_SPLIT
        return
    gv = plan.g * elem // 16
    assert plan.g * elem % 16 == 0 and 1 <= gv <= 32 and gv & (gv - 1) == 0
    assert 1 <= plan.k <= 16 and plan.k <= hw
    seen = np.zeros((c, hw), np.int64)
    tiles = kin.bwd_tiles(plan, hw, c)
    assert len(tiles) == -(-c // plan.g)
    for group in tiles:
        assert len(group) == plan.k
        for c0, c1, r0, r1 in group:
            assert c1 - c0 <= plan.g
            seen[c0:c1, r0:r1] += 1
    assert (seen == 1).all()
    assert plan.smem == kin._bwd_smem(hw, plan.g, plan.k, elem, relu) <= kin._MAX_SMEM
    assert plan.clusters == _h100(plan) >= b * len(tiles)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", B1_SHAPES)
def test_b1_shapes_take_the_cluster_route_all_resident(shape, dtype):
    """The family-3 style loop's single images: the cluster route, groups
    of 32 or 64 bytes of a row (whole sectors), at least
    ``_BWD_MIN_BLOCKS`` blocks in all (64 blocks of 64-byte rows beat 128
    of 32-byte rows on the card), every cluster resident at once."""
    b, h, w, c = shape
    plan = _plan(shape, dtype)
    groups = -(-c // plan.g)
    assert plan.route == "cluster" and plan.g * _ELEM[dtype] in (32, 64)
    assert b * groups * plan.k >= kin._BWD_MIN_BLOCKS
    assert plan.clusters >= b * groups


@pytest.mark.parametrize("shape,dtype,relu,aligned", [
    ((8, 224, 224, 32), "float32", True, True),  # the net's in1: its strips outgrow the card
    ((8, 224, 224, 32), "float32", False, True),
    ((8, 56, 56, 128), "float32", True, True),
    ((32, 112, 112, 64), "float32", True, True),  # family 3 at b32
    ((32, 112, 112, 64), "bfloat16", True, True),
    ((2, 13, 11, 5), "float32", True, True),  # C not a whole number of 16-byte vectors
    ((1, 14, 14, 12), "bfloat16", True, True),
    ((1, 56, 56, 128), "bfloat16", True, False),  # a misaligned pointer
])
def test_plan_takes_the_split_route_where_no_cluster_serves(shape, dtype, relu, aligned):
    assert _plan(shape, dtype, relu, aligned) == kin.BWD_SPLIT


def test_plan_prefers_wider_groups_and_small_clusters():
    """At (1,56,56,128) f32: 64-byte groups (8 of them) over 8 blocks;
    (1,112,112,64) f32 needs 32-byte groups for 64 blocks at k = 8; bf16
    (1,112,112,64) has 4 groups of 32 bytes at most and takes k = 16."""
    assert _plan((1, 56, 56, 128), "float32")[:3] == ("cluster", 16, 8)
    assert _plan((1, 112, 112, 64), "float32")[:3] == ("cluster", 8, 8)
    assert _plan((1, 112, 112, 64), "bfloat16")[:3] == ("cluster", 16, 16)


# --------------------------------------------- the decomposition, emulated


def _as_kernel(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, relu: bool,
               y, plan: kin.BwdPlan, eps: float = kin.EPS):
    """in_bwd_cluster_kernel's arithmetic on the CPU (f32, or f64 for f64
    input), tile by tile: per (image, channel group) and per block in rank
    order, u = x - K, g = dy (times 1[y > 0]), the block's (sum u, M2, sum
    g, H) about its own mean; the merge in rank order; dscale = r H_all,
    dbias = sum g; dx = a ((g - dbias / HW) - (u - ubar) r dscale / HW),
    one cast to x's type."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    b, hw, c = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty((b, c), dtype=acc)
    dbias = torch.empty((b, c), dtype=acc)
    inv_hw = torch.tensor(1.0 / hw, dtype=acc)
    for i in range(b):
        k_row = x[i, :1].to(acc)
        for group in kin.bwd_tiles(plan, hw, c):
            c0, c1 = group[0][:2]
            parts = []
            for _, _, r0, r1 in group:
                u = x[i, r0:r1, c0:c1].to(acc) - k_row[:, c0:c1]
                g = dy[i, r0:r1, c0:c1].to(acc)
                if relu:
                    g = torch.where(y[i, r0:r1, c0:c1] > 0, g, torch.zeros_like(g))
                su = u.sum(0)
                mb = su / (r1 - r0)
                parts.append((r1 - r0, su, torch.square(u - mb).sum(0), g.sum(0),
                              (g * (u - mb)).sum(0)))
            s = torch.zeros(c1 - c0, dtype=acc)
            for _, su, _, _, _ in parts:
                s = s + su
            ubar = s / hw
            m2 = torch.zeros_like(s)
            gsum = torch.zeros_like(s)
            hs = torch.zeros_like(s)
            for n_r, su, q, sg, h in parts:
                d = su / n_r - ubar
                m2 = m2 + (q + n_r * d * d)
                gsum = gsum + sg
                hs = hs + (h + d * sg)
            r = torch.rsqrt(m2 * inv_hw + eps)
            ds = r * hs
            a = scale[i, c0:c1].to(acc) * r
            rds = r * ds * inv_hw
            db = gsum * inv_hw
            u = x[i, :, c0:c1].to(acc) - k_row[:, c0:c1]
            g = dy[i, :, c0:c1].to(acc)
            if relu:
                g = torch.where(y[i, :, c0:c1] > 0, g, torch.zeros_like(g))
            dx[i, :, c0:c1] = (a * ((g - db) - (u - ubar) * rds)).to(x.dtype)
            dscale[i, c0:c1] = ds
            dbias[i, c0:c1] = gsum
    return dx, dscale, dbias


def _plans(hw: int, elem: int):
    """32-byte groups over 3 blocks; one block of 64-byte groups; 16-byte
    groups over 5 blocks. At C = 40 f32 the 64-byte groups leave a partial
    last group of 8 channels, in bf16 the 32-byte ones one of 8."""
    v = 16 // elem
    return [kin.BwdPlan("cluster", 2 * v, 3), kin.BwdPlan("cluster", 4 * v, 1),
            kin.BwdPlan("cluster", v, min(5, hw))]


def _inputs(shape, seed):
    """Signed x like conv outputs with per-channel offsets, a cotangent,
    and per-image affine rows that differ."""
    rng = np.random.RandomState(seed)
    b, c = shape[0], shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5 + rng.randn(c)).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    return x, dy, rng.randn(b, c).astype(np.float32), rng.randn(b, c).astype(np.float32)


def _errs(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = got - want
    return (float(np.abs(diff).max() / np.abs(want).max()),
            float(np.linalg.norm(diff) / np.linalg.norm(want)))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("plan_index", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 9, 7, 16), (1, 13, 13, 40)])
def test_decomposition_matches_jax_family3_norm(shape, dtype, plan_index):
    """dx of the emulated kernel, the mask from the forward's y, against
    jax.vjp of ReLU(JAX ``ops/norm.instance_norm``) (family 3's norm: unit
    scale, zero bias)."""
    tdt, jdt = DTYPES[dtype]
    b, h, w, c = shape
    x, dy, _, _ = _inputs(shape, 21)
    _, vjp = jax.vjp(lambda v: jnp.maximum(jnorm.instance_norm(v), 0), jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(dy, jdt))
    xt = torch.tensor(x).to(tdt).reshape(b, h * w, c)
    dyt = torch.tensor(dy).to(tdt).reshape(b, h * w, c)
    ones, zeros = torch.ones((b, c)), torch.zeros((b, c))
    y = kin.instance_norm_fwd_plain(xt, ones, zeros, relu=True)
    plan = _plans(h * w, _ELEM[dtype])[plan_index]
    dx, _, _ = _as_kernel(xt, dyt, ones, True, y, plan)
    assert dx.dtype == tdt
    errs = _errs(_np(dx).reshape(shape), _np(want))
    assert max(errs) <= TOL[dtype], errs


@pytest.mark.parametrize("plan_index", [0, 1, 2])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decomposition_matches_jax_in_apply(dtype, relu, plan_index):
    """dx, dscale and dbias of the emulated kernel against jax.vjp of
    ``nn/transformer_net._in_apply`` with per-image (B, C) rows that differ
    (one-hot style weights, so each image's row is its table row)."""
    tdt, jdt = DTYPES[dtype]
    shape = (3, 11, 9, 40)
    b, h, w, c = shape
    x, dy, scale, bias = _inputs(shape, 22)

    def f(v, s, t):
        return j_in_apply({"scale": s, "bias": t}, v, jnp.eye(b, dtype=jnp.float32), relu=relu,
                          backend="xla")

    _, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(dy, jdt))
    xt = torch.tensor(x).to(tdt).reshape(b, h * w, c)
    dyt = torch.tensor(dy).to(tdt).reshape(b, h * w, c)
    st, bt = torch.tensor(scale), torch.tensor(bias)
    y = kin.instance_norm_fwd_plain(xt, st, bt, relu=True) if relu else None
    got = _as_kernel(xt, dyt, st, relu, y, _plans(h * w, _ELEM[dtype])[plan_index])
    for name, g, wnt, tol in (("dx", got[0].reshape(shape), want[0], TOL[dtype]),
                              ("dscale", got[1], want[1], TOL_AFFINE[dtype]),
                              ("dbias", got[2], want[2], TOL_AFFINE[dtype])):
        errs = _errs(_np(g), _np(wnt))
        assert max(errs) <= tol, (name, errs)


@pytest.mark.parametrize("plan_index", [0, 1, 2])
def test_decomposition_is_accurate_at_mean_1e3(plan_index):
    """Channels of mean 1e3 and std 1: the shift by the first row and the
    per-block two-pass sums hold dx, dscale and dbias to 1e-4 of a float64
    two-pass backward."""
    rng = np.random.RandomState(23)
    b, hw, c = 2, 4096, 8
    x = torch.tensor((rng.randn(b, hw, c) + 1e3).astype(np.float32))
    dy = torch.tensor(rng.randn(b, hw, c).astype(np.float32))
    scale = torch.tensor(rng.randn(b, c).astype(np.float32))
    bias = torch.tensor(rng.randn(b, c).astype(np.float32))
    want = kin.instance_norm_bwd_plain(x.double(), dy.double(), scale.double(), bias.double())
    got = _as_kernel(x, dy, scale, False, None, _plans(hw, 4)[plan_index])
    for name, g, wnt in zip(("dx", "dscale", "dbias"), got, want):
        errs = _errs(g.numpy(), wnt.numpy())
        assert max(errs) <= 1e-4, (name, errs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", B1_SHAPES[:2])
def test_b1_plans_decompose_like_the_plain_version(shape, dtype):
    """The plan chosen for a b1 shape, emulated with its k and g on a
    cut-down image of the same channels (HW = 400), against the plain
    version at the same tolerances."""
    b, h, w, c = shape
    plan = _plan(shape, dtype)
    x, dy, _, _ = _inputs((1, 1, 400, c), 24)
    tdt = DTYPES[dtype][0]
    xt = torch.tensor(x).to(tdt).reshape(1, 400, c)
    dyt = torch.tensor(dy).to(tdt).reshape(1, 400, c)
    ones, zeros = torch.ones((1, c)), torch.zeros((1, c))
    y = kin.instance_norm_fwd_plain(xt, ones, zeros, relu=True)
    got = _as_kernel(xt, dyt, ones, True, y, plan)
    want = kin.instance_norm_bwd_plain(xt, dyt, ones, zeros, relu=True, y=y)
    for name, g, wnt, tol in zip(("dx", "dscale", "dbias"), got, want,
                                 (TOL[dtype], TOL_AFFINE[dtype], TOL_AFFINE[dtype])):
        errs = _errs(_np(g), _np(wnt))
        assert max(errs) <= tol, (name, errs)


def test_wrapper_on_the_cpu_ignores_a_forced_plan():
    """A forced plan is for measurements on the card: CPU tensors still take
    the plain version and count no launch."""
    x, dy, scale, bias = _inputs((1, 5, 5, 8), 25)
    args = (torch.tensor(x).reshape(1, 25, 8), torch.tensor(dy).reshape(1, 25, 8),
            torch.tensor(scale), torch.tensor(bias))
    before = dict(kin.LAUNCHES)
    forced = kin.instance_norm_bwd(*args, _plan=kin.BwdPlan("cluster", 8, 2))
    for a, b_ in zip(forced, kin.instance_norm_bwd_plain(*args)):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    assert kin.LAUNCHES == before
