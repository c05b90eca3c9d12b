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
from heuristique_style_transfer_code_tpu.ops.pooling import _pool_matrix_np
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
    kgram.pooled_gram_fwd(f, 3)
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
        kgram.pooled_gram_fwd(f, 3)


# ------------------------------------------------- gram_fwd launch plan
# (n, hw, c): the main path's three shapes, then C in {48, 200} by HW in
# {49, 143} at N = 1, then two that split HW at small C
_PLAN_SHAPES = [(4, 3136, 64), (4, 3136, 256), (4, 49, 2048),
                (1, 49, 48), (1, 143, 48), (1, 49, 200), (1, 143, 200),
                (1, 1024, 80), (2, 4096, 40)]
_SMS = 132  # the H100 SXM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_gram_fwd_plan_covers_g_and_hw_once(shape, dtype):
    """The triangle tiles and their mirrors cover every (i, j) of every
    image once; the splits cover every HW row once; wgmma exactly for bf16
    with C % 8 == 0."""
    n, hw, c = shape
    route, tiles, splits, rows = kgram._gram_fwd_plan(n, hw, c, _SMS, dtype)
    assert route == ("wgmma" if dtype == torch.bfloat16 and c % 8 == 0 else "ffma")
    edge = kgram._TILE
    side = -(-c // edge)
    assert tiles == side * (side + 1) // 2
    cover = np.zeros((n, c, c), np.int32)
    for img in range(n):  # the grid's z axis: every image gets every tile
        for t in range(tiles):
            bi, bj = kgram._triangle_tile(t)
            assert 0 <= bi <= bj < side
            rs = slice(bi * edge, (bi + 1) * edge)
            cs = slice(bj * edge, (bj + 1) * edge)
            cover[img, rs, cs] += 1
            if bi != bj:
                cover[img, cs, rs] += 1
    assert (cover == 1).all()

    assert splits in (1, 2, 4, 8, 16) and splits <= max(1, hw // 128)
    step = 16 if route == "ffma" else (64 if hw <= 64 else 128)
    assert rows % step == 0  # splits start on a stage boundary
    ranges = kgram._split_rows(hw, splits, rows)
    assert len(ranges) == splits
    covered = np.zeros(hw, np.int32)
    for begin, end in ranges:
        covered[begin:end] += 1
    assert (covered == 1).all()


def test_gram_fwd_plan_misaligned_bf16_takes_ffma():
    """TMA needs a 16-byte-aligned base: a misaligned bf16 view goes FFMA."""
    assert kgram._gram_fwd_plan(2, 100, 64, _SMS, torch.bfloat16)[0] == "wgmma"
    assert kgram._gram_fwd_plan(2, 100, 64, _SMS, torch.bfloat16, aligned=False)[0] == "ffma"


def _assemble_as_kernel(f: torch.Tensor, splits: int, rows: int) -> torch.Tensor:
    """G built as gram_fwd's blocks build it, in f32: per upper-triangle
    tile, one plain product per HW split, the splits added in order, scaled
    by the reciprocal of HW, written to the tile and its mirror."""
    n, hw, c = f.shape
    edge = kgram._TILE
    side = -(-c // edge)
    inv = torch.tensor(1.0, dtype=torch.float32) / hw
    g = torch.full((n, c, c), float("nan"), dtype=torch.float32)
    for img in range(n):
        for t in range(side * (side + 1) // 2):
            bi, bj = kgram._triangle_tile(t)
            rs = slice(bi * edge, (bi + 1) * edge)
            cs = slice(bj * edge, (bj + 1) * edge)
            acc = None
            for begin, end in kgram._split_rows(hw, splits, rows):
                part = f[img, begin:end, rs].t() @ f[img, begin:end, cs]
                acc = part if acc is None else acc + part
            tile = acc * inv
            g[img, rs, cs] = tile
            if bi != bj:
                g[img, cs, rs] = tile.t()
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 7, 48), (1, 13, 11, 200), (1, 32, 32, 80),
                                   (2, 64, 64, 40)])
def test_gram_fwd_tiles_and_splits_assemble_g(shape, dtype):
    """The kernels' decomposition (plan of the given dtype, computed in f32)
    against the plain version and the JAX XLA Gram on the same input."""
    n, h, w, c = shape
    x = np.abs(_x(shape, 5))  # post-ReLU-like: off-diagonal entries matter
    f = torch.from_numpy(x).reshape(n, h * w, c)
    _, _, splits, rows = kgram._gram_fwd_plan(n, h * w, c, _SMS, dtype)
    got = _assemble_as_kernel(f, splits, rows)
    np.testing.assert_allclose(got.numpy(), kgram.gram_fwd_plain(f).numpy(), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_gram(jnp.asarray(x))), **F32)


# ------------------------------------------ pooled_gram_fwd bins and plan
# (C, S): S | C, C % S != 0 (the main path's 256/7), C < S, S = 1, S = 16,
# C = 2048 (bins of 292-293 channels)
_BIN_CASES = [(64, 8), (256, 7), (5, 7), (3, 16), (64, 1), (256, 16), (203, 16), (2048, 7)]


@pytest.mark.parametrize("c,s", _BIN_CASES)
def test_pool_bins_equal_the_pool_matrix(c, s):
    """The kernel's bin formula gives exactly the support and the f32
    weights of ``adaptive_pool_matrix(C, S)`` (the JAX package's P)."""
    want = _pool_matrix_np(c, s)
    got = np.zeros_like(want)
    for o, (lo, hi, w) in enumerate(kgram._pool_bins(c, s)):
        got[o, lo:hi] = w
    np.testing.assert_array_equal(got, want)


# (n, hw): the classification path's four stages at b8, then ragged and
# small ones (hw < 16 keeps fewer splits)
_POOLED_PLAN = [(8, 3136), (8, 784), (8, 196), (8, 49), (2, 143), (1, 63), (2, 25),
                (1, 1), (1, 6), (16, 49), (4, 3136), (200, 49)]


@pytest.mark.parametrize("n,hw", _POOLED_PLAN)
def test_pooled_gram_plan_covers_hw_once(n, hw):
    splits, rows = kgram._pooled_gram_plan(n, hw, _SMS)
    assert splits in (1, 2, 4, 8, 16) and splits <= hw
    if splits < 16 and 2 * splits <= hw:
        assert n * splits >= _SMS  # stopped only once the SMs are filled
    ranges = kgram._pooled_split_rows(hw, splits)
    assert len(ranges) == splits
    covered = np.zeros(hw, np.int32)
    for begin, end in ranges:
        assert 1 <= end - begin <= rows
        covered[begin:end] += 1
    assert (covered == 1).all()
    assert kgram._pooled_gram_plan(8, 3136, _SMS)[0] == 16  # 128 blocks at b8


def _pooled_as_kernel(f: torch.Tensor, s: int, splits: int) -> torch.Tensor:
    """The pooled Gram built as pooled_gram_kernel builds it, in f32: per
    HW split, each row's bin sums times the bin's weight, the split's
    partial sum of outer products; partials added in split order, scaled by
    the reciprocal of HW and cast once."""
    n, hw, c = f.shape
    ff = f.float()
    bins = kgram._pool_bins(c, s)
    inv = torch.tensor(1.0, dtype=torch.float32) / hw
    out = torch.empty((n, s, s), dtype=torch.float32)
    for img in range(n):
        acc = None
        for begin, end in kgram._pooled_split_rows(hw, splits):
            rows = ff[img, begin:end]
            means = torch.stack([rows[:, lo:hi].sum(1) * w for lo, hi, w in bins], 1)
            part = means.t() @ means
            acc = part if acc is None else acc + part
        out[img] = acc * inv
    return out.to(f.dtype)


@pytest.mark.parametrize("shape,s", [((2, 7, 7, 256), 7), ((2, 13, 11, 200), 7),
                                     ((1, 9, 7, 203), 16), ((2, 5, 5, 5), 7),
                                     ((1, 4, 4, 2048), 7), ((3, 6, 6, 64), 1)])
def test_pooled_gram_decomposition_matches_jax_f32(shape, s):
    """The kernel's decomposition against JAX's XLA pooled Gram and the
    Pallas kernel in interpret mode, at 1e-4 (only the order of sums
    differs)."""
    n, h, w, c = shape
    x = np.abs(_x(shape, 6))
    f = torch.from_numpy(x).reshape(n, h * w, c)
    splits, _ = kgram._pooled_gram_plan(n, h * w, _SMS)
    got = _pooled_as_kernel(f, s, splits).numpy()
    np.testing.assert_allclose(got, np.asarray(j_pooled(jnp.asarray(x), s)), **F32)
    np.testing.assert_allclose(
        got, np.asarray(pooled_gram_pallas(jnp.asarray(x), s, interpret=True)), **F32
    )
    np.testing.assert_allclose(got, kgram.pooled_gram_fwd_plain(f, s).numpy(), **F32)


@pytest.mark.parametrize("shape,s", [((2, 7, 7, 256), 7), ((2, 5, 5, 5), 7),
                                     ((1, 9, 7, 203), 16)])
def test_pooled_gram_decomposition_matches_jax_bf16(shape, s):
    """On bf16 inputs, cast once at the end: within 2e-2 of max|G| of JAX's
    XLA pooled Gram and of the Pallas kernel in interpret mode."""
    n, h, w, c = shape
    x = np.abs(_x(shape, 7))
    jx = jnp.asarray(x, jnp.bfloat16)
    f = torch.from_numpy(x).to(torch.bfloat16).reshape(n, h * w, c)
    splits, _ = kgram._pooled_gram_plan(n, h * w, _SMS)
    got = _pooled_as_kernel(f, s, splits)
    assert got.dtype == torch.bfloat16
    for want in (j_pooled(jx, s), pooled_gram_pallas(jx, s, interpret=True)):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_pooled_gram_phases_tool_finds_its_anchors():
    """tools/pooled_gram_phases.py builds gram.cu with the sums, or the sums
    and the products, taken out; the lines it takes out must still exist."""
    from heuristique_style_transfer_code_tpu_torch.tools import pooled_gram_phases as tool

    with open(kgram.LIBRARY.source) as f:
        src = f.read()
    variants = tool._variants(src)
    assert variants["full"] == src
    assert tool.SUMS not in variants["no_sums"]
    assert all(a in variants["no_sums"] for a in tool.PRODUCTS)
    assert not any(a in variants["stream_only"] for a in (tool.SUMS, *tool.PRODUCTS))


@pytest.mark.parametrize("dtype,c,aligned,want", [
    (torch.float32, 256, True, "bulk"), (torch.bfloat16, 2048, True, "bulk"),
    (torch.float32, 200, True, "bulk"),       # 800 bytes a row
    (torch.bfloat16, 200, True, "bulk"),      # 400
    (torch.float32, 203, True, "scalar"), (torch.bfloat16, 204, True, "scalar"),
    (torch.float32, 5, True, "scalar"),       # C = 5 < S
    (torch.bfloat16, 256, False, "scalar"),   # a base off 16 bytes
])
def test_pooled_gram_route(dtype, c, aligned, want):
    """Bulk copies exactly where a row is a whole number of 16-byte chunks on
    an aligned base, as gram_fwd's cp.async route and TMA need."""
    assert kgram._pooled_gram_route(dtype, c, 7, aligned) == want
    assert kgram._pooled_gram_route(dtype, c, kgram.MAX_POOL_SIZE, aligned) == want


# ------------------------------------------- pooled_gram_fwd for S > 16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,s", [(256, 17), (200, 24), (2048, 40), (5, 20)])
def test_pooled_gram_route_projects_past_16(dtype, c, s):
    """Past MAX_POOL_SIZE every input takes the two-launch "project" route,
    aligned or not."""
    for aligned in (True, False):
        assert kgram._pooled_gram_route(dtype, c, s, aligned) == "project"


def _pooled_projected_as_kernels(f: torch.Tensor, s: int) -> torch.Tensor:
    """The pooled Gram built as the "project" route builds it: Y = each
    row's bin sums times the bin's f32 weight, in f32 (pooled_project_kernel),
    then gram_fwd's FFMA decomposition of Y (plan of an f32 (N, HW, S)
    input), cast once to f's dtype."""
    n, hw, c = f.shape
    ff = f.float()
    y = torch.stack([ff[..., lo:hi].sum(-1) * w for lo, hi, w in kgram._pool_bins(c, s)], -1)
    route, _, splits, rows = kgram._gram_fwd_plan(n, hw, s, _SMS, torch.float32)
    assert route == "ffma"
    return _assemble_as_kernel(y, splits, rows).to(f.dtype)


@pytest.mark.parametrize("s", [24, 40])
@pytest.mark.parametrize("shape", [(2, 13, 11, 200), (1, 4, 4, 2048), (2, 5, 5, 5)])
def test_pooled_gram_projection_matches_jax_f32(shape, s):
    """The "project" route's decomposition against JAX's XLA pooled Gram and
    the Pallas kernel in interpret mode at 1e-4; C = 5 < S puts a channel
    in several bins."""
    n, h, w, c = shape
    x = np.abs(_x(shape, 8))
    f = torch.from_numpy(x).reshape(n, h * w, c)
    got = _pooled_projected_as_kernels(f, s).numpy()
    assert got.shape == (n, s, s)
    np.testing.assert_allclose(got, np.asarray(j_pooled(jnp.asarray(x), s)), **F32)
    np.testing.assert_allclose(
        got, np.asarray(pooled_gram_pallas(jnp.asarray(x), s, interpret=True)), **F32
    )
    np.testing.assert_allclose(got, kgram.pooled_gram_fwd_plain(f, s).numpy(), **F32)


@pytest.mark.parametrize("s", [24, 40])
@pytest.mark.parametrize("shape", [(2, 13, 11, 200), (1, 4, 4, 2048), (2, 5, 5, 5)])
def test_pooled_gram_projection_matches_jax_bf16(shape, s):
    """On bf16 inputs, cast once at the end: within 2e-2 of max|G| of JAX's
    XLA pooled Gram and of the Pallas kernel in interpret mode."""
    n, h, w, c = shape
    x = np.abs(_x(shape, 9))
    jx = jnp.asarray(x, jnp.bfloat16)
    f = torch.from_numpy(x).to(torch.bfloat16).reshape(n, h * w, c)
    got = _pooled_projected_as_kernels(f, s)
    assert got.dtype == torch.bfloat16
    for want in (j_pooled(jx, s), pooled_gram_pallas(jx, s, interpret=True)):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


# ------------------------------------------------- gram_bwd launch plan
# (n, hw, c): the style loop's three shapes, then the ragged ones of
# chip_smoke.py: C = 200 at HW = 143, C = 48 at HW = 49, C = 203 at HW = 63
_BWD_PLAN_SHAPES = [(4, 3136, 64), (4, 3136, 256), (4, 49, 2048),
                    (1, 143, 200), (2, 49, 48), (1, 63, 203)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _BWD_PLAN_SHAPES)
def test_gram_bwd_plan_covers_df_and_c_once(shape, dtype):
    """The row and column tiles cover every (row, col) of dF once, no tile
    lies wholly past the edge, and the k-splits cover every channel once in
    whole stages."""
    n, hw, c = shape
    route, row_tile, col_tiles, k_splits, k_per_split = kgram._gram_bwd_plan(n, hw, c, _SMS, dtype)
    assert route == ("wgmma" if dtype == torch.bfloat16 and c % 8 == 0 else "ffma")
    assert row_tile == 64 or (row_tile == 128 and hw > 64)
    assert row_tile * kgram._bwd_col_tile(route, row_tile) in (64 * 128, 64 * 64, 128 * 128)
    col = kgram._bwd_col_tile(route, row_tile)
    row_tiles = -(-hw // row_tile)
    assert (row_tiles - 1) * row_tile < hw and (col_tiles - 1) * col < c <= col_tiles * col
    cover = np.zeros((hw, c), np.int32)
    for rt in range(row_tiles):
        for ct in range(col_tiles):
            cover[rt * row_tile:(rt + 1) * row_tile, ct * col:(ct + 1) * col] += 1
    assert (cover == 1).all()

    assert k_splits in (1, 2, 4, 8, 16)
    assert k_per_split % kgram._BWD_STAGE_K[route] == 0
    ranges = kgram._k_ranges(c, k_splits, k_per_split)
    assert len(ranges) == k_splits
    covered = np.zeros(c, np.int32)
    for begin, end in ranges:
        covered[begin:end] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("dtype,c,aligned,want", [
    (torch.bfloat16, 256, True, "wgmma"), (torch.bfloat16, 48, True, "wgmma"),
    (torch.bfloat16, 256, False, "ffma"),   # a base off 16 bytes: no TMA
    (torch.bfloat16, 203, True, "ffma"),    # C % 8 != 0
    (torch.bfloat16, 60, True, "ffma"),
    (torch.float32, 256, True, "ffma"),     # f32 stays off the tensor cores
])
def test_gram_bwd_route(dtype, c, aligned, want):
    assert kgram._gram_bwd_plan(2, 100, c, _SMS, dtype, aligned)[0] == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_bwd_plan_splits_c_at_layer4_only(dtype):
    """Layer4's (4, 49, 2048) leaves the SMs idle without a split of C; the
    other main shapes fill them with output tiles alone."""
    assert kgram._gram_bwd_plan(4, 49, 2048, _SMS, dtype)[3] > 1
    assert kgram._gram_bwd_plan(4, 3136, 256, _SMS, dtype)[3] == 1
    assert kgram._gram_bwd_plan(4, 3136, 64, _SMS, dtype)[3] == 1


def _gram_bwd_as_kernel(f: torch.Tensor, dg: torch.Tensor, plan) -> torch.Tensor:
    """dF built as gram_bwd's blocks build it, in f32: per (row tile, col
    tile), one partial per k-split (wgmma: F dG + F dG^T as two products
    into one sum; ffma: F (dG + dG^T) with the transposed tile added first),
    the splits added in order, scaled by the reciprocal of HW, cast once."""
    route, row_tile, col_tiles, k_splits, k_per_split = plan
    n, hw, c = f.shape
    col = kgram._bwd_col_tile(route, row_tile)
    ff, dgf = f.float(), dg.float()
    inv = torch.tensor(1.0, dtype=torch.float32) / hw
    out = torch.full((n, hw, c), float("nan"), dtype=torch.float32)
    for img in range(n):
        for rt in range(-(-hw // row_tile)):
            rs = slice(rt * row_tile, (rt + 1) * row_tile)
            for ct in range(col_tiles):
                cs = slice(ct * col, (ct + 1) * col)
                acc = None
                for kb, ke in kgram._k_ranges(c, k_splits, k_per_split):
                    a = ff[img, rs, kb:ke]
                    b, bt = dgf[img, kb:ke, cs], dgf[img, cs, kb:ke].t()
                    part = a @ b + a @ bt if route == "wgmma" else a @ (b + bt)
                    acc = part if acc is None else acc + part
                out[img, rs, cs] = acc * inv
    return out.to(f.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 7, 48), (1, 13, 11, 200), (1, 7, 7, 512),
                                   (1, 12, 12, 64)])
def test_gram_bwd_decomposition_matches_jax_vjp(shape, dtype):
    """The kernels' decomposition (plan of the given dtype) against jax.vjp
    of JAX's ``gram_matrix_nhwc`` under a non-symmetric cotangent: 1e-4 in
    f32, 2e-2 of max|dF| in bf16. C = 48 and 200 leave ragged column
    tiles; (1, 7, 7, 512) splits C; HW = 144 takes a partial row tile."""
    n, h, w, c = shape
    x = np.abs(_x(shape, 10))
    cot = _x((n, c, c), 11)
    plan = kgram._gram_bwd_plan(n, h * w, c, _SMS, dtype)
    if shape == (1, 7, 7, 512):
        assert plan[3] > 1
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, vjp = jax.vjp(j_gram, jnp.asarray(x, jdt))
    want = np.asarray(vjp(jnp.asarray(cot, jdt))[0], np.float32).reshape(n, h * w, c)
    f = torch.from_numpy(x).to(dtype).reshape(n, h * w, c)
    dg = torch.from_numpy(cot).to(dtype)
    got = _gram_bwd_as_kernel(f, dg, plan)
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, **F32)
        np.testing.assert_allclose(got.numpy(), kgram.gram_bwd_plain(f, dg).numpy(), **F32)
    else:
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()
