"""Spatial partitioning of the port (``--shard_spatial``: each canvas's H
rows over the ``spatial`` axis of a (data, spatial) mesh) on the CPU: four
gloo ranks spawned once for the module run every case on a 2x2 mesh (data
2 x spatial 2) and a 1x4 mesh (``tests/torch_spatial_ranks.py`` holds
their bodies, which import no jax), against the port's one-device run of
the same cases and against JAX's spatial mesh.

Tolerances:
- the banded ops (convs, the max-pool, the layer and instance norms, the
  adaptive and global pools, the Grams) in float64, output and gradient,
  at 1e-10 of one device, odd heights and empty bands (H = 3 on 1x4)
  included; the TV term, which the loops take in f32 as JAX does, within
  f32's precision (1e-6 relative);
- the three loops in float64 at threshold 0 (family 2's texture loop also
  under ``remat``): the iteration count equal, the pixels within 1e-10 of
  one device, the texture loops' per-image losses within 1e-10 (their
  Grams round to f32 alike); the content+style loss within 1e-6, because
  its content and TV terms are f32 sums, which the bands add in another
  order; family 2's texture loop in bf16 (module's test);
- JAX's own spatial tests' loops (``make_style_transfer_optimizer`` and
  ``make_content_style_optimizer`` on a 3x3 conv's Gram, f32), single
  device and on ``make_mesh_spatial(8, spatial=4)``: JAX's tolerances, rtol
  1e-4 on the losses and atol 1e-4 on the pixels, the iteration counts
  equal;
- ``make_spatial_eval_step`` (family 1, f32) against JAX's on
  ``make_mesh_spatial(8, spatial=4)``: rtol 1e-4, atol 1e-5 (JAX's test);
  against the port's one device within 1e-6 relative (f32 band sums);
- the CLIs under ``--shard_spatial``: rank 0 writes the one-device run's
  PNGs, each once, within one uint8 level.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.parallel import multihost
from tests import torch_spatial_ranks as R

F64_TOL = 1e-10
MESHES = tuple(R.MESHES)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_inputs(inputs: dict) -> None:
    """JAX's spatial tests' conv, images and targets (``tests/test_tasks.py``,
    ``tests/test_content_style.py``), as numpy."""
    import jax

    from heuristique_style_transfer_code_tpu.ops.conv import conv2d, conv2d_init
    from heuristique_style_transfer_code_tpu.ops.gram import gram_matrix_nhwc

    conv = conv2d_init(jax.random.PRNGKey(7), 3, 8, 3)
    inputs["jax_kernel"] = np.asarray(conv["kernel"])
    inputs["jax_bias"] = np.asarray(conv["bias"])
    target = jax.random.uniform(jax.random.PRNGKey(0), (2, 16, 16, 3))
    inputs["jax_targets"] = np.asarray(gram_matrix_nhwc(conv2d(conv, target, 1, 1)))
    inputs["jax_noise"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 16, 3)))
    style = jax.random.uniform(jax.random.PRNGKey(24), (2, 16, 16, 3))
    feats = conv2d(conv, style, 1, 1)
    inputs["jax_cs_feats"] = np.asarray(feats)
    inputs["jax_cs_targets"] = np.asarray(gram_matrix_nhwc(feats))
    inputs["jax_cs_noise"] = np.asarray(jax.random.normal(jax.random.PRNGKey(26), style.shape))


def _write_models(in_dir: str, inputs: dict) -> None:
    """The loops' and the CLIs' weight trees (the port's seeded weights in
    the JAX layout) and the CLIs' configs."""
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        truncated_resnet50_init,
    )

    for t in (R.F2_TRUNCATE, 8):
        inputs[f"f2_tree_{t}"] = to_jax_tree(gram_attention_init(
            torch.Generator().manual_seed(t), t, 4, R.F2_S, device="cpu"))
    inputs["f3_tree"] = to_jax_tree(multiscale_test_init(
        torch.Generator().manual_seed(1), R.F3_PATCHES, ndf=8, num_classes=4,
        gram_matrix_dim=R.F3_GDIM, norm="instance", device="cpu"))
    inputs["f1_tree"] = to_jax_tree(truncated_resnet50_init(
        torch.Generator().manual_seed(2), R.EVAL_TRUNCATE, 4, 16, device="cpu"))
    save_pytree_npz(inputs["f2_tree_8"], os.path.join(in_dir, "f2.npz"))
    save_pytree_npz(inputs["f3_tree"], os.path.join(in_dir, "f3.npz"))
    with open(os.path.join(in_dir, "f2.json"), "w") as f:
        json.dump({"batch_size": 4, "lr": 0.01, "truncate_layer": 8,
                   "gram_matrix_size": R.F2_S, "num_classes": 4, "seed": 0}, f)
    with open(os.path.join(in_dir, "f3.json"), "w") as f:
        json.dump({"batch_size": 4, "seed": 0, "ndf": 8, "gram_matrix_dim": R.F3_GDIM,
                   "num_classes": 4, "norm": "instance", "patch_sizes": R.F3_PATCHES}, f)


def _inputs(in_dir: str, data: str) -> dict:
    from PIL import Image

    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    rng = np.random.RandomState(0)
    inputs = {}
    _write_models(in_dir, inputs)
    _jax_inputs(inputs)
    inputs["f2_noise"] = rng.randn(R.B, R.F2_PX, R.F2_PX, 3)
    inputs["f3_noise"] = rng.randn(R.B, R.F3_PX, R.F3_PX, 3)
    inputs["cs_style"] = rng.randn(1, R.CS_PX, R.CS_PX, 3)
    inputs["cs_content"] = rng.randn(R.B, R.CS_PX, R.CS_PX, 3)
    inputs["eval_u8"] = rng.randint(0, 256, (4, R.EVAL_PX, R.EVAL_PX, 3)).astype(np.uint8)
    with torch.no_grad():
        inputs["f2_targets"] = pst.make_gram_fn_gram_attention(R.f2_model(inputs), R.F2_TRUNCATE)(
            torch.from_numpy(rng.randn(R.B, R.F2_PX, R.F2_PX, 3)))[0].numpy()
        inputs["f3_targets"] = pst.make_gram_fn_patches(R.f3_model(inputs), R.F3_GDIM,
                                                        norm="instance")(
            torch.from_numpy(rng.randn(R.B, R.F3_PX, R.F3_PX, 3)))[0].numpy()
    style = os.path.join(in_dir, "style.png")
    Image.fromarray(rng.randint(0, 256, (48, 48, 3)).astype(np.uint8)).save(style)
    save_pytree_npz(inputs, os.path.join(in_dir, "inputs.npz"))
    with open(os.path.join(in_dir, "paths.json"), "w") as f:
        json.dump({"_data": data, "_in": in_dir, "_style": style}, f)
    return R.load_inputs(in_dir)


def _jax_runs(inputs: dict) -> dict:
    """JAX's two loops, single device and on ``make_mesh_spatial(8,
    spatial=4)``, and its spatial eval step, on the same inputs."""
    import jax
    import jax.numpy as jnp

    from heuristique_style_transfer_code_tpu.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import combined_apply
    from heuristique_style_transfer_code_tpu.ops.conv import conv2d
    from heuristique_style_transfer_code_tpu.ops.gram import gram_matrix_nhwc
    from heuristique_style_transfer_code_tpu.parallel.sharding import (
        make_mesh_spatial,
        make_spatial_eval_step,
    )
    from heuristique_style_transfer_code_tpu.tasks.style_transfer import (
        make_content_style_optimizer,
        make_style_transfer_optimizer,
    )

    conv = {"kernel": jnp.asarray(inputs["jax_kernel"]), "bias": jnp.asarray(inputs["jax_bias"])}

    def gram_fn(imgs):
        return [gram_matrix_nhwc(conv2d(conv, imgs, stride=1, padding=1))]

    def extract(imgs):
        feats = conv2d(conv, imgs, stride=1, padding=1)
        return feats, [gram_matrix_nhwc(feats)]

    mesh = make_mesh_spatial(8, spatial=4)
    assert dict(mesh.shape) == {"data": 2, "spatial": 4}
    out = {}
    for tag, m in (("single", None), ("spatial", mesh)):
        run = make_style_transfer_optimizer(gram_fn, 0.05, 40, 1e-4, mesh=m)
        pixels, iters, per = run(jnp.asarray(inputs["jax_noise"]),
                                 [jnp.asarray(inputs["jax_targets"])])
        out[f"jax_texture_{tag}"] = (np.asarray(pixels), int(iters), np.asarray(per))
        run = make_content_style_optimizer(extract, 1.0, 0.5, 0.05, 40, 1e-4, tv_weight=0.1,
                                           mesh=m)
        pixels, iters, per = run(jnp.asarray(inputs["jax_cs_noise"]),
                                 [jnp.asarray(inputs["jax_cs_targets"])],
                                 jnp.asarray(inputs["jax_cs_feats"]))
        out[f"jax_content_style_{tag}"] = (np.asarray(pixels), int(iters), np.asarray(per))
    tree = jax.tree_util.tree_map(jnp.asarray, inputs["f1_tree"])

    def forward_eval(v, images):
        return combined_apply(v["moco"], v["classifier"], images, R.EVAL_TRUNCATE)[0]

    step = make_spatial_eval_step(forward_eval, mesh, R.EVAL_CROP)
    out["eval_step"] = np.asarray(step(tree, jnp.asarray(inputs["eval_u8"])))
    out["eval_step_single"] = np.asarray(jax.jit(
        lambda v, x: forward_eval(v, eval_preprocess(x, R.EVAL_CROP)))(
            tree, jnp.asarray(inputs["eval_u8"])))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny_imagefolder):
    """(the one-device results, each mesh's rank results, JAX's results,
    the one-device and the ranks' output directories, the spawn's
    seconds)."""
    root = tmp_path_factory.mktemp("spatial")
    in_dir, one_dir, ranks_dir = (str(root / d) for d in ("in", "one", "ranks"))
    for d in (in_dir, one_dir, ranks_dir):
        os.makedirs(d)
    inputs = _inputs(in_dir, str(tiny_imagefolder))
    spawn = {}

    def ranks_job():
        t0 = time.perf_counter()
        try:
            multihost.launch(4, None, [], target=R.rank_main, target_args=(in_dir, ranks_dir),
                             rendezvous_dir=str(root), deadline_s=200.0)
        except SystemExit as e:
            spawn["error"] = e
        spawn["seconds"] = time.perf_counter() - t0

    job = threading.Thread(target=ranks_job)
    job.start()  # the ranks run while this process takes the one-device and JAX runs
    try:
        one = R.run_cases(None, inputs, one_dir)
        jax_out = _jax_runs(inputs)
    finally:
        job.join()
    assert "error" not in spawn, spawn
    ranks = {m: [load_pytree_npz(os.path.join(ranks_dir, m, f"rank{r}.npz")) for r in range(4)]
             for m in MESHES}
    return one, ranks, jax_out, one_dir, ranks_dir, spawn["seconds"]


@pytest.mark.parametrize("h", R.OP_HEIGHTS)
@pytest.mark.parametrize("name", R.OP_NAMES)
@pytest.mark.parametrize("mesh", MESHES)
def test_banded_op_matches_one_device(runs, mesh, name, h):
    """Each banded op's output and input gradient, put back together from
    the bands, on every rank: one device's at 1e-10 in float64 (TV: f32,
    module docstring)."""
    one, ranks = runs[0], runs[1]
    want = one["ops"][R.op_key(name, h)]
    for rank in ranks[mesh]:
        got = rank["ops"][R.op_key(name, h)]
        for part in ("out", "grad"):
            assert got[part].shape == want[part].shape, (part, got[part].shape)
            if name == "total_variation":
                scale = np.abs(want[part]).max()
                np.testing.assert_allclose(got[part], want[part], rtol=1e-6, atol=1e-6 * scale)
            else:
                np.testing.assert_allclose(got[part], want[part], rtol=0, atol=F64_TOL,
                                           err_msg=part)


LOOPS = ("f2_texture", "f2_texture_remat", "content_style", "f3_texture")


@pytest.mark.parametrize("case", LOOPS)
@pytest.mark.parametrize("mesh", MESHES)
def test_style_loop_matches_one_device(runs, mesh, case):
    """The loop on the mesh (its pixels and Adam moments bands, the loss
    the group's): one device's iteration count, pixels at 1e-10, per-image
    losses at 1e-10 (content+style: 1e-6, module docstring), on every
    rank."""
    one, ranks = runs[0], runs[1]
    want = one[case]
    assert int(want["iters"]) == R.ITERS
    loss_tol = 1e-6 if case == "content_style" else F64_TOL
    for rank in ranks[mesh]:
        got = rank[case]
        assert int(got["iters"]) == R.ITERS
        np.testing.assert_allclose(got["per"], want["per"], rtol=loss_tol, atol=0)
        np.testing.assert_allclose(got["pixels"], want["pixels"], rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_bf16_texture_loop_stays_near_one_device(runs, mesh):
    """``compute_dtype=bfloat16`` (``--precision bf16``) on the mesh: the
    encoder in bf16, its Grams' band partials rounded to bf16 before the
    group's sum, the pixels and the loss f32. Against one device's bf16
    loop: the iterations equal, the losses within 2e-2 relative, the
    pixels within 2 lr an iteration (Adam's bound: a gradient component's
    sign) and, by RMS, within 1.5 times one device's own bf16 error
    against its float64 loop (the port's bf16 rule)."""
    one, ranks = runs[0], runs[1]
    want = one["f2_texture_bf16"]
    own = np.sqrt(np.mean(np.square(want["pixels"] - one["f2_texture"]["pixels"])))
    for rank in ranks[mesh]:
        got = rank["f2_texture_bf16"]
        assert int(got["iters"]) == int(want["iters"]) == R.ITERS
        np.testing.assert_allclose(got["per"], want["per"], rtol=2e-2)
        gap = got["pixels"] - want["pixels"]
        assert np.abs(gap).max() <= 2 * R.LR * R.ITERS + 1e-6
        assert np.sqrt(np.mean(np.square(gap))) <= 1.5 * own, (np.sqrt(np.mean(gap ** 2)), own)


@pytest.mark.parametrize("case", ("jax_texture", "jax_content_style"))
@pytest.mark.parametrize("mesh", MESHES)
def test_jax_spatial_loops_match(runs, mesh, case):
    """JAX's spatial tests' loops: the port on the mesh against JAX single
    device and on its spatial mesh (data 2 x spatial 4), at JAX's
    tolerances; the port's one device against JAX too."""
    one, ranks, jax_out = runs[0], runs[1], runs[2]
    for tag in ("single", "spatial"):
        j_pixels, j_iters, j_per = jax_out[f"{case}_{tag}"]
        for got in (ranks[mesh][0][case], one[case]):
            assert int(got["iters"]) == j_iters
            np.testing.assert_allclose(got["per"], j_per, rtol=1e-4)
            np.testing.assert_allclose(got["pixels"], j_pixels, atol=1e-4)


@pytest.mark.parametrize("mesh", MESHES)
def test_spatial_eval_step_matches_jax(runs, mesh):
    """``make_spatial_eval_step`` (family 1, truncate 5, uint8 in, a 64²
    crop): every rank returns the batch's logits, JAX's spatial step's
    within rtol 1e-4, atol 1e-5, and the port's one device's within 1e-6."""
    one, ranks, jax_out = runs[0], runs[1], runs[2]
    for rank in ranks[mesh]:
        got = rank["eval_step"]["logits"]
        np.testing.assert_allclose(got, jax_out["eval_step"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, one["eval_step"]["logits"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(jax_out["eval_step"], jax_out["eval_step_single"], rtol=1e-4,
                               atol=1e-5)


def _pngs(root: str) -> dict:
    from PIL import Image

    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".png"):
                path = os.path.join(dirpath, name)
                with Image.open(path) as im:
                    # family 3's names carry a millisecond time stamp
                    key = "_".join(os.path.relpath(path, root).split("_")[:-1]) \
                        if "style_transfer_" in name and name.count("_") == 4 \
                        else os.path.relpath(path, root)
                    out[key] = np.asarray(im, np.int16)
    return out


@pytest.mark.parametrize("case", tuple(R.CLI_CASES))
def test_cli_shard_spatial_writes_the_one_device_pngs(runs, case):
    """The CLI under ``--shard_spatial`` (2 on the 2x2 mesh, 4 on 1x4), each
    rank joining the ranks' group: rank 0 wrote the one-device run's PNGs,
    each once, within one uint8 level."""
    _, _, _, one_dir, ranks_dir, _ = runs
    on = R.CLI_CASES[case][0]
    want, got = _pngs(os.path.join(one_dir, case)), _pngs(os.path.join(ranks_dir, on, case))
    assert sorted(got) == sorted(want) and want, (sorted(want), sorted(got))
    for name, img in want.items():
        assert np.abs(got[name] - img).max() <= 1, name


@pytest.mark.parametrize("height,ranks", [(7, 2), (7, 4), (3, 4), (224, 2), (13, 3)])
def test_row_sharding_bands_and_windows(height, ranks):
    """``RowSharding``: contiguous bands covering the map, the first height
    % ranks one row taller (empty ones last); each rank's input rows of a
    window (k, s, p) are exactly the rows its output band's windows read."""
    from heuristique_style_transfer_code_tpu_torch.parallel.sharding import RowSharding

    rs = RowSharding(height, ranks)
    sizes = [b - a for a, b in rs.bands]
    assert rs.bands[0][0] == 0 and rs.bands[-1][1] == height and sum(sizes) == height
    assert all(rs.bands[i][1] == rs.bands[i + 1][0] for i in range(ranks - 1))
    assert sizes == sorted(sizes, reverse=True) and sizes[0] - sizes[-1] <= 1
    for k, s, p in ((3, 1, 1), (7, 2, 3), (4, 2, 1), (1, 2, 0), (3, 2, 1)):
        out = rs.window(k, s, p)
        assert out.height == (height + 2 * p - k) // s + 1
        for r in range(ranks):
            o0, o1 = out.rows(r)
            want = (o0 * s - p, (o1 - 1) * s - p + k) if o1 > o0 else (0, 0)
            assert rs.input_rows(r, k, s, p) == want


@pytest.mark.parametrize("n_devices,shard,batch", [
    (None, 2, 4), (None, 4, 1), (8, 4, 4), (8, 2, 4), (6, 4, 8), (8, 3, 2), (4, 8, 4),
    (3, 2, 5), (None, 16, 4),
])
def test_style_mesh_shape_matches_jax_clamp(n_devices, shard, batch, capsys):
    """The CLIs' (data, spatial) clamp (``cli/_common.style_mesh_shape``)
    with JAX's 8 devices: JAX ``resolve_style_mesh``'s mesh shape, the
    warning printed alike."""
    from heuristique_style_transfer_code_tpu.cli._common import resolve_style_mesh
    from heuristique_style_transfer_code_tpu_torch.cli._common import style_mesh_shape

    want = resolve_style_mesh(n_devices, shard, batch)
    j_printed = capsys.readouterr().out
    got = style_mesh_shape(n_devices, shard, batch, avail=8)
    assert got == (want.shape["data"], want.shape["spatial"])
    assert capsys.readouterr().out == j_printed


def test_band_entry_points_plain_match_the_unbanded_kernels():
    """The four banded K3/K3′ entry points' plain versions on one band (the
    whole image), merged as the ranks merge them: ``instance_norm_fwd``'s
    and ``instance_norm_bwd``'s plain outputs, in float64 at 1e-12."""
    from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin
    from heuristique_style_transfer_code_tpu_torch.parallel.spatial import _chan_merge

    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 37, 6), generator=g, dtype=torch.float64) * 3 + 5
    dy = torch.randn((2, 37, 6), generator=g, dtype=torch.float64)
    ones, zeros = torch.ones((2, 6), dtype=torch.float64), torch.zeros((2, 6), dtype=torch.float64)
    for relu in (False, True):
        parts = [kin.instance_norm_band_stats(x[:, a:b]) for a, b in ((0, 20), (20, 37))]
        n, mean, m2 = _chan_merge(parts).unbind(-1)
        coef = torch.stack([mean, torch.rsqrt(m2 / n + kin.EPS), 1 / n, 0 * n], dim=-1)
        y = kin.instance_norm_band_apply(x, coef, relu)
        torch.testing.assert_close(y, kin.instance_norm_fwd_plain(x, ones, zeros, relu=relu),
                                   rtol=0, atol=1e-12)
        sums = sum(kin.instance_norm_band_bwd_reduce(x[:, a:b], dy[:, a:b], coef, relu,
                                                     y[:, a:b]) for a, b in ((0, 20), (20, 37)))
        dx = kin.instance_norm_band_bwd_apply(x, dy, coef, sums, relu, y)
        want, dscale, dbias = kin.instance_norm_bwd_plain(x, dy, ones, zeros, relu=relu, y=y)
        torch.testing.assert_close(dx, want, rtol=0, atol=1e-12)
        torch.testing.assert_close(sums, torch.stack([dbias, dscale], dim=-1), rtol=0,
                                   atol=1e-12)


def _band_op_case(name: str):
    from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin

    g = torch.Generator().manual_seed(4)
    x, dy = (torch.randn((2, 9, 4), generator=g) for _ in range(2))
    coef = torch.stack([torch.randn((2, 4), generator=g), torch.rand((2, 4), generator=g) + 0.5,
                        torch.full((2, 4), 1 / 18.0), torch.zeros((2, 4))], dim=-1)
    y = kin.instance_norm_band_apply_plain(x, coef, True)
    sums = torch.randn((2, 4, 2), generator=g)
    return {"stats": (torch.ops.hst.instance_norm_band_stats.default, (x,)),
            "apply": (torch.ops.hst.instance_norm_band_apply.default, (x, coef, True)),
            "bwd_reduce": (torch.ops.hst.instance_norm_band_bwd_reduce.default,
                           (x, dy, coef, True, y)),
            "bwd_apply": (torch.ops.hst.instance_norm_band_bwd_apply.default,
                          (x, dy, coef, sums, True, y))}[name]


@pytest.mark.parametrize("name", ("stats", "apply", "bwd_reduce", "bwd_apply"))
def test_band_ops_pass_opcheck(name):
    """Each banded entry point is an ``hst`` op whose schema, fake
    implementation and vmap rule ``torch.library.opcheck`` accepts."""
    op, args = _band_op_case(name)
    torch.library.opcheck(op, args)


def test_band_entry_points_refuse_a_cpu_fallback_on_the_card_path():
    """A tensor on another device than the CPU launches the kernel or
    raises: on a host without CUDA the wrappers' checks refuse a meta
    tensor rather than taking the plain version."""
    from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin

    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kin.instance_norm_band_stats(x)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kin.instance_norm_band_apply(x, torch.empty((1, 8, 4), device="meta"))


def test_spawn_budget(runs):
    """The module's one spawn of four ranks, both meshes' cases on each,
    within 150 s."""
    assert runs[-1] < 150.0
