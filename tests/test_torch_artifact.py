"""The port's serving artifacts (``deploy/artifact.py``) and the
``torch.library`` ops they hold, on the CPU.

- ``torch.library.opcheck`` on each ``hst`` op at tiny shapes (schema,
  fake implementation, autograd registration), and the differentiable
  shims (``GramFunction``, ``PooledGramFunction``,
  ``InstanceNormFunction``) equal to the ops;
- inference artifacts of families 1, 2 and 3 (f32), family 1 in bf16 and
  yuv420 (int8: ``tests/test_torch_artifact_int8.py``; seeded port models
  in the JAX layout):
  exported with a symbolic batch, saved, loaded and run at b1 and b3 equal
  to the live infer function bit for bit, and to the JAX package's
  ``export_infer_artifact`` -> ``load_infer_artifact`` on the same
  checkpoint within 1e-5 on the
  probabilities in f32 (bf16: 5e-2, int8 on one quantised tree: 1e-3 and
  the argmax equal, the tolerances of ``tests/test_torch_serve_cli.py``);
  the graphs hold the ``hst`` ops (families 2 and 3);
- a static batch refusing another size; the platforms (``tpu`` and an
  absent card refused, no CUDA program in a CPU file); ``mesh=``; the
  format refusals both ways (JAX's loader on a port file, the port's on a
  JAX file); another torch version refused.

Sizes: truncate 5 (family 1 dim 16, family 2 S 4), family 3 at patch sizes
10/20/40 and ndf 8, 4 classes, 224² frames (the batcher's crop).
"""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.cli import serve as jcli
from heuristique_style_transfer_code_tpu.deploy import artifact as jart
from heuristique_style_transfer_code_tpu_torch.cli import serve as tcli
from heuristique_style_transfer_code_tpu_torch.deploy import artifact as tart
from heuristique_style_transfer_code_tpu_torch.ops.kernels import gram as kg
from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin
from heuristique_style_transfer_code_tpu_torch.tasks.camera import (
    make_camera_infer_fn,
    make_camera_infer_fn_yuv,
)

F3_PATCHES = {"small": 10, "medium": 20, "large": 40}
TOL = {"float32": dict(rtol=0, atol=1e-5), "bf16": dict(rtol=5e-2, atol=5e-2),
       "int8": dict(rtol=0, atol=1e-3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------- ops


def _r(*shape, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(dtype)


OP_CASES = {
    "gram_fwd": lambda: (torch.ops.hst.gram_fwd.default, (_r(2, 9, 5).requires_grad_(),)),
    "gram_bwd": lambda: (torch.ops.hst.gram_bwd.default, (_r(2, 9, 5), _r(2, 5, 5, seed=1))),
    "pooled_gram_fwd": lambda: (torch.ops.hst.pooled_gram_fwd.default, (_r(2, 9, 10), 3)),
    "pooled_gram_fwd_y": lambda: (torch.ops.hst.pooled_gram_fwd_y.default,
                                  (_r(2, 9, 10).requires_grad_(), 3)),
    "pooled_gram_bwd": lambda: (torch.ops.hst.pooled_gram_bwd.default,
                                (_r(2, 9, 3), _r(2, 3, 3, seed=1), 10, torch.float32)),
    "instance_norm_fwd": lambda: (torch.ops.hst.instance_norm_fwd.default,
                                  (_r(2, 12, 4).requires_grad_(), _r(2, 4, seed=1).abs() + 0.5,
                                   _r(2, 4, seed=2), kin.EPS, False)),
    "instance_norm_fwd_relu": lambda: (torch.ops.hst.instance_norm_fwd.default,
                                       (_r(2, 12, 4).requires_grad_(),
                                        _r(2, 4, seed=1).requires_grad_(),
                                        _r(2, 4, seed=2).requires_grad_(), kin.EPS, True)),
    "instance_norm_bwd": lambda: (torch.ops.hst.instance_norm_bwd.default,
                                  (_r(2, 12, 4), _r(2, 12, 4, seed=1), _r(2, 4, seed=2),
                                   _r(2, 4, seed=3), kin.EPS, False, None)),
    "instance_norm_bwd_relu": lambda: (
        torch.ops.hst.instance_norm_bwd.default,
        (_r(2, 12, 4), _r(2, 12, 4, seed=1), _r(2, 4, seed=2), _r(2, 4, seed=3), kin.EPS, True,
         kin.instance_norm_fwd_plain(_r(2, 12, 4), _r(2, 4, seed=2), _r(2, 4, seed=3),
                                     relu=True))),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_opcheck(case):
    op, args = OP_CASES[case]()
    torch.library.opcheck(op, args)


def test_shims_are_the_ops():
    f = _r(2, 9, 10)
    torch.testing.assert_close(kg.GramFunction.apply(f), torch.ops.hst.gram_fwd(f),
                               rtol=0, atol=0)
    torch.testing.assert_close(kg.PooledGramFunction.apply(f, 3),
                               torch.ops.hst.pooled_gram_fwd(f, 3), rtol=0, atol=0)
    fg = f.clone().requires_grad_(True)
    g = kg.PooledGramFunction.apply(fg, 3)
    want, y = torch.ops.hst.pooled_gram_fwd_y(f, 3)
    torch.testing.assert_close(g.detach(), want, rtol=0, atol=0)
    assert g.grad_fn is not None and y.shape == (2, 9, 3)
    x, s, b = _r(2, 12, 4), _r(2, 4, seed=1), _r(2, 4, seed=2)
    torch.testing.assert_close(kin.InstanceNormFunction.apply(x, s, b, kin.EPS, True),
                               torch.ops.hst.instance_norm_fwd(x, s, b, kin.EPS, True),
                               rtol=0, atol=0)


def test_gradients_trace_to_the_backward_ops():
    """A traced gradient holds the ``hst`` backward ops, each Gram and norm
    gradient equals the plain one, and the backward ops themselves refuse
    to be differentiated."""
    from torch.fx.experimental.proxy_tensor import make_fx

    f, x = _r(2, 9, 10), _r(2, 12, 4, seed=3)
    s, b = _r(2, 4, seed=1).abs() + 0.5, _r(2, 4, seed=2)

    def grads(f, x):
        loss = (kg.GramFunction.apply(f).square().sum()
                + kg.PooledGramFunction.apply(f, 3).square().sum()
                + kin.InstanceNormFunction.apply(x, s, b, kin.EPS, True).square().sum())
        return torch.autograd.grad(loss, (f, x))

    def traced(f, x):
        with torch.enable_grad():
            return grads(f.requires_grad_(True), x.requires_grad_(True))

    nodes = {str(n.target) for n in make_fx(traced)(f, x).graph.nodes}
    assert {"hst.gram_bwd.default", "hst.pooled_gram_bwd.default",
            "hst.instance_norm_bwd.default"} <= nodes
    fg, xg = f.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = grads(fg, xg)
    fp, xp = f.clone().requires_grad_(True), x.clone().requires_grad_(True)
    want = torch.autograd.grad(
        kg.gram_fwd_plain(fp).square().sum()
        + kg._pooled_gram_of_y(kg.pooled_gram_y_plain(fp, 3), fp.dtype).square().sum()
        + kin.instance_norm_fwd_plain(xp, s, b, relu=True).square().sum(), (fp, xp))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="hst::gram_bwd has no gradient"):
        torch.ops.hst.gram_bwd(fg, _r(2, 10, 10))


def test_prune_keeps_a_copying_to():
    """``_prune`` drops a no-op ``.to(dtype)`` and keeps one that asks for
    a copy (its output must not alias its input)."""

    class M(torch.nn.Module):
        def forward(self, x):
            return x.to(torch.float32, copy=True) * 2, x.to(torch.float32) * 3

    with torch.no_grad():
        ep = tart._prune(torch.export.export(M(), (torch.ones(3),), strict=False))
    to = [n.args for n in ep.graph.nodes if n.target is torch.ops.aten.to.dtype]
    assert len(to) == 1 and to[0][3] is True
    y2, y3 = ep.module()(torch.ones(3))
    assert torch.equal(y2, torch.full((3,), 2.0)) and torch.equal(y3, torch.full((3,), 3.0))


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU reaches the wrapper's kernel path: on a device
    other than CUDA that raises, never the plain formula."""
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kg.gram_fwd(torch.empty(2, 9, 5, device="meta"))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kin.instance_norm_fwd(torch.empty(2, 9, 4, device="meta"),
                              torch.empty(2, 4, device="meta"), torch.empty(2, 4, device="meta"))


# ------------------------------------------------------------- artifacts


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """family -> (config, checkpoint): seeded port models written in the
    JAX layout, which both packages' loaders read."""
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import multiscale_init
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        truncated_resnet50_init,
    )

    d = tmp_path_factory.mktemp("artifact_models")
    gen = torch.Generator().manual_seed(0)
    trees = {
        "truncated_resnet50": ({"batch_size": 4, "lr": 0.01, "truncate_layer": 5, "seed": 0,
                                "dim": 16}, truncated_resnet50_init(gen, 5, 4, 16, device="cpu")),
        "gram_attention": ({"batch_size": 4, "lr": 0.01, "truncate_layer": 5,
                            "gram_matrix_size": 4, "num_classes": 4, "seed": 0},
                           gram_attention_init(gen, 5, 4, 4, device="cpu")),
        "multi_patchgan": ({"batch_size": 4, "lr": 0.01, "seed": 0, "num_classes": 4,
                            "patch_sizes": F3_PATCHES, "ndf": 8, "norm": "instance"},
                           multiscale_init(gen, F3_PATCHES, ndf=8, num_classes=4,
                                           norm="instance", device="cpu")),
    }
    out = {}
    for family, (config, model) in trees.items():
        cfg, ckpt = str(d / f"{family}.json"), str(d / f"{family}.npz")
        with open(cfg, "w") as f:
            json.dump(config, f)
        save_pytree_npz(to_jax_tree(model), ckpt)
        out[family] = (cfg, ckpt)
    return out


def _argv(models, family, *extra):
    cfg, ckpt = models[family]
    return ["--family", family, "--config_path", cfg, "--model_path", ckpt, *extra]


def _frames(n, transport, seed):
    tail = (336, 224) if transport == "yuv420" else (224, 224, 3)
    return np.random.RandomState(seed).randint(0, 256, (n,) + tail).astype(np.uint8)


CASES = [("truncated_resnet50", "float32", "rgb"), ("gram_attention", "float32", "rgb"),
         ("multi_patchgan", "float32", "rgb"), ("truncated_resnet50", "bf16", "rgb"),
         ("truncated_resnet50", "float32", "yuv420")]
HST_NODES = {"truncated_resnet50": set(), "gram_attention": {"hst.pooled_gram_fwd.default"},
             "multi_patchgan": {"hst.instance_norm_fwd.default"}}


@pytest.mark.parametrize("family,precision,transport", CASES, ids=["-".join(c) for c in CASES])
def test_infer_artifact_is_the_live_path_and_jax(models, tiny_imagefolder, tmp_path, family,
                                                 precision, transport):
    check_infer_artifact(models, tiny_imagefolder, tmp_path, family, precision, transport)


def check_infer_artifact(models, tiny_imagefolder, tmp_path, family, precision, transport):
    """The port's artifact of ``family`` at ``precision`` and ``transport``
    against the live infer function (bit for bit) and JAX's artifact."""
    extra = ["--precision", precision, "--transport", transport]
    if precision == "int8":
        extra += ["--calib_data", str(tiny_imagefolder), "--quantized_path",
                  str(tmp_path / "q.npz")]
    argv = _argv(models, family, *extra)
    fwd, model, _, names = tcli._resolve_forward(
        tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    blobs, meta = tart.export_infer_artifact(fwd, model, transport=transport,
                                             class_names=names,
                                             extra_meta={"family": family,
                                                         "precision": precision})
    path = str(tmp_path / "port.npz")
    tart.save_infer_artifact(path, blobs, meta)
    art = tart.load_infer_artifact(path, device="cpu")
    assert art.meta["batch_size"] is None and art.meta["input_shape"][0] == "b"
    assert art.meta["platforms"] == ["cpu"] and art.meta["num_outputs"] == 4
    assert art.meta["family"] == family and art.meta["n_devices"] == 1
    assert art.meta["torch_version"] == torch.__version__
    nodes = {str(n.target) for n in art.exported.graph.nodes if str(n.target).startswith("hst.")}
    assert nodes == HST_NODES[family]

    j_fwd, variables, _, _ = jcli._resolve_forward(jcli.build_parser().parse_args(argv))
    jblob, jmeta = jart.export_infer_artifact(j_fwd, variables, transport=transport)
    jpath = str(tmp_path / "jax.npz")
    jart.save_infer_artifact(jpath, jblob, jmeta)
    jax_art = jart.load_infer_artifact(jpath)
    for n in (1, 3):
        x = _frames(n, transport, seed=n)
        live_fn = (make_camera_infer_fn_yuv(fwd, 224, batch=n) if transport == "yuv420"
                   else make_camera_infer_fn(fwd, batch=n, host_downscale=True))
        live = live_fn(model, torch.from_numpy(x))
        got = art(x)
        assert got.shape == (n, 4)
        torch.testing.assert_close(got, live, rtol=0, atol=0)
        want = np.asarray(jax_art(jnp.asarray(x)))
        np.testing.assert_allclose(got.numpy(), want, **TOL[precision])
        if precision != "bf16":
            np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))


def _f2(models):
    return tcli._resolve_forward(tcli.build_parser().parse_args(
        _argv(models, "gram_attention", "--device", "cpu")))[:2]


def test_static_batch_refuses_another_size(models, tmp_path):
    fwd, model = _f2(models)
    blobs, meta = tart.export_infer_artifact(fwd, model, batch_size=3)
    assert meta["batch_size"] == 3 and meta["input_shape"] == [3, 224, 224, 3]
    path = str(tmp_path / "static.npz")
    tart.save_infer_artifact(path, blobs, meta)
    art = tart.load_infer_artifact(path, device="cpu")
    assert art(_frames(3, "rgb", 0)).shape == (3, 4)
    with pytest.raises(Exception):
        art(_frames(2, "rgb", 0))


def test_platforms_and_mesh(models, tmp_path):
    fwd, model = _f2(models)
    with pytest.raises(ValueError, match="not one the port exports for"):
        tart.export_infer_artifact(fwd, model, platforms=["tpu"])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tart.export_infer_artifact(fwd, model, mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tart.export_infer_artifact(fwd, model, platforms=["cpu", "gpu"])
    blobs, meta = tart.export_infer_artifact(fwd, model, platforms=["cpu"], batch_size=2)
    path = str(tmp_path / "cpu.npz")
    tart.save_infer_artifact(path, blobs, meta)
    with pytest.raises(ValueError, match="holds no program for cuda"):
        tart._program_for(path, blobs, torch.device("cuda"))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tart.load_infer_artifact(path)


def test_formats_refused_both_ways(models, tmp_path):
    fwd, model = _f2(models)
    blobs, meta = tart.export_infer_artifact(fwd, model, batch_size=1)
    port = str(tmp_path / "port.npz")
    tart.save_infer_artifact(port, blobs, meta)
    with pytest.raises(ValueError, match="is not a hst-infer-artifact file"):
        jart.load_infer_artifact(port)
    with pytest.raises(ValueError, match="is not a hst-style-artifact file"):
        jart.load_style_artifact(port)
    with pytest.raises(ValueError, match="is not a hst-style-artifact-torch file"):
        tart.load_style_artifact(port, device="cpu")

    argv = _argv(models, "gram_attention")
    j_fwd, variables, _, _ = jcli._resolve_forward(jcli.build_parser().parse_args(argv))
    jblob, jmeta = jart.export_infer_artifact(j_fwd, variables, batch_size=1)
    jax_path = str(tmp_path / "jax.npz")
    jart.save_infer_artifact(jax_path, jblob, jmeta)
    for load in (tart.load_infer_artifact, tart.load_style_artifact):
        with pytest.raises(ValueError, match="is a JAX StableHLO artifact"):
            load(jax_path, device="cpu")

    old = dict(meta, torch_version="0.0.0")
    stale = str(tmp_path / "stale.npz")
    tart.save_infer_artifact(stale, blobs, old)
    with pytest.raises(RuntimeError,
                       match=r"torch 0\.0\.0.*torch " + re.escape(torch.__version__)):
        tart.load_infer_artifact(stale, device="cpu")
