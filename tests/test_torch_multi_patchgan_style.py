"""Family-3 style transfer in the port (``tasks/style_transfer.py``:
``make_gram_fn_patches``, ``style_transfer_patches``; the family-3 CLI's
``--mode style_transfer``) and the gradient path under it
(``ops/gram.gram_matrix_ncl`` through ``GramFunction``, the norms through
``InstanceNormFunction``) against the JAX package, on the same seeded numpy
inputs and the same weights (JAX init -> the weight bridge -> the port).

Size: ndf 8, gram dim 8, 64² inputs with patch sizes 10/20/40 (two, three
and four stride-2 convs: the smallest plan that keeps every scale's maps
at least 2x2 there); the Gram-count test uses the default plan (patch
sizes 10/70/150 at ndf 64, 16 convs) at 64². The CLI test runs both CLIs
at their 224² crop.

Tolerances, relative to the JAX result's own scale (max over entries):
the Gram program 1e-4 (f32 sums in other orders through up to six convs,
the norms, two attentions); the bf16 Gram program within 1.5 times JAX's
own bf16 error against JAX's f32 program (RMS) and 5e-2 of JAX's bf16
result; the pixel gradient 1e-4 max and RMS; per-image losses after three
Adam steps 1e-4, and the pixels' change over them 1e-4 max and RMS. With
seeded weights an image's own Gram gives a loss of about 1e-10 and a pixel
gradient far below Adam's eps (1e-8), which would leave the pixels where
they are; the three steps therefore chase the image's Gram plus a seeded
unit offset, where the gradient is about eps and pixels move by 0.02.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.models import multi_patchgan as jmp
from heuristique_style_transfer_code_tpu.tasks import style_transfer as jst
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree
from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
    multiscale_test_apply,
    multiscale_test_init,
)
from heuristique_style_transfer_code_tpu_torch.nn.patch_discriminator import (
    patch_discriminator_test_apply,
)
from heuristique_style_transfer_code_tpu_torch.ops.kernels import gram as gram_kernels
from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

PATCH = {"small": 10, "medium": 20, "large": 40}
NDF, GDIM, SIDE = 8, 8, 64


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module", params=["batch", "instance"])
def family3(request):
    """(norm, JAX tree, port model with that tree's weights)."""
    norm = request.param
    tree = jax.tree_util.tree_map(np.asarray, jmp.multiscale_test_init(
        jax.random.PRNGKey(0), PATCH, ndf=NDF, num_classes=4, gram_matrix_dim=GDIM, norm=norm))
    model = multiscale_test_init(None, PATCH, ndf=NDF, num_classes=4, gram_matrix_dim=GDIM,
                                 norm=norm, device="cpu")
    return norm, tree, load_jax_tree(model, tree)


def _images(seed, n=1):
    return np.random.RandomState(seed).randn(n, SIDE, SIDE, 3).astype(np.float32)


def test_gram_fn_patches_matches_jax(family3):
    norm, tree, model = family3
    x = _images(1, 2)
    (want,) = jax.jit(jst.make_gram_fn_patches(tree, GDIM, norm=norm))(jnp.asarray(x))
    with torch.no_grad():
        (got,) = pst.make_gram_fn_patches(model, GDIM, norm)(torch.tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, NDF, NDF)
    assert _rel(got.numpy(), want) <= 1e-4


def test_gram_fn_patches_bf16_runs_in_bf16(family3):
    """bf16: the discriminators are a bf16 copy of the model, made once
    (the caller's model stays f32), and the Gram comes back in f32. Both
    packages round every stage's output to 8 bits, at other places, so the
    port's bf16 Gram is held against JAX's f32 one to at most 1.5 times
    JAX's own bf16 error (RMS), and within 5e-2 of max|ref| of JAX's bf16
    Gram."""
    norm, tree, model = family3
    x = _images(2)
    (j32,) = jax.jit(jst.make_gram_fn_patches(tree, GDIM, norm=norm))(jnp.asarray(x))
    (j16,) = jax.jit(jst.make_gram_fn_patches(tree, GDIM, norm=norm,
                                              compute_dtype=jnp.bfloat16))(jnp.asarray(x))
    with torch.no_grad():
        (g16,) = pst.make_gram_fn_patches(model, GDIM, norm, torch.bfloat16)(torch.tensor(x))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert g16.dtype == torch.float32 and bool(torch.isfinite(g16).all())
    assert _rms(g16.numpy(), j32) <= 1.5 * _rms(j16, j32)
    assert _rel(g16.numpy(), j16) <= 5e-2


def test_embedding_gradient_matches_jax_grad(family3):
    """d<e, w>/dx of the embedding through every norm and Gram (the
    discriminators' backward) against jax.grad of JAX
    ``multiscale_test_apply``."""
    norm, tree, model = family3
    x = _images(3)
    w = np.random.RandomState(4).randn(NDF).astype(np.float32)
    want = jax.jit(jax.grad(lambda v: jnp.sum(
        jmp.multiscale_test_apply(tree, v, GDIM, norm=norm)[0] * w)))(jnp.asarray(x))
    xt = torch.tensor(x).requires_grad_(True)
    (got,) = torch.autograd.grad((multiscale_test_apply(model, xt, GDIM, norm)[0]
                                  * torch.tensor(w)).sum(), xt)
    assert _rel(got.numpy(), want) <= 1e-4 and _rms(got.numpy(), want) <= 1e-4


def test_optimizer_three_steps_match_jax(family3):
    """The port's optimiser against JAX ``make_style_transfer_optimizer``,
    both fed the same numpy noise0 and targets of the same image: the first
    step's pixel gradient, then three steps' final per-image losses and
    pixel change towards the offset targets."""
    norm, tree, model = family3
    image, noise0 = _images(5), _images(6)
    j_gram = jst.make_gram_fn_patches(tree, GDIM, norm=norm)
    p_gram = pst.make_gram_fn_patches(model, GDIM, norm)
    j_targets = jax.jit(j_gram)(jnp.asarray(image))
    with torch.no_grad():
        p_targets = p_gram(torch.tensor(image))

    def j_loss(n):
        return jnp.sum(jnp.mean(jnp.square(j_gram(n)[0] - j_targets[0]), axis=(1, 2)))

    nt = torch.tensor(noise0).requires_grad_(True)
    (g_port,) = torch.autograd.grad(
        torch.mean(torch.square(p_gram(nt)[0] - p_targets[0]), dim=(1, 2)).sum(), nt)
    g_jax = jax.jit(jax.grad(j_loss))(jnp.asarray(noise0))
    assert _rel(g_port.numpy(), g_jax) <= 1e-4 and _rms(g_port.numpy(), g_jax) <= 1e-4

    # the loop's targets: the image's Gram plus a seeded symmetric offset
    # of unit size, so that the pixel gradient is about Adam's eps and
    # each step moves pixels by a good share of lr, with both moments
    # mattering
    r = np.random.RandomState(8).randn(1, NDF, NDF).astype(np.float32)
    offset = (r + r.transpose(0, 2, 1)) / 2
    j_pix, j_iters, j_per = jst.make_style_transfer_optimizer(j_gram, 0.01, 3, 0.0)(
        jnp.asarray(noise0), [j_targets[0] + offset])
    history = []
    p_pix, p_iters, p_per = pst.make_style_transfer_optimizer(p_gram, 0.01, 3, 0.0)(
        torch.tensor(noise0), [p_targets[0] + torch.tensor(offset)], history)
    assert int(j_iters) == p_iters == 3 and len(history) == 3
    assert _rel(p_per.numpy(), j_per) <= 1e-4
    j_move, p_move = np.asarray(j_pix) - noise0, p_pix.numpy() - noise0
    assert np.abs(j_move).max() >= 0.01  # the loop moved pixels by at least one lr
    assert _rel(p_move, j_move) <= 1e-4 and _rms(p_move, j_move) <= 1e-4


def test_gram_backward_goes_through_gram_bwd(monkeypatch):
    """A backward through the discriminators at the default plan (ndf 64,
    patch sizes 10/70/150: 16 convs, so 16 Grams) calls ``gram_bwd`` once a
    Gram: ``gram_matrix_ncl`` is differentiable through ``GramFunction``."""
    calls = []
    real = gram_kernels.gram_bwd

    def spy(f, dg):
        calls.append(tuple(f.shape))
        return real(f, dg)

    monkeypatch.setattr(gram_kernels, "gram_bwd", spy)
    model = multiscale_test_init(torch.Generator().manual_seed(0),
                                 {"small": 10, "medium": 70, "large": 150}, ndf=64,
                                 num_classes=4, gram_matrix_dim=8, device="cpu")
    x = torch.tensor(_images(7)).requires_grad_(True)
    emb = sum(patch_discriminator_test_apply(getattr(model, s), x, 8, "batch")[0]
              for s in ("small", "medium", "large"))
    (gx,) = torch.autograd.grad(emb.sum(), x)
    assert len(calls) == 16 and set(calls) == {(1, 16, 8)}
    assert bool(torch.isfinite(gx).all()) and float(gx.abs().max()) > 0


# ------------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def f3_files(tmp_path_factory):
    import json

    from heuristique_style_transfer_code_tpu.checkpoint.io import save_pytree_npz

    d = tmp_path_factory.mktemp("f3style")
    tree = jmp.multiscale_test_init(jax.random.PRNGKey(1), PATCH, ndf=NDF, num_classes=4,
                                    gram_matrix_dim=GDIM, norm="instance")
    ckpt = str(d / "model.npz")
    save_pytree_npz(tree, ckpt)
    cfg = str(d / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 4, "seed": 0, "ndf": NDF, "gram_matrix_dim": GDIM,
                   "num_classes": 4, "norm": "instance", "patch_sizes": PATCH}, f)
    return cfg, ckpt


def _args(data, f3_files, save_dir, *extra):
    cfg, ckpt = f3_files
    return ["--data", str(data), "--config_path", cfg, "--model_path", ckpt,
            "--save_dir", str(save_dir), "--mode", "style_transfer", *extra]


def _tree(root):
    """{label/style_transfer_<label>_<n>: its PNG's RGBA pixels}, the
    millisecond stamp dropped, under the one style_transfer_<date>
    directory."""
    from PIL import Image

    (st,) = [d for d in os.listdir(root) if d.startswith("style_transfer_")]
    out = {}
    for dp, _, fs in os.walk(os.path.join(root, st)):
        for f in fs:
            stem = f.rsplit("_", 1)[0]
            with Image.open(os.path.join(dp, f)) as im:
                out[f"{os.path.basename(dp)}/{stem}"] = np.asarray(im)
    return st, out


def test_cli_style_transfer_writes_the_jax_tree(tiny_imagefolder, f3_files, tmp_path):
    from heuristique_style_transfer_code_tpu.cli.test_multi_patchgan import main as j_main
    from heuristique_style_transfer_code_tpu_torch.cli.test_multi_patchgan import main

    flags = ["--num_samples", "3", "--num_iterations", "2", "--threshold", "0"]
    j_main(_args(tiny_imagefolder, f3_files, tmp_path / "jax", *flags))
    main(_args(tiny_imagefolder, f3_files, tmp_path / "torch", *flags, "--device", "cpu"))
    j_st, j_tree = _tree(tmp_path / "jax")
    t_st, t_tree = _tree(tmp_path / "torch")
    assert t_st == j_st and sorted(t_tree) == sorted(j_tree) and len(t_tree) == 3
    for key, pixels in t_tree.items():
        # [original | stylised], 224 x 448, RGBA with an opaque alpha on
        # both sides (the JAX package's matplotlib, the port's PNG writer).
        # The originals are the same image, up to one step of rounding to
        # uint8, in all four channels.
        assert pixels.shape == j_tree[key].shape == (224, 448, 4)
        assert (pixels[..., 3] == 255).all() and (j_tree[key][..., 3] == 255).all()
        gap = np.abs(pixels[:, :224].astype(int) - j_tree[key][:, :224].astype(int)).max()
        assert gap <= 1, (key, gap)


def test_cli_layers_raises_the_jax_message(tiny_imagefolder, f3_files, tmp_path):
    from heuristique_style_transfer_code_tpu.cli.test_multi_patchgan import main as j_main
    from heuristique_style_transfer_code_tpu_torch.cli.test_multi_patchgan import main

    msgs = []
    for run, extra in ((j_main, []), (main, ["--device", "cpu"])):
        with pytest.raises(ValueError) as err:
            run(_args(tiny_imagefolder, f3_files, tmp_path, "--layers", "3", *extra))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "--layers" in msgs[0]


def test_max_images_stops_the_task(family3, tmp_path):
    norm, _, model = family3
    batches = [{"image": np.full((1, 64, 64, 3), 100 + i, np.uint8),
                "label": np.array([i % 2]), "n_valid": 1} for i in range(3)]
    logs = []
    saved = pst.style_transfer_patches(model, batches, str(tmp_path), gram_matrix_dim=GDIM,
                                       norm=norm, num_iterations=1, max_images=2,
                                       log_fn=logs.append)
    assert len(saved) == 2 and all(os.path.exists(p) for p in saved)
    assert logs == ["Maximum number of images (2) reached."]
    assert [os.path.basename(p).split("_")[2:4] for p in saved] == [["0", "0"], ["1", "1"]]
