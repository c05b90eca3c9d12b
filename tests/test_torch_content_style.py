"""Family 2's content+style transfer in the port (``tasks/style_transfer.py``:
``make_extract_fn_gram_attention``, ``total_variation``,
``make_per_image_content_style_loss``, ``make_content_style_optimizer``,
``content_style_transfer_gram_attention``; the family-2 CLI's
``--style_image``) against the JAX package, on the same seeded numpy
inputs and the same weights (the port's seeded model through
``to_jax_tree``; the CLI test reads a JAX-initialised npz).

Size: truncate 5 and 6 (through layer1 and layer2), 64² inputs for the
programs; the task and the CLI at their 224² crop.

Tolerances: in float64 on both sides (JAX under ``jax.enable_x64``) the
programs are the same functions: features 1e-9, Grams 1e-6 (JAX rounds
its Gram sums to f32), losses 1e-6, pixels after 5 Adam iterations 1e-9,
the same iteration count. In f32: features, Grams and TV 1e-5 of JAX's
own scale; losses and pixels, whose f32 error JAX's side magnifies more
than the port's (see each test), against the float64 result, and against
JAX's within its own f32 error; bf16 within 1.5 times
JAX's own bf16 error against its f32 result (RMS), as every bf16 parity
of the port; the PNGs within 1/255 where the pixels agree to 1e-4 and
within the 2·lr·iterations bound otherwise."""
import contextlib
import copy
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from heuristique_style_transfer_code_tpu.tasks import style_transfer as jst
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
from heuristique_style_transfer_code_tpu_torch.models.gram_attention import gram_attention_init
from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

LR, ITERS = 0.01, 5


@functools.lru_cache(maxsize=None)
def _setup(truncate):
    model = gram_attention_init(torch.Generator().manual_seed(truncate), truncate, 4, 4,
                                device="cpu")
    rng = np.random.RandomState(truncate)
    content = rng.randn(2, 64, 64, 3).astype(np.float32)
    style = rng.randn(2, 64, 64, 3).astype(np.float32)
    return model, to_jax_tree(model), content, style


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t):
    return t.detach().float().numpy()


def _f64(model, tree):
    """The port's model and the JAX tree in float64 (the JAX side then runs
    under ``jax.enable_x64``)."""
    return (copy.deepcopy(model).double(),
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree))


@pytest.mark.parametrize("truncate", [5, 6])
@pytest.mark.parametrize("style_layers", ["last", "all"])
def test_extract_fn_matches_jax(truncate, style_layers):
    model, tree, content, _ = _setup(truncate)
    j_feats, j_grams = jst.make_extract_fn_gram_attention(tree, truncate,
                                                          style_layers=style_layers)(content)
    feats, grams = pst.make_extract_fn_gram_attention(model, truncate,
                                                      style_layers=style_layers)(
        torch.tensor(content))
    want_n = 1 if style_layers == "last" else truncate - 4
    assert len(grams) == len(j_grams) == want_n
    assert _rel(_np(feats), j_feats) <= 1e-5
    for g, jg in zip(grams, j_grams):
        assert g.shape == jg.shape and _rel(_np(g), jg) <= 1e-5
    # float64 on both sides: the same function (JAX rounds its Gram sums to f32)
    m64, t64 = _f64(model, tree)
    with jax.enable_x64():
        j_feats, j_grams = jst.make_extract_fn_gram_attention(t64, truncate,
                                                              style_layers=style_layers)(
            content.astype(np.float64))
        j_feats, j_grams = np.asarray(j_feats), [np.asarray(g) for g in j_grams]
    feats, grams = pst.make_extract_fn_gram_attention(m64, truncate, style_layers=style_layers)(
        torch.tensor(content).double())
    assert j_feats.dtype == np.float64 and _rel(feats.detach().numpy(), j_feats) <= 1e-9
    for g, jg in zip(grams, j_grams):
        assert _rel(g.detach().numpy(), jg) <= 1e-6


def test_extract_fn_rejects_unknown_style_layers():
    model, tree, _, _ = _setup(5)
    with pytest.raises(ValueError) as jax_err:
        jst.make_extract_fn_gram_attention(tree, 5, style_layers="deep")
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        pst.make_extract_fn_gram_attention(model, 5, style_layers="deep")


def test_total_variation_matches_jax():
    x = np.random.RandomState(0).randn(3, 9, 7, 3).astype(np.float32)
    want = np.asarray(jst.total_variation(x))
    got = pst.total_variation(torch.tensor(x)).numpy()
    assert got.shape == (3,) and _rel(got, want) <= 1e-5
    assert not pst.total_variation(torch.ones((1, 4, 4, 3))).any()


def _loss_inputs(tree, content, style):
    """Style Grams of ``style``, content features of ``content`` (JAX's),
    and pixels near the content."""
    j_extract = jst.make_extract_fn_gram_attention(tree, 6, style_layers="all")
    noise = np.random.RandomState(1).randn(*content.shape).astype(content.dtype)
    return ([np.asarray(g) for g in j_extract(style)[1]], np.asarray(j_extract(content)[0]),
            content + 0.3 * noise)


@pytest.mark.parametrize("tv_weight", [0.0, 0.5])
def test_per_image_loss_matches_jax(tv_weight):
    """From float64 models and inputs (both losses then difference the
    float64 features and Grams in f32, as JAX casts them) the two agree to
    1e-6. From f32 ones the style and content terms are means of squared
    differences of near values, which magnify the f32 error of the
    features: JAX's f32 loss lies up to 2e-5 from the float64 one here; the
    port's is held within 1e-5 of it, and within 1e-5 plus JAX's own f32
    error of JAX's."""
    model, tree, content, style = _setup(6)
    m64, t64 = _f64(model, tree)

    def port(m, dtype):
        grams, cf, pixels = _loss_inputs(tree, content, style)
        extract = pst.make_extract_fn_gram_attention(m, 6, style_layers="all")
        return pst.make_per_image_content_style_loss(extract, 2.0, 0.5, tv_weight)(
            torch.tensor(pixels, dtype=dtype), [torch.tensor(g, dtype=dtype) for g in grams],
            torch.tensor(cf, dtype=dtype)).detach().numpy()

    def jax_side(t, dtype):
        grams, cf, pixels = _loss_inputs(tree, content, style)
        extract = jst.make_extract_fn_gram_attention(t, 6, style_layers="all")
        return np.asarray(jst.make_per_image_content_style_loss(extract, 2.0, 0.5, tv_weight)(
            pixels.astype(dtype), [g.astype(dtype) for g in grams], cf.astype(dtype)))

    truth = port(m64, torch.float64)
    with jax.enable_x64():
        want64 = jax_side(t64, np.float64)
    assert _rel(truth, want64) <= 1e-6
    got, want = port(model, torch.float32), jax_side(tree, np.float32)
    assert got.shape == (2,) and _rel(got, truth) <= 1e-5
    assert _rel(got, want) <= 1e-5 + _rel(want, truth)


def _targets(truncate, style_layers):
    """The JAX side's style Grams of image 0 of ``style`` for both images,
    and the content features: the loop's inputs, handed to both sides."""
    _, tree, content, style = _setup(truncate)
    j_extract = jst.make_extract_fn_gram_attention(tree, truncate, style_layers=style_layers)
    grams = [np.broadcast_to(np.asarray(g)[:1], g.shape).copy() for g in j_extract(style)[1]]
    return j_extract, grams, np.asarray(j_extract(content)[0])


def _runs(truncate, style_layers, iters, threshold, grams=None, history=None, tv_weight=0.1,
          dtype=np.float32, jax_side=True):
    """The loop from the content image on both sides (the port's alone
    without ``jax_side``), in ``dtype`` (float64: both models and every
    input in float64, JAX under ``enable_x64``)."""
    model, tree, content, _ = _setup(truncate)
    _, j_grams, cf = _targets(truncate, style_layers)
    grams = [g.astype(dtype) for g in (j_grams if grams is None else grams)]
    content, cf = content.astype(dtype), cf.astype(dtype)
    if dtype == np.float64:
        model, tree = _f64(model, tree)
    j_out = [None, 0, None]
    if jax_side:
        with jax.enable_x64() if dtype == np.float64 else contextlib.nullcontext():
            j_extract = jst.make_extract_fn_gram_attention(tree, truncate,
                                                           style_layers=style_layers)
            j_out = [np.asarray(a) for a in jst.make_content_style_optimizer(
                j_extract, 1.0, 1.0, LR, iters, threshold, tv_weight=tv_weight)(
                content, grams, cf)]
    extract = pst.make_extract_fn_gram_attention(model, truncate, style_layers=style_layers)
    out = pst.make_content_style_optimizer(extract, 1.0, 1.0, LR, iters, threshold,
                                           tv_weight=tv_weight)(
        torch.tensor(content), [torch.tensor(g) for g in grams],
        torch.tensor(cf), history)
    return (j_out[0], int(j_out[1]), j_out[2]), (out[0].numpy(), out[1], out[2].numpy())


@pytest.mark.parametrize("style_layers", ["last", "all"])
def test_optimizer_matches_jax(style_layers):
    """In float64, after 5 iterations: the same iteration count, per-image
    losses within 1e-6 relative and pixels within 1e-9. In f32 the first
    Adam step is lr·sign(g) for every pixel, so a pixel whose gradient is
    within the f32 error of zero may step the other way: JAX's f32 pixels
    lie more than 1e-4 from the float64 ones at 1.5% of them at "last"; the
    port's f32 pixels are held to the float64 ones by the texture tests'
    rule (99.9% within 1e-4, all within 2·lr·iterations), its losses within
    1e-4 of JAX's f32 ones, and its iteration count equal."""
    (j64, j_iters, j_per), (p64, iters, per) = _runs(6, style_layers, ITERS, 0.0,
                                                       dtype=np.float64)
    assert iters == j_iters == ITERS and p64.dtype == j64.dtype == np.float64
    np.testing.assert_allclose(per, j_per, rtol=1e-6)
    assert np.abs(p64 - j64).max() <= 1e-9
    (j_pix, j_iters, j_per), (pix, iters, per) = _runs(6, style_layers, ITERS, 0.0)
    assert iters == j_iters == ITERS and pix.dtype == np.float32
    np.testing.assert_allclose(per, j_per, rtol=1e-4)
    _assert_pixels_close(pix, p64, ITERS)
    assert np.abs(pix - j_pix).max() <= 2 * LR * ITERS
    assert not np.array_equal(pix, _setup(6)[2])  # the pixels moved


def _assert_pixels_close(got, want, iters):
    gap = np.abs(got - want)
    assert (gap <= 1e-4).mean() >= 0.999, (gap > 1e-4).mean()
    assert gap.max() <= 2 * LR * iters, gap.max()


def test_converged_image_freezes_bit_exactly_like_jax():
    """Image 0 aims at its own Gram (content init: its loss starts near 0)
    and image 1 at image 0 of ``style``'s: a threshold between them freezes
    image 0 after its first step while image 1 runs to the cap. The
    iteration counts equal JAX's, and image 0's pixels are those of a
    1-iteration run, bit for bit."""
    _, _, content, _ = _setup(5)
    j_extract, grams, _ = _targets(5, "all")
    own = [np.asarray(g) for g in j_extract(content)[1]]
    mixed = [np.stack([o[0] * 1.001, g[1]]) for o, g in zip(own, grams)]
    trace = []
    _runs(5, "all", ITERS, 0.0, mixed, trace, tv_weight=0.0, jax_side=False)
    losses = np.stack([t.numpy() for t in trace])
    assert losses[0, 0] < losses[:, 1].min()
    thr = float(np.sqrt(losses[0, 0] * losses[:, 1].min()))
    (j_pix, j_iters, j_per), (pix, iters, per) = _runs(5, "all", ITERS, thr, mixed,
                                                       tv_weight=0.0)
    assert iters == j_iters == ITERS
    (_, _, _), (one, _, _) = _runs(5, "all", 1, 0.0, mixed, tv_weight=0.0, jax_side=False)
    np.testing.assert_array_equal(pix[0], one[0])
    assert not np.array_equal(pix[1], one[1])
    assert np.abs(pix - j_pix).max() <= 2 * LR * ITERS
    np.testing.assert_allclose(per, j_per, rtol=1e-4)


def test_bf16_within_jax_own_bf16_error():
    model, tree, content, style = _setup(5)
    j32 = jst.make_extract_fn_gram_attention(tree, 5, style_layers="all")
    j16 = jst.make_extract_fn_gram_attention(tree, 5, style_layers="all",
                                             compute_dtype=jnp.bfloat16)
    p16 = pst.make_extract_fn_gram_attention(model, 5, style_layers="all",
                                             compute_dtype=torch.bfloat16)
    (f32, g32), (f16, g16) = j32(content), j16(content)
    feats, grams = p16(torch.tensor(content))
    assert feats.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grams)
    assert _rms(_np(feats), f32) <= 1.5 * _rms(np.asarray(f16, np.float32), f32)
    for g, jg16, jg32 in zip(grams, g16, g32):
        assert _rms(_np(g), jg32) <= 1.5 * _rms(np.asarray(jg16, np.float32), jg32)
    # the first iteration's loss, against the f32 one
    _, grams_t, cf = _targets(5, "all")
    j_per32 = jst.make_content_style_optimizer(j32, 1.0, 1.0, LR, 1, 0.0)(content, grams_t, cf)[2]
    j_per16 = jst.make_content_style_optimizer(j16, 1.0, 1.0, LR, 1, 0.0)(content, grams_t, cf)[2]
    per16 = pst.make_content_style_optimizer(p16, 1.0, 1.0, LR, 1, 0.0)(
        torch.tensor(content), [torch.tensor(g) for g in grams_t],
        torch.tensor(cf))[2].numpy()
    assert _rel(per16, j_per32) <= 1.5 * _rel(np.asarray(j_per16), j_per32) + 1e-6


def _png(path):
    with Image.open(path) as im:
        return im.mode, np.asarray(im).astype(np.int16)


def _staged_batch(seed, n=2):
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, (n, 256, 256, 3)).astype(np.uint8),
            "label": np.array([1, 3], np.int32)[:n], "indices": np.arange(n), "n_valid": n}


def _assert_pngs_close(got_dir, want_dir, files, iters):
    """Pixels in [0, 1] after denormalising by std <= 0.229: a pixel
    that moved 2·lr·iterations apart in normalised units is at most
    2·lr·iterations·0.229·255 steps apart; the rest within one step."""
    bound = int(np.ceil(2 * LR * iters * 0.229 * 255)) + 1
    for f in files:
        (ma, a), (mb, b) = _png(os.path.join(got_dir, f)), _png(os.path.join(want_dir, f))
        assert ma == mb == "RGBA" and a.shape == b.shape == (224, 448, 4)
        gap = np.abs(a - b)
        assert (gap <= 1).mean() >= 0.999 and gap.max() <= bound, (f, gap.max())
        assert gap[:, :224].max() <= 1  # the content half


def _rel_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("init", ["content", "noise"])
def test_task_writes_the_jax_pngs(tmp_path, monkeypatch, init):
    model, tree, _, _ = _setup(5)
    batch = _staged_batch(11)
    style_u8 = np.random.RandomState(12).randint(0, 256, (256, 256, 3)).astype(np.uint8)
    noise = torch.randn((2, 224, 224, 3), generator=torch.Generator().manual_seed(7))
    # the JAX task draws its noise from jax.random: give it the port's
    monkeypatch.setattr(jst.jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise.numpy()))
    kw = dict(layers=5, truncate_layer=5, style_layers="all", tv_weight=0.05,
              content_weight=0.5, threshold=0.0, num_iterations=2, init=init)
    logs = {"jax": [], "port": []}
    j_saved = jst.content_style_transfer_gram_attention(
        tree, [batch], style_u8, str(tmp_path / "jax"), log_fn=logs["jax"].append, **kw)
    saved = pst.content_style_transfer_gram_attention(
        model, [batch], style_u8, str(tmp_path / "port"), log_fn=logs["port"].append,
        generator=torch.Generator().manual_seed(7), **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in saved] == [
        os.path.relpath(p, tmp_path / "jax") for p in j_saved]
    assert _rel_files(tmp_path / "port") == _rel_files(tmp_path / "jax")
    assert [os.path.basename(p) for p in saved] == ["content_style_0.png", "content_style_1.png"]
    _assert_pngs_close(str(tmp_path / "port"), str(tmp_path / "jax"),
                       _rel_files(tmp_path / "port"), 2)

    def shape(msgs, root):  # the log lines with their numbers and directories taken out
        return [re.sub(r"\[.*\]", "[...]", m.replace(str(root), "<dir>")) for m in msgs]

    assert shape(logs["port"], tmp_path / "port") == shape(logs["jax"], tmp_path / "jax")
    assert logs["port"][0].startswith("Batch optimised in 2 iterations, final losses: [")


def test_task_rejects_an_unknown_init(tmp_path):
    model, tree, _, _ = _setup(5)
    style_u8 = np.zeros((256, 256, 3), np.uint8)
    with pytest.raises(ValueError) as jax_err:
        jst.content_style_transfer_gram_attention(tree, [], style_u8, str(tmp_path), init="x")
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        pst.content_style_transfer_gram_attention(model, [], style_u8, str(tmp_path), init="x")


def test_cli_style_image_matches_jax(tiny_imagefolder, tmp_path):
    """The family-2 CLI's --style_image against the JAX CLI: the same
    content_style_<i>.png tree, the PNGs as in the task test."""
    import json

    from heuristique_style_transfer_code_tpu.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu.cli.test_gram_attention import main as j_main
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_init as j_init,
    )
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main

    ckpt = str(tmp_path / "model.npz")
    save_pytree_npz(j_init(jax.random.PRNGKey(0), 5, 4, 4), ckpt)
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 2, "lr": 0.01, "truncate_layer": 5, "gram_matrix_size": 4,
                   "num_classes": 4, "seed": 0}, f)
    style_path = str(tmp_path / "style.png")
    Image.fromarray(np.random.RandomState(2).randint(0, 256, (80, 96, 3), np.uint8)).save(
        style_path)
    flags = ["--data", str(tiny_imagefolder), "--config_path", cfg, "--model_path", ckpt,
             "--mode", "style_transfer", "--layers", "5", "--num_iterations", "3",
             "--threshold", "1e-3", "--num_samples", "2", "--batch_size", "2",
             "--style_image", style_path, "--content_weight", "0.5", "--tv_weight", "0.05",
             "--style_layers", "all"]
    j_main(flags + ["--save_dir", str(tmp_path / "jax")])
    main(flags + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    files = _rel_files(tmp_path / "port")
    assert files == _rel_files(tmp_path / "jax")
    pngs = [f for f in files if os.path.basename(f).startswith("content_style_")]
    assert len(pngs) == 2
    _assert_pngs_close(str(tmp_path / "port"), str(tmp_path / "jax"), pngs, 3)
