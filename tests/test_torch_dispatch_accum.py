"""``--steps_per_dispatch`` (training and evaluation), ``--grad_accum`` and a
family-1 checkpoint in the family-2 CLI, in the port against the JAX
package, on the CPU.

Training: ``train_epochs`` at K = 2 against K = 1 on the same loader
(augmentation draws included): the weights and the per-batch prints bit
for bit; and family 3 (norm "instance", no batch statistics) over one
epoch of 4 batches against JAX's ``train_epochs`` with its
``train_step_multi`` at K = 2 from the same weights: each batch's loss
1e-4 relative and the final weights' moves 1e-2 by relative L2 (oneDNN's
and XLA's convolutions sum in other orders; the f32 gap grows over the
steps). Evaluation: ``run_inference`` at K = 2 (a chunk and a tail)
against K = 1, the JSON byte for byte, and against JAX's K = 2 run, each
probability within 1e-5.

Accumulation: family 3 (norm "instance") at ``--grad_accum 2`` against the
same full-batch step in float64, the loss within 1e-12 and each move
within 1e-6 of the leaf's largest (only reassociation differs: the
micro-batches' gradients are summed, then divided; measured 5.5e-8, the
instance norm's f32 constants setting the floor), the conv biases that a
norm follows (true gradient 0) within 1e-12; in f32 the out conv's
bias, a sum over the images that cancels, differs by 1e-4 of its move),
and in f32 against JAX's
``accum_step(2)`` as the plain family-3 step is held (loss 1e-5, moves
1e-2), each gap less two f32 spacings of the leaf's values (an f32
update resolves no finer); family 2 (train-mode batch norm: ghost
statistics chained over the micro-batches) in float64 against JAX's
``make_train_step_accum`` on the same augmented pixels (moves 1e-5 by
relative L2, as the plain float64 step's test holds them: the port's
attention takes its softmax in f32; the loss 1e-7; running statistics 1e-6
relative), and in
f32 bit for bit against a hand-written loop over the micro-batches; a batch
that the count does not divide raises JAX's ValueError.

Family-1 checkpoint in the family-2 CLI: the tree the CLI builds holds the
family-1 encoder and the port's fresh head (from a generator seeded with
the config's seed); the JAX CLI with that head carried across prints the
same message and writes the same classification results (equal, as
``test_torch_cli.py`` holds the plain family-2 CLI).

Sizes: family 3 at ndf 8, patch sizes 10/20/40, 224² crops, b2; family 2
at truncate 5, S 4, b4 (float64: 32² crops); the ``tiny_imagefolder``
fixture and the family-1 checkpoint of ``conftest.py``."""
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree, to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten
from heuristique_style_transfer_code_tpu_torch.config.schema import (
    GramAttentionConfig,
    MultiPatchGANConfig,
)
from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
from heuristique_style_transfer_code_tpu_torch.data.loader import HostLoader
from heuristique_style_transfer_code_tpu_torch.train.factories import (
    setup_gram_attention,
    setup_multi_patchgan,
)
from heuristique_style_transfer_code_tpu_torch.train.train_loop import train_epochs

F3 = dict(batch_size=2, lr=0.05, ndf=8, patch_sizes={"small": 10, "medium": 20, "large": 40},
          norm="instance")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def _move_gap(got, want, start):
    """The gap between two updated f32 leaves relative to the move the step
    made, less two f32 spacings of each value (the resolution of any f32
    update, whichever code made it)."""
    floor = 2 * np.linalg.norm(np.spacing(np.abs(start).astype(np.float32)))
    gap = np.linalg.norm(np.asarray(got, np.float64) - want)
    return max(0.0, gap - floor) / np.linalg.norm(np.asarray(want, np.float64) - start)


def _train_samples(data, n):
    return ImageFolderIndex(os.path.join(str(data), "train")).samples[:n]


def _run_epochs(setup, model, opt, loader, k):
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        train_epochs(setup.train_step, model, opt, loader, 1, steps_per_dispatch=k)
    return printed.getvalue().splitlines(), _flatten(to_jax_tree(model))


# ------------------------------------------------------ train dispatch


def test_train_dispatch_equals_one_step_a_dispatch(tiny_imagefolder):
    """Family 2 (train-mode batch norm) over 5 batches with their
    augmentation draws (a rotation and a brightness combination): K = 2
    (chunks of 2, 2 and a tail of 1) against K = 1, bit for bit."""
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn

    cfg = GramAttentionConfig(batch_size=4, lr=0.05, truncate_layer=5, gram_matrix_size=4)
    combos = [("rotation", None), (None, "brightness")]
    samples = _train_samples(tiny_imagefolder, 10)
    runs = []
    for k in (1, 2):
        setup = setup_gram_attention(cfg, 4, combos, device="cpu")
        model, opt = setup.init(torch.Generator().manual_seed(0))
        loader = HostLoader(samples * 2, 4, combo_ids=[0] * 10 + [1] * 10, shuffle=True, seed=3,
                            draw_key=(0, 0))
        assert len(loader) == 5 and make_augment_fn(combos) is not None
        runs.append(_run_epochs(setup, model, opt, loader, k))
    (lines1, w1), (lines2, w2) = runs
    assert lines2 == lines1 and sum("Batch [" in line for line in lines1) == 5
    assert all(np.array_equal(w2[k], w1[k]) for k in w1)


def test_train_dispatch_matches_jax_train_step_multi(tiny_imagefolder):
    from heuristique_style_transfer_code_tpu.config.schema import MultiPatchGANConfig as JConfig
    from heuristique_style_transfer_code_tpu.train.factories import (
        setup_multi_patchgan as j_setup,
    )
    from heuristique_style_transfer_code_tpu.train.train_loop import train_epochs as j_epochs

    samples = _train_samples(tiny_imagefolder, 8)
    setup = setup_multi_patchgan(MultiPatchGANConfig(**F3), 4, [(None, None)], device="cpu")
    model, opt = setup.init(torch.Generator().manual_seed(1))
    tree = to_jax_tree(model)
    start = _flatten(tree)
    lines, got = _run_epochs(setup, model, opt, HostLoader(samples, 2, shuffle=True, seed=4), 2)
    losses = [float(line.rsplit(" ", 1)[1]) for line in lines if "Batch [" in line]

    js = j_setup(JConfig(**F3), 4, [(None, None)], pretrained=tree)
    variables, j_opt = js.init(jax.random.PRNGKey(0))
    j_lines = []
    variables, _ = j_epochs(js.train_step, variables, j_opt,
                            HostLoader(samples, 2, shuffle=True, seed=4), 1,
                            jax.random.PRNGKey(1), log_fn=j_lines.append,
                            train_step_multi=js.train_step_multi, steps_per_dispatch=2)
    j_losses = [float(line.rsplit(" ", 1)[1]) for line in j_lines if "Batch [" in line]
    assert len(losses) == len(j_losses) == 4
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-4)
    want = _flatten(jax.tree_util.tree_map(np.asarray, variables))
    for key in want:
        if key.endswith("__none__") or (key.endswith("conv/bias") and "out_conv" not in key):
            continue  # the zero-gradient biases: rounding noise in both packages
        assert _rel_l2(got[key] - start[key], want[key] - start[key]) <= 1e-2, key


# ------------------------------------------------------- eval dispatch


def test_inference_dispatch_equals_k1_and_jax(tiny_imagefolder, f1_checkpoint, tmp_path):
    from heuristique_style_transfer_code_tpu.cli.test_truncated_resnet50 import main as j_main
    from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import main

    cfg, ckpt = f1_checkpoint
    base = ["--config_path", cfg, "--model_path", ckpt, "--mode", "inference",
            "--inference_input", str(tiny_imagefolder / "test"), "--batch_size", "5"]
    for k in ("1", "2"):
        main(base + ["--save_dir", str(tmp_path / f"k{k}"), "--steps_per_dispatch", k,
                     "--device", "cpu"])
    j_main(base + ["--save_dir", str(tmp_path / "jax"), "--steps_per_dispatch", "2"])
    raw = [open(tmp_path / d / "inference_predictions.json", "rb").read()
           for d in ("k1", "k2")]
    assert raw[1] == raw[0]
    got, want = (json.load(open(tmp_path / d / "inference_predictions.json"))
                 for d in ("k2", "jax"))
    assert got["num_images"] == want["num_images"] == 12
    for g, w in zip(got["predictions"], want["predictions"]):
        assert g["image_path"] == w["image_path"]
        np.testing.assert_allclose(list(g["class_probabilities"].values()),
                                   list(w["class_probabilities"].values()), atol=1e-5)


# ------------------------------------------------ gradient accumulation


def test_accum_without_batch_statistics_equals_the_full_batch_and_jax():
    from heuristique_style_transfer_code_tpu.config.schema import MultiPatchGANConfig as JConfig
    from heuristique_style_transfer_code_tpu.train.factories import (
        setup_multi_patchgan as j_setup,
    )

    cfg = dict(F3, batch_size=4)
    rng = np.random.RandomState(9)
    u8 = rng.randint(0, 256, (4, 224, 224, 3)).astype(np.uint8)
    labels = np.array([1, -1, 3, 0], np.int32)  # a pad entry in the first micro-batch
    setup = setup_multi_patchgan(MultiPatchGANConfig(**cfg), 4, [(None, None)], device="cpu")
    tree = to_jax_tree(setup.init(torch.Generator().manual_seed(2))[0])
    start = _flatten(tree)
    moved = {}
    for dtype in (torch.float64, torch.float32):
        run = setup_multi_patchgan(MultiPatchGANConfig(**cfg), 4, [(None, None)],
                                   compute_dtype=dtype if dtype == torch.float64 else None,
                                   device="cpu")
        for name, step in (("full", run.train_step), ("accum", run.accum_step(2))):
            model, _ = run.init(None)
            model = load_jax_tree(model, tree).to(dtype)
            opt = run.optimizer[0](model)
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            _, opt, loss = step(model, opt, u8, labels)
            moves = {n: p.detach() - before[n] for n, p in model.named_parameters()}
            moved[name, dtype] = (float(loss), moves, _flatten(to_jax_tree(model)))
    js = j_setup(JConfig(**cfg), 4, [(None, None)], pretrained=tree)
    variables, j_opt = js.init(jax.random.PRNGKey(0))
    new_v, _, j_loss = js.accum_step(2)(variables, j_opt, jnp.asarray(u8), jnp.asarray(labels),
                                        jnp.zeros(4, jnp.int32), jax.random.PRNGKey(1))
    want = _flatten(jax.tree_util.tree_map(np.asarray, new_v))
    (full_loss, full, _), (loss, accum, _) = (moved[k, torch.float64] for k in ("full", "accum"))
    assert loss == pytest.approx(full_loss, rel=1e-12)
    for name, m in accum.items():
        # the zero-gradient conv biases: rounding noise, 1e-12 at most
        bound = max(1e-6 * float(full[name].abs().max()), 1e-12)
        assert float((m - full[name]).abs().max()) <= bound, name
    loss, _, got = moved["accum", torch.float32]
    assert loss == pytest.approx(float(j_loss), rel=1e-5)
    for key in want:
        if key.endswith("__none__"):
            continue
        if key.endswith("conv/bias") and "out_conv" not in key:
            assert np.abs(got[key] - start[key]).max() <= 1e-6, key
            continue
        assert _move_gap(got[key], want[key], start[key]) <= 1e-2, key


def test_accum_ghost_batch_norm_matches_jax_in_float64():
    """Family 2: JAX's ``make_train_step_accum`` in float64 on the port's
    augmented pixels, against the port's accumulation step in float64; then
    the port's f32 accumulation step against a hand-written loop over the
    two micro-batches (each its own forward in train mode, the summed
    unnormalised NLL's gradients divided once), bit for bit."""
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_apply as j_apply,
    )
    from heuristique_style_transfer_code_tpu.train.optim import sgd_momentum as j_sgd
    from heuristique_style_transfer_code_tpu.train.train_loop import (
        make_train_step_accum as j_accum,
    )
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.train.optim import sgd_momentum
    from heuristique_style_transfer_code_tpu_torch.train.train_loop import (
        _masked_nll_parts,
        make_train_step_accum,
    )

    rng = np.random.RandomState(10)
    u8 = rng.randint(0, 256, (4, 40, 40, 3)).astype(np.uint8)
    labels = np.array([0, 3, -1, 2], np.int32)
    lr = 0.05
    augment = make_augment_fn([(None, None)], crop=32)
    images = augment(torch.from_numpy(u8))
    tree = to_jax_tree(gram_attention_init(torch.Generator().manual_seed(11), 5, 4, 4,
                                           device="cpu"))
    start = _flatten(tree)

    def port_model(dtype):
        model = load_jax_tree(gram_attention_init(None, 5, 4, 4, device="cpu"), tree)
        return model.to(dtype).train()

    def forward(model, x):
        return gram_attention_apply(model, x.to(next(model.parameters()).dtype), 5, 4, 4)[1]

    def port_accum(dtype):
        """(loss, each parameter's move taken in ``dtype``, the leaves)."""
        model = port_model(dtype)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        init, update = sgd_momentum(lr)
        step = make_train_step_accum(forward, (init, update),
                                     lambda x, c, d: images.to(dtype), 2)
        _, _, loss = step(model, init(model), u8, labels)
        moves = {n: p.detach() - before[n] for n, p in model.named_parameters()}
        return (float(loss), _flatten(to_jax_tree(model, moves)),
                _flatten(to_jax_tree(model)))

    with jax.enable_x64():
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        x64 = jnp.asarray(images.double().numpy())

        def j_forward(v, x):
            _, logits, new_v = j_apply(v, x, 5, 4, 4, train=True)
            return logits, new_v

        opt = j_sgd(lr, v)
        new_v, _, j_loss = jax.jit(j_accum(j_forward, opt, lambda x, c, k: x64, 2))(
            v, opt.init(v), jnp.asarray(u8), jnp.asarray(labels), jnp.zeros(4, jnp.int32),
            jax.random.PRNGKey(0))
        want = _flatten(jax.tree_util.tree_map(np.asarray, new_v))
    loss, moves, got = port_accum(torch.float64)
    assert loss == pytest.approx(float(j_loss), rel=1e-7)
    for key in want:
        if key.endswith(("/mean", "/var")):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-9, err_msg=key)
        else:
            assert _rel_l2(moves[key], want[key] - start[key]) <= 1e-5, key

    loss32, _, got32 = port_accum(torch.float32)
    model = port_model(torch.float32)
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    g_sum, nll_sum, cnt_sum = None, 0.0, 0.0
    labels_t = torch.from_numpy(labels)
    for part in (slice(0, 2), slice(2, 4)):
        nll, cnt = _masked_nll_parts(forward(model, images[part]), labels_t[part])
        grads = torch.autograd.grad(nll, [params[n] for n in names])
        g_sum = list(grads) if g_sum is None else [a + g for a, g in zip(g_sum, grads)]
        nll_sum, cnt_sum = nll_sum + nll.detach(), cnt_sum + cnt
    with torch.no_grad():
        for n, g in zip(names, g_sum):
            params[n].add_(g / cnt_sum * -lr)
    hand = _flatten(to_jax_tree(model))
    assert loss32 == float(nll_sum / cnt_sum)
    assert all(np.array_equal(got32[k], hand[k]) for k in hand)


def test_accum_refuses_a_batch_it_does_not_divide():
    from heuristique_style_transfer_code_tpu.train.train_loop import (
        make_train_step_accum as j_accum,
    )
    from heuristique_style_transfer_code_tpu_torch.train.optim import sgd_momentum
    from heuristique_style_transfer_code_tpu_torch.train.train_loop import make_train_step_accum

    x = np.zeros((3, 4), np.float32)
    with pytest.raises(ValueError) as jax_err:
        j_accum(lambda v, im: (im @ v["w"], None), None, lambda im, c, k: im, 2)(
            {"w": jnp.zeros((4, 2))}, None, jnp.asarray(x), jnp.zeros(3, jnp.int32),
            jnp.zeros(3, jnp.int32), jax.random.PRNGKey(0))
    lin = torch.nn.Linear(4, 2)
    opt = sgd_momentum(0.1)
    step = make_train_step_accum(lambda m, im: m(im), opt, lambda im, c, d: im, 2)
    with pytest.raises(ValueError, match=str(jax_err.value)):
        step(lin, opt[0](lin), x, np.zeros(3, np.int32))


# ---------------------------------- family-1 checkpoint, family-2 CLI


def test_family1_checkpoint_in_the_family2_cli(tiny_imagefolder, f1_checkpoint, tmp_path,
                                               capsys, monkeypatch):
    """The tree the port's CLI builds: the family-1 encoder, and the head
    of ``gram_attention_init`` from a generator seeded with the config's
    seed. The JAX CLI, its fresh init carried across (it returns the
    port's seeded tree), prints the same message and writes the same
    ``classification_results.json``."""
    import heuristique_style_transfer_code_tpu.models.gram_attention as j_models
    from heuristique_style_transfer_code_tpu.cli.test_gram_attention import main as j_main
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import load_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import (
        family1_encoder_tree,
        main,
    )
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )

    _, ckpt = f1_checkpoint
    cfg = str(tmp_path / "f2.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 4, "truncate_layer": 5, "gram_matrix_size": 4, "seed": 3}, f)
    fresh = to_jax_tree(gram_attention_init(torch.Generator().manual_seed(3), 5, 4, 4,
                                            device="cpu"))
    tree = family1_encoder_tree(load_pytree_npz(ckpt), 5, 4, 4, 3)
    flat, enc = _flatten(tree), _flatten({"encoder": load_pytree_npz(ckpt)["moco"]["encoder"]})
    assert flat.keys() == _flatten(fresh).keys()
    for key in flat:
        assert np.array_equal(flat[key], (enc if key.startswith("encoder/") else
                                          _flatten(fresh))[key]), key

    monkeypatch.setattr(j_models, "gram_attention_init",
                        lambda key, t, n, s: jax.tree_util.tree_map(jnp.asarray, fresh))
    argv = ["--data", str(tiny_imagefolder), "--config_path", cfg, "--model_path", ckpt,
            "--mode", "classification"]
    message = ("Family-1 checkpoint detected: loaded its encoder; gram/attention head freshly "
               "initialised.")
    results = []
    for side, run, extra in (("jax", j_main, []), ("torch", main, ["--device", "cpu"])):
        run(argv + ["--save_dir", str(tmp_path / side)] + extra)
        assert message in capsys.readouterr().out
        with open(tmp_path / side / "classification_results.json") as f:
            results.append(json.load(f))
    assert results[1] == results[0]
