"""The port's style-transfer optimiser against the JAX one: truncate 4,
32 px, 5 iterations, the same numpy noise and the same target Grams
(``jax.random`` noise cannot be reproduced in torch, so both sides take
noise0 from numpy).

Tolerances: per-image loss trajectories rtol 1e-3. Pixels: 99.9% within
1e-4, and every pixel within 2·lr·iterations — Adam normalises each
element's step by its own gradient history, so an element whose gradient
is near zero may step in the other direction on the two sides, but no step
exceeds about lr, which bounds the gap."""
import functools

import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.tasks.style_transfer import (
    make_gram_fn_gram_attention as j_make_gram_fn,
)
from heuristique_style_transfer_code_tpu.tasks.style_transfer import (
    make_style_transfer_optimizer as j_make_opt,
)
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree, to_jax_tree
from heuristique_style_transfer_code_tpu_torch.models.gram_attention import gram_attention_init
from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
    make_gram_fn_gram_attention,
    make_style_transfer_optimizer,
)

TRUNC, LR, ITERS = 4, 0.01, 5


@functools.lru_cache(maxsize=None)
def _setup():
    # seeded weights in the JAX tree layout, bridged into the port
    model = gram_attention_init(torch.Generator().manual_seed(0), TRUNC, 4, 4, device="cpu")
    tree = to_jax_tree(model)
    j_gram_fn = j_make_gram_fn(tree, TRUNC)
    model = load_jax_tree(gram_attention_init(None, TRUNC, 4, 4, device="cpu"), tree)
    gram_fn = make_gram_fn_gram_attention(model, TRUNC)
    rng = np.random.RandomState(0)
    content = rng.randn(2, 32, 32, 3).astype(np.float32)
    noise0 = rng.randn(2, 32, 32, 3).astype(np.float32)
    targets = [np.asarray(t) for t in j_gram_fn(content)]
    return j_gram_fn, gram_fn, noise0, targets


def _jax_run(iters, threshold, targets=None):
    j_gram_fn, _, noise0, t = _setup()
    noise, i, per = j_make_opt(j_gram_fn, LR, iters, threshold)(noise0, targets or t)
    return np.asarray(noise), int(i), np.asarray(per)


def _port_run(iters, threshold, targets=None, history=None):
    _, gram_fn, noise0, t = _setup()
    run = make_style_transfer_optimizer(gram_fn, LR, iters, threshold)
    noise, i, per = run(torch.tensor(noise0), [torch.tensor(x) for x in targets or t],
                        history)
    return noise.numpy(), i, per.numpy()


def _assert_pixels_close(got, want, iters):
    gap = np.abs(got - want)
    assert (gap <= 1e-4).mean() >= 0.999, (gap > 1e-4).mean()
    assert gap.max() <= 2 * LR * iters, gap.max()


def test_target_grams_match_jax():
    j_gram_fn, gram_fn, noise0, _ = _setup()
    want = np.asarray(j_gram_fn(noise0)[0])
    got = gram_fn(torch.tensor(noise0))[0].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_loss_trajectory_and_pixels_match_jax():
    history = []
    noise, iters, per = _port_run(ITERS, 0.0, history=history)
    assert iters == ITERS and len(history) == ITERS
    for k in (1, 3, ITERS):  # JAX's loop returns the loss of its last iteration
        _, j_iters, j_per = _jax_run(k, 0.0)
        assert j_iters == k
        np.testing.assert_allclose(history[k - 1].numpy(), j_per, rtol=1e-3)
    j_noise, _, j_per = _jax_run(ITERS, 0.0)
    np.testing.assert_allclose(per, j_per, rtol=1e-3)
    _assert_pixels_close(noise, j_noise, ITERS)
    assert history[-1].mean() < history[0].mean()


def _crossings(trace, thr):
    """Per image, the iteration after whose step it freezes (the first whose
    loss is below ``thr``), or ITERS if it never does."""
    losses = np.stack([t.numpy() for t in trace])  # (ITERS, B)
    return [next((k + 1 for k in range(ITERS) if losses[k, b] < thr), ITERS)
            for b in range(losses.shape[1])]


@pytest.mark.parametrize("case", ["one_image", "all_images"])
def test_early_threshold_freezes_like_jax(case):
    """Image 0 aims at a target near its own Gram, so its loss is far below
    image 1's. 'one_image': the threshold lies between the two, so image 0
    freezes early while image 1 runs to the cap. 'all_images': the threshold
    lies above both images' lowest loss before the last iteration, so the
    whole loop stops early. The iteration count and the frozen pixels equal
    JAX's."""
    j_gram_fn, _, noise0, targets = _setup()
    near = [np.stack([np.asarray(j_gram_fn(noise0)[0])[0] * 1.01, targets[0][1]])]
    trace = []
    _port_run(ITERS, 0.0, near, trace)
    losses = np.stack([t.numpy() for t in trace])  # (ITERS, B)
    lows = losses[:-1].min(axis=0)  # per image, before the last iteration
    if case == "one_image":
        assert lows[0] < losses[:, 1].min()
        thr = float(np.sqrt(lows[0] * losses[:, 1].min()))
    else:
        thr = float(lows.max() * 1.0001)
    cross = _crossings(trace, thr)
    want_iters = max(cross)
    assert cross[0] < ITERS and (want_iters == ITERS) == (case == "one_image")
    noise, iters, per = _port_run(ITERS, thr, near)
    j_noise, j_iters, j_per = _jax_run(ITERS, thr, near)
    assert iters == j_iters == want_iters
    for b, k in enumerate(cross):  # each image froze after its k-th step
        np.testing.assert_array_equal(noise[b], _port_run(k, 0.0, near)[0][b])
    _assert_pixels_close(noise[0], j_noise[0], cross[0])
    _assert_pixels_close(noise, j_noise, want_iters)
    np.testing.assert_allclose(per, j_per, rtol=1e-3)


def test_bf16_encoder_grams_and_first_loss_close_to_jax():
    """``compute_dtype`` bf16: the encoder (weights and BN statistics cast,
    as the JAX policy casts them) runs in bf16, the pixels, Adam and the
    loss stay f32. Tolerance: 2e-2 of max|G| on the Grams (bf16 rounds each
    conv output), 5e-2 relative on the first iteration's loss."""
    import jax.numpy as jnp

    _, _, noise0, targets = _setup()
    model = gram_attention_init(torch.Generator().manual_seed(0), TRUNC, 4, 4, device="cpu")
    tree = to_jax_tree(model)
    j_gram_fn = j_make_gram_fn(tree, TRUNC, compute_dtype=jnp.bfloat16)
    gram_fn = make_gram_fn_gram_attention(model, TRUNC, compute_dtype=torch.bfloat16)
    want = np.asarray(j_gram_fn(noise0)[0], np.float32)
    got = gram_fn(torch.tensor(noise0))[0]
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().detach().numpy() - want).max() <= 2e-2 * np.abs(want).max()
    _, _, j_per = j_make_opt(j_gram_fn, LR, 1, 0.0)(noise0, targets)
    history = []
    make_style_transfer_optimizer(gram_fn, LR, 1, 0.0)(
        torch.tensor(noise0), [torch.tensor(t) for t in targets], history)
    np.testing.assert_allclose(history[0].numpy(), np.asarray(j_per), rtol=5e-2)
