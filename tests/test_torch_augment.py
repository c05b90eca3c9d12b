"""The port's augmentation (``data/augment.py``) against the JAX package's,
on the CPU: each transform's deterministic form on the same seeded numpy
images and parameters; the random wrappers' draws inside JAX's ranges; a
batch of mixed combinations equal, image by image, to JAX's deterministic
forms composed (geometric, colour, centre crop, ImageNet normalisation)
with the parameters the port drew; the same device ops for a batch
whatever combinations it holds; ``generate_transform_combinations``,
``select_augmentations`` under one seed, the loader's combination ids and
draws, and k-fold's product expansion.

Tolerances, absolute on [0, 1] images: 1e-5 for every transform (measured:
0 for brightness, hue and the flips, about 1e-7 for the luma blends and
rotation, 3.5e-6 for affine and the resized crop, whose float32 sampling
coordinates round differently by a few ulps of the canvas size); 1e-4 on
the normalised batch (that 1e-5 divided by ImageNet's std, 0.225 at the
smallest)."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.data import augment as pa

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(3, 24, 30, 3).astype(np.float32)


def _ja():
    from heuristique_style_transfer_code_tpu.data import augment as ja

    return ja


def _check(jax_fn, port_fn, images, params):
    for i, p in enumerate(params):
        want = np.asarray(jax_fn(jnp.asarray(images[i]), *p))
        got = port_fn(torch.from_numpy(images[i:i + 1]), *p)[0].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=str(p))


@pytest.mark.parametrize("name", ["adjust_brightness", "adjust_contrast", "adjust_saturation"])
def test_blend_transforms_match_jax(images, name):
    _check(getattr(_ja(), name), getattr(pa, name), images, [(0.5,), (1.27,), (1.5,)])


def test_adjust_hue_matches_jax(images):
    grey = images.copy()
    grey[2, :4] = 0.5  # maxc == minc: no hue
    _check(_ja().adjust_hue, pa.adjust_hue, grey, [(0.07,), (-0.1,), (0.0999,)])


def test_to_grayscale_matches_jax(images):
    _check(_ja().to_grayscale, pa.to_grayscale, images, [(), (), ()])


@pytest.mark.parametrize("name", ["horizontal_flip", "vertical_flip"])
def test_flips_are_exact(images, name):
    fn = getattr(_ja(), name)
    for i in range(3):
        want = np.asarray(fn(jnp.asarray(images[i]), None))
        got = getattr(pa, name)(torch.from_numpy(images[i:i + 1]))[0].numpy()
        np.testing.assert_array_equal(got, want)


def test_rotate_by_matches_jax(images):
    _check(_ja().rotate_by, pa.rotate_by, images, [(7.3,), (-15.0,), (14.9,)])


def test_affine_by_matches_jax(images):
    _check(_ja().affine_by, pa.affine_by, images,
           [(7.3, (1.5, -2.2), 0.93), (-14.2, (3.0, 2.4), 1.1), (0.0, (0.0, 0.0), 1.0)])


def test_resized_crop_box_matches_jax(images):
    _check(_ja().resized_crop_box, pa.resized_crop_box, images,
           [(2.3, 1.7, 20.1, 26.5), (0.0, 0.0, 24.0, 30.0), (3.9, 8.2, 8.0, 21.3)])


def test_per_image_parameters_in_one_call(images):
    """One call, a different parameter per image: each row is the
    single-image call's."""
    degs = [5.0, -9.5, 12.25]
    batch = pa.rotate_by(torch.from_numpy(images), degs).numpy()
    for i, d in enumerate(degs):
        np.testing.assert_array_equal(batch[i], pa.rotate_by(torch.from_numpy(images[i:i + 1]),
                                                             d)[0].numpy())


# --------------------------------------------------------------- draws


def test_draws_fall_inside_the_jax_ranges():
    """A thousand draws of each random wrapper inside JAX's ranges
    (``:121-258``), spread over them; the resized crop's box inside the
    canvas with its area and aspect ratio in range."""
    u = pa.batch_draws((3, 1, 0, 7), 1000)
    assert u.shape == (1000, pa.N_DRAWS) and u.dtype == np.float32
    assert (u >= 0).all() and (u < 1).all()
    deg = pa.rotation_draw(u[:, 0])
    assert deg.min() >= -15 and deg.max() < 15 and np.ptp(deg) > 28
    h, w = 256, 200
    deg, scale, ty, tx = pa.affine_draw(u[:, :4], h, w)
    assert deg.min() >= -15 and deg.max() <= 15
    assert scale.min() >= 0.9 and scale.max() <= 1.1 and np.ptp(scale) > 0.19
    assert np.abs(ty).max() <= 0.1 * h and np.abs(tx).max() <= 0.1 * w
    top, left, ch, cw = pa.resized_crop_draw(u[:, :4], h, w)
    assert ch.min() >= 8 and ch.max() <= h and cw.min() >= 8 and cw.max() <= w
    assert (top >= 0).all() and (top + ch <= h + 1e-3).all()
    assert (left >= 0).all() and (left + cw <= w + 1e-3).all()
    unclipped = (ch < h) & (cw < w)
    area = ch * cw / (h * w)
    assert area[unclipped].min() >= 0.8 - 1e-5 and area.max() <= 1 + 1e-5
    ratio = (cw / ch)[unclipped]
    assert ratio.min() >= 0.75 - 1e-5 and ratio.max() <= 4 / 3 + 1e-5
    for name in ("brightness", "contrast", "saturation"):
        f = pa.color_draw(name, u[:, 4])
        assert f.min() >= 0.5 and f.max() < 1.5 and np.ptp(f) > 0.95
    hue = pa.color_draw("hue", u[:, 4])
    assert hue.min() >= -0.1 and hue.max() < 0.1


def test_batch_draws_depend_only_on_their_key():
    a = pa.batch_draws((0, 1, 2, 3), 8)
    np.testing.assert_array_equal(a, pa.batch_draws((0, 1, 2, 3), 8))
    for other in ((0, 1, 2, 4), (0, 1, 3, 3), (0, 0, 2, 3), (1, 1, 2, 3)):
        assert not np.array_equal(a, pa.batch_draws(other, 8))


# ------------------------------------------------- the batched augmentation


def _jax_reference(img_u8, geom, color, params):
    """JAX's deterministic forms composed as its ``make_augment_fn`` branch
    composes the random ones, with the port's drawn parameters."""
    from heuristique_style_transfer_code_tpu.ops.resize import center_crop, normalize_imagenet

    ja = _ja()
    img = jnp.asarray(img_u8, jnp.float32) / 255.0
    h, w = img.shape[:2]
    u = params
    if geom == "horizontal_flip":
        img = ja.horizontal_flip(img, None)
    elif geom == "vertical_flip":
        img = ja.vertical_flip(img, None)
    elif geom == "rotation":
        img = ja.rotate_by(img, float(pa.rotation_draw(u[0])))
    elif geom == "affine":
        deg, scale, ty, tx = (float(v) for v in pa.affine_draw(u[:4], h, w))
        img = ja.affine_by(img, deg, translate=(tx, ty), scale=scale)
    elif geom == "resized_crop":
        img = ja.resized_crop_box(img, *(float(v) for v in pa.resized_crop_draw(u[:4], h, w)))
    f = float(pa.color_draw(color, u[4]))
    if color == "brightness":
        img = ja.adjust_brightness(img, f)
    elif color == "contrast":
        img = ja.adjust_contrast(img, f)
    elif color == "saturation":
        img = ja.adjust_saturation(img, f)
    elif color == "hue":
        img = ja.adjust_hue(img, f)
    elif color == "grayscale":
        img = ja.to_grayscale(img)
    return np.asarray(normalize_imagenet(center_crop(img, 20)))


ALL_COMBOS = ([(None, None)] + [(g, c) for g in pa.AVAILABLE_GEOM_TRANSFORMS
                                for c in pa.AVAILABLE_COLOR_TRANSFORMS])


def test_mixed_batch_matches_jax_composition():
    """The identity and all 25 (geometric x colour) combinations in one
    batch of 26 staged uint8 images: each image equals JAX's
    deterministic composition with its own drawn parameters."""
    rng = np.random.RandomState(1)
    u8 = rng.randint(0, 256, (len(ALL_COMBOS), 26, 28, 3)).astype(np.uint8)
    ids = np.arange(len(ALL_COMBOS))
    draws = pa.batch_draws((0, 0, 0, 0), len(ids))
    got = pa.make_augment_fn(ALL_COMBOS, crop=20)(torch.from_numpy(u8), ids, draws).numpy()
    assert got.shape == (len(ids), 20, 20, 3) and got.dtype == np.float32
    for i, (geom, color) in enumerate(ALL_COMBOS):
        want = _jax_reference(u8[i], geom, color, draws[i])
        np.testing.assert_allclose(got[i], want, rtol=0, atol=10 * TOL,
                                   err_msg=f"{(geom, color)}")


def test_identity_is_eval_preprocess_and_needs_no_draws():
    u8 = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 26, 28, 3)).astype(np.uint8))
    want = pa.eval_preprocess(u8, 20)
    assert torch.equal(pa.make_augment_fn([(None, None)], 20)(u8), want)
    # an identity image inside a mixed batch is bit-equal too
    mixed = pa.make_augment_fn([(None, None), ("rotation", "hue")], 20)
    got = mixed(u8, np.array([0, 1]), pa.batch_draws((1,), 2))
    assert torch.equal(got[0], want[0]) and not torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="draws"):
        mixed(u8, np.array([0, 1]))
    with pytest.raises(ValueError, match="unknown"):
        pa.make_augment_fn([("shear", None)])


def test_a_batch_takes_the_same_ops_whatever_its_combinations():
    """The device ops of one batch depend on the run's combination list,
    not on which combinations the batch holds."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    augment = pa.make_augment_fn(ALL_COMBOS, crop=20)
    u8 = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (4, 26, 28, 3)).astype(np.uint8))
    draws = pa.batch_draws((2,), 4)
    seen = []
    for ids in ([0, 0, 0, 0], [1, 7, 13, 25], [25, 25, 25, 25]):
        with Count() as c:
            augment(u8, np.array(ids), draws)
        seen.append(c.ops)
    assert seen[0] == seen[1] == seen[2]


# ------------------------------------------------------ selection, product


def test_generate_transform_combinations_matches_jax():
    ja = _ja()
    for geom, color in (([None], [None]), (["rotation", "affine"], [None]),
                        ([None], ["hue", "grayscale"]), (list(pa.AVAILABLE_GEOM_TRANSFORMS),
                                                         list(pa.AVAILABLE_COLOR_TRANSFORMS)),
                        ([], [])):
        assert (pa.generate_transform_combinations(geom, color)
                == ja.generate_transform_combinations(geom, color))
    assert pa.AVAILABLE_GEOM_TRANSFORMS == ja.AVAILABLE_GEOM_TRANSFORMS
    assert pa.AVAILABLE_COLOR_TRANSFORMS == ja.AVAILABLE_COLOR_TRANSFORMS


@pytest.mark.parametrize("flags", [
    dict(color_aug=True, num_color_transforms=2, geom_aug=True, num_geom_transforms=3),
    dict(color_aug=True, num_color_transforms=9),
    dict(geom_aug=True, geom_transforms=["affine", "swirl", "vertical_flip"]),
    dict(geom_aug=True, geom_transforms=["swirl"]),
    dict(color_aug=False, num_color_transforms=2, geom_aug=False, num_geom_transforms=2),
])
@pytest.mark.parametrize("seed", [0, 123])
def test_select_augmentations_matches_jax_under_one_seed(flags, seed, capsys):
    """``resolve_seed`` then ``select_augmentations``, in each package, as
    the train CLIs call them: the same transforms, and the same warning
    for an unknown name."""
    import argparse

    from heuristique_style_transfer_code_tpu.cli._common import resolve_seed as j_seed
    from heuristique_style_transfer_code_tpu.cli._common import select_augmentations as j_select
    from heuristique_style_transfer_code_tpu_torch.cli._common import (
        resolve_seed,
        select_augmentations,
    )

    args = argparse.Namespace(**{"color_aug": False, "geom_aug": False, "num_color_transforms": 0,
                                 "num_geom_transforms": 0, "geom_transforms": None, **flags})
    j_seed({}, seed)
    want = j_select(args)
    j_out = capsys.readouterr().out
    random.seed(seed + 1)  # whatever came before, resolve_seed reseeds
    resolve_seed({}, seed)
    assert select_augmentations(args) == want
    assert capsys.readouterr().out == j_out


def test_loader_carries_combination_ids_and_draws(tiny_imagefolder):
    """The loader's "combo" equals the JAX loader's (pads keep their
    sample's id); "draws" are ``batch_draws(key + (epoch, batch))``, the
    same after ``set_position``."""
    from heuristique_style_transfer_code_tpu.data.loader import HostLoader as JHostLoader
    from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
    from heuristique_style_transfer_code_tpu_torch.data.loader import HostLoader

    samples = ImageFolderIndex(str(tiny_imagefolder / "train")).samples[:5]
    combos = [3, 1, 4, 1, 5]
    port = HostLoader(samples, 2, combo_ids=combos, shuffle=True, seed=4, num_workers=1,
                      draw_key=(9, 1))
    theirs = JHostLoader(samples, 2, combo_ids=combos, shuffle=True, seed=4, num_workers=1)
    for epoch in range(2):
        got, want = list(port), list(theirs)
        assert len(got) == len(want) == 3
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g["combo"], w["combo"])
            np.testing.assert_array_equal(g["indices"], w["indices"])
            np.testing.assert_array_equal(g["draws"], pa.batch_draws((9, 1, epoch, i), 2))
    port.set_position(1, 2)
    (last,) = list(port)
    np.testing.assert_array_equal(last["draws"], pa.batch_draws((9, 1, 1, 2), 2))
    assert "draws" not in next(iter(HostLoader(samples, 2, num_workers=1)))
    with pytest.raises(ValueError, match="combination ids"):
        HostLoader(samples, 2, combo_ids=[0])


class _Stop(Exception):
    pass


def _first_train_loader(module, loader_name, call, monkeypatch):
    """The arguments of the first train loader ``call`` builds in
    ``module`` (a shuffled one), stopping the run right after it."""
    real = getattr(module, loader_name)
    seen = {}

    def spy(samples, batch_size, combo_ids=None, shuffle=False, seed=0, **kw):
        if shuffle:
            seen.update(samples=list(samples), combo_ids=list(combo_ids), seed=seed)
        return real(samples, batch_size, combo_ids=combo_ids, shuffle=shuffle, seed=seed, **kw)

    monkeypatch.setattr(module, loader_name, spy)
    with pytest.raises(_Stop):
        call()
    return seen


def test_kfold_product_expansion_matches_jax(tiny_imagefolder, tmp_path, monkeypatch):
    """Each train sample x each combination, with its id, loader
    seed ``seed + fold``: the same samples and ids in both packages."""
    from heuristique_style_transfer_code_tpu.data.imagefolder import ImageFolderIndex as JIndex
    from heuristique_style_transfer_code_tpu.train import kfold as jk
    from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
    from heuristique_style_transfer_code_tpu_torch.train import kfold as pk

    def stop(*_):
        raise _Stop

    common = dict(k_folds=3, seed=5, epochs=1, batch_size=4, hyperparameters={},
                  combos_per_sample=3)
    want = _first_train_loader(jk, "HostLoader", lambda: jk.run_kfold(
        JIndex(str(tiny_imagefolder / "train")), save_dir=str(tmp_path / "j"), init_fn=stop,
        **common), monkeypatch)
    got = _first_train_loader(pk, "HostLoader", lambda: pk.run_kfold(
        ImageFolderIndex(str(tiny_imagefolder / "train")), save_dir=str(tmp_path / "p"),
        init_fn=stop, **common), monkeypatch)
    assert len(got["samples"]) == 16 * 3  # 24 samples, 3 folds: 16 train
    assert got == want
