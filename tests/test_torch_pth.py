"""The port's reference ``.pth`` support (``checkpoint/pth_converter.py``,
``checkpoint/pth_exporter.py``, ``cli/_common.load_checkpoint_tree``,
``cli/convert_checkpoint.py``) against the JAX package's.

The reference-layout state dicts are made here: the JAX exporter's output
for seeded JAX trees (ndf 8, gram dim 8, truncate 5), and the layouts the
converter's four strategies take, derived from it as
``tests/test_checkpoint_aux.py`` and ``tests/test_data_and_train.py`` do
from the reference's own modules: (a) the nested family-1 checkpoint, its
flat form with ``classifier.`` keys and a moco-only one; (b) a raw
torchvision resnet state dict, named keys and its ``fc`` head; (c) the
family-2 component dicts and their flat prefixed form; (d) the
shape-filtered partial update. Nothing here needs the reference's code.

Every comparison is exact (``np.array_equal`` on every leaf, the same
dtypes and the same tree): both packages transpose and copy the same numpy
values. The CLIs' ``.pth`` runs equal their ``.npz`` runs byte for byte
(the same float32 weights reach the same model).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.checkpoint import pth_converter as jpc
from heuristique_style_transfer_code_tpu.checkpoint import pth_exporter as jpe
from heuristique_style_transfer_code_tpu.cli.convert_checkpoint import main as j_convert
from heuristique_style_transfer_code_tpu.models import gram_attention as jga
from heuristique_style_transfer_code_tpu.models import multi_patchgan as jmp
from heuristique_style_transfer_code_tpu.models import truncated_resnet50 as jtr
from heuristique_style_transfer_code_tpu_torch.checkpoint import pth_converter as ppc
from heuristique_style_transfer_code_tpu_torch.checkpoint import pth_exporter as ppe
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import load_pytree_npz, save_pytree_npz
from heuristique_style_transfer_code_tpu_torch.cli.convert_checkpoint import main as p_convert

PATCH = {"small": 10, "medium": 70, "large": 150}
NDF, GDIM = 8, 8
F3_CONFIG = {"patch_sizes": PATCH, "ndf": NDF, "gram_matrix_dim": GDIM, "num_classes": 4}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same_tree(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got),
                                                                        sorted(want))
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), path


def _named(sd, prefix=""):
    """Sequential-positional encoder keys (``<prefix>0.weight``) renamed to
    torchvision's child names (``<prefix>conv1.weight``)."""
    out = {}
    for k, v in sd.items():
        head, _, tail = k[len(prefix):].partition(".")
        if not k.startswith(prefix) or not head.isdigit():
            out[k] = v
            continue
        out[f"{prefix}{jpc.RESNET50_CHILDREN[int(head)]}.{tail}"] = v
    return out


@pytest.fixture(scope="module")
def trees():
    k = jax.random.split(jax.random.PRNGKey(0), 7)
    return {
        "truncated_resnet50": _np({"moco": jtr.truncated_moco_init(k[0], 5, dim=16),
                                   "classifier": jtr.classifier_init(k[1], 16, 4)}),
        "gram_attention": _np(jga.gram_attention_init(k[2], 5, 4, 4)),
        "multi_patchgan_test/batch": _np(jmp.multiscale_test_init(
            k[3], PATCH, ndf=NDF, num_classes=4, gram_matrix_dim=GDIM, norm="batch")),
        "multi_patchgan_test/instance": _np(jmp.multiscale_test_init(
            k[4], PATCH, ndf=NDF, num_classes=4, gram_matrix_dim=GDIM, norm="instance")),
        "multi_patchgan/batch": _np(jmp.multiscale_init(k[5], PATCH, ndf=NDF, num_classes=4,
                                                        norm="batch")),
        "multi_patchgan/instance": _np(jmp.multiscale_init(k[6], PATCH, ndf=NDF, num_classes=4,
                                                           norm="instance")),
    }


def _layout(trees, name):
    """(state dict in a reference layout, converter name, its extra args)."""
    if name.startswith("f1"):
        nested = jpe.export_moco_checkpoint(trees["truncated_resnet50"])
        moco, clf = nested["moco_model_state_dict"], nested["classifier_state_dict"]
        flat = {**moco, **{f"classifier.{k[len('fc.'):]}": v for k, v in clf.items()}}
        sd = {"f1_nested": nested, "f1_flat": flat, "f1_moco_only": dict(moco),
              "f1_named": {**_named(moco, "truncated_encoder."),
                           **{f"classifier.{k[len('fc.'):]}": v for k, v in clf.items()}}}[name]
        return sd, "convert_moco_checkpoint", {}
    if name.startswith("f2"):
        comp = jpe.export_gram_attention_checkpoint(trees["gram_attention"])
        if name == "f2_components":
            sd = comp
        elif name == "f2_flat":
            sd = {f"{part}.{k}": v for part, d in comp.items() for k, v in d.items()}
        else:  # a raw torchvision resnet50: named keys, fc head skipped
            sd = {**_named(comp["truncated_encoder"]), "fc.weight": np.ones((10, 2048), np.float32),
                  "fc.bias": np.zeros(10, np.float32)}
        return sd, "convert_gram_attention_checkpoint", {}
    family, norm = name.split(":")
    key = f"{family}/{norm}"
    export = (jpe.export_multi_patchgan_test_checkpoint if family == "multi_patchgan_test"
              else jpe.export_multi_patchgan_checkpoint)
    conv = ("convert_multi_patchgan_test_checkpoint" if family == "multi_patchgan_test"
            else "convert_multi_patchgan_checkpoint")
    return export(trees[key], norm=norm), conv, {"patch_sizes": PATCH, "ndf": NDF, "norm": norm}


LAYOUTS = ["f1_nested", "f1_flat", "f1_moco_only", "f1_named", "f2_components", "f2_flat",
           "f2_torchvision", "multi_patchgan_test:batch", "multi_patchgan_test:instance",
           "multi_patchgan:batch", "multi_patchgan:instance"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_converter_equals_jax(trees, layout):
    sd, conv, kw = _layout(trees, layout)
    if layout in ("f1_named", "f2_torchvision"):
        assert {"truncated_encoder.conv1.weight", "conv1.weight"} & set(sd), sorted(sd)[:3]
    want = getattr(jpc, conv)(sd, **kw)
    got = getattr(ppc, conv)(sd, **kw)
    _assert_same_tree(got, want)
    if layout in ("f1_nested", "f2_components", "multi_patchgan_test:batch"):
        # and the round trip: the exporter's layout converts back to the tree
        src = {"f1_nested": "truncated_resnet50", "f2_components": "gram_attention",
               "multi_patchgan_test:batch": "multi_patchgan_test/batch"}[layout]
        _assert_same_tree(got, trees[src])


def test_pth_file_through_load_torch_state_dict(trees, tmp_path):
    """A nested ``.pth`` file read by each package's ``torch.load`` path."""
    path = str(tmp_path / "f1.pth")
    jpe.save_pth(jpe.export_moco_checkpoint(trees["truncated_resnet50"]), path)
    _assert_same_tree(ppc.load_torch_state_dict(path), jpc.load_torch_state_dict(path))
    _assert_same_tree(ppc.convert_moco_checkpoint(path), jpc.convert_moco_checkpoint(path))


@pytest.mark.parametrize("family,key,config", [
    ("truncated_resnet50", "truncated_resnet50", {}),
    ("gram_attention", "gram_attention", {}),
    ("multi_patchgan_test", "multi_patchgan_test/batch", {"norm": "batch"}),
    ("multi_patchgan_test", "multi_patchgan_test/instance", {"norm": "instance"}),
    ("multi_patchgan", "multi_patchgan/batch", {"norm": "batch"}),
    ("multi_patchgan", "multi_patchgan/instance", {"norm": "instance"}),
])
def test_exporter_equals_jax(trees, family, key, config, tmp_path):
    want = jpe.export_checkpoint_tree(trees[key], family, config)
    got = ppe.export_checkpoint_tree(trees[key], family, config)
    _assert_same_tree(got, want)
    # saved files hold the same tensors
    pp, jp = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    ppe.save_pth(got, pp)
    jpe.save_pth(want, jp)
    _assert_same_tree(jpc.to_numpy_state_dict(torch.load(pp, weights_only=False)),
                      jpc.to_numpy_state_dict(torch.load(jp, weights_only=False)))


def _loaded_paths(out, source, path=""):
    """Paths of ``out``'s leaves that are the very ``source`` leaves (what
    shape_filtered_update took from the checkpoint)."""
    if isinstance(out, dict):
        found = set()
        for k, v in out.items():
            if isinstance(source, dict) and k in source:
                found |= _loaded_paths(v, source[k], f"{path}/{k}")
        return found
    if isinstance(out, (list, tuple)):
        found = set()
        for i, v in enumerate(out):
            if isinstance(source, (list, tuple)) and i < len(source):
                found |= _loaded_paths(v, source[i], f"{path}/{i}")
        return found
    return {path} if out is not None and out is source else set()


@pytest.mark.parametrize("source_kind", ["train_variant", "other_gram_dim", "toy"])
def test_shape_filtered_update_matches_jax(trees, source_kind):
    """The same stats and the same matched leaves as JAX. The target is
    each package's own seeded test-variant init (JAX's PRNGKey and the
    port's torch.Generator draw different numbers), so the unmatched leaves
    come from two inits and cannot agree; the matched ones are the
    checkpoint's own."""
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )

    if source_kind == "toy":  # tests/test_checkpoint_aux.py's case
        j_target = p_target = {"a": np.zeros((2, 2)), "b": np.zeros(3), "c": np.zeros(4),
                               "seq": (np.zeros(2), np.zeros(3))}
        source = {"a": np.ones((2, 2)), "b": np.ones(9), "seq": [np.ones(2), np.ones(9)]}
    else:
        j_target = _np(jmp.multiscale_test_init(jax.random.PRNGKey(9), PATCH, ndf=NDF,
                                                num_classes=4, gram_matrix_dim=GDIM))
        p_target = to_jax_tree(multiscale_test_init(
            torch.Generator().manual_seed(9), PATCH, ndf=NDF, num_classes=4,
            gram_matrix_dim=GDIM, device="cpu"))
        source = (trees["multi_patchgan/batch"] if source_kind == "train_variant" else
                  _np(jmp.multiscale_test_init(jax.random.PRNGKey(10), PATCH, ndf=NDF,
                                               num_classes=4, gram_matrix_dim=4)))
    j_stats, p_stats = {}, {}
    j_out = jpc.shape_filtered_update(j_target, source, j_stats)
    p_out = ppc.shape_filtered_update(p_target, source, p_stats)
    assert p_stats == j_stats and p_stats["total"] > 0
    loaded = _loaded_paths(p_out, source)
    assert loaded == _loaded_paths(j_out, source)
    assert len(loaded) == p_stats.get("loaded", 0)
    if source_kind == "other_gram_dim":  # convs, norms, attentions, classifier: yes;
        assert 0 < len(loaded) < p_stats["total"]  # projections, feature_projection: no
    if source_kind == "toy":
        assert isinstance(p_out["seq"], tuple) and p_stats == {"loaded": 2, "total": 5}


# ------------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, f1_checkpoint):
    """Each family's checkpoint as .npz and as a reference-layout .pth
    (the JAX exporter's), with its config."""
    from heuristique_style_transfer_code_tpu.checkpoint.io import load_pytree_npz as j_load

    d = tmp_path_factory.mktemp("pth")
    out = {}
    cfg1, npz1 = f1_checkpoint
    out["f1"] = (cfg1, npz1, str(d / "f1.pth"))
    jpe.save_pth(jpe.export_moco_checkpoint(j_load(npz1, as_jax=False)), out["f1"][2])
    k = jax.random.split(jax.random.PRNGKey(3), 2)
    t2 = _np(jga.gram_attention_init(k[0], 5, 4, 4))
    cfg2 = str(d / "f2.json")
    with open(cfg2, "w") as f:
        json.dump({"batch_size": 4, "truncate_layer": 5, "gram_matrix_size": 4,
                   "num_classes": 4, "seed": 0}, f)
    save_pytree_npz(t2, str(d / "f2.npz"))
    jpe.save_pth(jpe.export_gram_attention_checkpoint(t2), str(d / "f2.pth"))
    out["f2"] = (cfg2, str(d / "f2.npz"), str(d / "f2.pth"))
    t3 = _np(jmp.multiscale_test_init(k[1], PATCH, ndf=NDF, num_classes=4, gram_matrix_dim=GDIM))
    cfg3 = str(d / "f3.json")
    with open(cfg3, "w") as f:
        json.dump({"batch_size": 4, "seed": 0, "norm": "batch", **F3_CONFIG}, f)
    save_pytree_npz(t3, str(d / "f3.npz"))
    jpe.save_pth(jpe.export_multi_patchgan_test_checkpoint(t3), str(d / "f3.pth"))
    out["f3"] = (cfg3, str(d / "f3.npz"), str(d / "f3.pth"))
    return out


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("family", ["f1", "f2", "f3"])
def test_cli_pth_run_equals_npz_run(tiny_imagefolder, ckpts, tmp_path, family):
    cfg, npz, pth = ckpts[family]
    if family == "f1":
        from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import main
        extra, artifact = ["--batch_size", "4", "--prob_threshold", "0.0"], "metrics.txt"
    elif family == "f2":
        from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main
        extra, artifact = [], "classification_results.json"
    else:
        from heuristique_style_transfer_code_tpu_torch.cli.test_multi_patchgan import main
        extra, artifact = ["--num_samples", "4"], "classification_results.json"
    for name, model in (("npz", npz), ("pth", pth)):
        main(["--data", str(tiny_imagefolder), "--config_path", cfg, "--model_path", model,
              "--save_dir", str(tmp_path / name), "--mode", "classification", "--device", "cpu",
              *extra])
    assert _read(tmp_path / "pth" / artifact) == _read(tmp_path / "npz" / artifact)


def test_serve_style_texture_mode_takes_a_pth(ckpts):
    """serve_style's texture-mode Gram program built from the .pth equals
    the one built from the .npz."""
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style as p_cli

    cfg, npz, pth = ckpts["f2"]
    image = torch.tensor(np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32))
    grams = []
    for model in (npz, pth):
        args = p_cli.build_parser().parse_args(
            ["--config_path", cfg, "--model_path", model, "--layers", "5", "--device", "cpu"])
        with torch.no_grad():
            grams.append(p_cli._build_gram_fn(args, torch.device("cpu"))(image)[0])
    assert torch.equal(grams[0], grams[1])


def test_multi_patchgan_cli_loads_a_train_variant_pth_tree(tiny_imagefolder, ckpts, tmp_path,
                                                           trees, capsys):
    """A train-variant tree (saved as npz after the train converter) loads
    partially, with the JAX CLI's "N/M tensors matched" line and count."""
    from heuristique_style_transfer_code_tpu_torch.cli.test_multi_patchgan import main

    cfg, _, _ = ckpts["f3"]
    sd = jpe.export_multi_patchgan_checkpoint(trees["multi_patchgan/batch"])
    path = str(tmp_path / "train.npz")
    save_pytree_npz(ppc.convert_multi_patchgan_checkpoint(sd, PATCH, ndf=NDF), path)
    main(["--data", str(tiny_imagefolder), "--config_path", cfg, "--model_path", path,
          "--save_dir", str(tmp_path), "--mode", "classification", "--num_samples", "4",
          "--device", "cpu"])
    stats = {}
    jpc.shape_filtered_update(_np(jmp.multiscale_test_init(
        jax.random.PRNGKey(0), PATCH, ndf=NDF, num_classes=4, gram_matrix_dim=GDIM)),
        load_pytree_npz(path), stats)
    assert (f"({stats.get('loaded', 0)}/{stats['total']} tensors matched)"
            in capsys.readouterr().out)


@pytest.mark.parametrize("family,key,config", [
    ("truncated_resnet50", "f1", {}), ("gram_attention", "f2", {}),
    ("multi_patchgan_test", "f3", F3_CONFIG)])
def test_convert_checkpoint_npz_pth_npz(ckpts, tmp_path, family, key, config, capsys):
    """npz -> pth -> npz is an identity, and each step's file equals the
    JAX CLI's."""
    _, npz, _ = ckpts[key]
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(config, f)
    paths = {side: (str(tmp_path / f"{side}.pth"), str(tmp_path / f"{side}.npz"))
             for side in ("port", "jax")}
    for side, convert in (("port", p_convert), ("jax", j_convert)):
        pth, back = paths[side]
        convert(["--family", family, "--input", npz, "--output", pth, "--config", cfg])
        convert(["--family", family, "--input", pth, "--output", back, "--config", cfg])
    out = capsys.readouterr().out
    assert f"Converted {npz} -> {paths['port'][0]} (" in out
    assert out.count("parameters)") == 4
    _assert_same_tree(load_pytree_npz(paths["port"][1]), load_pytree_npz(npz))
    _assert_same_tree(load_pytree_npz(paths["port"][1]), load_pytree_npz(paths["jax"][1]))
    _assert_same_tree(jpc.load_torch_state_dict(paths["port"][0]),
                      jpc.load_torch_state_dict(paths["jax"][0]))


def test_convert_checkpoint_orbax_is_not_ported(ckpts, tmp_path):
    _, npz, _ = ckpts["f2"]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        p_convert(["--family", "gram_attention", "--input", npz, "--output",
                   str(tmp_path / "x.orbax")])
    os.makedirs(tmp_path / "orbax_dir")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        p_convert(["--family", "gram_attention", "--input", str(tmp_path / "orbax_dir"),
                   "--output", str(tmp_path / "x.npz")])
