"""The model axis of the port (``parallel/sharding.py``'s 2-D and 3-D
meshes, layouts and train-step factories, ``parallel/tensor_parallel.py``,
the banded train-mode batch norm) on the CPU.

In the test process, with no spawn: the meshes' shapes against JAX's
``make_mesh_2d``/``make_mesh_3d`` on the conftest's virtual devices, and
``variable_shardings`` and ``fsdp_variable_shardings`` on the three
families' trees against JAX's specs (through the weight bridge's names).

Four gloo ranks spawned once for the module (``tests/torch_model_axis_ranks.py``
holds their bodies, which import no jax) run every factory on a 2x2
(data, model) mesh, ``make_mesh_3d(4)`` = (1, 2, 2), a data mesh of 4 and
a 1x1x4 mesh with thin and empty bands, at JAX's own test sizes
(``tests/test_parallel.py``: truncate 5, dim 16, 4 classes, 96 px canvases,
64 px crop, B 8): in float64 against the port's one-device step, in f32
against JAX's single-device ``make_train_step``.
"""
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    _flatten,
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.parallel import multihost
from heuristique_style_transfer_code_tpu_torch.parallel import sharding as port
from tests import torch_model_axis_ranks as R

F64_TOL = 1e-9
F64_CASES = [c for c, spec in R.CASES.items() if spec[3] == "float64"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ layouts


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shapes_match_jax(n):
    """``mesh_shape_2d``/``mesh_shape_3d`` are JAX's ``dict(mesh.shape)``
    (``tests/test_parallel.py``'s factorisation tables)."""
    from heuristique_style_transfer_code_tpu.parallel import sharding as jsh

    assert port.mesh_shape_2d(n) == dict(jsh.make_mesh_2d(n).shape)
    assert port.mesh_shape_3d(n) == dict(jsh.make_mesh_3d(n).shape)


def _port_model(family: str):
    g = torch.Generator().manual_seed(0)
    if family == "f1":
        from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
            truncated_resnet50_init,
        )

        return truncated_resnet50_init(g, R.F1_TRUNCATE, 4, R.F1_DIM, device="cpu")
    if family == "f2":
        from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
            gram_attention_init,
        )

        return gram_attention_init(g, R.F2_TRUNCATE, 4, R.F2_S, device="cpu")
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )

    return multiscale_test_init(g, R.F3_PATCHES, ndf=8, num_classes=4, gram_matrix_dim=4,
                                device="cpu")


def _jax_names(model):
    """({JAX path: state-dict key}, the JAX-layout tree): each leaf of the
    bridge's tree made of its key's index."""
    keys = list(model.state_dict())
    tensors = {k: torch.full(tuple(v.shape), float(i)) for i, (k, v) in
               enumerate(model.state_dict().items())}
    tree = to_jax_tree(model, tensors)
    names = {path: keys[int(np.asarray(arr).flat[0])] for path, arr in _flatten(tree).items()
             if not path.endswith("__none__") and np.size(arr)}
    return names, tree


def _jax_specs(tree, fn, mesh):
    specs = fn(tree, mesh)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(specs)[0]:
        parts = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        flat["/".join(parts)] = tuple(leaf.spec)
    return flat


@pytest.mark.parametrize("family", ["f1", "f2", "f3"])
@pytest.mark.parametrize("model_size", [2, 3])
def test_variable_shardings_match_jax(family, model_size):
    """The port's ``variable_shardings`` on the family's tree (family 3's
    test variant: ``classifier`` and ``feature_projection``) is JAX's, leaf
    for leaf through the bridge's names: a 2-D kernel split over ``model``
    (``P(None, "model")``) is dim 0 of the (out, in) weight, a split bias
    dim 0, ``P()`` None. At model 3 the 4-class heads stay replicated;
    ``classifier.bias`` is always replicated."""
    from heuristique_style_transfer_code_tpu.parallel import sharding as jsh

    model = _port_model(family)
    names, tree = _jax_names(model)
    mesh = jsh.make_mesh_2d(2 * model_size, model_size)
    specs = _jax_specs(tree, jsh.variable_shardings, mesh)
    got = port.variable_shardings({k: v.shape for k, v in model.state_dict().items()},
                                  model_size)
    assert set(names.values()) == set(got)
    split = 0
    for path, key in names.items():
        spec = specs[path]
        if got[key] is None:
            assert not any(spec), (path, spec)
        else:
            split += 1
            want = (None, "model") if len(model.state_dict()[key].shape) == 2 else ("model",)
            assert got[key] == 0 and spec == want, (path, spec, got[key])
    bias = [k for k in got if k.endswith("classifier.bias")]
    assert all(got[k] is None for k in bias)
    assert (split > 0) == (model_size == 2)


@pytest.mark.parametrize("family", ["f1", "f2", "f3"])
def test_fsdp_shardings_match_jax(family):
    """``fsdp_variable_shardings`` over a data axis of 4 splits the same
    leaves as JAX's, with the same bytes a rank (the axis may differ for
    OIHW kernels against JAX's HWIO ones)."""
    from heuristique_style_transfer_code_tpu.parallel import sharding as jsh
    from jax.sharding import Mesh

    model = _port_model(family)
    names, tree = _jax_names(model)
    mesh = Mesh(np.asarray(jax.devices()[:4]), (jsh.DATA_AXIS,))
    specs = _jax_specs(tree, jsh.fsdp_variable_shardings, mesh)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    got = port.fsdp_variable_shardings(shapes, 4)
    for path, key in names.items():
        assert (got[key] is not None) == any(specs[path]), (path, specs[path], got[key])
        if got[key] is not None:
            assert shapes[key][got[key]] % 4 == 0


# ------------------------------------------------------------ the ranks


def _inputs():
    """JAX's test weights (``tests/test_parallel.py``: PRNGKey(0) split for
    the MoCo encoder and the classifier) and batches (its seed-0 batch,
    then a second with one pad entry); families 2 and 3 from JAX's
    initialisers."""
    from heuristique_style_transfer_code_tpu.models.gram_attention import gram_attention_init
    from heuristique_style_transfer_code_tpu.models.multi_patchgan import multiscale_init
    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import (
        classifier_init,
        truncated_moco_init,
    )

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    k3, k4 = jax.random.split(jax.random.PRNGKey(2))
    rng = np.random.RandomState(0)
    first = rng.randint(0, 256, (R.B, R.STAGE, R.STAGE, 3), dtype=np.uint8)
    second = np.random.RandomState(1).randint(0, 256, (R.B, R.STAGE, R.STAGE, 3),
                                              dtype=np.uint8)
    labels = np.stack([np.arange(R.B, dtype=np.int32) % 4] * 2)
    labels[1, -1] = -1
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"images": np.stack([first, second]), "labels": labels,
            "f1": tree({"moco": truncated_moco_init(k1, R.F1_TRUNCATE, dim=R.F1_DIM),
                        "classifier": classifier_init(k2, R.F1_DIM, 4)}),
            "f2": tree(gram_attention_init(k3, R.F2_TRUNCATE, 4, R.F2_S)),
            "f3": tree(multiscale_init(k4, R.F3_PATCHES, ndf=8, num_classes=4, norm="batch"))}


def _jax_single_device(inputs):
    """JAX's single-device ``make_train_step`` on family 1 in f32 (JAX's
    own test's forward, optimiser and augmentation): the losses and the
    variables after each of the two steps."""
    from heuristique_style_transfer_code_tpu.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import combined_apply
    from heuristique_style_transfer_code_tpu.train.optim import sgd_momentum
    from heuristique_style_transfer_code_tpu.train.train_loop import make_train_step

    def forward_train(v, images):
        logits, new_v = combined_apply(v["moco"], v["classifier"], images, R.F1_TRUNCATE,
                                       train=True)
        return logits, {"moco": new_v, "classifier": v["classifier"]}

    variables = jax.tree_util.tree_map(jnp.asarray, inputs["f1"])
    optimizer = sgd_momentum(R.LR, variables)
    step = make_train_step(forward_train, optimizer, make_augment_fn([(None, None)],
                                                                     crop=R.CROP))
    state = optimizer.init(variables)
    losses = []
    for i in range(R.STEPS):
        variables, state, loss = step(variables, state, inputs["images"][i],
                                      inputs["labels"][i], np.zeros(R.B, np.int32),
                                      jax.random.PRNGKey(1))
        losses.append(float(loss))
    return np.asarray(losses), _flatten(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-device results, every rank's results, JAX's single-device
    run, the spawn's seconds). The ranks run while this process takes the
    references."""
    root = tmp_path_factory.mktemp("model_axis")
    in_dir, out_dir = str(root / "in"), str(root / "out")
    os.makedirs(in_dir)
    os.makedirs(out_dir)
    save_pytree_npz(_inputs(), os.path.join(in_dir, "inputs.npz"))
    inputs = load_pytree_npz(os.path.join(in_dir, "inputs.npz"))  # the ranks' exact inputs
    spawn = {}

    def ranks_job():
        t0 = time.perf_counter()
        try:
            multihost.launch(R.WORLD, None, [], target=R.rank_main,
                             target_args=(in_dir, out_dir), rendezvous_dir=str(root),
                             deadline_s=150.0)
        except SystemExit as e:
            spawn["error"] = e
        spawn["seconds"] = time.perf_counter() - t0

    job = threading.Thread(target=ranks_job)
    job.start()
    one = {}
    try:
        for name in F64_CASES:
            one[name] = R.run_case(None, inputs, name)
        for mesh_name, h in R.BN_CASES:
            one[R.bn_key(mesh_name, h)] = R.bn_case(None, mesh_name, h)
        jax_run = _jax_single_device(inputs)
    finally:
        job.join()
    assert "error" not in spawn, spawn
    ranks = [load_pytree_npz(os.path.join(out_dir, f"rank{r}.npz")) for r in range(R.WORLD)]
    return one, ranks, jax_run, spawn["seconds"]


def _close(got: dict, want: dict, tol: float, what: str, floor: float = R.LR) -> None:
    """Every leaf within ``tol`` of ``want``'s, relative L2, the scale at
    least ``floor`` an element (a conv bias ahead of a batch norm has no
    gradient and stays near zero)."""
    assert got.keys() == want.keys(), what
    for key in want:
        a, b = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        scale = max(np.linalg.norm(b), floor * np.sqrt(b.size))
        assert np.linalg.norm(a - b) <= tol * scale, (what, key, np.linalg.norm(a - b) / scale)


@pytest.mark.parametrize("mesh_name", R.MESHES)
def test_rank_layout_is_jax_reshape(runs, mesh_name):
    """Each rank's axes on each mesh: rank r = (d M + m) S + s (JAX's
    ``reshape(data, model, spatial)``); its data, model and spatial axes
    the ranks that differ from it in that coordinate alone, its replica
    plane those of its model index, in (d, s) order."""
    _, ranks, _, _ = runs
    for r, rk in enumerate(ranks):
        lay = rk["layout"][mesh_name]
        d_n, m_n, s_n = (int(x) for x in lay["shape"])
        assert d_n * m_n * s_n == R.WORLD
        grid = np.arange(R.WORLD).reshape(d_n, m_n, s_n)
        d, m, s = (int(i[0]) for i in np.nonzero(grid == r))
        assert lay["data"].tolist() == grid[:, m, s].tolist()
        assert lay["model"].tolist() == (grid[d, :, s].tolist() if m_n > 1 else [])
        assert lay["spatial"].tolist() == (grid[d, m, :].tolist() if s_n > 1 else [])
        assert lay["replica"].tolist() == grid[:, m, :].reshape(-1).tolist()


@pytest.mark.parametrize("case", F64_CASES)
def test_steps_match_one_device_in_float64(runs, case):
    """Two float64 steps of the case's factory on its mesh against the
    port's one-device step: the global losses and every parameter and
    running statistic (heads and FSDP shards gathered) within 1e-9."""
    one, ranks, _, _ = runs
    got, want = ranks[0][case], one[case]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=F64_TOL)
    _close(got["params"], want["params"], F64_TOL, case)


@pytest.mark.parametrize("case", list(R.CASES))
def test_replicas_are_bit_equal_across_ranks(runs, case):
    """After the steps every rank holds the same bits: the gathered state
    dict, and each rank's own copy of every leaf the mesh replicates
    (every leaf but a split head's block or an FSDP shard), running
    buffers included."""
    _, ranks, _, _ = runs
    first = ranks[0][case]
    split = set(first.get("split", ()))
    for rk in ranks[1:]:
        for key, value in first["params"].items():
            np.testing.assert_array_equal(rk[case]["params"][key], value, err_msg=key)
        for key, value in first["local"].items():
            if key in split or value.shape != first["params"][key].shape:
                continue
            np.testing.assert_array_equal(rk[case]["local"][key], value, err_msg=key)
    family, mesh_name = R.CASES[case][:2]
    blocks = (mesh_name in ("2x2", "3d") and family != "f3") or mesh_name == "d4"
    assert any(v.shape != first["params"][k].shape
               for k, v in first["local"].items()) == blocks  # family 3 has no head


def test_dp_tp_matches_jax_single_device(runs):
    """Family 1 on the 2x2 (data, model) mesh in f32 against JAX's
    single-device ``make_train_step`` on the same weights and batches, at
    JAX's own tolerances (``tests/test_parallel.py:92-96``): the first
    loss rtol 1e-4; the classifier and MoCo fc kernels after it rtol 1e-3,
    atol 1e-5 (after two steps here)."""
    _, ranks, (losses, variables), _ = runs
    got = ranks[0]["f1_2x2_f32"]
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-4)
    mine = _flatten(got["jax"])
    for key in ("classifier/fc/kernel", "moco/fc/kernel"):
        np.testing.assert_allclose(mine[key], variables[key], rtol=1e-3, atol=1e-5, err_msg=key)


def test_fsdp_matches_jax_single_device(runs):
    """FSDP over a data mesh of 4 in f32 against JAX's single-device step,
    at JAX's tolerances (``tests/test_parallel.py:278-282``): both losses
    rtol 1e-5, the classifier's fc kernel rtol 1e-4, atol 1e-6."""
    _, ranks, (losses, variables), _ = runs
    got = ranks[0]["f1_fsdp_f32"]
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
    key = "classifier/fc/kernel"
    np.testing.assert_allclose(_flatten(got["jax"])[key], variables[key], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", ["f1_fsdp", "f1_fsdp_f32"])
def test_fsdp_stores_a_quarter_of_the_split_leaves(runs, case):
    """Each FSDP rank stores 1/D of every split parameter (JAX
    ``:266-275``), and every parameter of at least 64 elements is split."""
    _, ranks, _, _ = runs
    for rk in ranks:
        res = rk[case]
        assert int(res["stored_split_bytes"]) * R.WORLD == int(res["whole_split_bytes"])
        split = set(res["split"].tolist())
        for key, value in res["params"].items():
            if key.endswith(("running_mean", "running_var", "num_batches_tracked")):
                continue
            if value.size >= 64:
                assert key in split, key
                assert res["local"][key].size * R.WORLD == value.size, key


@pytest.mark.parametrize("mesh_name,h", R.BN_CASES)
def test_banded_batch_norm_matches_unbanded(runs, mesh_name, h):
    """Train-mode batch norm on each rank's band of an odd height (a band
    of 1x1x4 at H 3 is empty) against the unbanded op in float64: the
    output, the gradients of x, scale and bias and the running buffers
    (the variance unbiased over the whole count) within 1e-12."""
    one, ranks, _, _ = runs
    key = R.bn_key(mesh_name, h)
    for rk in ranks:
        for part, want in one[key].items():
            np.testing.assert_allclose(rk[key][part], want, rtol=1e-12, atol=1e-12,
                                       err_msg=part)


def test_spawn_budget(runs):
    """The module's one spawn of four ranks, every case on each, stays
    within 45 s."""
    assert runs[3] < 45.0
