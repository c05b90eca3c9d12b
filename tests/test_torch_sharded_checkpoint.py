"""The port's sharded checkpoints (``checkpoint/sharded_io.py``) on the CPU,
against the JAX package's ``checkpoint/sharded_io.py`` and its tests
(``tests/test_sharded_checkpoint.py``), at their sizes.

Four gloo ranks spawned once for the module (``tests/torch_sharded_ranks.py``
holds their bodies, which import no jax) save and load every placement of
the port's training state (plain data parallelism, FSDP and ZeRO-1 on a
data mesh of 4, TP heads with ZeRO-1 on 2x2), JAX's 8-device save, a
bfloat16 leaf, family 2's FSDP handoff (an asynchronous save submitted
just before a step) and the one-process save of this process, and run the
loader stride's two-process training case (``tests/test_multihost.py:166``).
This process holds their files and results to the whole trees, to JAX's
loader and layouts on the conftest's virtual devices, and to one device.
The single-process cases (markers, torn and repeated saves, missing
specs, the asynchronous writer's errors and snapshots) run here.
"""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from PIL import Image

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    _flatten,
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.checkpoint import sharded_io as port
from heuristique_style_transfer_code_tpu_torch.parallel import multihost
from tests import torch_sharded_ranks as R

SPAWN_BUDGET_S = 60.0
ELASTIC_RTOL, ELASTIC_ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("data",))


def _tiny_trees():
    """JAX's test tree (``tests/test_sharded_checkpoint.py:41-62``) plus the
    norm's running buffers and a (64, 64) ``proj`` layer, and a seeded
    trace of its trainable leaves."""
    rng = np.random.RandomState(0)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    tiny = {"conv": {"kernel": f32(3, 3, 16, 32)},
            "fc": {"kernel": f32(64, 8), "bias": f32(8)},
            "proj": {"kernel": f32(64, 64), "bias": f32(64)},
            "bn": {"scale": np.ones(16, np.float32), "mean": f32(16),
                   "var": (rng.rand(16) + 0.5).astype(np.float32)}}
    trace = {"conv": {"kernel": f32(3, 3, 16, 32)},
             "fc": {"kernel": f32(64, 8), "bias": f32(8)},
             "proj": {"kernel": f32(64, 64), "bias": f32(64)},
             "bn": {"scale": f32(16)}}
    return tiny, trace


def _whole_tiny(tiny, trace, ema: bool = False) -> dict:
    """The whole JAX-layout tree every placement's save holds."""
    opt = {"count": np.int64(3), "trace": trace}
    if ema:
        opt["ema"] = {k: v for k, v in tiny.items() if k != "bn"}
        opt["ema"]["bn"] = {"scale": tiny["bn"]["scale"]}
    return {"variables": tiny, "opt": opt}


def _jax_fsdp_save(tree, n: int, directory: str) -> None:
    """JAX's save of ``tree`` with every variable and trace leaf laid out
    by its FSDP/ZeRO-1 policy on ``n`` virtual devices."""
    from heuristique_style_transfer_code_tpu.checkpoint.sharded_io import save_sharded_pytree
    from heuristique_style_transfer_code_tpu.parallel.sharding import (
        fsdp_variable_shardings,
        zero1_state_shardings,
    )

    mesh = _jax_mesh(n)
    variables = jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree["variables"]),
                               fsdp_variable_shardings(tree["variables"], mesh))
    trace = jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree["opt"]["trace"]),
                           zero1_state_shardings(tree["opt"]["trace"], mesh))
    save_sharded_pytree({"variables": variables,
                         "opt": {"count": tree["opt"]["count"], "trace": trace}}, directory)


def _stride_folder(root: str) -> None:
    """JAX's two-process test folder: 2 classes x 6 random 40x40 PNGs."""
    rng = np.random.RandomState(3)
    for cls in ("a", "b"):
        os.makedirs(os.path.join(root, cls))
        for i in range(6):
            Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                os.path.join(root, cls, f"{i}.png"))


def _inputs():
    from heuristique_style_transfer_code_tpu.models.gram_attention import gram_attention_init

    tiny, trace = _tiny_trees()
    bf16 = np.random.RandomState(1).randn(16, 4).astype(ml_dtypes.bfloat16)
    rng = np.random.RandomState(4)
    f2 = jax.tree_util.tree_map(np.asarray, gram_attention_init(
        jax.random.split(jax.random.PRNGKey(2))[0], R.MA.F2_TRUNCATE, 4, R.MA.F2_S))
    labels = (np.arange(2 * R.B, dtype=np.int32) % 4).reshape(2, R.B)
    labels[1, -1] = -1
    return {"tiny": tiny, "tiny_trace": trace, "bf16_bits": bf16.view(np.uint16),
            "f2": f2, "f2_images": rng.randint(0, 256, (2, R.B, R.STAGE, R.STAGE, 3),
                                               dtype=np.uint8),
            "f2_labels": labels,
            "lin": {"fc": {"kernel": (np.random.RandomState(0).randn(R.STRIDE_CROP ** 2 * 3, 2)
                                      * 0.01).astype(np.float32),
                           "bias": np.zeros(2, np.float32)}}}


def _one_device_f2_save(inputs, directory: str):
    """Family 2's one-device float64 step on the first batch, saved by
    this process alone."""
    model, step, state = R.f2_setup(inputs)
    step(model, state, inputs["f2_images"][0], inputs["f2_labels"][0])
    port.save_sharded_pytree(port.state_tree(model, state), directory)


def _stride_one_device(inputs, root: str):
    """JAX's single-process reference: the same model and step on one
    device over the two strides' batches concatenated in data-rank order.
    Returns (losses, the fc tree after the run, the pixel sums)."""
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
    from heuristique_style_transfer_code_tpu_torch.data.loader import HostLoader
    from heuristique_style_transfer_code_tpu_torch.train.optim import sgd_momentum
    from heuristique_style_transfer_code_tpu_torch.train.train_loop import make_train_step_body

    samples = ImageFolderIndex(root).samples
    loaders = [HostLoader(samples, R.STRIDE_BATCH, shuffle=True, seed=R.STRIDE_SEED,
                          process_index=i, process_count=2, num_workers=2) for i in range(2)]
    model = load_jax_tree(R.LinNet(), inputs["lin"])
    opt = sgd_momentum(R.STRIDE_LR)
    step = make_train_step_body(R.lin_forward, opt,
                                make_augment_fn([(None, None)], R.STRIDE_CROP))
    state = opt[0](model)
    losses, sums, indices = [], [], []
    for b0, b1 in zip(*loaders):
        images = np.concatenate([b0["image"], b1["image"]])
        model, state, loss = step(model, state, images,
                                  np.concatenate([b0["label"], b1["label"]]),
                                  np.concatenate([b0["combo"], b1["combo"]]))
        losses.append(float(loss))
        sums.append(int(images.astype(np.int64).sum()))
        indices.append((b0["indices"], b1["indices"]))
    return np.asarray(losses), to_jax_tree(model)["fc"], sums, indices


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawn's directories, every rank's results and its seconds, and
    this process's references (the inputs, the stride's one-device run)."""
    root = tmp_path_factory.mktemp("sharded")
    in_dir, out_dir = str(root / "in"), str(root / "out")
    os.makedirs(in_dir)
    os.makedirs(out_dir)
    inputs = _inputs()
    save_pytree_npz(inputs, os.path.join(in_dir, "inputs.npz"))
    inputs = load_pytree_npz(os.path.join(in_dir, "inputs.npz"))  # the ranks' exact inputs
    _stride_folder(os.path.join(in_dir, "stride"))
    _jax_fsdp_save(_whole_tiny(inputs["tiny"], inputs["tiny_trace"]), 8,
                   os.path.join(in_dir, "jax8"))
    _one_device_f2_save(inputs, os.path.join(in_dir, "one"))
    spawn = {}

    def ranks_job():
        t0 = time.perf_counter()
        try:
            multihost.launch(R.WORLD, None, [], target=R.rank_main,
                             target_args=(in_dir, out_dir), rendezvous_dir=str(root),
                             deadline_s=180.0)
        except SystemExit as e:
            spawn["error"] = e
        spawn["seconds"] = time.perf_counter() - t0

    job = threading.Thread(target=ranks_job)
    job.start()
    try:
        stride = _stride_one_device(inputs, os.path.join(in_dir, "stride"))
    finally:
        job.join()
    assert "error" not in spawn, spawn
    ranks = [load_pytree_npz(os.path.join(out_dir, f"rank{r}.npz")) for r in range(R.WORLD)]
    return {"in": in_dir, "out": out_dir, "inputs": inputs, "ranks": ranks,
            "seconds": spawn["seconds"], "stride": stride}


def _manifests(directory: str) -> list:
    with open(os.path.join(directory, "MANIFEST.json")) as f:
        top = json.load(f)
    out = []
    for name in top["manifests"]:
        with open(os.path.join(directory, name)) as f:
            out.append(json.load(f))
    return out


def _assert_trees_equal(got, want) -> None:
    g, w = _flatten(got, coerce=lambda x: x), _flatten(want, coerce=lambda x: x)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        np.testing.assert_array_equal(a, b, err_msg=k)
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)


def _whole(runs, name: str) -> dict:
    inputs = runs["inputs"]
    return _whole_tiny(inputs["tiny"], inputs["tiny_trace"], ema=name == "zero1")


# ------------------------------------------------------------ the ranks' files


@pytest.mark.parametrize("name", list(R.PLACEMENTS))
def test_same_layout_round_trip_bit_identical(runs, name):
    """Each placement's state, saved by the four ranks and loaded into a
    fresh state of the same placement, is bit-equal on every rank (JAX
    ``TestRoundTrip.test_same_layout_bit_identical``)."""
    assert all(bool(rk["roundtrip"][name]) for rk in runs["ranks"])


@pytest.mark.parametrize("name", list(R.PLACEMENTS))
def test_port_save_is_the_whole_tree_in_both_loaders(runs, name):
    """The four ranks' files hold the whole state, in JAX's names and
    layouts: the port's loader and JAX's (``as_jax=False``) give the whole
    tree bit for bit (JAX ``test_numpy_load_equals_saved``)."""
    from heuristique_style_transfer_code_tpu.checkpoint.sharded_io import load_sharded_pytree

    d = os.path.join(runs["out"], name)
    want = _whole(runs, name)
    _assert_trees_equal(port.load_sharded_pytree(d), want)
    _assert_trees_equal(load_sharded_pytree(d, as_jax=False), want)


@pytest.mark.parametrize("name", list(R.PLACEMENTS))
def test_each_rank_writes_only_its_blocks(runs, name):
    """Rank r's npz holds exactly the blocks it owns, each equal to its box
    of the whole tree: a split leaf's block on its owner (on 2x2 a data
    shard on model index 0, a head's block on data index 0 and a head's
    ZeRO-1 block on each rank), every whole leaf on rank 0 alone."""
    d = os.path.join(runs["out"], name)
    flat = _flatten(_whole(runs, name), coerce=lambda x: x)
    mesh, factory = R.PLACEMENTS[name]
    for r, m in enumerate(_manifests(d)):
        with np.load(os.path.join(d, m["file"])) as z:
            keys = set(z.files)
            written = set()
            for key, meta in m["leaves"].items():
                for c in meta["chunks"]:
                    box = tuple(slice(a, b) for a, b in zip(c["start"], c["stop"]))
                    np.testing.assert_array_equal(z[c["key"]], np.asarray(flat[key])[box],
                                                  err_msg=key)
                    written.add(c["key"])
            assert written == keys
        if r != 0:  # whole leaves: rank 0's
            assert not {"variables/bn/mean", "opt/count"} & set(m["leaves"])
        if factory == "dp":  # everything replicated: rank 0 writes it all
            assert (len(m["leaves"]) == len(flat)) == (r == 0)
            assert (not m["leaves"]) == (r != 0)
        if name == "tp_zero1":  # rank r = (data r // 2, model r % 2)
            d_idx, m_idx = divmod(r, 2)
            owns = {k for k, meta in m["leaves"].items() if meta["chunks"]}
            assert ("variables/fc/kernel" in owns) == (d_idx == 0)  # a head block
            assert ("opt/trace/conv/kernel" in owns) == (m_idx == 0)  # a data shard
            assert "opt/trace/fc/kernel" in owns  # a head's ZeRO-1 block: every rank's own
            spans = [(c["start"], c["stop"]) for c in m["leaves"]["opt/trace/fc/kernel"]["chunks"]]
            assert spans == [([32 * d_idx, 4 * m_idx], [32 * (d_idx + 1), 4 * (m_idx + 1)])]


@pytest.mark.parametrize("name", list(R.PLACEMENTS))
def test_no_shard_duplication_on_disk(runs, name):
    """The elements stored over all the ranks' files equal the whole tree's
    (JAX ``test_no_shard_duplication_on_disk``)."""
    d = os.path.join(runs["out"], name)
    stored = 0
    for m in _manifests(d):
        with np.load(os.path.join(d, m["file"])) as z:
            stored += sum(int(z[k].size) for k in z.files)
    want = sum(int(np.size(v)) for v in _flatten(_whole(runs, name)).values())
    assert stored == want


def test_chunked_storage_is_real(runs):
    """FSDP over 4 ranks saves the conv kernel HWIO (3, 3, 16, 32) as 4
    boxes along dim 3, one a rank: the port's OIHW split dimension 0,
    transposed, and JAX's own policy's (JAX ``test_chunked_storage_is_real``)."""
    spans = []
    for m in _manifests(os.path.join(runs["out"], "fsdp")):
        meta = m["leaves"]["variables/conv/kernel"]
        assert len(meta["chunks"]) == 1 and meta["shape"] == [3, 3, 16, 32]
        spans += [(c["start"][3], c["stop"][3]) for c in meta["chunks"]]
        assert all(c["start"][:3] == [0, 0, 0] for c in meta["chunks"])
    assert sorted(spans) == [(i * 8, i * 8 + 8) for i in range(4)]


def test_boxes_match_jax_where_split_dims_agree(runs, tmp_path):
    """Against JAX's 4-device FSDP save of the same tree: every leaf split
    along the same dimension has the same boxes; the (64, 64) ``proj``
    kernel (the port's (out, in) tie picks ``out``, JAX's (in, out) picks
    ``in``) and the norm's running buffers (replicated in the port) have
    others; the values agree everywhere."""
    from heuristique_style_transfer_code_tpu.checkpoint.sharded_io import load_sharded_pytree

    jax_dir = str(tmp_path / "jax4")
    _jax_fsdp_save(_whole(runs, "fsdp"), 4, jax_dir)

    def boxes(d):
        out = {}
        for m in _manifests(d):
            for key, meta in m["leaves"].items():
                out.setdefault(key, set()).update(
                    (tuple(c["start"]), tuple(c["stop"])) for c in meta.get("chunks", ()))
        return out

    mine, theirs = boxes(os.path.join(runs["out"], "fsdp")), boxes(jax_dir)
    assert mine.keys() == theirs.keys()
    differ = {k for k in mine if mine[k] != theirs[k]}
    assert differ == {"variables/proj/kernel", "opt/trace/proj/kernel", "variables/bn/mean",
                      "variables/bn/var"}
    assert len(mine) - len(differ) >= 9
    _assert_trees_equal(load_sharded_pytree(jax_dir, as_jax=False),
                        port.load_sharded_pytree(os.path.join(runs["out"], "fsdp")))


@pytest.mark.parametrize("n", [8, 4])
def test_port_save_loads_under_jax_fsdp_shardings(runs, n):
    """The port's 4-rank FSDP save loads in JAX under
    ``fsdp_variable_shardings``/``zero1_state_shardings`` on 8 and on 4
    virtual devices, bit-equal, each array in the asked layout (JAX
    ``TestElasticReshard.test_load_under_different_layout``)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from heuristique_style_transfer_code_tpu.checkpoint.sharded_io import load_sharded_pytree
    from heuristique_style_transfer_code_tpu.parallel.sharding import (
        fsdp_variable_shardings,
        zero1_state_shardings,
    )

    mesh, whole = _jax_mesh(n), _whole(runs, "fsdp")
    v_shard = fsdp_variable_shardings(whole["variables"], mesh)
    shardings = {"variables": v_shard,
                 "opt": {"count": NamedSharding(mesh, P()),
                         "trace": zero1_state_shardings(whole["opt"]["trace"], mesh)}}
    got = load_sharded_pytree(os.path.join(runs["out"], "fsdp"), shardings=shardings)
    assert got["variables"]["conv"]["kernel"].sharding == v_shard["conv"]["kernel"]
    for part in ("variables", "trace"):
        _assert_trees_equal(jax.tree_util.tree_map(np.asarray, got.get(part, got["opt"].get(part))),
                            whole.get(part, whole["opt"].get(part)))
    assert int(got["opt"]["count"]) == 3


def test_jax_eight_device_save_loads_into_port_ranks(runs):
    """JAX's 8-device FSDP save of the tree (its running buffers split,
    the port's whole) loads into the four ranks' FSDP state bit-equal to
    placing the whole tree."""
    assert all(bool(rk["jax8"]) for rk in runs["ranks"])


def test_bf16_leaf_round_trips(runs):
    """A bfloat16 (16, 4) leaf split over the four ranks loads whole as a
    ``torch.bfloat16`` tensor, bit for bit, in the port; JAX reads the same
    bits as ml_dtypes' bfloat16 (JAX ``test_bf16_leaf_round_trips``)."""
    from heuristique_style_transfer_code_tpu.checkpoint.sharded_io import load_sharded_pytree

    d, bits = os.path.join(runs["out"], "bf16"), runs["inputs"]["bf16_bits"]
    back = port.load_sharded_pytree(d)["x"]
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.view(torch.int16).numpy().view(np.uint16), bits)
    theirs = load_sharded_pytree(d, as_jax=False)["x"]
    assert theirs.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(theirs.view(np.uint16), bits)
    assert all(m["leaves"]["x"]["dtype"] == "bfloat16" for m in _manifests(d))


# ------------------------------------------------------------ elastic


def test_handoff_reload_equals_the_kept_copy(runs):
    """Each rank's reload of the asynchronous save, submitted just before
    the next step ran (its collectives on the main thread, the writer's
    barriers on its thread), is bit-equal to the copy kept before that
    step."""
    assert all(bool(rk["handoff"]["reload_equal"]) for rk in runs["ranks"])
    losses = [rk["handoff"]["losses"] for rk in runs["ranks"]]
    assert all(np.array_equal(x, losses[0]) for x in losses)


def test_four_rank_checkpoint_resumes_on_one_process(runs):
    """The four ranks' FSDP checkpoint after step 1, restored into a
    one-device model and state (read whole), takes step 2 on the same
    global batch and lands within rtol 1e-6, atol 1e-7 of the ranks'
    uninterrupted step 2 (JAX ``TestElasticTrainingHandoff``; float64)."""
    inputs = runs["inputs"]
    model, step, state = R.f2_setup(inputs)
    port.restore_state(model, state, port.load_sharded_pytree(os.path.join(runs["out"], "mid")))
    assert state["count"] == 1
    _, _, loss = step(model, state, inputs["f2_images"][1], inputs["f2_labels"][1])
    np.testing.assert_allclose(float(loss), runs["ranks"][0]["handoff"]["losses"][1],
                               rtol=ELASTIC_RTOL)
    mine = _flatten(port.state_tree(model, state), coerce=lambda x: x)
    final = _flatten(port.load_sharded_pytree(os.path.join(runs["out"], "fin")))
    assert mine.keys() == final.keys()
    for k, v in final.items():
        np.testing.assert_allclose(np.asarray(mine[k]), v, rtol=ELASTIC_RTOL,
                                   atol=ELASTIC_ATOL, err_msg=k)


@pytest.mark.parametrize("name", R.REVERSE)
def test_one_process_checkpoint_loads_on_four_ranks(runs, name):
    """This process's one-device checkpoint loads into each placement of
    the four ranks: every rank's blocks bit-equal to placing the whole
    state."""
    assert all(bool(rk["reverse"][name]) for rk in runs["ranks"])


# ------------------------------------------------------------ the loader stride


def test_stride_training_matches_one_device(runs):
    """Each data rank of the 2x2 mesh trains on its loader stride through
    ``global_batch_dict`` and ``make_sharded_train_step``: the losses equal
    one device's on the strides' batches concatenated in data-rank order
    (rtol 1e-6), and the gathered head too (JAX
    ``test_two_process_training_matches_single_process``)."""
    losses, fc, sums, indices = runs["stride"]
    ranks = runs["ranks"]
    for rk in ranks:
        np.testing.assert_array_equal(rk["stride"]["losses"], ranks[0]["stride"]["losses"])
        np.testing.assert_allclose(rk["stride"]["losses"], losses, rtol=1e-6)
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(rk["stride"]["fc"][k], fc[k], rtol=1e-6, atol=1e-7)
        assert rk["stride"]["image_sums"].tolist() == sums
    for rk in ranks:  # the ranks of a model group draw their data index's stride
        d = int(rk["data_index"])
        np.testing.assert_array_equal(rk["stride"]["indices"], np.stack([i[d] for i in indices]))


def test_make_global_batch_refuses_uneven_rows(runs):
    """Data ranks holding 2 and 3 rows: every rank raises ValueError."""
    assert all(bool(rk["stride"]["refused"]) for rk in runs["ranks"])


def test_spawn_budget(runs):
    """The module's one spawn of four ranks, every case on each, stays
    within its budget."""
    assert runs["seconds"] < SPAWN_BUDGET_S, runs["seconds"]


# ------------------------------------------------------------ one process


@pytest.fixture
def tiny_state():
    """TinyNet's plain state in this process (one rank), the trace set."""
    tiny, trace = _tiny_trees()
    model, t = R.tiny({"tiny": tiny, "tiny_trace": trace})
    _, state = R.place("dp", model, None, trace=t, count=3)
    return model, state, _whole_tiny(tiny, trace)


def test_structure_markers_survive(tmp_path):
    """None, {}, [], nested lists and a numpy scalar (JAX
    ``test_structure_markers_survive``), and the JAX loader reads them."""
    from heuristique_style_transfer_code_tpu.checkpoint.sharded_io import load_sharded_pytree

    tree = {"a": None, "b": {}, "c": [], "d": [torch.ones(3), {"e": np.zeros((2, 2))}],
            "s": np.int64(7)}
    d = str(tmp_path / "ckpt")
    port.save_sharded_pytree(tree, d)
    for back in (port.load_sharded_pytree(d), load_sharded_pytree(d, as_jax=False)):
        assert back["a"] is None and back["b"] == {} and back["c"] == []
        np.testing.assert_array_equal(back["d"][0], np.ones(3, np.float32))
        np.testing.assert_array_equal(back["d"][1]["e"], np.zeros((2, 2)))
        assert int(back["s"]) == 7 and np.asarray(back["s"]).shape == ()


def test_bf16_file_is_jax_bytes(tmp_path):
    """A whole bfloat16 leaf's npy member is byte for byte what JAX's
    ``np.savez`` of the ml_dtypes array writes ('<V2', 2-byte payloads),
    and its manifest entry JAX's."""
    import zipfile

    from heuristique_style_transfer_code_tpu.checkpoint.sharded_io import save_sharded_pytree

    bits = np.random.RandomState(1).randn(16, 4).astype(ml_dtypes.bfloat16)
    port.save_sharded_pytree({"x": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)},
                             str(tmp_path / "port"))
    save_sharded_pytree({"x": jnp.asarray(bits)}, str(tmp_path / "jax"))
    members = []
    for side in ("port", "jax"):
        with zipfile.ZipFile(tmp_path / side / "shards_p00000.npz") as z:
            members.append((z.namelist(), z.read("c0.npy")))
    assert members[0] == members[1] and b"'descr': '<V2'" in members[0][1]
    assert _manifests(str(tmp_path / "port")) == _manifests(str(tmp_path / "jax"))


def test_torn_save_not_loadable(tiny_state, tmp_path):
    model, state, _ = tiny_state
    d = str(tmp_path / "ckpt")
    port.save_sharded_pytree(port.state_tree(model, state), d)
    os.unlink(os.path.join(d, "MANIFEST.json"))
    with pytest.raises(FileNotFoundError):
        port.load_sharded_pytree(d)


def test_resave_overwrites_cleanly(tiny_state, tmp_path):
    model, state, whole = tiny_state
    d = str(tmp_path / "ckpt")
    port.save_sharded_pytree(port.state_tree(model, state), d)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    port.save_sharded_pytree(port.state_tree(model, state), d)
    back = port.load_sharded_pytree(d)
    np.testing.assert_array_equal(back["variables"]["conv"]["kernel"],
                                  whole["variables"]["conv"]["kernel"] + 1.0)
    np.testing.assert_array_equal(back["opt"]["trace"]["fc"]["kernel"],
                                  whole["opt"]["trace"]["fc"]["kernel"])


def test_missing_spec_errors(tiny_state, tmp_path):
    """A saved key without a spec raises KeyError (JAX
    ``test_missing_sharding_leaf_errors``)."""
    model, state, _ = tiny_state
    d = str(tmp_path / "ckpt")
    port.save_sharded_pytree(port.state_tree(model, state), d)
    with pytest.raises(KeyError):
        port.load_sharded_pytree(d, shardings={"variables": {"conv": {"kernel": port.WHOLE}}})


def test_unowned_leaf_is_listed_and_missing_data_raises(tmp_path):
    """A leaf that rank 0 owns no block of is still listed (no chunks),
    and reading it raises JAX's "missing data" ValueError."""
    d = str(tmp_path / "ckpt")
    port.save_sharded_pytree({"x": port.Shard(torch.ones(2, 3), (4, 3), (2, 0), owner=False)}, d)
    (m,) = _manifests(d)
    assert m["leaves"]["x"] == {"shape": [4, 3], "dtype": "float32", "chunks": []}
    with pytest.raises(ValueError, match="missing data"):
        port.load_sharded_pytree(d)


def test_only_overlapping_chunks_are_read():
    """``_read_slice`` fetches only the chunks its box overlaps (the fast
    path when one chunk is the box), and assembles boxes across chunks."""
    whole = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)

    class Recording(dict):
        read = []

        def __getitem__(self, k):
            Recording.read.append(k)
            return dict.__getitem__(self, k)

    npz = Recording({f"c{i}": whole[2 * i:2 * i + 2] for i in range(4)})
    chunks = [port._Chunk(npz, f"c{i}", [2 * i, 0], [2 * i + 2, 6]) for i in range(4)]
    meta = {"shape": [8, 6], "dtype": "float32"}
    np.testing.assert_array_equal(port._read_slice(meta, chunks, [2, 0], [4, 6]), whole[2:4])
    assert Recording.read == ["c1"]
    Recording.read = []
    np.testing.assert_array_equal(port._read_slice(meta, chunks, [3, 1], [6, 4]), whole[3:6, 1:4])
    assert sorted(Recording.read) == ["c1", "c2"]


def test_split_boxes_nest_and_transpose():
    """A head's ZeRO-1 block: its model block (dim 0 of 2), then its data
    shard of that; transposed to JAX's (in, out) the cuts move with the
    dimensions."""
    s = port.Split((0, 1, 2), (1, 0, 2))
    assert s.box((8, 64)) == ([4, 0], [8, 32])
    assert s.global_shape((4, 32)) == (8, 64)
    assert s.permuted((1, 0)).box((64, 8)) == ([0, 4], [32, 8])
    assert port.Split((0, 1, 2), (0, 1, 2)).box((8,)) == ([6], [8])
    assert port.WHOLE.box((3, 2)) == ([0, 0], [3, 2])


def test_like_restores_structure(tmp_path):
    """``like=`` re-hangs the leaves on a template's containers, tuples and
    named tuples included (lists in the file), in JAX's leaf order (JAX
    ``test_like_restores_namedtuple_structure``)."""
    from collections import namedtuple

    Trace = namedtuple("Trace", ["trace", "count"])
    tree = (Trace({"b": np.ones(2), "a": np.zeros(3)}, np.int64(4)), {"z": np.arange(2)})
    d = str(tmp_path / "ckpt")
    port.save_sharded_pytree(tree, d)
    back = port.load_sharded_pytree(d, like=tree)
    assert isinstance(back, tuple) and isinstance(back[0], Trace)
    assert list(back[0].trace) == ["b", "a"]
    np.testing.assert_array_equal(back[0].trace["a"], np.zeros(3))
    np.testing.assert_array_equal(back[0].trace["b"], np.ones(2))
    assert int(back[0].count) == 4
    np.testing.assert_array_equal(back[1]["z"], np.arange(2))


def test_async_submit_is_donation_safe_and_durable(tiny_state, tmp_path):
    """``submit`` copies the state's blocks; an in-place step right after
    it does not reach the file, which is committed after ``wait`` (JAX
    ``test_submit_is_donation_safe_and_durable_after_wait``)."""
    model, state, whole = tiny_state
    d = str(tmp_path / "ckpt")
    w = port.make_async_sharded_writer()
    w.submit(port.state_tree(model, state), d)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0).sub_(1.0)
        for t in state["trace"].values():
            t.zero_()
    w.wait()
    assert os.path.exists(os.path.join(d, "MANIFEST.json"))
    _assert_trees_equal(port.load_sharded_pytree(d), whole)
    w.close()


def test_async_snapshot_keeps_shard_boxes():
    """The writer's snapshot of a ``Shard`` keeps its box and copies only
    an owned block."""
    from heuristique_style_transfer_code_tpu_torch.checkpoint.async_io import _snapshot

    block = torch.ones(2, 3)
    own, other = _snapshot([port.Shard(block, (4, 3), (2, 0), True),
                            port.Shard(block, (4, 3), (0, 0), False)])
    assert (own.shape, own.start, own.stop) == ((4, 3), [2, 0], [4, 3])
    assert own.data.data_ptr() != block.data_ptr() and other.data is block
    block.zero_()
    assert float(own.data.sum()) == 6.0


def test_worker_error_surfaces_on_wait(tiny_state, tmp_path):
    model, state, _ = tiny_state
    w = port.make_async_sharded_writer()
    target = str(tmp_path / "f")
    with open(target, "w") as f:
        f.write("x")  # a file where the save needs a directory
    w.submit(port.state_tree(model, state), target)
    with pytest.raises(Exception):
        w.wait()
    w.close()
