"""The port's multi-host loader stride (``data/loader.HostLoader(
process_index=, process_count=)``) and global batches
(``parallel/multihost.make_global_batch``, ``global_batch_dict``) in this
process, against the JAX package's ``HostLoader`` and its tests
(``tests/test_multihost.py``). The two-process training case runs in
``tests/test_torch_sharded_checkpoint.py``'s spawn."""
import numpy as np
import pytest
import torch
from PIL import Image

from heuristique_style_transfer_code_tpu.data.loader import HostLoader as JaxLoader
from heuristique_style_transfer_code_tpu_torch.data.loader import HostLoader


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """JAX's 11 random 40x40 PNGs (a deliberately awkward count), labels
    i % 4."""
    root = tmp_path_factory.mktemp("mhdata")
    rng = np.random.RandomState(0)
    out = []
    for i in range(11):
        p = str(root / f"s{i}.png")
        Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8)).save(p)
        out.append((p, i % 4))
    return out


def _collect(loader):
    batches = list(loader)
    idxs, labels = [], []
    for b in batches:
        idxs.extend(b["indices"].tolist())
        labels.extend(b["label"].tolist())
    return batches, np.asarray(idxs), np.asarray(labels)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("pc", [2, 3, 4])
def test_stride_batches_equal_jax(samples, pc, shuffle):
    """Every process's batches (indices, labels, combination ids, n_valid,
    images) equal JAX's, over two epochs and after a ``set_position``, and
    ``len`` is JAX's."""
    combos = [i % 3 for i in range(len(samples))]
    for pi in range(pc):
        kw = dict(shuffle=shuffle, seed=7, process_index=pi, process_count=pc, num_workers=2)
        mine = HostLoader(samples, 2, combos, **kw)
        theirs = JaxLoader(samples, 2, combos, **kw)
        assert len(mine) == len(theirs)
        runs = [(list(mine), list(theirs)) for _ in range(2)]
        mine.set_position(1, 1)
        theirs.set_position(1, 1)
        runs.append((list(mine), list(theirs)))
        for got, want in runs:
            assert len(got) == len(want)
            for a, b in zip(got, want):
                for k in ("indices", "label", "combo", "image"):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert a["n_valid"] == b["n_valid"]


@pytest.mark.parametrize("pc", [2, 3])
def test_disjoint_exact_cover(samples, pc):
    """JAX ``TestProcessSharding.test_disjoint_exact_cover``: the same
    number of batches on every process, the valid entries covering each
    sample once."""
    per_host = [_collect(HostLoader(samples, batch_size=2, shuffle=True, seed=5,
                                    process_index=pi, process_count=pc, num_workers=2))
                for pi in range(pc)]
    assert len({len(b) for b, _, _ in per_host}) == 1
    seen = []
    for _, idxs, labels in per_host:
        seen.extend(idxs[labels >= 0].tolist())
    assert sorted(seen) == list(range(len(samples)))


def test_same_global_permutation_across_hosts(samples):
    """JAX ``test_same_global_permutation_across_hosts``: the strides
    interleave back into the single-process permutation."""
    pc, strides = 2, []
    for pi in range(pc):
        loader = HostLoader(samples, batch_size=2, shuffle=True, seed=9, process_index=pi,
                            process_count=pc, num_workers=2)
        strides.append(loader._order())
    total = sum(len(o) for o, _ in strides)
    merged, merged_valid = np.empty(total, dtype=int), np.empty(total, dtype=bool)
    for pi, (o, v) in enumerate(strides):
        merged[pi::pc] = o
        merged_valid[pi::pc] = v
    real = merged[merged_valid]
    assert sorted(real.tolist()) == list(range(len(samples)))
    solo = HostLoader(samples, batch_size=2, shuffle=True, seed=9)
    np.testing.assert_array_equal(solo._order()[0], real)


def test_padding_marked_invalid(samples):
    """JAX ``test_padding_marked_invalid``: n_valid counts the labels >= 0,
    pads inside full batches included."""
    batches, _, labels = _collect(HostLoader(samples, batch_size=4, process_index=0,
                                             process_count=2, num_workers=2))
    assert sum(b["n_valid"] for b in batches) == int((labels >= 0).sum())
    assert (labels >= 0).sum() <= len(samples)


def test_single_host_unchanged(samples):
    """JAX ``test_single_host_unchanged``: ``process_count=1`` is the plain
    loader."""
    a = _collect(HostLoader(samples, batch_size=4, shuffle=True, seed=3))
    b = _collect(HostLoader(samples, batch_size=4, shuffle=True, seed=3, process_index=0,
                            process_count=1))
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def test_rows_and_a_stride_are_refused(samples):
    with pytest.raises(ValueError, match="exclude"):
        HostLoader(samples, 4, rows=[0, 1], process_index=0, process_count=2)
    with pytest.raises(ValueError, match="outside"):
        HostLoader(samples, 4, process_index=2, process_count=2)


def test_make_global_batch_on_mesh(samples):
    """JAX ``test_make_global_batch_on_mesh`` on one device: the global
    batch is the local one (one process), on the mesh's device, and a sum
    over it is the host's."""
    from heuristique_style_transfer_code_tpu_torch.core.mesh import create_mesh
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import global_batch_dict
    from heuristique_style_transfer_code_tpu_torch.parallel.sharding import (
        batch_sharding,
        image_sharding,
    )

    mesh = create_mesh()
    batch = next(iter(HostLoader(samples, batch_size=8, num_workers=2)))
    g = global_batch_dict(batch, image_sharding(mesh), batch_sharding(mesh))
    assert g["image"].shape == batch["image"].shape and g["image"].device == mesh.device
    np.testing.assert_array_equal(g["image"].numpy(), batch["image"])
    np.testing.assert_array_equal(g["label"].numpy(), batch["label"])
    assert int(g["image"].to(torch.int64).sum()) == int(batch["image"].astype(np.int64).sum())
    with pytest.raises(ValueError, match="labels"):
        global_batch_dict({**batch, "label": batch["label"][:3]}, image_sharding(mesh),
                          batch_sharding(mesh))
