"""Shared case of the port's three train CLIs' ``--ema_decay``,
``--mixup``, ``--cutmix``, ``--auto_batch`` and ``--hbm_budget_gb`` flags,
each run through the CLI on the CPU against the same CLI's plain run (one
epoch, 2 folds, the ``tiny_imagefolder`` fixture):

- ``--ema_decay 0.5``: the per-batch losses are the plain run's (training
  is unchanged), the fold checkpoint's batch-norm statistics are the plain
  run's (taken live) and its trained weights are not (the EMA's);
- ``--mixup 0.2`` and ``--cutmix 1.0``: the per-batch losses differ from
  the plain run's, every saved leaf is finite;
- ``--auto_batch --hbm_budget_gb B``, B set between the CPU estimates of
  the b8 and b16 steps of the same setup: the probe table is printed,
  batch 8 adopted (configured 4) and written into the saved
  hyperparameters, and the fold checkpoint is bit-equal to a plain run
  configured at batch 8 (the probes leave the run's initialisation
  alone);
- ``--hbm_budget_gb`` alone is ignored, as in JAX: the plain run's
  checkpoint bit for bit.
"""
import json

import numpy as np

from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten, load_pytree_npz

FLAG_CASES = [("--ema_decay", "0.5"), ("--mixup", "0.2"), ("--cutmix", "1.0"),
              ("--auto_batch", "--hbm_budget_gb", "BUDGET"), ("--hbm_budget_gb", "8")]


def _leaves(path):
    return _flatten(load_pytree_npz(str(path)))


def _is_bn_stat(key: str) -> bool:
    return key.endswith(("/mean", "/var"))


def budget_between_b8_and_b16(setup) -> str:
    """A budget in GiB whose usable 95 % lies between the CPU estimates of
    ``setup``'s b8 and b16 steps."""
    from heuristique_style_transfer_code_tpu_torch.train.autotune import (
        GIB,
        train_step_peak_bytes,
    )

    p8, p16 = (train_step_peak_bytes(setup, b, 256, "cpu") for b in (8, 16))
    assert p8 < p16
    return f"{(p8 + p16) / 2 / 0.95 / GIB:.9f}"


def check_flag_run(main, args_fn, run_dir, plain, extra, cfg: dict, fold_model: str,
                   make_setup, capsys, tmp_path):
    """Run ``main(args_fn(cfg_path, save_dir, *extra))`` and hold it to
    the plain run ``plain`` ((its directory, its per-batch loss lines)) as
    the module docstring says. ``make_setup(cfg)`` builds the CLI's setup
    at ``cfg`` on the CPU."""
    plain_dir, plain_lines = plain
    if "BUDGET" in extra:
        extra = tuple(budget_between_b8_and_b16(make_setup(cfg)) if e == "BUDGET" else e
                      for e in extra)
    main(args_fn(run_dir, *extra))
    printed = capsys.readouterr().out
    lines = [line for line in printed.splitlines() if "Batch [" in line]
    got, want = _leaves(run_dir / fold_model), _leaves(plain_dir / fold_model)
    assert sorted(got) == sorted(want)
    assert all(np.isfinite(v).all() for v in got.values() if v.dtype.kind == "f")
    flag = extra[0]
    if flag == "--ema_decay":
        assert lines == plain_lines
        stats = [k for k in want if _is_bn_stat(k)]
        assert all(np.array_equal(got[k], want[k]) for k in stats)
        assert any(not np.array_equal(got[k], want[k]) for k in want if not _is_bn_stat(k))
    elif flag in ("--mixup", "--cutmix"):
        assert len(lines) == len(plain_lines) and lines != plain_lines
    elif flag == "--auto_batch":
        assert "HBM budget" in printed
        assert "--auto_batch: adopting batch 8 (configured 4)" in printed
        with open(run_dir / f"{fold_model[:-4]}_hyperparameters.json") as f:
            assert json.load(f)["batch_size"] == 8
        cfg8 = tmp_path / "cfg_b8.json"
        with open(cfg8, "w") as f:
            json.dump(dict(cfg, batch_size=8), f)
        main(args_fn(tmp_path / "b8", config=str(cfg8)))
        capsys.readouterr()
        b8 = _leaves(tmp_path / "b8" / fold_model)
        assert all(np.array_equal(got[k], b8[k]) for k in b8)
    else:
        assert lines == plain_lines
        assert all(np.array_equal(got[k], want[k]) for k in want)
