"""``--debug_nans`` (the JAX ``apply_debug_flags``, ``cli/_common.py:292-297``,
which turns on ``jax_debug_nans``): a ``FloatingPointError`` at the first
NaN that the path produces.

Inside ``debug_nans(True)``:
- every module's output is checked as the module returns (a global
  forward hook), so a NaN weight or activation stops the forward at the
  first module that yields it;
- autograd's anomaly mode checks every backward function's outputs; its
  "returned nan values" error leaves the block as ``FloatingPointError``;
- ``check_nan`` (the train loop's loss, the style loops' per-image loss)
  raises too, as anomaly mode is on.

Each check reads the value on the host, so the flag costs a
synchronisation a module; off, nothing is installed and nothing is read.
"""
from __future__ import annotations

import contextlib
import math

import torch


def _has_nan(value) -> bool:
    if isinstance(value, float):
        return math.isnan(value)
    if torch.is_tensor(value):
        return value.is_floating_point() and bool(torch.isnan(value).any())
    if isinstance(value, (tuple, list)):
        return any(_has_nan(v) for v in value)
    if isinstance(value, dict):
        return any(_has_nan(v) for v in value.values())
    return False


def _nan_error(where: str) -> FloatingPointError:
    return FloatingPointError(f"invalid value (nan) encountered in {where}")


def _check_module_output(module, inputs, output):
    if _has_nan(output):
        raise _nan_error(type(module).__name__)


def check_nan(where: str, value) -> None:
    """Raise ``FloatingPointError`` if ``value`` holds a NaN while
    ``debug_nans`` is on (anomaly mode enabled); otherwise read nothing."""
    if torch.is_anomaly_enabled() and _has_nan(value):
        raise _nan_error(where)


@contextlib.contextmanager
def debug_nans(enabled: bool):
    """The block with the NaN checks on (see the module's docstring); a
    no-op when ``enabled`` is false."""
    if not enabled:
        yield
        return
    handle = torch.nn.modules.module.register_module_forward_hook(_check_module_output)
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as e:
        if "returned nan values" in str(e):
            raise FloatingPointError(str(e)) from e
        raise
    finally:
        handle.remove()
