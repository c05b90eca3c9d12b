"""The port's int8 inference artifacts (``deploy/artifact.py``) of
families 1 and 2, on the CPU: the encoder calibrated by the port and
written to ``--quantized_path``, which JAX reads; the artifact exported
with a symbolic batch, saved, loaded and run at b1 and b3 equal to the
live infer function bit for bit, and within 1e-3 of JAX's artifact on the
same tree with the argmax equal (``tests/test_torch_artifact.py`` holds
the other precisions, and its models and checks serve here)."""
import pytest

from tests.test_torch_artifact import _one_torch_thread, check_infer_artifact, models  # noqa: F401


@pytest.mark.parametrize("family", ["truncated_resnet50", "gram_attention"])
def test_int8_infer_artifact_is_the_live_path_and_jax(models, tiny_imagefolder,  # noqa: F811
                                                      tmp_path, family):
    check_infer_artifact(models, tiny_imagefolder, tmp_path, family, "int8", "rgb")
