"""tests/test_torch_batch.py's check on the basic family: a batch of 16
through the tiny basic-block net of ResNet-18's structure, whole, against
the JAX package's forward in two chunks of 8, at every tier (its bars
there)."""

import pytest

from test_torch_batch import check_whole_batch, models  # noqa: F401 - the fixture


@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
def test_resnet18_whole_batch_matches_jax_chunks(models, tier):  # noqa: F811
    check_whole_batch(models, "resnet18", tier)
