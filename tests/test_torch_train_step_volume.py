"""One training step of MSREDNet and CasMVSNet against the JAX package's
`make_train_step` on the CPU (the oracle, inputs and tolerances of
tests/test_torch_train_step.py, which holds AdaMVS and UCSNet; split in
two so that each file's JAX compiles stay near a minute on one worker)."""

import pytest
import torch

from tests.test_torch_train_step import check_train_step, run_jax_step

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["msrednet", "casmvsnet"])
def test_train_step_matches_jax(name):
    check_train_step(*run_jax_step(name))
