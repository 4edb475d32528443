"""The port's per-round pytree API on a small ResNet-tiny against the
JAX package's, on the CPU: 5 rounds of each server optimizer through
``make_round_step`` + ``init_server`` + ``run_rounds``, against JAX's
``make_round_step(backend="pallas")`` + ``run_rounds`` on the same
draws (``tests/_torch_ref.py:run_rounds_both``), at the trajectory tier
1e-5. The convolution, GroupNorm and residual paths run under
``torch.func.vmap``. Apart from ``tests/test_torch_pytree.py`` so the
two files run on two workers.
"""

import numpy as np
import pytest

from _torch_ref import assert_trajectories, run_rounds_both
from repro.models import vision as jvision
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.fl import FLConfig
from repro_torch.models import vision as tvision

OPTIMIZERS = ["adagrad_ota", "adam_ota", "amsgrad_ota", "yogi_ota",
              "fedavgm", "fedavg"]
TOL = 1e-5
N_CLIENTS, BATCH = 3, 2
# The reference draws of each round, shared by the six runs (the same
# channel, model and key chain): the JAX package draws them leaf by leaf,
# one compile per leaf shape.
_DRAWS = {}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_resnet_tiny_five_rounds_match_jax(name):
    """Channels (8, 16), one block a stage, 8x8x3 images, 3 clients."""
    jm = jvision.resnet_tiny(10, channels=(8, 16), blocks_per_stage=1)
    tm = tvision.resnet_tiny(10, channels=(8, 16), blocks_per_stage=1)
    params = {k: v.numpy() for k, v in tm.init(seed=3, device="cpu").items()}
    rng = np.random.default_rng(5)
    batches = [{"x": rng.normal(size=(N_CLIENTS, BATCH, 8, 8, 3)).astype(
                    np.float32),
                "y": rng.integers(0, 10, (N_CLIENTS, BATCH)).astype(
                    np.int64)} for _ in range(5)]
    j, t = run_rounds_both(jm, tm, params, batches, OTAChannelConfig(),
                           AdaptiveConfig(optimizer=name, lr=0.01),
                           FLConfig(n_clients=N_CLIENTS), 5,
                           draws_cache=_DRAWS)
    assert_trajectories(j, t, TOL)
