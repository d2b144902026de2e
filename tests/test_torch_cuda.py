"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU with nvcc and skips
without one (the CPU suite runs the plain versions against the JAX
package instead).  On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from tests.test_torch_models import scenario, to_torch

pytestmark = pytest.mark.cuda

MODES = [("v2", True), ("reference", True), ("reference", False)]


@pytest.fixture
def gpu_state():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    st = to_torch(scenario(61, 70, 300, 8))
    return type(st)(*(x.cuda() for x in st))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_merge_kernel_matches_plain(gpu_state):
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    full = gpu_state.base()
    for off in (0, 1, 64, 65, 141):
        assert _equal(cm.ring_round_rows(full, off, kernel="cuda"),
                      cm.ring_round_rows(full, off, kernel="torch")), off
    perm = torch.from_numpy(np.random.default_rng(0).permutation(70)).cuda()
    assert _equal(cm.gossip_round_rows(full, perm, kernel="cuda"),
                  cm.gossip_round_rows(full, perm, kernel="torch"))
    other = cm.ring_round_rows(full, 3, kernel="torch")
    assert _equal(cm.merge_pairwise_rows(full, other, kernel="cuda"),
                  cm.merge_pairwise_rows(full, other, kernel="torch"))


@pytest.mark.parametrize("sem,strict", MODES)
def test_delta_kernel_matches_plain(gpu_state, sem, strict):
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd

    kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
    for off in (0, 1, 64, 65, 141):
        assert _equal(cd.delta_ring_round(gpu_state, off, kernel="cuda", **kw),
                      cd.delta_ring_round(gpu_state, off, kernel="torch",
                                          **kw)), off
    perm = torch.from_numpy(np.random.default_rng(1).permutation(70)).cuda()
    assert _equal(cd.delta_gossip_round(gpu_state, perm, kernel="cuda", **kw),
                  cd.delta_gossip_round(gpu_state, perm, kernel="torch", **kw))
