"""Which card a spawned rank runs on (``gausplat_tpu_torch.scripts.rank_device``,
which ``gausplat_tpu_torch.testing.spawn_ranks`` makes each NCCL rank's
current device): under NCCL rank ``r`` on a host of ``n`` cards gets
``cuda:r``, and a rank past the cards raises; under gloo every rank shares
card 0; a device with an index, and the CPU, are kept. The mapping is pure,
so it is checked here with the card count given."""

import pytest
import torch

from gausplat_tpu_torch.scripts import rank_device


@pytest.mark.parametrize("device, rank, backend, cards, want", [
    ("cuda", 0, "nccl", 4, "cuda:0"),
    ("cuda", 3, "nccl", 4, "cuda:3"),
    ("cuda", 2, "gloo", 4, "cuda:0"),
    ("cuda:1", 3, "nccl", 4, "cuda:1"),
    ("cuda:0", 5, "gloo", 1, "cuda:0"),
    ("cpu", 3, "gloo", 0, "cpu"),
])
def test_rank_device(device, rank, backend, cards, want):
    assert rank_device(device, rank, backend, card_count=cards) == torch.device(want)


def test_rank_device_refuses_a_shared_card_under_nccl():
    with pytest.raises(ValueError, match="card of its own"):
        rank_device("cuda", 4, "nccl", card_count=4)
