"""``parallel.launch.run`` hands rank 0's result to the parent whenever the
parent reads it, on the CPU.

Two gloo ranks; rank 0 returns a dict of tensors, once small and once
larger than a pipe's buffer (over 1 MB). The parent's poll
(``launch.time.sleep``) is held back until every rank has exited, so the
result is read only after rank 0 is gone: a result that still needs its
sender (a tensor sent through a queue as a handle to the sender's memory)
fails there, and one that a rank must push through a pipe before it can
exit deadlocks.
"""

import multiprocessing
import time

import pytest
import torch

from genmmrec_tpu_torch.parallel import launch

# how long the held-back poll waits for the ranks to exit
EXIT_WAIT_S = 120.0


def _tensors(device, n: int) -> dict:
    """Every rank's result: ``n`` floats and a few small tensors, the same on
    every rank."""
    g = torch.Generator().manual_seed(n)
    return {
        "big": torch.randn(n, generator=g),
        "ids": torch.arange(17, dtype=torch.int64),
        "nested": {"state": [torch.ones(3, 4), torch.zeros(2, dtype=torch.bool)], "count": 5},
        "device": str(device),
    }


# 400,000 float32 are 1.6 MB
@pytest.mark.parametrize("n", [64, 400_000], ids=["small", "over_1MB"])
def test_run_reads_rank0_after_every_rank_exited(n, monkeypatch):
    real_sleep = time.sleep

    def after_every_rank(seconds):
        t0 = time.monotonic()
        while multiprocessing.active_children() and time.monotonic() - t0 < EXIT_WAIT_S:
            real_sleep(0.05)

    monkeypatch.setattr(launch.time, "sleep", after_every_rank)
    out = launch.run(_tensors, {"data": 2}, "cpu", (n,))
    monkeypatch.undo()
    ref = _tensors("cpu", n)
    assert torch.equal(out["big"], ref["big"]) and torch.equal(out["ids"], ref["ids"])
    assert torch.equal(out["nested"]["state"][0], ref["nested"]["state"][0])
    assert torch.equal(out["nested"]["state"][1], ref["nested"]["state"][1])
    assert out["nested"]["count"] == 5 and out["device"] == "cpu"
    assert not multiprocessing.active_children()


def _fails_on_rank1(device):
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails")
    return torch.ones(2)


def test_run_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 1"):
        launch.run(_fails_on_rank1, {"data": 2}, "cpu")
    assert not multiprocessing.active_children()
