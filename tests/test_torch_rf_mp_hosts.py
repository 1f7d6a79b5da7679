"""The message-passing RF hosts (RFMMGCN, RFGRCN, RFDualGNN, RFCOHESION)
against the JAX package, on the CPU, as ``test_torch_rf_hosts.py`` holds
RFBM3 and the graph-CF hosts: the parameters, R, the conditions (the raw
features, built once at set-up in the port: d = 32 and 16 here, the
sliced product past 512 columns on the card) and ``rf_host_repr``; the
loss parts, the total and every gradient with the JAX draws injected;
``full_embeddings`` and the scores with ``warmed`` 0 and 1.
"""

import jax
import pytest

from test_torch_rf_hosts import (  # noqa: F401 (_one_torch_thread: an autouse fixture)
    _one_torch_thread,
    build_pair, check_embeddings_and_scores, check_host_pieces, check_loss_and_grads, host_draws, rf_draws,
)

HOSTS = ["RFMMGCN", "RFGRCN", "RFDualGNN", "RFCOHESION"]


@pytest.fixture(scope="module", params=HOSTS)
def pair(request):
    return build_pair(request.param)


def test_mp_host_pieces_match(pair):
    check_host_pieces(pair)
    assert pair["tm"]._rf_cached is not None


def test_mp_host_loss_and_grads_match(pair):
    name, jm = pair["name"], pair["jm"]
    N = jm.n_users + jm.n_items
    draws = lambda key, B: {**host_draws(name, jm, key, B),
                            "rf_draws": rf_draws(jm.rf_cfg, jax.random.fold_in(key, 1317), N, B)}
    check_loss_and_grads(pair, draws, n_parts=3)


@pytest.mark.parametrize("warmed", [0, 1])
def test_mp_host_embeddings_and_scores_match(pair, warmed):
    check_embeddings_and_scores(pair, warmed)
