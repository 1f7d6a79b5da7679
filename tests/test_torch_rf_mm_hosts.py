"""The multimodal graph RF hosts (RFMGCN, RFSMORE, RFLGMRec, RFPGL)
against the JAX package, on the CPU, as ``test_torch_rf_hosts.py`` holds
RFBM3 and the graph-CF hosts: the parameters, R, the conditions (PGL's
raw features built once at set-up; the others' projected features each
batch) and ``rf_host_repr``; the loss parts, the total and every gradient
with the JAX draws injected (each base model's own); ``full_embeddings``
and the scores with ``warmed`` 0 and 1. RFLGMRec's target takes the
draws of the JAX ``PRNGKey(0)``, as its evaluation does.
"""

import jax
import pytest

from test_torch_rf_hosts import (  # noqa: F401 (_one_torch_thread: an autouse fixture)
    _one_torch_thread,
    build_pair, check_embeddings_and_scores, check_host_pieces, check_loss_and_grads, host_draws, lgmrec_draws,
    rf_draws,
)

HOSTS = ["RFMGCN", "RFSMORE", "RFLGMRec", "RFPGL"]


@pytest.fixture(scope="module", params=HOSTS)
def pair(request):
    p = build_pair(request.param)
    if request.param == "RFLGMRec":
        p["tm"].repr_draws = lgmrec_draws(p["jm"], jax.random.PRNGKey(0))
    return p


def test_mm_host_pieces_match(pair):
    check_host_pieces(pair)
    assert (pair["tm"]._rf_cached is not None) == (pair["name"] == "RFPGL")


def test_mm_host_loss_and_grads_match(pair):
    name, jm = pair["name"], pair["jm"]
    N = jm.n_users + jm.n_items
    draws = lambda key, B: {**host_draws(name, jm, key, B),
                            "rf_draws": rf_draws(jm.rf_cfg, jax.random.fold_in(key, 1317), N, B)}
    check_loss_and_grads(pair, draws, n_parts=3)


@pytest.mark.parametrize("warmed", [0, 1])
def test_mm_host_embeddings_and_scores_match(pair, warmed):
    check_embeddings_and_scores(pair, warmed)
