"""The port's elec-scale pieces on the CPU: DiffMM's ``remat_gcn`` against
the JAX package's rule and model, the port with remat on against itself
with remat off, and ``scripts/elec_scale_torch.py`` at tiny size.

Tolerances are those of ``tests/test_torch_train.py``: the loss to 1e-5
relative, each ``rec`` gradient to 1e-4 relative plus 1e-5 of its tensor's
largest magnitude, the forward's towers to 1e-5.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.dataset import InterTable as JTable
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.models.diffmm import DiffMM as JDiffMM
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import InterTable as TTable
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import diffmm as tdiffmm
from genmmrec_tpu_torch.ops import segment

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"train_batch_size": 24, "save_recommended_topk": False}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(over, n_users=None, n_items=None):
    """The JAX and port DiffMM on tiny, or on a table of a few interactions
    over ``n_users`` × ``n_items`` nodes (the node count alone sets the
    rule), with the same config overrides."""
    jc, tc = JConfig("DiffMM", "tiny", {**BASE, **over}), TConfig("DiffMM", "tiny", {**BASE, **over})
    if n_users is None:
        jtd, ttd = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    else:
        rng = np.random.default_rng(0)
        users = np.concatenate([rng.integers(0, n_users, 40), [n_users - 1]]).astype(np.int32)
        items = np.concatenate([rng.integers(0, n_items, 40), [n_items - 1]]).astype(np.int32)
        jtd = j_train(JDataset(jc, JTable(users, items, n_users, n_items)))
        ttd = t_train(TDataset(tc, TTable(users, items, n_users, n_items)), CPU)
    return JDiffMM(jc, jtd), tdiffmm.DiffMM(tc, ttd)


@pytest.mark.parametrize(
    "nodes, remat_gcn, want",
    [
        ((99_000, 1_000), None, False),  # 100,000 nodes: off
        ((99_000, 1_001), None, True),  # 100,001 nodes: on
        ((99_000, 1_001), 0, False),  # the key overrides the node count
        ((99_000, 1_000), True, True),
    ],
)
def test_remat_rule_at_the_threshold(nodes, remat_gcn, want):
    over = {"dims": [8], "embedding_size": 8}
    if remat_gcn is not None:
        over["remat_gcn"] = remat_gcn
    jm, tm = _models(over, *nodes)
    assert tm.n_users + tm.n_items == sum(nodes)
    assert tm.remat is want and bool(jm.remat) is want


@pytest.mark.parametrize("remat_gcn", [None, True, False, 0, 1])
def test_remat_flag_equals_the_jax_models(remat_gcn):
    over = {} if remat_gcn is None else {"remat_gcn": remat_gcn}
    jm, tm = _models(over)
    assert tm.remat == bool(jm.remat)
    assert tm.remat is (False if remat_gcn is None else bool(remat_gcn))


@pytest.fixture(scope="module")
def remat_pair():
    """Both packages' DiffMM on tiny with remat forced on, the same
    parameters and the same regenerated modal graphs."""
    jm, tm = _models({"remat_gcn": True})
    assert jm.remat and tm.remat
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    rng = np.random.default_rng(6)
    tops = {m: rng.integers(0, jm.n_items, (jm.n_users, 1)) for m in ("image_ui", "text_ui")}
    jstate = {m: jm.rebuild_ui_graph(jnp.asarray(t, jnp.int32), None) for m, t in tops.items()}
    tstate = {m: tm.rebuild_ui_graph(_t(t)) for m, t in tops.items()}
    rng = np.random.default_rng(0)
    B = 24
    users, pos, neg = (rng.integers(0, n, B) for n in (jm.n_users, jm.n_items, jm.n_items))
    w = np.ones(B, np.float32)
    w[-5:] = 0.0
    return dict(jm=jm, tm=tm, params=params, jstate=jstate, tstate=tstate, batch=(users, pos, neg, w))


def _port_loss_and_grads(tm, state, batch):
    users, pos, neg, w = batch
    tb = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    tm.zero_grad(set_to_none=True)
    total, _ = tm.loss(state, tb)
    total.backward()
    grads = {name: p.grad.clone() for name, p in tm.named_parameters() if p.grad is not None}
    tm.zero_grad(set_to_none=True)
    return total.detach(), grads


def test_remat_forward_loss_and_rec_grads_match_jax(remat_pair):
    jm, tm, params = remat_pair["jm"], remat_pair["tm"], remat_pair["params"]
    ref = jm._forward_joint(params, remat_pair["jstate"])
    with torch.enable_grad():
        got = tm._forward_joint(remat_pair["tstate"])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)

    users, pos, neg, w = remat_pair["batch"]
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    (ref_loss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(params, remat_pair["jstate"], jb, None)
    total, grads = _port_loss_and_grads(tm, remat_pair["tstate"], remat_pair["batch"])
    np.testing.assert_allclose(total.item(), float(ref_loss), rtol=1e-5)
    ref_g = jax_tree_by_name(_np_tree(jgrads))
    names = dict(zip(params_by_jax_name(tm), (n for n, _ in tm.named_parameters())))
    checked = 0
    for jname, pname in names.items():
        if jname.startswith("rec/"):
            scale = np.abs(ref_g[jname]).max()
            np.testing.assert_allclose(grads[pname].numpy(), ref_g[jname], rtol=1e-4, atol=1e-5 * scale, err_msg=jname)
            checked += 1
        else:
            assert pname not in grads  # the denoisers play no part in the BPR loss
    assert checked >= 5


def test_remat_on_equals_remat_off_and_recomputes(remat_pair, monkeypatch):
    """The port with remat on gives the loss and every gradient of remat off
    bit for bit, and its backward runs the regions' forward products again
    (one more K1 forward a product on the card; here its plain version)."""
    tm, state, batch = remat_pair["tm"], remat_pair["tstate"], remat_pair["batch"]
    calls = {"n": 0}
    forward = segment.segment_spmm

    def counted(*args, **kwargs):
        calls["n"] += 1
        return forward(*args, **kwargs)

    monkeypatch.setattr(segment, "segment_spmm", counted)
    runs = {}
    for remat in (True, False):
        tm.remat = remat
        calls["n"] = 0
        runs[remat] = (*_port_loss_and_grads(tm, state, batch), calls["n"])
    tm.remat = True
    (loss_on, g_on, n_on), (loss_off, g_off, n_off) = runs[True], runs[False]
    assert torch.equal(loss_on, loss_off)
    assert g_on.keys() == g_off.keys() and len(g_on) >= 5
    for name in g_on:
        assert torch.equal(g_on[name], g_off[name]), name
    # two modal graphs, two main-adjacency passes and one layer, each
    # forward once more in the backward
    products = 4 + tm.gnn_layer
    assert n_off == products and n_on == 2 * products
    with torch.no_grad():
        calls["n"] = 0
        tm._forward_joint(state)
    assert calls["n"] == products  # no region outside autograd


def test_elec_scale_script_at_tiny_size(tmp_path):
    out, doc = tmp_path / "scale.json", tmp_path / "scale.md"
    cmd = [sys.executable, os.path.join(ROOT, "scripts", "elec_scale_torch.py"), "--dataset", "tiny",
           "--epochs", "1", "--device", "cpu", "--out", str(out), "--doc", str(doc)]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    # the host tools' section (scripts/prep_scale_torch.py) outlives the table
    doc.write_text("an older table\n\n## The host tools at elec\n\nkept\n")
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    results = json.loads(out.read_text())
    assert set(results) == {"DiffRec", "LD4MRec", "GenRecV1", "DiffMM"}
    for name, r in results.items():
        assert "error" not in r, (name, r.get("error"))
        assert r["epochs_run"] == 1 and all(r["train_loss_finite"].values()), name
        for key in ("valid_recall@20", "test_recall@20", "data_s", "build_s", "fit_s", "loss_grad_batch_ms"):
            assert np.isfinite(r[key]), (name, key)
        assert 0.0 < r["valid_recall@20"] <= 1.0 and 0.0 < r["test_recall@20"] <= 1.0, name
    assert results["DiffMM"]["remat"] is False  # 112 nodes
    assert np.isfinite(results["DiffMM"]["spmm_pass_ms"]) and np.isfinite(results["GenRecV1"]["spmm_pass_ms"])
    text = doc.read_text()
    assert "| DiffMM | 1/1 |" in text and "Card: cpu" in text
    assert "an older table" not in text and text.endswith("|\n\n## The host tools at elec\n\nkept\n")
