"""The port's preprocessing (``genmmrec_tpu_torch/preprocessing``, numpy and
the standard library) against the JAX package's pandas pipeline, on the
CPU: the ``.inter``, split, mapping and meta files byte for byte, the
hashed text features bit for bit, the user graph by sorted counts and the
neighbours strictly above each row's least count (ties come in another
order); the golden fixture of ``tests/test_preprocessing_golden.py`` and
its digests; a raw file with blank timestamps and meta with empty and
absent cells; repeated (user, item) rows in the user graph; ``kcore_filter``
on seeded random raw tables; the CLI. Both encoders are held to the
hashing encoder: ``transformers`` is made unimportable."""

import filecmp
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import genmmrec_tpu.preprocessing.pipeline as J
import genmmrec_tpu_torch.preprocessing.pipeline as T
from genmmrec_tpu.preprocessing.__main__ import main as j_main
from genmmrec_tpu_torch.preprocessing.__main__ import main as t_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("{ds}-indexed.inter", "{ds}-indexed-v4.inter", "u_id_mapping.csv", "i_id_mapping.csv", "meta-indexed.csv")


@pytest.fixture(autouse=True)
def _hashing_encoder_only(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)


def _golden_fixture(tmp):
    """The raw ratings and meta of ``tests/test_preprocessing_golden.py``."""
    inter = {
        "A": ["i0", "i1", "i2", "i3"], "B": ["i0", "i1", "i2"], "C": ["i1", "i2", "i3"],
        "D": ["i0", "i3", "i4"], "E": ["i2", "i4", "i5"], "F": ["i0", "i4", "i5"],
        "G": ["i1", "i5", "i3"], "H": ["i6"],
    }
    rows, t = [], 1_000_000
    for u, its in inter.items():
        for it in its:
            rows.append((u, it, 5.0, t))
            t += 1000
    raw = os.path.join(tmp, "raw.csv")
    pd.DataFrame(rows).to_csv(raw, index=False, header=False)
    meta = pd.DataFrame({
        "asin": [f"i{k}" for k in range(7)],
        "title": [f"Item number {k}" for k in range(7)],
        "brand": ["Acme", "Bolt", "Acme", "Cork", "Bolt", "Acme", "Dud"],
        "categories": [str([["Toys", "Blocks"]])] * 7,
        "description": [f"desc {k} words here" for k in range(7)],
    })
    meta_csv = os.path.join(tmp, "meta.csv")
    meta.to_csv(meta_csv, index=False)
    return raw, meta_csv


def _chain(M, raw, meta, out, ds, min_k, **graph_kw):
    inter = M.rating2inter(raw, out, ds, min_k, min_k)
    split = M.per_user_split(inter, seed=999)
    M.reindex_meta(meta, os.path.join(out, "i_id_mapping.csv"), os.path.join(out, "meta-indexed.csv"))
    feats = M.encode_text_features(os.path.join(out, "meta-indexed.csv"), os.path.join(out, "text_feat.npy"))
    graph = M.build_user_graph_dict(split, top_k=3, **graph_kw)
    return split, feats, graph


def _same_graph(g, ref):
    """Equal by sorted counts and by the neighbours strictly above each row's least count."""
    assert sorted(g) == sorted(ref)
    for u in ref:
        (n, w), (rn, rw) = g[u], ref[u]
        assert all(type(x) is int for x in n) and all(type(x) is float for x in w)
        assert sorted(w) == sorted(rw), u
        if w:
            assert {a for a, b in zip(n, w) if b > min(w)} == {a for a, b in zip(rn, rw) if b > min(rw)}, u


def _both_chains(tmp_path, raw, meta, ds, min_k):
    j = _chain(J, raw, meta, str(tmp_path / "j"), ds, min_k)
    t = _chain(T, raw, meta, str(tmp_path / "t"), ds, min_k, device="cpu")
    for name in FILES:
        name = name.format(ds=ds)
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name, shallow=False), name
    assert t[1].dtype == np.float32 and np.array_equal(t[1], j[1])
    _same_graph(t[2], j[2])
    return t


def test_golden_fixture_through_both_pipelines(tmp_path):
    """Files byte-equal, features bit-equal, graphs equal; the JAX golden
    digests of the inter file, the split, the features and the graph (no
    tied counts in it) reproduced from the port's outputs."""
    from tests.test_preprocessing_golden import _digest

    raw, meta = _golden_fixture(str(tmp_path))
    split, feats, graph = _both_chains(tmp_path, raw, meta, "golden", 2)
    inter = T.read_table(str(tmp_path / "t" / "golden-indexed.inter"), "\t")
    assert len(np.unique(inter["userID"])) == 7 and len(np.unique(inter["itemID"])) == 6
    s = T.read_table(split, "\t")
    digests = {
        "inter": _digest({c: inter[c] for c in ["userID", "itemID", "timestamp", "x_label"]}),
        "split": _digest({c: s[c] for c in ["userID", "itemID", "x_label"]}),
        "feat": _digest(feats),
        "graph": _digest(graph),
    }
    assert all(len(set(w)) == len(w) for _, w in graph.values())
    assert digests == {
        "inter": "96c84f034f812445", "split": "8368fe3c92ce2fca",
        "feat": "8bdacd6246c7b01d", "graph": "12bf35d6db6c83e9",
    }


def _raw_with_gaps(tmp):
    """Raw ratings with blank timestamps (the column reads as float) and
    repeated rows; meta as Python-dict lines with empty and absent fields,
    and an unmapped asin."""
    rng = np.random.default_rng(7)
    lines = []
    for _ in range(600):
        u, i = rng.integers(0, 40), rng.integers(0, 30)
        ts = "" if rng.random() < 0.03 else str(1_400_000_000 + int(rng.integers(0, 10**5)))
        lines.append(f"A{u:03d},B{i:04d},{rng.integers(1, 6)}.0,{ts}")
    lines += lines[:20]  # exact repeats
    raw = os.path.join(tmp, "raw.csv")
    with open(raw, "w") as f:
        f.write("\n".join(lines) + "\n")
    meta = os.path.join(tmp, "meta.json.gz")
    with gzip.open(meta, "wt") as f:
        for i in list(range(30)) + [999]:
            rec = {"asin": f"B{i:04d}", "title": "" if i % 7 == 0 else f"Title {i}", "price": 1.5 * i}
            if i % 3:
                rec["brand"] = f"Brand {i % 4}"
            if i % 5:
                rec["categories"] = [["Baby", f"Cat {i % 6}"], ["Other"]]
            rec["description"] = "line one\nline, two" if i % 4 == 0 else f"about item {i}"
            if i % 11 == 0:
                rec["salesRank"] = {"Baby": i}
            f.write(repr(rec) + "\n")
        f.write(json.dumps({"asin": "B0003", "title": "a json line"}).replace("B0003", "B0998") + "\n")
    return raw, meta


def test_blank_timestamps_and_empty_meta_cells(tmp_path):
    """The timestamp column of a raw file with blank cells is float and is
    written as such (``100.0``); an empty meta title is the token ``nan`` in
    its sentence, an absent column is ``" "``."""
    raw, meta = _raw_with_gaps(str(tmp_path))
    _both_chains(tmp_path, raw, meta, "gaps", 3)
    inter = open(tmp_path / "t" / "gaps-indexed.inter").read().splitlines()
    assert inter[1].split("\t")[3].endswith(".0")
    m = T.read_table(str(tmp_path / "t" / "meta-indexed.csv"), ",")
    sentences = T._meta_sentences(m)
    assert sentences == J._meta_sentences(pd.read_csv(tmp_path / "j" / "meta-indexed.csv"))
    assert any(x.startswith("nan ") for x in sentences)
    no_brand = T._meta_sentences({k: v for k, v in m.items() if k != "brand"})
    assert no_brand == J._meta_sentences(pd.read_csv(tmp_path / "j" / "meta-indexed.csv").drop(columns=["brand"]))


def test_repeated_rows_in_the_user_graph(tmp_path):
    """A user's repeated (user, item) train rows count once each on its own
    side and once on the other's, as the JAX loop counts them."""
    rng = np.random.default_rng(11)
    u, i = rng.integers(0, 25, 300), rng.integers(0, 20, 300)
    u[:40], i[:40] = u[40:80], i[40:80]  # repeats
    u[-1] = 25  # the last user only in a test row
    lab = np.where(rng.random(300) < 0.8, 0, 2)
    lab[-1] = 2
    pd.DataFrame({"userID": u, "itemID": i, "rating": 1.0, "timestamp": np.arange(300), "x_label": lab}).to_csv(
        tmp_path / "r.inter", sep="\t", index=False)
    for k in (4, 200):
        ref = J.build_user_graph_dict(str(tmp_path / "r.inter"), top_k=k)
        got = T.build_user_graph_dict(str(tmp_path / "r.inter"), top_k=k, device="cpu")
        _same_graph(got, ref)
    assert got[25] == [[], []] and len(got) == 26
    train = lab == 0
    pairs = np.unique(np.stack([u[train], i[train]], 1), axis=0)
    once = T.user_graph_dict(pairs[:, 0], pairs[:, 1], 26, 20, 200, device="cpu")
    assert any(sorted(once[x][1]) != sorted(got[x][1]) for x in got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kcore_filter_on_random_raw_tables(tmp_path, seed):
    """rating2inter's files byte-equal on skewed random raw tables (numeric
    user ids on seed 1, so the id column reads as integers); the kept rows
    a fixed point of the floor."""
    rng = np.random.default_rng(seed)
    n = 3000
    users = rng.zipf(1.6, n) % 300
    items = rng.zipf(1.4, n) % 200
    uid = [str(x) if seed == 1 else f"U{x}" for x in users]
    lines = [f"{a},I{b},{rng.integers(1, 6)}.0,{1_000 + int(rng.integers(0, 50))}" for a, b in zip(uid, items)]
    raw = tmp_path / "raw.csv"
    raw.write_text("\n".join(lines) + "\n")
    for name, M in (("j", J), ("t", T)):
        M.rating2inter(str(raw), str(tmp_path / name), "r", 4, 3)
    for f in ("r-indexed.inter", "u_id_mapping.csv", "i_id_mapping.csv"):
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f, shallow=False), f
    t = T.read_table(str(tmp_path / "t" / "r-indexed.inter"), "\t")
    assert len(t["userID"]) > 0
    assert np.bincount(t["userID"]).min() >= 4 and np.bincount(t["itemID"]).min() >= 3
    table = T.read_table(str(raw), ",", ["userID", "itemID", "rating", "timestamp"])
    kept = T.kcore_filter(table, min_u=4, min_i=3)
    ref = J.kcore_filter(pd.read_csv(raw, names=["userID", "itemID", "rating", "timestamp"], header=None), min_u=4, min_i=3)
    assert kept["userID"].tolist() == ref["userID"].tolist() and kept["itemID"].tolist() == ref["itemID"].tolist()


def test_cli_against_jax_cli(tmp_path):
    """The five subcommands of both CLIs on the same inputs, ``uu-graph`` of
    the port with ``--device cpu``."""
    raw, meta = _raw_with_gaps(str(tmp_path))
    for name, main, extra in (("j", j_main, []), ("t", t_main, ["--device", "cpu"])):
        d = str(tmp_path / name)
        main(["rating2inter", "--ratings", raw, "--out", d, "--dataset", "x", "--min-u", "3", "--min-i", "3"])
        main(["split", "--inter", f"{d}/x-indexed.inter", "--out", f"{d}/x.inter", "--seed", "5"])
        main(["reindex-feat", "--meta", meta, "--mapping", f"{d}/i_id_mapping.csv", "--out", f"{d}/meta-x.csv"])
        main(["encode-feat", "--meta", f"{d}/meta-x.csv", "--out", f"{d}/text_feat.npy"])
        main(["uu-graph", "--inter", f"{d}/x.inter", "--out", f"{d}/user_graph_dict.npy", "--top-k", "5", *extra])
    for f in ("x-indexed.inter", "x.inter", "u_id_mapping.csv", "i_id_mapping.csv", "meta-x.csv"):
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f, shallow=False), f
    assert np.array_equal(np.load(tmp_path / "j" / "text_feat.npy"), np.load(tmp_path / "t" / "text_feat.npy"))
    load = lambda n: np.load(tmp_path / n / "user_graph_dict.npy", allow_pickle=True).item()
    _same_graph(load("t"), load("j"))


@pytest.mark.parametrize("error", [FileNotFoundError, ImportError, RuntimeError])
def test_text_encoder_falls_back_only_without_a_checkpoint(tmp_path, monkeypatch, error):
    """No cached checkpoint or no ``transformers``: the hashing encoder's
    features; any other failure of the transformer route raises."""
    raw, meta = _golden_fixture(str(tmp_path))
    out = str(tmp_path / "t")
    T.rating2inter(raw, out, "golden", 2, 2)
    T.reindex_meta(meta, os.path.join(out, "i_id_mapping.csv"), os.path.join(out, "meta-indexed.csv"))

    def fail(sentences, model_name):
        raise error("the transformer route failed")

    monkeypatch.setattr(T, "_transformer_features", fail)
    args = (os.path.join(out, "meta-indexed.csv"), os.path.join(out, "text_feat.npy"))
    if error is RuntimeError:
        with pytest.raises(RuntimeError):
            T.encode_text_features(*args)
        assert not os.path.exists(args[1])
    else:
        feats = T.encode_text_features(*args)
        meta_t = T.read_table(args[0], ",")
        meta_t = T._take(meta_t, np.argsort(meta_t["itemID"], kind="stable"))
        np.testing.assert_array_equal(feats, T._hashing_encoder(T._meta_sentences(meta_t)))


def test_port_imports_no_pandas_sklearn_pil_or_transformers():
    """Importing every module of the port loads none of pandas, sklearn, PIL
    and transformers (the card machine has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import genmmrec_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, 'genmmrec_tpu_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert 'genmmrec_tpu_torch.preprocessing.pipeline' in names and 'genmmrec_tpu_torch.native' in names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('pandas', 'sklearn', 'PIL', 'transformers')]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_prep_scale_section_and_its_place_in_the_doc(tmp_path):
    """``scripts/prep_scale_torch.py``'s section of the scale document from
    a hand-written run: the steps in the CLI's order, a step stopped at its
    timeout named and the steps after it absent; ``write_section`` replaces
    its own part of the document, from its heading on, and keeps the rest."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("prep_scale_torch", os.path.join(REPO, "scripts", "prep_scale_torch.py"))
    P = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(P)
    gb = 1e9
    step = lambda s: dict(ok=True, step_s=s, import_s=8.0, peak_rss_bytes=6 * gb, peak_allocated_bytes=None,
                          k3_launches=0)
    run = dict(
        dataset="elec", card="NVIDIA H100 80GB HBM3, 700.00 W", torch="2.11.0+cu128", total_s=300.0,
        raw=dict(core_users=192403, core_items=63001, core_rows=1855897, noise_rows=470500, raw_rows=2326397,
                 generate_s=143.6, write_s=161.0, peak_rss_bytes=1.43 * gb, parent_peak_rss_bytes=0.05 * gb),
        steps={"split": dict(ok=False, stopped_after_s=1800), "rating2inter": step(33.0)},
    )
    text = P.section(run)
    assert text.startswith("## The host tools at elec\n") and "(192,403 users × 63,001 items)" in text
    rows = [ln for ln in text.splitlines() if ln.startswith("| ") and "---" not in ln][1:]
    assert rows == ["| rating2inter | 33.0 | 8.0 | 6.00 | — | 0 |", "| split | stopped after 1800 s | | | | |"]
    assert "The user graph on the card" not in text and "NVIDIA H100 80GB HBM3, 700.00 W" in text
    doc = tmp_path / "ELEC_SCALE_TORCH.md"
    doc.write_text("# Elec-scale runs\n\n| table |\n")
    P.write_section(str(doc), text)
    P.write_section(str(doc), text.replace("33.0", "34.0"))
    assert doc.read_text() == "# Elec-scale runs\n\n| table |\n\n" + text.replace("33.0", "34.0")
