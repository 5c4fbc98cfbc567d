"""Port parity per kernel module: each wrapper (on the CPU, its plain
version) against the reference's Pallas kernel in interpret mode on a
small trie, and the import isolation of the port from JAX.  The kernels
themselves are held against their plain versions on the card in
``test_torch_gpu.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import synthetic as JS  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels.item_index import rules_with_pallas  # noqa: E402
from repro.kernels.rank import topk_rank_batch_pallas  # noqa: E402
from repro.kernels.rule_search import rule_search_fused_pallas  # noqa: E402
from repro.kernels.trie_reduce import trie_reduce_pallas  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels.item_index import rules_with_member  # noqa: E402
from repro_torch.kernels.rank import topk_rank_batch  # noqa: E402
from repro_torch.kernels.rule_search import rule_search_fused  # noqa: E402
from repro_torch.kernels.trie_reduce import trie_reduce_columns  # noqa: E402
from repro_torch.core import synthetic as TS  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture(scope="module")
def small():
    """A ~1.5K-node irregular trie with tie-forced confidences, its
    arrays, and the port's and reference's gathered column dicts."""
    arrs = JS.random_csr_trie(np.random.RandomState(31), 1500, 30)
    arrs["confidence"] = np.round(arrs["confidence"], 1).astype(np.float32)
    arrs["edge_conf"] = arrs["confidence"][arrs["edge_child"]]
    jf = JS.frozen_from_arrays(arrs)
    tf = TS.frozen_from_arrays(arrs)
    return {
        "arrs": arrs,
        "jdfs": JO.dfs_rank_arrays(jf),
        "jitem": JO.item_rank_arrays(jf),
        "tdfs": TO.dfs_rank_arrays(tf, device="cpu"),
        "titem": TO.item_rank_arrays(tf, device="cpu"),
        "tf": tf,
        "jf": jf,
    }


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _ranges(small):
    los, his, _ = TO.prefix_ranges(small["tf"], [[], [1], [2, 5], [77]],
                                   device="cpu")
    return los, his


def test_rank_module_vs_pallas(small):
    los, his = _ranges(small)
    d, t = small["jdfs"], small["tdfs"]
    for metric, k in (("confidence", 9), ("conviction", 300)):
        want = topk_rank_batch_pallas(
            d["support"], d["confidence"], d["lift"], d["depth"],
            jnp.asarray(los.numpy()), jnp.asarray(his.numpy()),
            k=k, metric=metric, interpret=True)
        got = topk_rank_batch(
            t["support"], t["confidence"], t["lift"], t["depth"], los, his,
            k=k, metric=metric)
        _same(got, want)


def test_item_index_module_vs_pallas(small):
    ji, ti = small["jitem"], small["titem"]
    plos, phis, qitems = TO._posting_slices(ti["item_offsets"],
                                            [0, 4, 29, -1])
    cols = ("support", "confidence", "lift", "depth", "node_item",
            "post_lo", "post_hi")
    for role in ("antecedent", "any", "consequent"):
        want = rules_with_pallas(
            *[ji[c] for c in cols], *map(jnp.asarray, (plos, phis, qitems)),
            k=12, metric="leverage", role=role,
            max_postings=ji["max_postings"], interpret=True)
        got = rules_with_member(
            *[ti[c] for c in cols], *map(torch.from_numpy,
                                         (plos, phis, qitems)),
            k=12, metric="leverage", role=role)
        _same(got, want)


def test_rule_search_module_vs_pallas(small):
    arrs = small["arrs"]
    q, al = JS.mixed_queries(np.random.RandomState(3), arrs, 48, 5)
    names = ("child_offsets", "edge_item", "edge_child", "edge_conf",
             "edge_sup", "edge_lift")
    want = rule_search_fused_pallas(
        *[jnp.asarray(arrs[n]) for n in names], jnp.asarray(q),
        jnp.asarray(al), max_fanout=arrs["max_fanout"], interpret=True)
    got = rule_search_fused(
        *[torch.from_numpy(arrs[n]) for n in names], torch.from_numpy(q),
        torch.from_numpy(al), max_fanout=arrs["max_fanout"])
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    # and the ops on top of it, against the reference op (Pallas inside)
    want = JO.rule_search_batch(small["jf"], q, al)
    got = TO.rule_search_batch(small["tf"], q, al, device="cpu")
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


def test_trie_reduce_module_vs_pallas(small):
    arrs = small["arrs"]
    want = trie_reduce_pallas(
        jnp.asarray(arrs["support"]), jnp.asarray(arrs["confidence"]),
        jnp.asarray(arrs["node_depth"]), interpret=True)
    got = trie_reduce_columns(
        torch.from_numpy(arrs["support"]),
        torch.from_numpy(arrs["confidence"]),
        torch.from_numpy(arrs["node_depth"]))
    assert float(got[0]) == float(want[0])
    assert float(got[2]) == float(want[2])
    for i in (1, 3):
        np.testing.assert_allclose(float(got[i]), float(want[i]), rtol=1e-6)


def test_port_imports_without_jax_or_repro():
    """``repro_torch`` and everything under it import with ``jax`` and
    ``repro`` made unimportable."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.kernels.ops, repro_torch.serve\n"
        "import repro_torch.kernels.trie_reduce, repro_torch.kernels._build\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
