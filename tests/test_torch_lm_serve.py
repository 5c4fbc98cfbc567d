"""Port parity for the LM serving path: the data pipeline (tokenizer,
packed batches, corpus rules, the ``NgramTrie`` proposer), the serving
steps (``serve.engine``) and trie-backed speculative decoding
(``serve.spec_decode``), each against the reference on the CPU, then the
LM path run with ``jax`` and ``repro`` blocked, and the check logic of
``chip_smoke.py``'s ``[lm]`` phase at a reduced size on the CPU.

Weights cross from the reference side (numpy draws in the shapes of its
``abstract_params``; its own init cannot be re-derived in another
process).  Tolerance: bitwise for the data path and the proposer (every
count, support, confidence and lift, every proposal); tokens and the
speculative stats exact with ``compute_dtype="float32"``.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JCB  # noqa: E402
from repro.data import corpus_rules as JR  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.data.tokenizer import ByteTokenizer as JTok  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import spec_decode as JSD  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.data import corpus_rules as TR  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.models import convert, init_cache  # noqa: E402
from repro_torch.models import materialize_params  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import spec_decode as TSD  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
CPU = torch.device("cpu")


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------
def test_tokenizer_matches_reference():
    texts = ["", "trie of rules", "naïve café — ünïcödé ✓",
             "terms and conditions apply\n\tsee store"]
    j, t = JTok(), ByteTokenizer()
    assert (t.pad_id, t.bos_id, t.eos_id, t.vocab_size) == \
        (j.pad_id, j.bos_id, j.eos_id, j.vocab_size)
    for text in texts:
        for bos in (True, False):
            for eos in (True, False):
                ids = t.encode(text, add_bos=bos, add_eos=eos)
                assert ids == j.encode(text, add_bos=bos, add_eos=eos)
                assert t.decode(ids) == j.decode(ids) == text
    assert t.decode([0xC3, 256, 0x28]) == j.decode([0xC3, 256, 0x28])


@pytest.fixture(scope="module")
def corpus():
    docs = JP.synthetic_corpus(200, seed=3)
    assert TP.synthetic_corpus(200, seed=3) == docs
    return docs


@pytest.mark.parametrize("pack", [True, False])
def test_token_pipeline_batches_bitwise(corpus, pack):
    docs = corpus[:40]
    for seq_len, gb, seed in ((64, 4, 0), (37, 3, 5)):
        jp = JP.TokenPipeline(docs, JP.PipelineConfig(seq_len, gb, seed,
                                                      pack))
        tp = TP.TokenPipeline(docs, TP.PipelineConfig(seq_len, gb, seed,
                                                      pack))
        assert tp.n_rows == jp.n_rows
        assert np.array_equal(tp._rows, jp._rows)
        assert np.array_equal(tp._segs, jp._segs)
        batches = tp.batches(start_step=3)
        for step in (0, 1, 3, 4, 1000):
            want, got = jp.batch_at(step), tp.batch_at(step)
            if step in (3, 4):
                assert all(np.array_equal(v, got[k])
                           for k, v in next(batches).items())
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(got[k], want[k]), k


def _token_rows(n, seed, vocab=12, length=80):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, vocab, rng.randint(2, length)))
            for _ in range(n)]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_ngram_trie_bitwise(corpus, n):
    """Every node's path, count-derived support, confidence and lift,
    bitwise, and every proposal at several draft lengths and gates, on
    random rows and on byte-tokenized corpus rows."""
    tok = ByteTokenizer()
    for rows in (_token_rows(6, n), [tok.encode(d) for d in corpus[:30]]):
        j = JR.NgramTrie(n=n).fit(rows)
        t = TR.NgramTrie(n=n).fit(rows)
        assert t.total == j.total
        want = [(p, nd.support, nd.confidence, nd.lift, nd.depth)
                for p, nd in j.trie.all_paths()]
        got = [(p, nd.support, nd.confidence, nd.lift, nd.depth)
               for p, nd in t.trie.all_paths()]
        assert got == want
        contexts = {p[-(n - 1):] for p, _ in j.trie.all_paths()}
        contexts |= {(9999,) * (n - 1), ()}
        for ctx in sorted(contexts):
            for k, gate in ((1, 0.0), (4, 0.3), (6, 0.05)):
                assert t.propose(ctx, max_tokens=k, min_confidence=gate) \
                    == j.propose(ctx, max_tokens=k, min_confidence=gate)


def test_mine_corpus_rules_and_boilerplate(corpus):
    """The reference test's corpus case: the windows' transactions, the
    mined trie node for node, and the boilerplate paths in order."""
    jp = JP.TokenPipeline(corpus, JP.PipelineConfig(seq_len=256,
                                                    global_batch=4))
    rows = jp._rows[:120, :-1]
    jres, jdb = JR.mine_corpus_rules(rows, min_support=0.03, window=10,
                                     stride=5)
    tres, tdb = TR.mine_corpus_rules(rows, min_support=0.03, window=10,
                                     stride=5, device="cpu")
    assert tdb.transactions == jdb.transactions
    assert tdb.n_items == jdb.n_items
    assert tres.itemsets == jres.itemsets
    assert tres.sequences == jres.sequences
    want = [(p, nd.support, nd.confidence, nd.lift)
            for p, nd in jres.trie.all_paths()]
    assert [(p, nd.support, nd.confidence, nd.lift)
            for p, nd in tres.trie.all_paths()] == want
    for depth, conf in ((3, 0.5), (4, 0.8), (1, 0.0)):
        assert TR.boilerplate_paths(tres, depth, conf) == \
            JR.boilerplate_paths(jres, depth, conf)
    assert TR.boilerplate_paths(tres, min_depth=3, min_confidence=0.5)
    wdb = TR.windows_to_db(rows[:5], window=6, stride=3, vocab_size=300)
    assert wdb.transactions == JR.windows_to_db(rows[:5], 6, 3,
                                                300).transactions


# ----------------------------------------------------------------------
# serving: greedy and speculative decoding
# ----------------------------------------------------------------------
SPEC_CFG = dict(name="t", d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
                d_ff=64, vocab_size=64, n_units=2, remat=False,
                tie_embeddings=True, compute_dtype="float32")


def _weights(cfg, seed):
    """numpy weights in the reference's tree, at the reference's init
    scale (1 / sqrt(fan in); norm scales near 1)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[-1] == "scale":
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        shape = leaf.shape[1:] if "units" in keys else leaf.shape
        fan = int(np.prod(shape[:-1])) if keys[-1] == "wo" else cfg.d_model
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, JM.abstract_params(cfg)[0])


@pytest.fixture(scope="module")
def spec_model():
    """The reference's spec-decode test config at float32 compute, with
    its weights on both sides, and the greedy continuation of its prompt
    on the reference."""
    jcfg = JCB.ModelConfig(unit=(JCB.LayerSpec("attn", "mlp"),), **SPEC_CFG)
    tcfg = TCB.ModelConfig(unit=(TCB.LayerSpec("attn", "mlp"),), **SPEC_CFG)
    w = _weights(jcfg, 0)
    jparams = jax.tree.map(jnp.asarray, w)
    tparams = convert.params_from_numpy(tcfg, w, CPU)
    prompt = np.array([[1, 2, 3]], np.int32)
    out, _ = JE.greedy_generate(
        jcfg, jparams, JM.init_cache(jcfg, 1, 64, jnp.float32),
        jnp.asarray(prompt), 16)
    return jcfg, tcfg, jparams, tparams, prompt, np.asarray(out)[0]


def test_greedy_generate_matches_reference(spec_model):
    jcfg, tcfg, jparams, tparams, prompt, want = spec_model
    got, cache = TE.greedy_generate(
        tcfg, tparams, init_cache(tcfg, 1, 64, torch.float32, CPU), prompt,
        16)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 16)
    assert np.array_equal(got.numpy()[0], want)
    assert cache["units"]["0"]["pos"].tolist() == [3 + 16, 3 + 16]
    # a reduced dense config, batch 2, through the exported step makers
    cfg = get_reduced_config("yi-6b").scaled(compute_dtype="float32")
    jc = JCB.ModelConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in ("unit", "prefix", "suffix")},
        unit=(JCB.LayerSpec("attn", "mlp"),))
    w = _weights(jc, 1)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 7))
    want, _ = JE.greedy_generate(
        jc, jax.tree.map(jnp.asarray, w), JM.init_cache(jc, 2, 24,
                                                        jnp.float32),
        jnp.asarray(toks, jnp.int32), 9)
    got, _ = TE.greedy_generate(
        cfg, convert.params_from_numpy(cfg, w, CPU),
        init_cache(cfg, 2, 24, torch.float32, CPU), toks, 9)
    assert np.array_equal(got.numpy(), np.asarray(want))
    from repro_torch.serve import make_decode_step, make_prefill_step
    assert make_prefill_step is TE.make_prefill_step
    assert make_decode_step is TE.make_decode_step


def _proposers(prompt, greedy):
    rows = [list(np.random.RandomState(0).randint(0, 64, 64))]
    seq = list(prompt[0]) + list(greedy)
    wrong = []
    for i in range(3, len(seq)):
        gram = [int(t) for t in seq[i - 3:i + 1]]
        if i % 3:
            gram[-1] = (gram[-1] + 1) % 64
        wrong.append(gram)
    return {
        # the reference test's own proposer: random rows
        "random_rows": (3, 3, 0.0, rows),
        # the continuation itself: drafts accepted
        "continuation": (4, 4, 0.3, [seq]),
        # its 4-grams, the last token changed in two of three: drafts
        # rejected, the cache rewound
        "rejecting": (4, 4, 0.0, wrong),
    }


@pytest.mark.parametrize("proposer", ["random_rows", "continuation",
                                      "rejecting"])
def test_speculative_matches_reference_and_greedy(spec_model, proposer):
    """Tokens and stats (``proposed``, ``accepted``, ``verify_steps``)
    equal to the reference's, and tokens equal to greedy decoding."""
    jcfg, tcfg, jparams, tparams, prompt, greedy = spec_model
    n, max_draft, gate, rows = _proposers(prompt, greedy)[proposer]
    jt, tt = JR.NgramTrie(n=n).fit(rows), TR.NgramTrie(n=n).fit(rows)
    want, wstats = JSD.speculative_generate(
        jcfg, jparams, JM.init_cache(jcfg, 1, 64, jnp.float32), prompt, jt,
        16, max_draft=max_draft, min_confidence=gate)
    got, stats = TSD.speculative_generate(
        tcfg, tparams, init_cache(tcfg, 1, 64, torch.float32, CPU), prompt,
        tt, 16, max_draft=max_draft, min_confidence=gate)
    assert got.dtype == np.int32 and got.shape == (1, 16)
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], greedy)
    assert stats == wstats
    if proposer == "continuation":
        assert stats["accepted"] > 0
    if proposer == "rejecting":
        assert stats["accepted"] < stats["proposed"]


def test_rewind_moves_every_position_counter():
    """``_rewind`` subtracts k from every integer leaf of rank 0 or 1 (the
    stacked units' [n_units] ``pos``) and leaves the k/v buffers alone,
    as the reference's does."""
    cfg = get_reduced_config("granite-3-2b")
    cache = init_cache(cfg, 1, 8, torch.float32, CPU)
    cache["units"]["0"]["pos"] += 5
    out = TSD._rewind(cache, 2)
    assert out["units"]["0"]["pos"].tolist() == [3, 3]
    assert out["units"]["0"]["pos"].dtype == torch.int32
    assert out["units"]["0"]["k"] is cache["units"]["0"]["k"]
    jc = JM.init_cache(JCB.ModelConfig(
        name="g", d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=131, unit=(JCB.LayerSpec("attn", "mlp"),),
        n_units=2), 1, 8, jnp.float32)
    jc = jax.tree.map(lambda x: x + 5 if x.dtype == jnp.int32 else x, jc)
    assert np.asarray(JSD._rewind(jc, 2)["units"]["0"]["pos"]).tolist() \
        == out["units"]["0"]["pos"].tolist()


# ----------------------------------------------------------------------
# isolation and the chip phase's checks
# ----------------------------------------------------------------------
def test_lm_path_imports_and_runs_without_jax_or_repro():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "import repro_torch.configs as C\n"
        "import repro_torch.distributed.sharding as S\n"
        "import repro_torch.models as M\n"
        "import repro_torch.data as D\n"
        "from repro_torch.serve.engine import greedy_generate\n"
        "from repro_torch.serve.spec_decode import speculative_generate\n"
        "for name in ('ModelConfig', 'ShapeConfig', 'SHAPES', 'ARCH_IDS',\n"
        "             'get_config', 'get_reduced_config', 'get_shape'):\n"
        "    assert hasattr(C, name), name\n"
        "for name in ('abstract_params', 'cache_axes',\n"
        "             'count_params_analytic', 'decode_step', 'forward',\n"
        "             'init_cache', 'init_model', 'materialize_params',\n"
        "             'PV', 'split_pv'):\n"
        "    assert name in M.__all__, name\n"
        "for name in ('ByteTokenizer', 'PipelineConfig', 'TokenPipeline',\n"
        "             'synthetic_corpus', 'NgramTrie', 'mine_corpus_rules'):\n"
        "    assert name in D.__all__, name\n"
        "assert S.logical_to_spec(('heads',), type('M', (), {'shape':\n"
        "    {'model': 16}})(), (15,)) == (None,)\n"
        "assert C.get_config('smollm-360m').param_count() == 361821120\n"
        "cfg = C.get_reduced_config('smollm-360m').scaled(\n"
        "    compute_dtype='float32', vocab_size=300)\n"
        "p, _ = M.materialize_params(cfg, torch.Generator().manual_seed(0),\n"
        "                            'cpu')\n"
        "tok = D.ByteTokenizer()\n"
        "rows = [tok.encode(d) for d in D.synthetic_corpus(5, seed=1)]\n"
        "prompt = np.asarray([rows[0][:12]], np.int32)\n"
        "g, _ = greedy_generate(cfg, p, M.init_cache(cfg, 1, 64,\n"
        "    torch.float32, 'cpu'), prompt, 8)\n"
        "trie = D.NgramTrie(n=3).fit([list(prompt[0]) + g[0].tolist()])\n"
        "s, st = speculative_generate(cfg, p, M.init_cache(cfg, 1, 64,\n"
        "    torch.float32, 'cpu'), prompt, trie, 8)\n"
        "assert s[0].tolist() == g[0].tolist() and st['accepted'] > 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_lm_checks_on_cpu(capsys):
    """The ``[lm]`` phase's checks (f32 speculative == greedy with three
    proposers, the rejecting one rewinding the cache; prefill logits on
    the device against the CPU; the bf16 agreement share) at a reduced
    config on the CPU, so a broken phase fails here before the card."""
    cs = _chip_smoke()
    cfg = get_reduced_config("smollm-360m").scaled(vocab_size=320)
    params, _ = materialize_params(cfg, torch.Generator().manual_seed(0),
                                   CPU)
    sizes = dict(prompt=48, decode=24, max_seq=96, xdev=16, corpus_docs=20)
    res = cs.lm_checks(cfg, params, CPU, params, sizes, seed=0)
    out = capsys.readouterr().out
    assert "speculative == greedy" in out
    assert res["continuation"]["accepted"] > 0
    assert res["rejecting"]["accepted"] < res["rejecting"]["proposed"]
    assert res["xdev_err"] == 0.0
    assert set(res["bf16_agree"]) == {"corpus", "continuation", "rejecting"}
    # a speculative token that differs from greedy fails the phase
    real = cs.lm_spec_vs_greedy

    def broken(*a, **k):
        greedy, spec = real(*a, **k)
        toks, stats = spec["continuation"]
        toks = toks.copy()
        toks[5] += 1
        spec["continuation"] = (toks, stats)
        return greedy, spec

    cs.lm_spec_vs_greedy = broken
    with pytest.raises(AssertionError, match="position 5"):
        cs.lm_checks(cfg, params, CPU, params, sizes, seed=0)
