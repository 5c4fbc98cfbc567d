"""Port parity for the observability package (``repro_torch.obs``) and the
launch-profiler hook of the port's ops, on the CPU.

The obs package is plain Python in both packages: the same inputs go to
both and every output must be equal (quantiles, snapshots, text and
trace exports compare exactly).  The profiled ops must record the
reference's op names, rows and pad factors for the same call sequence,
and answer bit for bit as with the profiler off (and as the reference
does, the trie_reduce sums to 1e-6 relative).
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as J  # noqa: E402
import repro_torch.obs as T  # noqa: E402
from repro.arm.rulegen import sample_rule_sequences  # noqa: E402
from repro.arm.transactions import TransactionDB as JDB  # noqa: E402
from repro.core import array_trie as JA  # noqa: E402
from repro.core.build_arrays import build_frozen_trie as j_build  # noqa: E402
from repro.core import synthetic as JS  # noqa: E402
from repro.core.delta_trie import StreamingTrie as JStream  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.serve.trie_engine import TrieQueryEngine as JEngine  # noqa: E402
from repro_torch.core import StreamingTrie  # noqa: E402
from repro_torch.arm.transactions import TransactionDB as TDB  # noqa: E402
from repro_torch.core import array_trie as TA  # noqa: E402
from repro_torch.core.build_arrays import (  # noqa: E402
    build_frozen_trie as t_build,
)
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.serve import TrieQueryEngine  # noqa: E402


def _both(fn):
    """``fn(obs_module)`` run against both packages: (reference, port)."""
    return fn(J), fn(T)


# ----------------------------------------------------------------------
# metrics, traces and exports: identical inputs, identical outputs
# ----------------------------------------------------------------------
def _quantiles(obs):
    rng = np.random.default_rng(7)
    h = obs.Histogram("lat")
    for v in rng.lognormal(mean=2.0, sigma=1.5, size=4000):
        h.observe(v)
    qs = [h.quantile(q) for q in (0.0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9,
                                  0.99, 1.0)]
    return qs, h.mean, h.count, h.snapshot()


def _underflow(obs):
    h = obs.Histogram("x", lo=1.0)
    for v in (0.25, 0.75, -1.0, float("nan")):
        h.observe(v)
    return h.count, list(h.counts), h.quantile(0.5)


def _snapshot_merge(obs):
    rng = np.random.default_rng(11)
    a, b = rng.exponential(5.0, 500), rng.exponential(50.0, 500)
    ha, hb = obs.Histogram("m"), obs.Histogram("m")
    for v in a:
        ha.observe(v)
    for v in b:
        hb.observe(v)
    ha.merge_snapshot(hb.snapshot())
    try:
        ha.merge_snapshot(obs.Histogram("m", lo=1.0).snapshot())
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return ha.snapshot(), [ha.quantile(q) for q in (0.1, 0.5, 0.99)], refused


def _registry(obs):
    m = obs.MetricsRegistry()
    m.counter("req", tenant="a").inc(3)
    m.counter("req", tenant="b").inc()
    same = m.counter("x", a="1", b="2") is m.counter("x", b="2", a="1")
    m.gauge("depth", shard="0").set(2.5)
    m.histogram("lat", tenant="a").observe(10.0)
    m2 = obs.MetricsRegistry()
    m2.counter("req", tenant="a").inc(4)
    m2.histogram("lat", tenant="a").observe(1000.0)
    merged = obs.merge_snapshots([m.snapshot(), m2.snapshot()])
    hs = merged["histograms"]['lat{tenant="a"}']
    return (same, m.value("req", tenant="a"), m.label_values("req", "tenant"),
            merged, obs.quantile_from_snapshot(hs, 1.0),
            obs.metrics_text(merged), obs.metrics_text(m),
            obs.format_metric("req", (("tenant", "a"),)))


def _disabled(obs):
    m = obs.MetricsRegistry(enabled=False)
    nulls = [m.counter("a") is obs.NULL_INSTRUMENT,
             m.gauge("b") is obs.NULL_INSTRUMENT,
             m.histogram("c") is obs.NULL_INSTRUMENT]
    m.counter("a").inc()
    m.histogram("c").observe(5.0)
    tr = obs.Tracer(enabled=False)
    sp = tr.start("root")
    with tr.span("scoped", parent=sp) as inner:
        inner.attrs["x"] = 1
    tr.end(sp, status="ok")
    return nulls, m.snapshot(), sp is obs.NULL_SPAN, tr.spans, inner.attrs


class _Clock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        self.t += 0.25
        return self.t


def _trace_export(obs):
    tr = obs.Tracer(enabled=True, clock=_Clock())
    root = tr.start("request", parent=False, req=3)
    with tr.span("queue", parent=root):
        with tr.span("launch", op="top_k"):
            pass
    tr.end(root, status="ok")
    step = tr.start("step", parent=False)
    with tr.span("merge", parent=step):
        pass
    tr.end(step)
    tr.start("open", parent=False)            # never ended: not exported
    doc = obs.spans_to_trace_events(tr.spans)
    return json.dumps(doc, sort_keys=True), [s.name for s in tr.finished()]


def _ring(obs):
    prof = obs.KernelProfiler(capacity=4)
    calls = []

    def spy(rec):
        calls.append(rec.op)

    prof.add_observer(spy)
    prof.enable()
    for _ in range(10):
        prof.record("op", rows=1, shape=(1,), seconds=0.001)
    ring = len(prof.ring("op"))
    seen = len(calls)
    del spy                                     # weakly held: drops
    prof.record("op", rows=1, shape=(1,), seconds=0.001)
    after = len(calls)
    prof.disable()
    return ring, seen, after, prof.ops(), prof.ring("op")[-1]


def _bundle(obs):
    bundle = obs.Observability(tracing=True,
                               profiler=obs.KernelProfiler(capacity=8))
    bundle.bind_clock(_Clock())
    bundle.bind_clock(None)                     # first bind wins
    with bundle.profile_kernels() as prof:
        prof.record("top_k", rows=4, shape=(4, 3), seconds=0.002,
                    pad_factor=2.0)
    assert not bundle.profiler.enabled          # scope restores
    snap = bundle.snapshot()
    return (sorted(snap["counters"]), snap["counters"],
            sorted(snap["histograms"]), bundle.tracer.now())


CASES = {
    "histogram_quantiles": _quantiles,
    "histogram_underflow_nan": _underflow,
    "snapshot_merge": _snapshot_merge,
    "registry_labels": _registry,
    "disabled_noops": _disabled,
    "export_open_spans": _trace_export,
    "ring_capacity_dead_observer": _ring,
    "observability_bundle": _bundle,
}


def _plain(x):
    """Records and dataclasses as tuples, so both packages' compare."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(v) for v in dataclasses.astuple(x))
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


@pytest.mark.parametrize("case", list(CASES))
def test_obs_matches_reference(case):
    want, got = _both(CASES[case])
    assert _plain(got) == _plain(want)


def test_obs_is_plain_python():
    """The port's obs package imports neither torch nor JAX nor the
    reference (its modules read only the standard library)."""
    import ast
    import pathlib

    root = pathlib.Path(T.__file__).parent
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] in {
                    "math", "json", "time", "weakref", "collections",
                    "contextlib", "dataclasses", "typing", "__future__",
                }, (path.name, name)


# ----------------------------------------------------------------------
# the profiled ops
# ----------------------------------------------------------------------
def _port_trie(fz):
    return TA.FrozenTrie.from_arrays({
        f.name: np.asarray(getattr(fz, f.name))
        for f in dataclasses.fields(JA.FrozenTrie)
    })


@pytest.fixture(scope="module")
def tries():
    arrs = JS.random_csr_trie(np.random.RandomState(5), 400, 16)
    jf = JS.frozen_from_arrays(arrs)
    return jf, _port_trie(jf)


def _calls(jf, tf):
    """The same op sequence for each package: (name, reference call,
    port call)."""
    rng = np.random.RandomState(2)
    pairs = [(list(jf.path_items(v)[:1]), list(jf.path_items(v)[1:]))
             for v in rng.randint(1, jf.n_nodes, size=20)]
    pairs += pairs[:5] + [([0], [99])]
    q, al = jf.canonicalize_queries([p[0] for p in pairs],
                                    [p[1] for p in pairs])
    prefixes = [[], [0], [1, 2], [99]]
    items = [0, 1, 1, 99, -1]
    jd, td = jf.device_arrays(), tf.device_arrays(device="cpu")
    jc = jf.device_arrays(layout="compressed")
    tc = tf.device_arrays(device="cpu", layout="compressed")
    out = [
        ("rule_search_batch", lambda: JO.rule_search_batch(jf, pairs),
         lambda: TO.rule_search_batch(tf, pairs, device="cpu")),
        ("rule_search compressed", lambda: JO.rule_search(jc, q, al),
         lambda: TO.rule_search(tc, q, al)),
        ("top_k_rules_batch",
         lambda: JO.top_k_rules_batch(jf, prefixes, 5, metric="lift"),
         lambda: TO.top_k_rules_batch(tf, prefixes, 5, metric="lift",
                                      device="cpu")),
        ("top_k_rules", lambda: JO.top_k_rules(jd, 3, prefix=[0]),
         lambda: TO.top_k_rules(td, 3, prefix=[0])),
    ]
    for role in ("any", "antecedent", "consequent"):
        out.append((f"rules_with {role}",
                    lambda role=role: JO.rules_with(jf, items, role=role,
                                                    k=4),
                    lambda role=role: TO.rules_with(tf, items, role=role,
                                                    k=4, device="cpu")))
    out.append(("trie_reduce", lambda: JO.trie_reduce(jd),
                lambda: TO.trie_reduce(td)))
    return out


def _recorded(obs, fn):
    """``fn()`` under an enabled profiler: its answer and, in order, the
    (op, rows, pad factor, shards, shape) of each record."""
    prof = obs.kernel_profiler
    seen = []

    def spy(rec):
        seen.append((rec.op, rec.rows, rec.pad_factor, rec.n_shards,
                     rec.shape))

    prof.add_observer(spy)
    try:
        with prof.enabled_scope():
            out = fn()
    finally:
        prof._observers = [r for r in prof._observers if r() is not spy]
    return out, seen


def _bitwise(got, want):
    assert set(got) == set(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("call", range(8))
def test_profiled_ops_record_reference_names(tries, call):
    name, jfn, tfn = _calls(*tries)[call]
    plain = tfn()
    j_out, j_seen = _recorded(J, jfn)
    t_out, t_seen = _recorded(T, tfn)
    assert [s[:4] for s in t_seen] == [s[:4] for s in j_seen], name
    if name != "top_k_rules":
        # the reference's single top_k ranks one range with its own
        # kernel, shaped (n, k); the port's is the batched kernel's Q=1
        assert [s[4] for s in t_seen] == [s[4] for s in j_seen], name
    _bitwise(t_out, plain)
    if name == "trie_reduce":
        # the sums hold to 1e-6 relative against the reference, as in
        # tests/test_torch_ops.py; the rest is bitwise
        for key in ("support_sum", "mean_conf"):
            np.testing.assert_allclose(float(t_out.pop(key)),
                                       float(j_out.pop(key)), rtol=1e-6)
    _bitwise(t_out, j_out)
    assert not T.kernel_profiler.enabled


def test_profiled_stream_ops_record_reference_names():
    # a stream's base is canonical (every path in item-frequency order),
    # so it is built from transactions, by both packages
    rng = np.random.RandomState(8)
    txs = [set(rng.randint(0, 10, size=rng.randint(1, 6)))
           for _ in range(30)]
    jdb = JDB(txs, n_items=10)
    seqs = sample_rule_sequences(jdb, 40, seed=2)
    jf, _, _ = j_build(jdb, seqs[:25])
    tf, _, _ = t_build(TDB(txs, n_items=10), seqs[:25], use_kernel=False)
    paths = [tuple(jf.path_items(v)) for v in range(1, jf.n_nodes, 3)]
    mets = np.random.RandomState(3).rand(3, len(paths)).astype(np.float32)
    js, ts = JStream(jf), StreamingTrie(tf, device="cpu")
    for st in (js, ts):
        st.insert(paths, *mets)
    pairs = [(p[:1], p[1:]) for p in paths if len(p) > 1]
    calls = [
        (lambda: JO.rule_search_batch(js, pairs),
         lambda: TO.rule_search_batch(ts, pairs)),
        (lambda: JO.top_k_rules_batch(js, [[], [0]], 4),
         lambda: TO.top_k_rules_batch(ts, [[], [0]], 4)),
        (lambda: JO.rules_with(js, [0, 3], role="consequent", k=4),
         lambda: TO.rules_with(ts, [0, 3], role="consequent", k=4)),
        (lambda: JO.rules_with(js, [0, 3], role="any", k=4),
         lambda: TO.rules_with(ts, [0, 3], role="any", k=4)),
    ]
    for jfn, tfn in calls:
        plain = tfn()
        j_out, j_seen = _recorded(J, jfn)
        t_out, t_seen = _recorded(T, tfn)
        assert t_seen == j_seen
        _bitwise(t_out, plain)
        _bitwise(t_out, j_out)


def test_profiler_off_records_nothing(tries):
    _, tf = tries
    prof = T.kernel_profiler
    prof.clear()
    assert not prof.enabled
    TO.top_k_rules_batch(tf, [[]], 3, device="cpu")
    TO.trie_reduce(tf, device="cpu")
    assert prof.ops() == []
    with prof.enabled_scope(metrics=T.MetricsRegistry()) as p:
        TO.trie_reduce(tf, device="cpu")
        assert p.metrics.value("kernel.launches", op="trie_reduce") == 1
    assert prof.ops() == ["trie_reduce"] and prof.metrics is None
    prof.clear()


def test_engine_spans_match_reference(tries):
    jf, tf = tries
    engines = (JEngine(jf, mode="replicated"),
               TrieQueryEngine(tf, device="cpu"))
    names = []
    for eng, obs in zip(engines, (J, T)):
        eng.obs = obs.Observability(tracing=True)
        eng.obs.bind_clock(_Clock())
        eng.rule_search_batch([([0], [1])])
        eng.top_k_rules_batch([[]], 3)
        eng.rules_with([0, 1], role="any", k=2)
        names.append([(s.name, s.parent_id, s.start_s, s.end_s, s.attrs)
                      for s in eng.obs.tracer.finished()])
    assert names[1] == names[0]
    assert [n[0] for n in names[1]] == [
        "engine.rule_search_batch", "engine.top_k_rules_batch",
        "engine.rules_with"]
    teng = engines[1]
    teng.trie_reduce()
    assert teng.obs.tracer.finished()[-1].name == "engine.trie_reduce"
    teng.obs = None
    _bitwise(teng.top_k_rules_batch([[]], 3),
             engines[0].top_k_rules_batch([[]], 3))
