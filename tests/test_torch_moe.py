"""Port parity for the Mixture-of-Experts FFN (``models/moe.py``), the
ambient mesh it reads (``distributed.sharding.use_mesh`` / ``get_mesh``),
serving a DeepSeek decoder greedily and speculatively, the MLA + MoE path
with ``jax`` and ``repro`` blocked, and the check logic of
``chip_smoke.py``'s ``[deepseek]`` phase at a reduced size, each on the
CPU.

The MoE of reduced DeepSeek-V2-Lite (4 routed experts, top-2, 1 shared)
and V3 (8 routed), weights drawn with numpy in the reference's shapes.
The router's tie order (``lax.top_k``: the lower expert first) on forced
ties; ``moe_dense`` in float32 and bf16; ``moe_alltoall`` and
``moe_serve_tp`` against the reference's under ``jax.set_mesh(
make_host_mesh())`` (one expert slice) at capacity_factor 8 (no drops)
and 0.1 (most token copies dropped); the port at 2 and 4 expert slices
against one; the bf16 ``psum``; the mesh shapes of one process run in series.

Tolerances: float32 compute to rtol = atol = 1e-5 (aux 1e-6 relative);
bf16 compute within 5e-2 on the same input (the router then sees the same
bf16 input on both sides); the slices of the port against one slice to
1e-6; the bf16 ``psum`` to two bf16 ulps (of the largest output across
slices); tokens and speculative stats exact.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.data import corpus_rules as JR  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import spec_decode as JSD  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import corpus_rules as TR  # noqa: E402
from repro_torch.distributed.sharding import get_mesh, use_mesh  # noqa: E402
from repro_torch.models import convert, init_cache  # noqa: E402
from repro_torch.models import materialize_params  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.pytree import tree_map  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import spec_decode as TSD  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
CPU = torch.device("cpu")
V2, V3 = "deepseek-v2-lite-16b", "deepseek-v3-671b"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
SLICES = dict(rtol=1e-6, atol=1e-6)

needs_set_mesh = pytest.mark.skipif(
    not hasattr(jax, "set_mesh"),
    reason="jax.set_mesh not available in this jax version",
)


class _Mesh:
    """What the port reads of a mesh: axis name → extent (and, where
    given, the devices)."""

    def __init__(self, devices=None, **shape):
        self.shape = shape
        if devices is not None:
            self.devices = devices


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _cfgs(arch, dt="float32", **moe):
    jc = JC.get_reduced_config(arch)
    tc = TC.get_reduced_config(arch)
    return (jc.scaled(compute_dtype=dt,
                      moe=dataclasses.replace(jc.moe, **moe)),
            tc.scaled(compute_dtype=dt,
                      moe=dataclasses.replace(tc.moe, **moe)))


def _moe_weights(cfg, seed):
    """One MoE layer's weights (numpy, the reference's ``init_moe``
    shapes): N(0, 1) / sqrt(fan in)."""
    shapes, _ = JM.abstract_params(cfg)
    rng = np.random.RandomState(seed)
    out = {}
    for name, leaf in shapes["units"]["0"]["ffn"].items():
        shape = leaf.shape[1:]
        fan = shape[-2] if len(shape) == 3 else shape[0]
        out[name] = (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)
    return out


def _x(cfg, b=2, s=8, seed=0):
    return (np.random.RandomState(seed).randn(b, s, cfg.d_model)
            * 0.5).astype(np.float32)


def _ref(fn, cfg, w, x, mesh=False):
    run = jax.jit(partial(fn, cfg))
    args = (jax.tree.map(jnp.asarray, w), jnp.asarray(x))
    if mesh:
        with jax.set_mesh(make_host_mesh()):
            return run(*args)
    return run(*args)


def _port(fn, cfg, w, x, mesh=None):
    with torch.inference_mode():
        if mesh is None:
            return fn(cfg, tree_map(_t, w), _t(x))
        with use_mesh(mesh):
            return fn(cfg, tree_map(_t, w), _t(x))


# ----------------------------------------------------------------------
# the ambient mesh and the router
# ----------------------------------------------------------------------
def test_use_mesh_sets_and_restores_the_ambient_mesh():
    assert get_mesh() is None
    outer, inner = _Mesh(model=2), _Mesh(model=4, data=1)
    with use_mesh(outer) as m:
        assert m is outer and get_mesh() is outer
        with pytest.raises(RuntimeError):
            with use_mesh(inner):
                assert get_mesh() is inner
                raise RuntimeError
        assert get_mesh() is outer
    assert get_mesh() is None
    with pytest.raises(TypeError):
        with use_mesh({"model": 2}):
            pass


@pytest.mark.parametrize("arch", [V2, V3])
def test_router_ties_lower_expert_first(arch):
    """Experts with equal router columns tie exactly; both sides put the
    lower expert first (``lax.top_k``), and a zero router ties every
    expert, so the first ``top_k`` experts are picked."""
    jcfg, tcfg = _cfgs(arch)
    w = _moe_weights(jcfg, seed=1)
    e = jcfg.moe.n_routed
    router = w["router"]
    router[:, e // 2:] = router[:, :e // 2]      # expert i ties i + e/2
    x2d = _x(jcfg).reshape(-1, jcfg.d_model)
    for r in (router, np.zeros_like(router)):
        want = jax.jit(partial(JMOE._router, jcfg))(
            {"router": jnp.asarray(r)}, jnp.asarray(x2d))
        with torch.inference_mode():
            got = TMOE._router(tcfg, {"router": _t(r)}, _t(x2d))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        _close(got[0], want[0], dict(rtol=1e-6, atol=1e-7))
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    assert (got[1].numpy() == np.arange(jcfg.moe.top_k)).all()
    vals, idx = TMOE.top_k_lower_first(torch.tensor([[1., 3., 3., 2., 3.]]),
                                       3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3., 3., 3.]]


# ----------------------------------------------------------------------
# dense and dispatch paths against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [V2, V3])
def test_moe_dense_matches_reference(arch, dt):
    jcfg, tcfg = _cfgs(arch, dt)
    w = _moe_weights(jcfg, seed=2)
    x = _x(jcfg, seed=3)
    want_y, want_aux = _ref(JMOE.moe_dense, jcfg, w, x)
    got_y, got_aux = _port(TMOE.moe_dense, tcfg, w, x)
    assert got_y.dtype == torch.float32
    _close(got_y, want_y, F32 if dt == "float32" else BF16)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


@needs_set_mesh
@pytest.mark.parametrize("cf", [8.0, 0.1])
@pytest.mark.parametrize("path", ["moe_alltoall", "moe_serve_tp"])
def test_dispatch_matches_reference_on_host_mesh(path, cf):
    """One expert slice (the reference's 1 x 1 host mesh; the port's
    {"data": 1, "model": 1}): output and aux against the reference's, with
    no drops at capacity_factor 8 and most token copies dropped at 0.1."""
    jcfg, tcfg = _cfgs(V2, capacity_factor=cf)
    w = _moe_weights(jcfg, seed=4)
    x = _x(jcfg, seed=5)
    want_y, want_aux = _ref(getattr(JMOE, path), jcfg, w, x, mesh=True)
    got_y, got_aux = _port(getattr(TMOE, path), tcfg, w, x,
                           _Mesh(data=1, model=1))
    _close(got_y, want_y, F32)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    dense, _ = _port(TMOE.moe_dense, tcfg, w, x)
    dropped = not np.allclose(_np(got_y), _np(dense), **F32)
    assert dropped == (cf < 1)


@pytest.mark.parametrize("cf", [8.0, 0.1])
@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("arch", [V2, V3])
def test_expert_slices_match_one_slice(arch, ep, cf):
    """The port's shard body run once per expert slice and summed equals
    one slice: the same token copies kept and dropped at every ep."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    w = _moe_weights(jcfg, seed=6)
    x = _x(jcfg, seed=7)
    one = _port(TMOE.moe_alltoall, tcfg, w, x, _Mesh(model=1))
    many = _port(TMOE.moe_alltoall, tcfg, w, x, _Mesh(model=ep))
    _close(many[0], one[0], SLICES)
    np.testing.assert_allclose(float(many[1]), float(one[1]), rtol=1e-6)
    serve = _port(TMOE.moe_serve_tp, tcfg, w, x, _Mesh(data=1, model=ep))
    _close(serve[0], one[0], SLICES)
    if cf < 1:
        # most token copies go past 8 slots an expert and are dropped
        cap = TMOE._capacity(x.shape[0] * x.shape[1], tcfg)
        with torch.inference_mode():
            _, ids, _ = TMOE._router(tcfg, tree_map(_t, w),
                                     _t(x).reshape(-1, tcfg.d_model))
        counts = np.bincount(ids.reshape(-1).numpy(),
                             minlength=tcfg.moe.n_routed)
        assert cap == 8 and (counts > cap).any()


@needs_set_mesh
def test_psum_bf16_matches_reference():
    """``moe_psum_bf16``: each slice's partial output rounded to bf16 and
    summed in bf16; one slice against the reference's, and two slices,
    bf16-representable, against one."""
    jcfg, tcfg = _cfgs(V3, n_shared=0)
    jcfg, tcfg = (c.scaled(moe_psum_bf16=True) for c in (jcfg, tcfg))
    w = _moe_weights(jcfg, seed=8)
    x = _x(jcfg, seed=9)
    want, _ = _ref(JMOE.moe_alltoall, jcfg, w, x, mesh=True)
    one, _ = _port(TMOE.moe_alltoall, tcfg, w, x, _Mesh(data=1, model=1))
    two, _ = _port(TMOE.moe_alltoall, tcfg, w, x, _Mesh(model=2))
    # one slice rounds the same float32 sum as the reference; two slices
    # round two partial sums, each off by up to half an ulp of its own
    # magnitude, which cancellation can leave beside a small total
    _close(one, want, dict(rtol=2 ** -7, atol=1e-6))
    _close(two, one, dict(rtol=2 ** -7,
                          atol=2 ** -7 * float(one.abs().max())))
    for y in (one, two):
        assert torch.equal(y, y.to(torch.bfloat16).float())


def test_mesh_shapes_the_port_does_not_run_raise():
    """A mesh of one process runs every shape in series: data- or
    pod-parallel extents cut the rows into the reference's batch blocks
    (``alltoall``: each block at its own capacity, the aux averaged over
    the blocks; ``serve_tp``: every row at the global capacity, each
    expert's FFN in blocks over data, to f32 rounding); such a
    mesh over several devices raises ``ValueError`` (several devices take
    a process mesh, which ``tests/test_torch_mesh.py`` runs); an expert
    count the model axis does not divide runs dense, as in the reference;
    no mesh, or no model axis, runs dense."""
    jcfg, tcfg = _cfgs(V2, capacity_factor=0.1)
    w = _moe_weights(jcfg, seed=10)
    x = _x(jcfg, seed=11)
    dense = _port(TMOE.moe_dense, tcfg, w, x)
    for mesh in (_Mesh(data=2, model=2), _Mesh(pod=2, data=1, model=1)):
        flat = _Mesh(model=mesh.shape["model"])
        y, aux = _port(TMOE.moe_alltoall, tcfg, w, x, mesh)
        blocks = [_port(TMOE.moe_alltoall, tcfg, w, x[i:i + 1], flat)
                  for i in range(x.shape[0])]
        assert torch.equal(y, torch.cat([yb for yb, _ in blocks]))
        assert torch.equal(aux, torch.stack([a for _, a in blocks]).mean())
        # serve_tp: the FFN blocks over data add in another order
        y_tp, aux_tp = _port(TMOE.moe_serve_tp, tcfg, w, x, mesh)
        want_y, want_aux = _port(TMOE.moe_serve_tp, tcfg, w, x, flat)
        _close(y_tp, want_y, F32)
        assert torch.equal(aux_tp, want_aux)
    for mesh in (_Mesh(devices=["cpu", "cuda:0"], model=2),
                 _Mesh(devices=np.array([["cpu"], ["meta"]], object),
                       model=2)):
        for path in (TMOE.moe_alltoall, TMOE.moe_serve_tp):
            with pytest.raises(ValueError, match="process mesh"):
                _port(path, tcfg, w, x, mesh)
    for mesh in (None, _Mesh(data=1), _Mesh(model=3),
                 _Mesh(devices=["cpu", "cpu"], model=3)):
        for path in (TMOE.moe_alltoall, TMOE.moe_serve_tp):
            y, _ = _port(path, tcfg, w, x, mesh)
            assert torch.equal(y, dense[0])


@needs_set_mesh
@pytest.mark.parametrize("impl,serving", [("dense", True),
                                          ("alltoall", False),
                                          ("alltoall", True)])
def test_moe_picks_the_reference_path(impl, serving):
    """``moe`` dispatches as the reference's does (dense; ``alltoall``;
    ``serve_tp`` when serving), told apart by the drops at
    capacity_factor 0.1."""
    jcfg, tcfg = _cfgs(V2, capacity_factor=0.1, impl=impl)
    jcfg, tcfg = (c.scaled(serving=serving) for c in (jcfg, tcfg))
    w = _moe_weights(jcfg, seed=12)
    x = _x(jcfg, seed=13)
    want, _ = _ref(JMOE.moe, jcfg, w, x, mesh=True)
    got, _ = _port(TMOE.moe, tcfg, w, x, _Mesh(data=1, model=1))
    _close(got, want, F32)


# ----------------------------------------------------------------------
# serving a DeepSeek decoder
# ----------------------------------------------------------------------
def _model_weights(cfg, seed):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[-1] == "scale":
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        shape = leaf.shape[1:] if "units" in keys else leaf.shape
        fan = shape[-2] if len(shape) == 3 and "ffn" in keys else shape[0]
        if keys[-1] == "embed":
            fan = cfg.d_model
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, JM.abstract_params(cfg)[0])


def test_deepseek_greedy_and_speculative_match_reference():
    """Reduced DeepSeek-V2-Lite in float32: greedy tokens equal to the
    reference's; speculative decoding with a trie fit on the greedy
    continuation, its 4-grams changed at every third token (drafts
    accepted and rejected, the latent cache rewound): tokens and stats
    equal to the reference's and tokens equal to greedy."""
    jcfg, tcfg = _cfgs(V2)
    w = _model_weights(jcfg, seed=14)
    jparams = jax.tree.map(jnp.asarray, w)
    tparams = convert.params_from_numpy(tcfg, w, CPU)
    prompt = np.array([[5, 17, 42, 99, 3, 250]], np.int32)
    want, _ = JE.greedy_generate(jcfg, jparams, JM.init_cache(
        jcfg, 1, 64, jnp.float32), jnp.asarray(prompt), 16)
    want = np.asarray(want)
    got, cache = TE.greedy_generate(tcfg, tparams, init_cache(
        tcfg, 1, 64, torch.float32, CPU), prompt, 16)
    assert np.array_equal(got.numpy(), want)
    assert cache["units"]["0"]["pos"].tolist() == [6 + 16] * jcfg.n_units
    assert int(cache["prefix"][0]["pos"]) == 6 + 16
    seq = list(prompt[0]) + list(want[0])
    rows = []
    for i in range(3, len(seq)):
        gram = [int(t) for t in seq[i - 3:i + 1]]
        if i % 3 == 0:
            gram[-1] = (gram[-1] + 1) % jcfg.vocab_size
        rows.append(gram)
    w_toks, w_stats = JSD.speculative_generate(
        jcfg, jparams, JM.init_cache(jcfg, 1, 64, jnp.float32), prompt,
        JR.NgramTrie(n=4).fit(rows), 16, min_confidence=0.0)
    g_toks, g_stats = TSD.speculative_generate(
        tcfg, tparams, init_cache(tcfg, 1, 64, torch.float32, CPU), prompt,
        TR.NgramTrie(n=4).fit(rows), 16, min_confidence=0.0)
    assert np.array_equal(g_toks, w_toks)
    assert np.array_equal(g_toks, want)
    assert g_stats == w_stats
    assert 0 < g_stats["accepted"] < g_stats["proposed"]


# ----------------------------------------------------------------------
# isolation and the chip phase's checks
# ----------------------------------------------------------------------
def test_mla_moe_path_imports_and_runs_without_jax_or_repro():
    """With ``jax`` and ``repro`` blocked: greedy and speculative decoding
    agree on reduced DeepSeek-V2-Lite and V3, and the dispatch path at
    two expert slices equals the dense MoE on a random batch at
    capacity_factor 8 (no copy dropped, whatever the batch routes)."""
    code = (
        "import dataclasses, sys, types\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "import repro_torch.configs as C\n"
        "import repro_torch.models as M\n"
        "import repro_torch.data as D\n"
        "from repro_torch.distributed import use_mesh\n"
        "from repro_torch.models import mla, moe\n"
        "from repro_torch.serve.engine import greedy_generate\n"
        "from repro_torch.serve.spec_decode import speculative_generate\n"
        "assert C.get_config('deepseek-v2-lite-16b').param_count() == \\\n"
        "    15706484224\n"
        "for arch in ('deepseek-v2-lite-16b', 'deepseek-v3-671b'):\n"
        "    cfg = C.get_reduced_config(arch).scaled(\n"
        "        compute_dtype='float32')\n"
        "    p, _ = M.materialize_params(\n"
        "        cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "    prompt = np.asarray([[1, 2, 3, 4, 5]], np.int32)\n"
        "    g, c = greedy_generate(cfg, p, M.init_cache(cfg, 1, 32,\n"
        "        torch.float32, 'cpu'), prompt, 6)\n"
        "    assert c['units']['0']['ckv'].shape[-1] == \\\n"
        "        cfg.mla.kv_lora_rank\n"
        "    trie = D.NgramTrie(n=3).fit([list(prompt[0]) + g[0].tolist()])\n"
        "    s, st = speculative_generate(cfg, p, M.init_cache(cfg, 1, 32,\n"
        "        torch.float32, 'cpu'), prompt, trie, 6)\n"
        "    assert s[0].tolist() == g[0].tolist() and st['accepted'] > 0\n"
        "    x = torch.randn(1, 16, cfg.d_model)\n"
        "    ffn = {k: v[0] for k, v in p['units']['0']['ffn'].items()}\n"
        "    dense, _ = moe.moe_dense(cfg, ffn, x)\n"
        "    wide = cfg.scaled(moe=dataclasses.replace(cfg.moe,\n"
        "                                              capacity_factor=8.0))\n"
        "    with use_mesh(types.SimpleNamespace(shape={'model': 2})):\n"
        "        y, _ = moe.moe_alltoall(wide, ffn, x)\n"
        "    assert torch.allclose(y, dense, atol=1e-5)\n"
        "assert 'mtp' in p\n"
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


class _CpuGenerator(torch.Generator):
    """``torch.Generator(device=...)`` on the CPU."""

    def __init__(self, device=None):
        super().__init__()


def test_chip_smoke_deepseek_checks_on_cpu(capsys, monkeypatch):
    """The ``[deepseek]`` phase's checks (f32 speculative == greedy with
    three proposers after a chunked absorbed prefill; the two-layer slice
    on the device against the CPU; expanded against absorbed; the
    dispatch path against dense at ep 1 and 4, and at capacity_factor 0.1
    with drops) at a reduced config on the CPU, so a broken phase fails
    here before the card; a dispatch path that drifts from dense fails
    it."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch, "Generator", _CpuGenerator)
    cfg = TC.get_reduced_config(V2).scaled(vocab_size=320)
    params, _ = materialize_params(cfg, torch.Generator().manual_seed(0),
                                   CPU)
    sizes = dict(prompt=512, decode=16, max_seq=540, xdev=16,
                 corpus_docs=20, moe_tokens=64)
    res = cs.ds_checks(cfg, params, CPU, sizes, seed=0)
    out = capsys.readouterr().out
    assert "speculative == greedy" in out and "[deepseek absorbed]" in out
    assert res["continuation"]["accepted"] > 0
    assert res["xdev_err"] == 0.0 and res["absorbed_err"] < 1e-3
    assert res["dropped"] > 0
    real = TMOE.moe_alltoall
    monkeypatch.setattr(TMOE, "moe_alltoall",
                        lambda *a: (real(*a)[0] * 1.1, real(*a)[1]))
    with pytest.raises(AssertionError, match="dispatch at ep=1"):
        cs.ds_moe_checks(cfg, params, CPU, 64, 0, "deepseek")
