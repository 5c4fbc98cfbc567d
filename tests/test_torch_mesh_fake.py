"""The port's placement on meshes no host here has: an in-process fake
process group (``torch.testing._internal.distributed.fake_pg``: rank 0
of a world of 8, collectives that move nothing) under a (2, 2)
``("data", "model")`` and a (2, 2, 2) ``("pod", "data", "model")``
``DeviceMesh``.

- Every param and cache leaf of all ten configs at their reduced sizes,
  placed by ``remesh_state``: DTensor placements and local shape equal
  to the reference's ``named_sharding`` spec and ``shard_shape`` (on a
  ``jax.sharding.AbstractMesh`` of the same shape).
- ``CommDebugMode`` around ``moe_alltoall`` on reduced DeepSeek-V2-Lite
  (the expert-parallel MoE) counts the bytes of each collective: the
  psum's all-reduce bytes equal ``launch/dryrun.py::collective_bytes``'s
  MoE psum term for the same layout (float32 payload).  ``python
  tests/test_torch_mesh_fake.py`` prints every counted collective beside
  the model's terms.
- ``named_sharding`` and ``constrain`` (a failing redistribute raises).
- The placed Mamba2 forward, Jamba's hybrid unit and DeepSeek-V3's loss
  with its MTP head run and return outputs of the placed shapes (the
  values are the four-rank gloo worlds' to check:
  ``tests/test_torch_mesh.py``); ``cache_position`` of a placed pure-SSM
  cache reads 0, of a placed Jamba cache its attention layer's counter.

The group is torn down after the module, so no other test sees it.
"""
import dataclasses
import sys
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    Replicate, Shard, distribute_tensor,
)

from repro_torch import configs as TC  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    NamedSharding, constrain, is_placed, named_sharding, use_mesh,
)
from repro_torch.launch.mesh import ProcessMesh  # noqa: E402
from repro_torch.models import (  # noqa: E402
    abstract_params, cache_axes, cache_position, forward, init_cache,
    loss_fn, materialize_params,
)
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.pytree import tree_leaves_with_path, tree_map  # noqa: E402
from repro_torch.train.elastic import remesh_state  # noqa: E402

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CACHE_B, CACHE_SEQ = 4, 32
MOE_B, MOE_S = 4, 8


def _world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)


def _mesh(name):
    shape, axes = MESHES[name]
    n = int(np.prod(shape))
    return ProcessMesh(DeviceMesh("cpu", torch.arange(n).reshape(shape),
                                  mesh_dim_names=axes))


@pytest.fixture(scope="module")
def fake_world():
    if dist.is_initialized():
        pytest.fail("a process group is already up in this process")
    _world()
    try:
        yield {name: _mesh(name) for name in MESHES}
    finally:
        dist.destroy_process_group()


def _reference_layout(arch, name, group):
    """(path, placements, shard shape) of every leaf from the
    reference's ``named_sharding`` on an ``AbstractMesh``."""
    from jax.sharding import AbstractMesh

    from repro import configs as JC
    from repro.distributed.sharding import named_sharding as j_named
    from repro.models import model as JM
    from repro_torch.distributed.sharding import placements_of

    shape, axes = MESHES[name]
    mesh = AbstractMesh(shape, axes)
    cfg = JC.get_reduced_config(arch)
    if group == "params":
        shapes, ax = JM.abstract_params(cfg)
    else:
        shapes, ax = (JM.init_cache(cfg, CACHE_B, CACHE_SEQ),
                      JM.cache_axes(cfg))
    out = []
    for (path, leaf), (_, a) in zip(tree_leaves_with_path(_port(shapes)),
                                    tree_leaves_with_path(_port(ax, True))):
        sh = j_named(tuple(a), mesh, tuple(leaf.shape))
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        out.append((path, [str(p) for p in placements_of(spec, mesh)],
                    tuple(sh.shard_shape(tuple(leaf.shape)))))
    return out


def _port(tree, tuples_are_leaves=False):
    if isinstance(tree, dict):
        return {k: _port(v, tuples_are_leaves) for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not tuples_are_leaves):
        return [_port(v, tuples_are_leaves) for v in tree]
    return tree


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_placements_equal_named_sharding(fake_world, arch, name):
    """All ten configs at reduced size: each param and cache leaf placed
    by ``remesh_state`` has the reference's placements and shard shape,
    and its global shape."""
    mesh = fake_world[name]
    cfg = TC.get_reduced_config(arch)
    params, axes = materialize_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
    cache = init_cache(cfg, CACHE_B, CACHE_SEQ, torch.float32, "cpu")
    for group, tree, ax in (("params", params, axes),
                            ("cache", cache, cache_axes(cfg))):
        placed = remesh_state(tree, ax, mesh)
        got = list(tree_leaves_with_path(placed))
        want = _reference_layout(arch, name, group)
        assert len(got) == len(want) > 0
        for (path, leaf), (wpath, places, local) in zip(got, want):
            assert path == tuple(wpath), (path, wpath)
            assert [str(p) for p in leaf.placements] == places, path
            assert tuple(leaf.to_local().shape) == local, path
            assert tuple(leaf.shape) == tuple(
                _leaf(tree, path).shape), path


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_named_sharding_record(fake_world):
    """``named_sharding`` is the reference's record: the mesh, the spec
    ``logical_to_spec`` gives (with the divisibility fallback), the
    placements one a mesh dim, the shard shape."""
    mesh = fake_world["2x2x2"]
    sh = named_sharding(("batch", "seq", "heads"), mesh, (8, 16, 6))
    assert isinstance(sh, NamedSharding) and sh.mesh is mesh
    assert sh.spec == (("pod", "data"), None, "model")
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert sh.shard_shape((8, 16, 6)) == (2, 16, 3)
    odd = named_sharding(("batch", "heads"), mesh, (2, 5))
    assert odd.spec == ("pod", None)
    assert odd.placements == (Shard(0), Replicate(), Replicate())
    with pytest.raises(ValueError):
        named_sharding(("batch",), mesh).shard_shape((3,))


def test_constrain_redistributes_on_a_process_mesh(fake_world):
    """A DTensor under an ambient process mesh goes to its logical
    placements; a plain tensor, or no process mesh, is left alone; a
    redistribution that cannot run raises."""
    mesh = fake_world["2x2"]
    x = distribute_tensor(torch.randn(4, 6, 8), mesh.device_mesh,
                          [Replicate(), Replicate()])
    plain = torch.randn(4, 6, 8)
    assert constrain(x, ("batch", "seq", "mlp")) is x
    with use_mesh(mesh):
        y = constrain(x, ("batch", "seq", "mlp"))
        assert y.placements == (Shard(0), Shard(2))
        assert y.to_local().shape == (2, 6, 4)
        assert constrain(plain, ("batch", "seq", "mlp")) is plain
    other = fake_world["2x2x2"]
    with use_mesh(other):
        with pytest.raises(Exception):
            constrain(x, ("batch", "seq", "mlp"))


@pytest.mark.parametrize("arch,what", [
    ("mamba2-370m", "forward"),
    ("jamba-1.5-large-398b", "forward"),
    ("deepseek-v3-671b", "loss"),
])
def test_placed_mamba_jamba_and_mtp_run(fake_world, arch, what):
    """Mamba2, Jamba's hybrid unit and DeepSeek-V3's MTP loss on placed
    params: the forward's logits and ``hidden`` come back placed, their
    batch over ``data`` (a rank's rows) and their global shapes the
    batch's; a prefill and a decode step into a placed cache write it
    back placed as it came, its position read off it; the loss and each
    metric (``mtp_loss`` too) a finite scalar on every rank."""
    mesh = fake_world["2x2"]
    cfg = TC.get_reduced_config(arch)
    params, axes = materialize_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
    placed = remesh_state(params, axes, mesh)
    b, s = 4, 8
    toks = torch.zeros((b, s), dtype=torch.int32)
    with use_mesh(mesh):
        if what == "loss":
            loss, metrics = loss_fn(cfg, placed, {"tokens": toks,
                                                  "labels": toks})
            assert set(metrics) == {"lm_loss", "aux_loss", "mtp_loss"}
            for v in [loss, *metrics.values()]:
                assert not is_placed(v) and v.shape == ()
                assert bool(torch.isfinite(v))
            return
        logits, extras, _ = forward(cfg, placed, {"tokens": toks})
        for x, width in ((logits, cfg.vocab_size),
                         (extras["hidden"], cfg.d_model)):
            assert is_placed(x) and tuple(x.shape) == (b, s, width)
            assert tuple(x.to_local().shape) == (b // 2, s, width)
        cache = remesh_state(init_cache(cfg, b, CACHE_SEQ, torch.float32,
                                        "cpu"), cache_axes(cfg), mesh)
        before = [(path, leaf.placements, tuple(leaf.to_local().shape))
                  for path, leaf in tree_leaves_with_path(cache)]
        with torch.inference_mode():
            for n in (s, 1):
                logits, _, cache = forward(cfg, placed, {"tokens": toks[:, :n]},
                                           cache=cache)
                assert tuple(logits.to_local().shape) == (
                    b // 2, n, cfg.vocab_size)
        assert [(path, leaf.placements, tuple(leaf.to_local().shape))
                for path, leaf in tree_leaves_with_path(cache)] == before
        pos = cache_position(cache)
        if arch == "mamba2-370m":
            # no position counter: a pure-SSM cache reads 0
            assert int(pos) == 0
        else:
            assert int(pos.full_tensor() if is_placed(pos) else pos) == s + 1


# ----------------------------------------------------------------------
# counted collectives against the dry run's model
# ----------------------------------------------------------------------
class CollectiveBytes:
    """``CommDebugMode`` that also sums the bytes of each collective's
    tensors (its counts stay ``get_comm_counts()``)."""

    def __init__(self):
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.distributed.tensor.debug._comm_mode import (
            c10d_collective_ops,
        )

        outer = self

        class Mode(CommDebugMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                packet = getattr(func, "_overloadpacket", None)
                if packet in c10d_collective_ops or \
                        packet in self.comm_registry:
                    first = args[0] if args else None
                    ts = first if isinstance(first, (list, tuple)) else [first]
                    for t in ts:
                        if isinstance(t, (list, tuple)):
                            t = t[0]
                        if isinstance(t, torch.Tensor):
                            outer.calls.append(
                                (str(packet).split(".")[-1],
                                 t.numel() * t.element_size()))
                return super().__torch_dispatch__(func, types, args, kwargs)

        self.calls = []
        self.mode = Mode()

    def by_kind(self):
        out = Counter()
        for kind, n in self.calls:
            out[kind] += n
        return out


def _moe_case(mesh, bf16=False):
    """Reduced DeepSeek-V2-Lite's MoE (experts over ``model``) on a
    4 x 8 batch placed over ``data``: (cfg, placed weights, placed x)."""
    cfg = TC.get_reduced_config("deepseek-v2-lite-16b").scaled(
        compute_dtype="float32", moe_psum_bf16=bf16)
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, impl="alltoall"))
    params, axes = materialize_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
    ffn = tree_map(lambda t: t[0], params["units"]["0"]["ffn"])
    ffn_axes = tree_map(lambda a: tuple(a)[1:], axes["units"]["0"]["ffn"])
    x = torch.randn(MOE_B, MOE_S, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    return (cfg, remesh_state(ffn, ffn_axes, mesh),
            remesh_state(x, ("batch", "seq", "embed"), mesh))


def _model_psum_bytes(cfg):
    """``collective_bytes``'s MoE psum term for one MoE layer of a
    prefill of the same batch on the same layout: the difference the
    bf16 payload knob makes (2 bytes a value instead of 4) isolates the
    term; over the all-reduce multiplier and the MoE layers' count."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh

    mesh = AbstractMesh((2, 2), ("data", "model"))
    shape = ShapeConfig("moe", MOE_S, MOE_B, "prefill")
    f32 = dryrun.collective_bytes(dryrun.Program(cfg, shape, mesh))
    bf16 = dryrun.collective_bytes(dryrun.Program(
        cfg.scaled(moe_psum_bf16=True), shape, mesh))
    layers = sum(1 for s in cfg.layer_specs() if s.ffn == "moe")
    term = 2 * (f32["all-reduce"] - bf16["all-reduce"])
    return term / dryrun._MULT["all-reduce"] / layers, f32


def count_moe_collectives(mesh, bf16=False):
    """The collectives of one ``moe_alltoall`` call, as
    ``CollectiveBytes`` counts them: (list of (kind, bytes), the model's
    psum bytes, the model's terms for the whole prefill)."""
    cfg, w, x = _moe_case(mesh, bf16)
    counter = CollectiveBytes()
    with use_mesh(mesh), torch.no_grad(), counter.mode:
        TMOE.moe_alltoall(cfg, w, x)
    psum, terms = _model_psum_bytes(cfg.scaled(moe_psum_bf16=False))
    return counter.calls, psum, terms


def test_moe_psum_bytes_equal_the_dry_run_model(fake_world):
    """The expert-parallel psum (an all-reduce of the [tokens, d] float32
    partial outputs of this rank's rows) moves exactly the bytes the dry
    run's collective model charges one MoE layer; the aux loss's pmeans
    add a float32 scalar each (the model leaves them out)."""
    calls, psum, _ = count_moe_collectives(fake_world["2x2"])
    reduces = sorted(n for kind, n in calls if kind.startswith("allreduce"))
    cfg = TC.get_reduced_config("deepseek-v2-lite-16b")
    assert reduces[-1] == (MOE_B // 2) * MOE_S * cfg.d_model * 4
    assert reduces[-1] == psum
    assert reduces[:-1] == [4, 4]


def _report():
    """Print the counted collectives of one ``moe_alltoall`` beside the
    dry run's terms (f32 and the bf16 payload knob)."""
    _world()
    try:
        mesh = _mesh("2x2")
        for bf16 in (False, True):
            calls, psum, terms = count_moe_collectives(mesh, bf16)
            print(f"moe_psum_bf16={bf16}: counted {calls}; the model's MoE "
                  f"psum for one layer {psum:.0f} B (f32 payload); the "
                  f"model's prefill terms {dict(terms)}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_report())
