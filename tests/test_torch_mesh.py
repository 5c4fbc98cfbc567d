"""The port on a mesh of four ranks: ``named_sharding`` placement,
``remesh_state``, the placed forward, greedy decode and train steps, the
MoE's expert-parallel collectives and ``compressed_psum``, each against
the one-process port and against the reference on four XLA CPU devices.

Four gloo CPU processes are spawned once per mesh shape, (2, 2) and
(1, 4) ``("data", "model")``, and run every check of this file inside
that world (``_rank_main``); they meet over a ``FileStore`` in the
test's temporary directory, so no port is opened, and each world has a
join timeout: a rank that raises fails the world, and the others are
killed.  The reference runs in a subprocess a mesh with
``--xla_force_host_platform_device_count=4`` (``_reference_main``), on
the same seeded numpy inputs, its params placed by its ``remesh_state``
under ``jax.set_mesh``.  Neither the ranks nor the reference import
anything but their own package.

Configs: reduced smollm-360m, reduced DeepSeek-V2-Lite (its dense MoE)
and the same with ``impl="alltoall"`` (the expert-parallel MoE: experts
over ``model``, ep = 2 on (2, 2) and 4 on (1, 4)); reduced mamba2-370m
and reduced Jamba cut to the first two layers of its hybrid unit
(attention + MLP, Mamba2 + the dense MoE: forward, greedy decode through
both of Mamba's cache branches, a train step); reduced DeepSeek-V3 (its
train step with the MTP loss); f32 compute.

Tolerances: f32 logits within 1e-4 of both (the LM parity tolerance; the
placed step equals the one-process port bitwise here, the reference's
partitioned programs sum in other orders); greedy tokens exact; a train
step's loss within 1e-4 and every new param and state leaf within 1e-3
of its max |value|; the MoE's outputs within 1e-5 (aux 1e-6 relative) of
the reference's ``shard_map``, with and without drops and the bf16
``psum``; ``compressed_psum`` and the ``remesh_state`` round trips
bitwise; every param and cache leaf's placements and local shape equal
to the reference's ``named_sharding`` spec and ``shard_shape``; a placed
Mamba cache's leaves after greedy decode within 1e-4 of the one-process
port's.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ARCHS = {"smollm": ("smollm-360m", None),
         "ds": ("deepseek-v2-lite-16b", None),
         "ds_ep": ("deepseek-v2-lite-16b", "alltoall")}
# Mamba2 layers on a mesh: forward, greedy decode and a train step
SSM_ARCHS = {"mamba": ("mamba2-370m", None),
             "jamba": ("jamba-1.5-large-398b", None)}
# DeepSeek-V3's MTP loss on a mesh: a train step
MTP_ARCHS = {"v3": ("deepseek-v3-671b", None)}
ALL_ARCHS = {**ARCHS, **SSM_ARCHS, **MTP_ARCHS}
# the train steps of SSM_ARCHS and MTP_ARCHS: AdamW on both meshes,
# Adafactor on one
NEW_STEPS = [(key, opt, mesh) for key in {**SSM_ARCHS, **MTP_ARCHS}
             for opt, mesh in (("adamw", "2x2"), ("adamw", "1x4"),
                               ("adafactor", "1x4"))]


def _ref_step_mesh(key):
    """The mesh whose reference process runs ``key``'s train steps: the
    expert-parallel MoE's capacity follows the rows a rank holds, so it
    runs on each; the others (whose values the mesh does not change)
    split between the two processes."""
    if key == "ds_ep":
        return None
    return "2x2" if key in ARCHS else "1x4"
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
B, S = 4, 16                  # the forward's batch
PROMPT, N_GEN, MAX_SEQ = 8, 8, 32
MOE_B, MOE_S = 4, 8
CAPACITY = (8.0, 0.1)         # nothing dropped; most experts drop copies
OPTS = ("adamw", "adafactor")
TRAIN_ARGS = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
              "--ckpt-every", "2", "--log-every", "1"]
WORLD_TIMEOUT = 600           # seconds a world may take, all ranks
LOGITS = dict(rtol=1e-4, atol=1e-4)
MOE = dict(rtol=1e-5, atol=1e-5)


def _cfg(configs, key, **kw):
    arch, impl = ALL_ARCHS[key]
    cfg = configs.get_reduced_config(arch)
    if key == "jamba":
        # its first two layers (attention + MLP, then Mamba2 + MoE):
        # every kind of layer the unit has, at a quarter of the
        # reference's compile time (as tests/test_torch_train.py cuts it)
        kw = dict(kw, unit=cfg.unit[:2])
    cfg = cfg.scaled(compute_dtype="float32", **kw)
    if impl is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, impl=impl))
    return cfg


def _moe_cfg(configs, cf, bf16):
    cfg = _cfg(configs, "ds_ep", moe_psum_bf16=bf16)
    return cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _opt_cfg(name):
    """The optimizers' defaults: the first step's learning rate is
    3e-6, so a gradient that rounding leaves near zero (whose first Adam
    step is +-lr by its sign) moves its param by far less than the
    tolerance; the state leaves (m, v; Adafactor's row and column
    moments) carry the gradients themselves."""
    return dict(name=name)


# ----------------------------------------------------------------------
# the inputs (numpy, drawn here, read by both sides)
# ----------------------------------------------------------------------
def _draw(path, shape, rng, d_model):
    """N(0, 1) / sqrt(fan in) for a matrix, 1 + N(0, 0.1) for a norm
    scale (the models' test draws)."""
    if path[-1] == "scale":
        return (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
    inner = shape[1:] if path[0] == "units" else shape
    fan = int(np.prod(inner[:-1])) if path[-1] == "wo" else d_model
    return (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)


def _write_inputs(path):
    from repro_torch import configs as TC
    from repro_torch.models import abstract_params
    from repro_torch.pytree import tree_leaves_with_path

    rng = np.random.RandomState(0)
    out = {}
    for key in ARCHS:
        cfg = _cfg(TC, key)
        like, _ = abstract_params(cfg)
        for i, (p, leaf) in enumerate(tree_leaves_with_path(like)):
            out[f"p/{key}/{i}"] = _draw(p, tuple(leaf.shape), rng,
                                        cfg.d_model)
    vocab = TC.get_reduced_config("smollm-360m").vocab_size
    out["tokens"] = rng.randint(0, vocab, (B, S)).astype(np.int32)
    out["prompt"] = out["tokens"][:, :PROMPT]
    out["labels"] = np.roll(out["tokens"], -1, axis=1)
    out["loss_mask"] = (rng.rand(B, S) > 0.25).astype(np.float32)
    cfg = _cfg(TC, "ds_ep")
    like, _ = abstract_params(cfg)
    for name, leaf in like["units"]["0"]["ffn"].items():
        out[f"moe/{name}"] = _draw(("units", name), tuple(leaf.shape[1:]),
                                   rng, cfg.d_model)
    out["moe/x"] = (rng.randn(MOE_B, MOE_S, cfg.d_model) * 0.5).astype(
        np.float32)
    out["psum/x"] = (rng.randn(257) * 3).astype(np.float32)
    for key in {**SSM_ARCHS, **MTP_ARCHS}:
        cfg = _cfg(TC, key)
        like, _ = abstract_params(cfg)
        for i, (p, leaf) in enumerate(tree_leaves_with_path(like)):
            out[f"p/{key}/{i}"] = _draw(p, tuple(leaf.shape), rng,
                                        cfg.d_model)
    np.savez(path, **out)


def _batch(data):
    return {k: data[k] for k in ("tokens", "labels", "loss_mask")}


# ----------------------------------------------------------------------
# the reference (a subprocess over four XLA CPU devices)
# ----------------------------------------------------------------------
def _reference_main(in_path, out_path, mesh_names):
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import configs as JC
    from repro.distributed.compression import compressed_psum
    from repro.models import model as JM
    from repro.models import moe as JMOE
    from repro.serve.engine import greedy_generate
    from repro.train.elastic import remesh_state
    from repro.train.optimizer import OptConfig, pick_optimizer
    from repro.train.train_step import make_train_step

    data = dict(np.load(in_path))
    devs = np.array(jax.devices()[:4])

    def mesh(shape, axes=AXES):
        return Mesh(devs.reshape(shape), axes,
                    axis_types=(AxisType.Auto,) * len(axes))

    out = {}
    for mname in mesh_names:
        m = mesh(MESHES[mname])
        with jax.set_mesh(m):
            for key in ALL_ARCHS:
                cfg = _cfg(JC, key)
                shapes, axes = JM.abstract_params(cfg)
                n = len(jax.tree.leaves(shapes))
                params = jax.tree.unflatten(
                    jax.tree.structure(shapes),
                    [jnp.asarray(data[f"p/{key}/{i}"]) for i in range(n)])
                params = remesh_state(params, axes, m)
                if key not in MTP_ARCHS:
                    out[f"{mname}/{key}/logits"] = np.asarray(jax.jit(
                        partial(JM.forward, cfg))(params, {
                            "tokens": jnp.asarray(data["tokens"])})[0])
                    cache = remesh_state(JM.init_cache(cfg, B, MAX_SEQ,
                                                       jnp.float32),
                                         JM.cache_axes(cfg), m)
                    toks, _ = greedy_generate(cfg, params, cache,
                                              jnp.asarray(data["prompt"]),
                                              N_GEN)
                    out[f"{mname}/{key}/greedy"] = np.asarray(toks)
                if _ref_step_mesh(key) not in (None, mname):
                    continue
                batch = {k: jnp.asarray(v) for k, v in _batch(data).items()}
                for name in OPTS if key in ARCHS else ("adamw",):
                    opt = pick_optimizer(cfg, OptConfig(**_opt_cfg(name)))
                    state = remesh_state(opt.init(params),
                                         opt.state_axes(axes), m)
                    new_p, new_s, metrics = jax.jit(make_train_step(
                        cfg, opt))(params, state, batch, jnp.float32(0))
                    pre = f"{mname}/{key}/{name}"
                    out[f"{pre}/loss"] = np.asarray(metrics["loss"])
                    if "mtp_loss" in metrics:
                        out[f"{pre}/mtp_loss"] = np.asarray(
                            metrics["mtp_loss"])
                    for i, leaf in enumerate(jax.tree.leaves(
                            (new_p, new_s))):
                        out[f"{pre}/{i}"] = np.asarray(leaf)
            w = {k[4:]: jnp.asarray(v) for k, v in data.items()
                 if k.startswith("moe/") and k != "moe/x"}
            x = jnp.asarray(data["moe/x"])
            for impl in ("alltoall", "serve_tp"):
                for cf in CAPACITY:
                    for bf16 in (False, True):
                        cfg = _moe_cfg(JC, cf, bf16)
                        fn = getattr(JMOE, f"moe_{impl}")
                        y, aux = jax.jit(partial(fn, cfg))(w, x)
                        pre = f"{mname}/moe/{impl}/{cf}/{int(bf16)}"
                        out[f"{pre}/y"] = np.asarray(y)
                        out[f"{pre}/aux"] = np.asarray(aux)
    if "2x2" not in mesh_names:
        # serve_tp on a (pod, data) mesh, a reference fault (ROADMAP.md)
        w = {k[4:]: jnp.asarray(v) for k, v in data.items()
             if k.startswith("moe/") and k != "moe/x"}
        with jax.set_mesh(mesh((2, 2, 1), POD_AXES)):
            out["pod/serve_tp"] = np.asarray(jax.jit(partial(
                JMOE.moe_serve_tp, _moe_cfg(JC, CAPACITY[0], False)))(
                    w, jnp.asarray(data["moe/x"]))[0])
        np.savez(out_path, **out)
        return
    m41 = mesh((4, 1))
    out["psum"] = np.asarray(compressed_psum(jnp.asarray(data["psum/x"]),
                                             "data", m41))
    # the reference's chunk of a dim split over ("model", "data")
    m22 = mesh((2, 2))
    arr = jax.device_put(jnp.arange(16.0).reshape(16, 1),
                         NamedSharding(m22, P(("model", "data"), None)))
    where = {d.id: idx for idx, d in np.ndenumerate(m22.devices)}
    for shard in arr.addressable_shards:
        d, mo = where[shard.device.id]
        out[f"layout/{d}{mo}"] = np.asarray(shard.data)[:, 0]
    np.savez(out_path, **out)


# ----------------------------------------------------------------------
# one rank of a gloo world
# ----------------------------------------------------------------------
class _OneProcess:
    """A mesh of one process with a process mesh's shape: the port runs
    the ranks' bodies in series on one device."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _tensors(tree):
    from repro_torch.pytree import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _whole(x):
    from repro_torch.distributed.sharding import is_placed

    return (x.full_tensor() if is_placed(x) else x).detach().numpy()


def _rank_main(rank, world, store, shape, in_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res, mine = _rank_checks(rank, tuple(shape), in_path, out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **mine)
        if rank == 0:
            np.savez(os.path.join(out_dir, "port.npz"), **res)
    finally:
        dist.destroy_process_group()


def _rank_checks(rank, shape, in_path, out_dir):
    from repro_torch import configs as TC
    from repro_torch.distributed.compression import (
        ErrorFeedbackInt8, compressed_psum,
    )
    from repro_torch.distributed.sharding import is_placed, use_mesh
    from repro_torch.launch import train as TLT
    from repro_torch.launch.mesh import HostMesh, make_host_mesh, make_mesh
    from repro_torch.models import abstract_params, convert
    from repro_torch.pytree import (
        tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten,
    )
    from repro_torch.train.elastic import remesh_state
    from repro_torch.train.optimizer import OptConfig, pick_optimizer
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    data = dict(np.load(in_path))
    mesh = make_mesh(shape, AXES, "cpu")
    one = _OneProcess(mesh.shape)
    res, mine = {}, {}

    def record(prefix, tree):
        for path, leaf in tree_leaves_with_path(tree):
            name = f"{prefix}/{'.'.join(map(str, path))}"
            mine[f"{name}/local"] = np.asarray(leaf.to_local().shape)
            mine[f"{name}/placements"] = np.asarray(
                [str(p) for p in leaf.placements])

    tokens = torch.from_numpy(data["tokens"])
    prompt = torch.from_numpy(data["prompt"])
    batch = _tensors(_batch(data))
    with use_mesh(mesh):
        for key in ALL_ARCHS:
            cfg = _cfg(TC, key)
            like, axes = abstract_params(cfg)
            tree = tree_unflatten(like, [data[f"p/{key}/{i}"]
                                         for i in range(len(tree_leaves(
                                             like)))])
            placed = convert.params_from_numpy(cfg, tree, mesh=mesh)
            plain = convert.params_from_numpy(cfg, tree, "cpu")
            record(f"{key}/params", placed)
            if key not in MTP_ARCHS:
                _forward_checks(key, cfg, placed, plain, mesh, one, tokens,
                                prompt, record, res)
            for name in OPTS:
                if key not in ARCHS and (key, name, _name_of(shape)) \
                        not in NEW_STEPS:
                    continue
                opt = pick_optimizer(cfg, OptConfig(**_opt_cfg(name)))
                state = remesh_state(opt.init(plain), opt.state_axes(axes),
                                     mesh)
                got = make_train_step(cfg, opt)(placed, state, batch, 0.0)
                with use_mesh(one):
                    want = make_train_step(cfg, opt)(plain, opt.init(plain),
                                                     batch, 0.0)
                for tag, (p, s, metrics) in (("", got), ("1", want)):
                    pre = f"{key}/{name}{tag}"
                    res[f"{pre}/loss"] = float(metrics["loss"])
                    if "mtp_loss" in metrics:
                        res[f"{pre}/mtp_loss"] = float(metrics["mtp_loss"])
                    for i, leaf in enumerate(tree_leaves(p)
                                             + tree_leaves(s)):
                        res[f"{pre}/{i}"] = _whole(leaf)
                    if not tag:
                        assert all(is_placed(x) for x in tree_leaves(p)
                                   + tree_leaves(s))
            if key in ("smollm", "mamba"):
                # remat recomputes each unit (its placed weights gathered
                # again; Mamba's chunked SSD) in the backward pass: the
                # same gradients
                on = cfg.scaled(remat=True)
                l0, _, g0 = loss_and_grads(cfg, placed, batch)
                l1, _, g1 = loss_and_grads(on, placed, batch)
                pre = "remat" if key == "smollm" else f"remat/{key}"
                res[f"{pre}/loss"] = np.asarray([float(l0), float(l1)])
                res[f"{pre}/grad_err"] = max(
                    float(np.abs(_whole(a) - _whole(b)).max())
                    for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
            if key == "smollm":
                # int8 error feedback on placed gradients: each leaf's
                # scale from its whole max, as the reference's
                ef = ErrorFeedbackInt8()
                got = ef.compress(g0, ef.init(g0))
                want = ef.compress(
                    tree_map(lambda g: torch.from_numpy(_whole(g)), g0),
                    ef.init(plain))
                res["ef_bitwise"] = all(
                    np.array_equal(_whole(a), b.numpy())
                    for i in (0, 1)
                    for a, b in zip(tree_leaves(got[i]),
                                    tree_leaves(want[i])))

        _moe_checks(data, mesh, one, res)
        if shape == (1, 4):
            _pod_checks(data, res)

        # the reference's layout trap: a dim split over ("model", "data")
        lay = remesh_state(torch.arange(16.0).reshape(16, 1),
                           ("seq_kv", None), mesh)
        mine["layout"] = lay.to_local()[:, 0].numpy()
        mine["coordinate"] = np.asarray([mesh.coordinate[a] for a in AXES])

    # compressed_psum over data = 4: every rank's own x, then the same x
    m41 = make_mesh((4, 1), AXES, "cpu")
    x = torch.from_numpy(data["psum/x"])
    res["psum"] = compressed_psum(x, "data", m41).numpy()
    res["psum_mine"] = compressed_psum(x * (rank + 1), "data", m41).numpy()

    # remesh_state: this mesh -> the other -> one host device, bitwise
    cfg = _cfg(TC, "ds")
    like, axes = abstract_params(cfg)
    plain = convert.params_from_numpy(cfg, tree_unflatten(like, [
        data[f"p/ds/{i}"] for i in range(len(tree_leaves(like)))]), "cpu")
    other = make_mesh(MESHES["1x4" if shape == (2, 2) else "2x2"], AXES,
                      "cpu")
    there = remesh_state(remesh_state(plain, axes, mesh), axes, other)
    back = remesh_state(there, axes, HostMesh("cpu"))
    res["remesh_bitwise"] = all(
        torch.equal(a, b) and a.dtype == b.dtype
        for a, b in zip(tree_leaves(plain), tree_leaves(back)))
    res["remesh_other_placed"] = all(
        is_placed(t) and t.device_mesh == other.device_mesh
        for t in tree_leaves(there))

    host = make_host_mesh("cpu")
    mine["host_mesh"] = np.asarray([host.shape[a] for a in AXES]
                                   + [host.coordinate["model"]])
    if shape == (1, 4):
        ckpt = os.path.join(out_dir, "ckpt")
        first = TLT.main(TRAIN_ARGS + ["--steps", "3", "--ckpt-dir", ckpt,
                                       "--resume", "never"])
        resumed = TLT.main(TRAIN_ARGS + ["--steps", "5", "--ckpt-dir", ckpt])
        res["train/losses"] = np.asarray(first["losses"]
                                         + resumed["losses"])
        res["train/start"] = resumed["start_step"]
        res["train/mesh"] = np.asarray(list(resumed["mesh"].shape.values()))
        for i, leaf in enumerate(tree_leaves(resumed["params"])):
            assert is_placed(leaf)
            res[f"train/p/{i}"] = _whole(leaf)
    return res, mine


def _name_of(shape):
    return next(m for m, s in MESHES.items() if s == tuple(shape))


def _forward_checks(key, cfg, placed, plain, mesh, one, tokens, prompt,
                    record, res):
    """Logits of the forward and greedy tokens, placed (params and cache)
    and one-process; the placed cache's position after them, and for a
    Mamba config every cache leaf of both."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import cache_axes, cache_position, forward
    from repro_torch.models import init_cache
    from repro_torch.pytree import tree_leaves
    from repro_torch.serve.engine import greedy_generate
    from repro_torch.train.elastic import remesh_state

    cache = remesh_state(init_cache(cfg, B, MAX_SEQ, torch.float32, "cpu"),
                         cache_axes(cfg), mesh)
    record(f"{key}/cache", cache)
    with torch.inference_mode():
        res[f"{key}/logits"] = _whole(forward(
            cfg, placed, {"tokens": tokens})[0])
        toks, cache = greedy_generate(cfg, placed, cache, prompt, N_GEN)
        res[f"{key}/greedy"] = _whole(toks)
        res[f"{key}/cache_pos"] = _whole(cache_position(cache))
        with use_mesh(one):
            res[f"{key}/logits1"] = _whole(forward(
                cfg, plain, {"tokens": tokens})[0])
            toks1, cache1 = greedy_generate(
                cfg, plain, init_cache(cfg, B, MAX_SEQ, torch.float32,
                                       "cpu"), prompt, N_GEN)
            res[f"{key}/greedy1"] = _whole(toks1)
    if key in SSM_ARCHS:
        for i, (a, b) in enumerate(zip(tree_leaves(cache),
                                       tree_leaves(cache1))):
            res[f"{key}/cache/{i}"] = _whole(a)
            res[f"{key}/cache1/{i}"] = _whole(b)


def _moe_checks(data, mesh, one, res):
    from repro_torch import configs as TC
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import abstract_params
    from repro_torch.models import moe as TMOE
    from repro_torch.pytree import tree_map
    from repro_torch.train.elastic import remesh_state

    _, axes = abstract_params(_cfg(TC, "ds_ep"))
    ffn_axes = tree_map(lambda a: tuple(a)[1:], axes["units"]["0"]["ffn"])
    w = {k[4:]: torch.from_numpy(v) for k, v in data.items()
         if k.startswith("moe/") and k != "moe/x"}
    placed_w = remesh_state(w, ffn_axes, mesh)
    x = torch.from_numpy(data["moe/x"])
    placed_x = remesh_state(x, ("batch", "seq", "embed"), mesh)
    for impl in ("alltoall", "serve_tp"):
        fn = getattr(TMOE, f"moe_{impl}")
        for cf in CAPACITY:
            for bf16 in (False, True):
                cfg = _moe_cfg(TC, cf, bf16)
                pre = f"moe/{impl}/{cf}/{int(bf16)}"
                with torch.inference_mode():
                    y, aux = fn(cfg, placed_w, placed_x)
                    with use_mesh(one):
                        y1, aux1 = fn(cfg, w, x)
                res[f"{pre}/y"], res[f"{pre}/aux"] = _whole(y), float(aux)
                res[f"{pre}/y1"], res[f"{pre}/aux1"] = _whole(y1), \
                    float(aux1)


def _pod_checks(data, res):
    """``moe_serve_tp`` on a (2, 2, 1) ``("pod", "data", "model")`` mesh
    of the same four ranks, nothing dropped, and ``moe_dense`` beside
    it."""
    from repro_torch import configs as TC
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import abstract_params
    from repro_torch.models import moe as TMOE
    from repro_torch.pytree import tree_map
    from repro_torch.train.elastic import remesh_state

    mesh = make_mesh((2, 2, 1), POD_AXES, "cpu")
    cfg = _moe_cfg(TC, CAPACITY[0], False)
    _, axes = abstract_params(cfg)
    ffn_axes = tree_map(lambda a: tuple(a)[1:], axes["units"]["0"]["ffn"])
    w = {k[4:]: torch.from_numpy(v) for k, v in data.items()
         if k.startswith("moe/") and k != "moe/x"}
    x = torch.from_numpy(data["moe/x"])
    with torch.inference_mode():
        with use_mesh(mesh):
            y, _ = TMOE.moe_serve_tp(
                cfg, remesh_state(w, ffn_axes, mesh),
                remesh_state(x, ("batch", "seq", "embed"), mesh))
        res["pod/serve_tp"] = _whole(y)
        res["pod/dense"] = _whole(TMOE.moe_dense(cfg, w, x)[0])


# ----------------------------------------------------------------------
# the fixtures: the reference and both worlds, started together
# ----------------------------------------------------------------------
def _python(code, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _start_world(shape, in_path, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    return [_python(
        "import test_torch_mesh as t\n"
        f"t._rank_main({r}, 4, {store!r}, {list(shape)!r}, {in_path!r}, "
        f"{out_dir!r})\n") for r in range(4)]


def _join(procs, what, deadline):
    """Wait for every process; on a failure or the deadline, kill the
    rest and fail with the first failure's output."""
    failed = None
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1)
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                failed = failed or (p, "timed out")
                break
            if p.returncode != 0:
                failed = failed or (p, f"exit code {p.returncode}")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        p, why = failed
        out, err = p.communicate()
        pytest.fail(f"{what}: a process {why}:\n{err[-6000:]}\n{out[-2000:]}")
    for p in procs:
        p.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's results, "2x2" / "1x4": (rank 0's results,
    [each rank's records])}, and the input arrays."""
    base = tmp_path_factory.mktemp("mesh")
    in_path = str(base / "inputs.npz")
    _write_inputs(in_path)
    deadline = time.monotonic() + WORLD_TIMEOUT
    # the reference one process a mesh, beside both worlds
    refs = {m: _python(
        "import test_torch_mesh as t\n"
        f"t._reference_main({in_path!r}, {str(base / f'ref{m}.npz')!r}, "
        f"[{m!r}])\n",
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
        for m in MESHES}
    worlds = {m: _start_world(s, in_path, str(base / m))
              for m, s in MESHES.items()}
    for m, procs in worlds.items():
        _join(procs, f"the {m} world", deadline)
    for m, ref in refs.items():
        _join([ref], f"the reference on {m}", deadline)
    ref = {}
    for m in MESHES:
        ref.update(np.load(base / f"ref{m}.npz"))
    out = {"ref": ref, "inputs": dict(np.load(in_path)), "dir": str(base)}
    for m in MESHES:
        ranks = [dict(np.load(base / m / f"rank{r}.npz")) for r in range(4)]
        out[m] = (dict(np.load(base / m / "port.npz")), ranks)
    return out


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **tol)


# ----------------------------------------------------------------------
# placement
# ----------------------------------------------------------------------
def _reference_layout(key, shape, tree_of):
    """(path, spec placements, shard shape) of every leaf, from the
    reference's ``named_sharding`` on an abstract mesh of ``shape``."""
    from jax.sharding import AbstractMesh

    from repro import configs as JC
    from repro.distributed.sharding import named_sharding
    from repro.models import model as JM
    from repro_torch.distributed.sharding import placements_of
    from repro_torch.pytree import tree_leaves_with_path

    mesh = AbstractMesh(shape, AXES)
    cfg = _cfg(JC, key)
    shapes, axes = tree_of(JM, cfg)
    out = []
    for (path, leaf), (_, ax) in zip(
            tree_leaves_with_path(_as_port_tree(shapes)),
            tree_leaves_with_path(_as_port_tree(axes, leaf_tuples=True))):
        sh = named_sharding(tuple(ax), mesh, tuple(leaf.shape))
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        out.append((".".join(map(str, path)),
                    [str(p) for p in placements_of(spec, mesh)],
                    tuple(sh.shard_shape(tuple(leaf.shape)))))
    return out


def _as_port_tree(tree, leaf_tuples=False):
    """A reference tree of dicts and lists (axes tuples as leaves) as
    nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _as_port_tree(v, leaf_tuples) for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and not
                                  leaf_tuples):
        return [_as_port_tree(v, leaf_tuples) for v in tree]
    return tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("key", ["smollm", "ds", "mamba", "jamba"])
def test_param_and_cache_placements_match_named_sharding(runs, mesh, key):
    """Every param and cache leaf on every rank: DTensor placements and
    local shape as the reference's ``named_sharding`` spec and
    ``shard_shape`` give them."""
    _, ranks = runs[mesh]
    for group, tree_of in (
            ("params", lambda JM, c: JM.abstract_params(c)),
            ("cache", lambda JM, c: (JM.init_cache(c, B, MAX_SEQ),
                                     JM.cache_axes(c)))):
        layout = _reference_layout(key, MESHES[mesh], tree_of)
        assert layout
        for path, places, local in layout:
            name = f"{key}/{group}/{path}"
            for rec in ranks:
                assert list(rec[f"{name}/placements"]) == places, name
                assert tuple(rec[f"{name}/local"]) == local, name


def test_seq_kv_layout_is_mesh_dim_major(runs):
    """The documented difference: a dim split over ``("model", "data")``
    (``seq_kv`` with the batch and heads unsplit) holds, on rank
    (data d, model m), DTensor's chunk d * 2 + m; the reference's device
    there holds chunk m * 2 + d.  Same values, same shapes."""
    ref = runs["ref"]
    _, ranks = runs["2x2"]
    full = np.arange(16.0)
    for rec in ranks:
        d, m = (int(v) for v in rec["coordinate"])
        assert np.array_equal(rec["layout"], full[(d * 2 + m) * 4:][:4])
        assert np.array_equal(ref[f"layout/{d}{m}"],
                              full[(m * 2 + d) * 4:][:4])
    assert sum(not np.array_equal(r["layout"], ref["layout/%d%d" % tuple(
        r["coordinate"])]) for r in ranks) == 2


# ----------------------------------------------------------------------
# the placed model against the one-process port and the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("key", list(ARCHS) + list(SSM_ARCHS))
def test_forward_and_greedy(runs, mesh, key):
    """Logits of a 4 x 16 batch within 1e-4 of the one-process port and
    of the reference on the same mesh; a prefill of 8 tokens and 8
    greedy tokens, exact against both; the cache's position after it (a
    pure-SSM cache has none: it reads 0).  Mamba's prefill of whole
    chunks takes the chunked SSD into the placed cache, each decode step
    the recurrence; every leaf of the placed cache after them within
    1e-4 of its max against the one-process port's."""
    port, _ = runs[mesh]
    ref = runs["ref"]
    _close(port[f"{key}/logits"], port[f"{key}/logits1"], LOGITS,
           "one process")
    _close(port[f"{key}/logits"], ref[f"{mesh}/{key}/logits"], LOGITS,
           "reference")
    assert np.array_equal(port[f"{key}/greedy"], port[f"{key}/greedy1"])
    assert np.array_equal(port[f"{key}/greedy"], ref[f"{mesh}/{key}/greedy"])
    assert port[f"{key}/greedy"].shape == (B, N_GEN)
    pos = 0 if key == "mamba" else PROMPT + N_GEN
    assert np.all(port[f"{key}/cache_pos"] == pos)
    leaves = [k for k in port if k.startswith(f"{key}/cache/")]
    assert len(leaves) == {"mamba": 4, "jamba": 3 + 4}.get(key, 0)
    for name in leaves:
        want = port[name.replace("/cache/", "/cache1/")]
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(port[name] - want).max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("key", list(ARCHS))
def test_train_step(runs, mesh, opt, key):
    """One step (AdamW, or Adafactor with its factored moments over split
    dims): the loss within 1e-4 and every new param and state leaf within
    1e-3 of its max |value| against the one-process port and the
    reference's step (on the (2, 2) mesh; the expert-parallel MoE, whose
    capacity follows the rows a rank holds, on the same mesh)."""
    port, _ = runs[mesh]
    ref = runs["ref"]
    pre = f"{key}/{opt}"
    n = len([k for k in port if k.startswith(pre + "/")
             and k[len(pre) + 1:].isdigit()])
    assert n > 0
    on = mesh if key == "ds_ep" else "2x2"
    for other, tag in ((port, pre + "1"), (ref, f"{on}/{pre}")):
        assert abs(float(port[f"{pre}/loss"]) - float(other[f"{tag}/loss"])
                   ) <= 1e-4 * max(1.0, abs(float(other[f"{tag}/loss"])))
        for i in range(n):
            got, want = port[f"{pre}/{i}"], other[f"{tag}/{i}"]
            assert got.shape == want.shape, (tag, i)
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(got.astype(np.float64) - want).max())
            assert err <= 1e-3 * scale, (tag, i, err, scale)


@pytest.mark.parametrize("key,opt,mesh", NEW_STEPS)
def test_train_step_mamba_jamba_and_mtp(runs, key, opt, mesh):
    """One step of reduced mamba2-370m, Jamba and DeepSeek-V3 (its loss
    with the MTP head's), AdamW on both meshes and Adafactor on one: the
    loss (and V3's ``mtp_loss``) within 1e-4 and every new param and
    state leaf within 1e-3 of its max |value| against the one-process
    port, and for AdamW against the reference's step (on the one mesh
    its reference process steps on; Adafactor's factored moments over
    split dims are held against the reference by ``test_train_step``)."""
    port, _ = runs[mesh]
    ref = runs["ref"]
    pre = f"{key}/{opt}"
    n = len([k for k in port if k.startswith(pre + "/")
             and k[len(pre) + 1:].isdigit()])
    assert n > 0
    metrics = ("loss", "mtp_loss") if key in MTP_ARCHS else ("loss",)
    sides = [(port, pre + "1")]
    if opt == "adamw":
        sides.append((ref, f"{_ref_step_mesh(key)}/{pre}"))
    for other, tag in sides:
        for m in metrics:
            want = float(other[f"{tag}/{m}"])
            assert abs(float(port[f"{pre}/{m}"]) - want) <= \
                1e-4 * max(1.0, abs(want)), (tag, m)
        for i in range(n):
            got, want = port[f"{pre}/{i}"], other[f"{tag}/{i}"]
            assert got.shape == want.shape, (tag, i)
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(got.astype(np.float64) - want).max())
            assert err <= 1e-3 * scale, (tag, i, err, scale)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mamba_remat_on_a_mesh(runs, mesh):
    """Mamba2 under remat on placed params: each unit's chunked SSD and
    its gathered weights recomputed in the backward pass give the same
    loss and gradients."""
    port, _ = runs[mesh]
    lo, hi = port["remat/mamba/loss"]
    assert lo == hi and float(port["remat/mamba/grad_err"]) == 0.0


def test_remat_on_a_mesh(runs):
    """Remat recomputes each unit in the backward pass, its placed
    weights gathered again: the same loss and gradients."""
    port, _ = runs["2x2"]
    lo, hi = port["remat/loss"]
    assert lo == hi and float(port["remat/grad_err"]) == 0.0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_error_feedback_on_placed_gradients(runs, mesh):
    """``ErrorFeedbackInt8.compress`` of placed gradients (each leaf's
    scale its whole max) equals the same on whole gradients, bitwise:
    the dequantized gradients and the residual."""
    port, _ = runs[mesh]
    assert bool(port["ef_bitwise"])


# ----------------------------------------------------------------------
# the MoE's expert-parallel collectives
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("impl,mesh", [("alltoall", "2x2"),
                                       ("alltoall", "1x4"),
                                       ("serve_tp", "2x2"),
                                       ("serve_tp", "1x4")])
def test_moe_expert_parallel(runs, impl, mesh, cf, bf16):
    """``moe_alltoall`` at ep = 2 (2 x 2, the batch over data) and 4
    (1 x 4), ``moe_serve_tp`` with the expert FFN split over data:
    outputs within 1e-5 and aux within 1e-6 relative of the reference's
    ``shard_map`` and of the one-process port (the ranks' bodies in
    series); at capacity factor 0.1 copies are dropped, the same ones."""
    port, _ = runs[mesh]
    ref = runs["ref"]
    pre = f"moe/{impl}/{cf}/{int(bf16)}"
    y = port[f"{pre}/y"]
    assert y.shape == (MOE_B, MOE_S, runs["inputs"]["moe/x"].shape[-1])
    _close(y, ref[f"{mesh}/{pre}/y"], MOE, "reference")
    _close(y, port[f"{pre}/y1"], MOE, "one process")
    for want in (ref[f"{mesh}/{pre}/aux"], port[f"{pre}/aux1"]):
        assert abs(float(port[f"{pre}/aux"]) - float(want)) <= \
            1e-6 * abs(float(want))
    if cf < 1:   # drops: the outputs differ from the undropped ones
        wide = port[f"moe/{impl}/{CAPACITY[0]}/{int(bf16)}/y"]
        assert np.abs(y - wide).max() > 1e-2


def test_serve_tp_on_pod_and_data_reference_fault(runs):
    """``moe_serve_tp`` on a (2, 2, 1) ``("pod", "data", "model")`` mesh
    at capacity factor 8: the port's rows equal ``moe_dense``'s within
    1e-5; the reference gathers the tokens over ``pod`` then ``data``
    (rows data-major) and slices its rows back pod-major, so its batch
    rows 1 and 2 (ranks (pod 0, data 1) and (pod 1, data 0)) are other
    rows' outputs while rows 0 and 3 hold."""
    port, _ = runs["1x4"]
    dense = port["pod/dense"]
    _close(port["pod/serve_tp"], dense, MOE, "port")
    ref = runs["ref"]["pod/serve_tp"]
    err = [float(np.abs(ref[i] - dense[i]).max()) for i in range(MOE_B)]
    assert err[0] <= 1e-5 and err[3] <= 1e-5
    assert err[1] > 0.1 and err[2] > 0.1


# ----------------------------------------------------------------------
# compressed_psum, remesh_state, the host mesh, the trainer
# ----------------------------------------------------------------------
def test_compressed_psum_over_four_ranks(runs):
    """Over data = 4: the same x on every rank equals the reference's
    (whose ``shard_map`` body sees x on each shard) bitwise; each rank's
    own x gives the int32 sum of its codes at the max scale."""
    port, _ = runs["1x4"]
    assert np.array_equal(port["psum"], runs["ref"]["psum"])
    x = runs["inputs"]["psum/x"]
    xs = [x * np.float32(r + 1) for r in range(4)]
    scale = max(np.float32(max(np.abs(v).max(), 1e-12)) / np.float32(127)
                for v in xs)
    codes = sum(np.clip(np.round(v / scale), -127, 127).astype(np.int32)
                for v in xs)
    assert np.array_equal(port["psum_mine"],
                          codes.astype(np.float32) * scale)
    assert np.array_equal(runs["2x2"][0]["psum"], port["psum"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_remesh_round_trip(runs, mesh):
    """Host → this mesh → the other mesh → one host device: every leaf
    bitwise, placed on the other mesh between."""
    port, _ = runs[mesh]
    assert bool(port["remesh_bitwise"]) and bool(port["remesh_other_placed"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_host_mesh_spans_the_world(runs, mesh):
    """``make_host_mesh`` with a process group up: the reference's 1 x n
    ``("data", "model")`` mesh, rank r at model coordinate r."""
    _, ranks = runs[mesh]
    for r, rec in enumerate(ranks):
        assert list(rec["host_mesh"]) == [1, 4, r]


def test_trainer_over_the_world_restores_across_meshes(runs, tmp_path):
    """``launch.train.main`` in the four-rank world (the 1 x 4 host
    mesh): 3 steps with checkpoints of whole tensors, then a resume to 5
    placed again, against the one-process trainer's 5 uninterrupted steps
    (losses within 1e-5 relative, params within 1e-5 of each leaf's max);
    the world's last checkpoint restores in one process to the world's
    params, bitwise."""
    from repro_torch.launch import train as TLT
    from repro_torch.pytree import tree_leaves
    from repro_torch.train.checkpoint import restore_latest

    port, _ = runs["1x4"]
    assert list(port["train/mesh"]) == [1, 4]
    assert int(port["train/start"]) == 3
    whole = TLT.main(TRAIN_ARGS + ["--steps", "5", "--ckpt-dir",
                                   str(tmp_path), "--resume", "never"])
    losses = port["train/losses"]
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    _close(losses, whole["losses"], dict(rtol=1e-5, atol=0), "losses")
    like = {"params": whole["params"], "opt": whole["opt_state"]}
    restored, manifest = restore_latest(
        os.path.join(runs["dir"], "1x4", "ckpt"), like)
    assert manifest["step"] == 4
    for i, (leaf, back) in enumerate(zip(tree_leaves(whole["params"]),
                                         tree_leaves(restored["params"]))):
        got = port[f"train/p/{i}"]
        assert np.array_equal(back.numpy(), got), i
        scale = max(float(leaf.abs().max()), 1e-30)
        assert float(np.abs(got - leaf.numpy()).max()) <= 1e-5 * scale, i
