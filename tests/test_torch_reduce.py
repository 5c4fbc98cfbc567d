"""The traversal reduction's kernel design (``csrc/trie_reduce.cu``: a
persistent grid streaming the three columns in 16-byte vectors, a head and
a tail read node by node, per-thread sums in index order, the xor
butterfly in each warp, the warps in warp order, and the blocks' partials
folded in block order by the last block) in its plain mirror
``ref.trie_reduce_split_ref``, held to the plain version
``ref.trie_reduce_ref`` and to the reference's ``trie_reduce_pallas`` in
interpret mode; and the launch sizes of ``trie_reduce.launch_shape``.

Tolerance: count and max bitwise (the count is exact below 2^24 nodes in
any order, the max is order-free but for NaN payloads); the sums within
1e-6 relative, since the mirror's order is not the plain version's; the
mean bitwise against ``conf_sum / n.clamp(min=1.0)`` of the same sums.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.trie_reduce import trie_reduce_pallas  # noqa: E402
from repro_torch.core.array_trie import ieee_amax  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.trie_reduce import (  # noqa: E402
    THREADS, launch_shape, trie_reduce_columns, trie_reduce_stats,
    vector_head, vector_nodes,
)
from repro_torch.core import synthetic as TS  # noqa: E402

N_TX = 100_000
INT8_SCALE = 0.0078125
KINDS = ("f32", "i32+bf16", "i32+int8")
# (blocks, threads, unroll): one warp, a few blocks of two warps, the
# shipped block on a handful of blocks, and a deeper unroll
GEOMS = ((1, 32, 1), (3, 64, 2), (5, THREADS, 2), (2, 32, 4))


def _columns(kind, n, seed, extra=0):
    """numpy (support, confidence, depth) of ``n + extra`` nodes: depths
    -1..5 (the root, padding and live nodes), and the kind's storage."""
    rng = np.random.RandomState(seed)
    m = n + extra
    depth = rng.randint(-1, 6, m).astype(np.int32)
    if kind == "f32":
        sup = rng.rand(m).astype(np.float32)
        conf = rng.rand(m).astype(np.float32)
    else:
        sup = rng.randint(0, N_TX, m).astype(np.int32)
        if kind == "i32+int8":
            conf = rng.randint(-127, 128, m).astype(np.int8)
        else:
            conf = rng.rand(m).astype(np.float32)
    return sup, conf, depth


def _scales(kind):
    if kind == "f32":
        return dict()
    return dict(n_transactions=N_TX,
                confidence_scale=INT8_SCALE if kind == "i32+int8" else 1.0)


def _torch(kind, cols, offset=0):
    """The columns as torch tensors, each a view at ``offset`` (an int or
    one per column) into a longer buffer."""
    offs = (offset,) * 3 if isinstance(offset, int) else offset
    out = []
    for col, off in zip(cols, offs):
        t = torch.from_numpy(np.ascontiguousarray(col))
        if col is cols[1] and kind == "i32+bf16":
            t = t.to(torch.bfloat16)
        t = torch.cat([t[:1].repeat(off), t])[off:]
        assert t.storage_offset() == off
        out.append(t)
    return out


def _jax(kind, cols):
    sup, conf, depth = cols
    jc = jnp.asarray(conf, jnp.bfloat16) if kind == "i32+bf16" else \
        jnp.asarray(conf)
    return jnp.asarray(sup), jc, jnp.asarray(depth)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _mirror(kind, t, blocks, threads, unroll, head=None):
    if head is None:
        head = vector_head(*t)[0]
    return ref.trie_reduce_split_ref(*t, **_scales(kind), blocks=blocks,
                                     threads=threads, unroll=unroll,
                                     head=head)


def _agree(got, want):
    """count and max bitwise, sums to 1e-6 relative (NaN where NaN)."""
    assert _bits(got[0]) == _bits(want[0])
    assert _bits(got[2]) == _bits(want[2]) or (
        np.isnan(float(got[2])) and np.isnan(float(want[2])))
    for i in (1, 3):
        np.testing.assert_allclose(float(got[i]), float(want[i]), rtol=1e-6,
                                   atol=0)


def _mean_exact(got):
    want = got[3] / got[0].clamp(min=1.0)
    assert _bits(got[4]) == _bits(want)


@pytest.mark.parametrize("n", [0, 1, 3, 4095, 4097, 20000])
@pytest.mark.parametrize("kind", KINDS)
def test_mirror_against_reference_and_pallas(kind, n):
    cols = _columns(kind, n, seed=n + 7)
    t = _torch(kind, cols)
    want = ref.trie_reduce_ref(*t, **_scales(kind))
    jwant = trie_reduce_pallas(*_jax(kind, cols), interpret=True,
                               **_scales(kind))
    _agree(want, [np.float32(x) for x in jwant])
    for geom in GEOMS:
        got = _mirror(kind, t, *geom)
        _agree(got, want)
        _agree(got, [np.float32(x) for x in jwant])
        _mean_exact(got)


@pytest.mark.parametrize("offset", [1, 2, 3, (1, 0, 2), (3, 2, 1)])
@pytest.mark.parametrize("kind", KINDS)
def test_mirror_on_views_at_storage_offsets(kind, offset):
    """A head before the first aligned vector (the same offset in every
    column), or columns with no common aligned node (the kernel's element
    by element variant, head 0)."""
    n = 4099
    cols = _columns(kind, n, seed=11)
    t = _torch(kind, cols, offset)
    head, aligned = vector_head(*t)
    assert aligned == isinstance(offset, int)
    if aligned:
        assert 0 < head < vector_nodes(t[1].dtype)
        for c in t:
            assert (c.data_ptr() + head * c.element_size()) % 16 == 0
    want = ref.trie_reduce_ref(*t, **_scales(kind))
    for geom in GEOMS:
        got = _mirror(kind, t, *geom, head=head)
        _agree(got, want)
        _mean_exact(got)


def test_heads_and_tails_below_one_vector():
    """Every head below a vector, on tries shorter than one, one and a
    bit, and several vectors: a node is added once, wherever it goes."""
    for kind in KINDS:
        for n in (1, 2, 15, 16, 17, 33):
            cols = _columns(kind, n, seed=n)
            t = _torch(kind, cols)
            want = ref.trie_reduce_ref(*t, **_scales(kind))
            for head in range(vector_nodes(t[1].dtype)):
                got = _mirror(kind, t, 1, 32, 1, head=head)
                _agree(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_no_live_node_and_padding(kind):
    n = 5000
    sup, conf, depth = _columns(kind, n, seed=5)
    for dead in (np.zeros(n, np.int32), np.full(n, -1, np.int32)):
        t = _torch(kind, (sup, conf, dead))
        for geom in GEOMS:
            got = _mirror(kind, t, *geom)
            assert [float(x) for x in got] == [0.0] * 5
            assert not np.signbit(float(got[2]))
        jgot = trie_reduce_pallas(*_jax(kind, (sup, conf, dead)),
                                  interpret=True, **_scales(kind))
        assert [float(x) for x in jgot] == [0.0] * 4
    # -1 padding after the live nodes, as a padded layout holds it
    depth = depth.copy()
    depth[-300:] = -1
    t = _torch(kind, (sup, conf, depth))
    want = ref.trie_reduce_ref(*t, **_scales(kind))
    trimmed = ref.trie_reduce_ref(*[c[:-300] for c in t], **_scales(kind))
    _agree(want, trimmed)
    for geom in GEOMS:
        _agree(_mirror(kind, t, *geom), want)


SPECIAL = {
    # a live NaN propagates; a NaN at a node that is not live does not
    "nan": (np.nan, "live"),
    "nan_dead": (np.nan, "dead"),
    "inf": (np.inf, "live"),
    "-inf": (-np.inf, "all"),
    # every live confidence -0.0, then one +0.0 after many -0.0
    "-0": (-0.0, "all"),
    "+0_after_-0": (0.0, "one"),
}


@pytest.mark.parametrize("case", sorted(SPECIAL))
@pytest.mark.parametrize("kind", ("f32", "i32+bf16"))
def test_special_confidences_pinned_to_the_reference(kind, case):
    """NaN, inf and signed zeros: the max is IEEE 754's maximum (NaN
    propagates, +0.0 above -0.0), as ``jnp.max`` in the reference takes
    it; ``amax`` alone would keep whichever zero comes first."""
    n = 3001
    sup, conf, depth = _columns(kind, n, seed=3)
    conf = conf.astype(np.float32)
    depth = np.where(np.arange(n) % 5 == 0, 0, 1 + depth % 3).astype(
        np.int32)
    val, where = SPECIAL[case]
    live = depth > 0
    if where == "live":
        conf[np.flatnonzero(live)[::97]] = val
    elif where == "dead":
        conf[~live] = val
    elif where == "all":
        conf[:] = val
    else:
        conf[:] = -0.0
        conf[np.flatnonzero(live)[-2]] = val
    cols = (sup, conf, depth)
    t = _torch(kind, cols)
    want = ref.trie_reduce_ref(*t, **_scales(kind))
    jwant = [np.float32(x) for x in trie_reduce_pallas(
        *_jax(kind, cols), interpret=True, **_scales(kind))]
    _agree(want, jwant)
    expect = {"nan": np.nan, "nan_dead": None, "inf": np.inf,
              "-inf": -np.inf, "-0": -0.0, "+0_after_-0": 0.0}[case]
    if expect is not None:
        assert _bits(want[2]) == _bits(np.float32(expect)) or (
            np.isnan(expect) and np.isnan(float(want[2])))
    else:
        assert np.isfinite(float(want[2]))
    # the live confidences as they widen (torch's vectorized cast to bf16
    # writes some NaNs as 0xffff, others as 0x7fc0)
    wide = ref.dequantize_metrics(*t[:2], t[1], **_scales(kind))[1].numpy()
    nans = wide[live & np.isnan(wide)]
    for geom in GEOMS:
        got = _mirror(kind, t, *geom)
        _agree(got, want)
        if len(nans):
            # a NaN max is the largest |NaN| among the live values
            assert _bits(got[2]) == _bits(np.abs(nans)).max()
        else:
            assert _bits(got[2]) == _bits(want[2])


def test_ieee_amax_against_jnp_max():
    rng = np.random.RandomState(2)
    for _ in range(40):
        n = int(rng.randint(1, 40))
        x = rng.choice(np.array([-0.0, 0.0, -1.0, 2.0, np.inf, -np.inf],
                                np.float32), n)
        got = ieee_amax(torch.from_numpy(x))
        assert _bits(got) == _bits(np.asarray(jnp.max(jnp.asarray(x))))


def test_geometry_orders_the_sums():
    """The sums depend on the geometry (so the mirror's order, and not
    only its result, is exercised) while count and max do not."""
    n = 20000
    sup, conf, depth = _columns("f32", n, seed=9)
    # values over nine decades, so that every regrouping rounds apart
    conf = (conf * 10.0 ** np.random.RandomState(10).randint(-3, 6, n)
            ).astype(np.float32)
    t = _torch("f32", (sup, conf, depth))
    outs = [_mirror("f32", t, *geom) for geom in GEOMS]
    assert len({int(_bits(o[3])) for o in outs}) > 1
    assert len({int(_bits(o[0])) for o in outs}) == 1
    assert len({int(_bits(o[2])) for o in outs}) == 1
    # and one geometry repeats bitwise
    again = _mirror("f32", t, *GEOMS[1])
    assert [int(_bits(x)) for x in again] == [int(_bits(x)) for x in outs[1]]


@pytest.mark.parametrize("kind", KINDS)
def test_mirror_past_one_wave_of_the_shipped_grid(kind):
    """The kernel's geometry on a 132-SM card, past one wave of its grid
    (every block walks more than one tile)."""
    vec = 16 // {"f32": 4, "i32+bf16": 2, "i32+int8": 1}[kind]
    shape = launch_shape(10 ** 9, vec, 0, 132)
    wave = shape["blocks"] * THREADS * shape["unroll"] * vec
    n = wave + 12345
    cols = _columns(kind, n, seed=1)
    t = _torch(kind, cols)
    shape = launch_shape(n, vec, vector_head(*t)[0], 132)
    assert shape["tiles"] > shape["blocks"] == 528
    assert shape["unroll"] * vec == 16
    got = _mirror(kind, t, shape["blocks"], THREADS, shape["unroll"])
    want = ref.trie_reduce_ref(*t, **_scales(kind))
    _agree(got, want)
    _mean_exact(got)
    jwant = trie_reduce_pallas(*_jax(kind, cols), interpret=True,
                               **_scales(kind))
    _agree(got, [np.float32(x) for x in jwant])


def test_launch_shape_pinned():
    assert vector_nodes(torch.float32) == 4
    assert vector_nodes(torch.bfloat16) == 8
    assert vector_nodes(torch.int8) == 16
    # the 2^20 hub trie (1,048,577 nodes) at f32 on 132 SMs: a thread
    # takes 16 nodes a tile (4 vectors), a tile of 256 threads to each of
    # 256 blocks
    assert launch_shape(1_048_577, 4, 0, 132) == {
        "nv": 262_144, "tiles": 256, "blocks": 256, "threads": 256,
        "unroll": 4}
    # int32 + bf16 and int32 + int8: the same 4,096 nodes a tile
    assert launch_shape(1_048_577, 8, 0, 132)["unroll"] == 2
    assert launch_shape(1_048_577, 16, 0, 132)["tiles"] == 256
    # the 2^23 hub trie: four blocks an SM, each walking about 4 tiles
    assert launch_shape(8_388_609, 4, 0, 132)["blocks"] == 528
    # the launch floor's 4,096 nodes: one tile, one block (no ticket); one
    # block up to two tiles
    assert launch_shape(4096, 4, 0, 132)["blocks"] == 1
    assert launch_shape(2 * 4096 + 3, 4, 0, 132)["blocks"] == 1
    assert launch_shape(2 * 4096 + 4, 4, 0, 132)["blocks"] == 3
    # fewer nodes than a vector: one block, head and tail only
    assert launch_shape(3, 16, 0, 132) == {
        "nv": 0, "tiles": 0, "blocks": 1, "threads": 256, "unroll": 1}
    assert launch_shape(3, 4, 3, 132)["nv"] == 0


def test_cpu_wrappers_and_op_mean():
    """On CPU tensors the wrappers run the plain version; the op's mean is
    ``conf_sum / n.clamp(min=1.0)`` bitwise, as before the kernel wrote
    it."""
    arrs = TS.random_csr_trie(np.random.RandomState(4), 3000, 20)
    fz = TS.frozen_from_arrays(arrs)
    cols = [torch.from_numpy(arrs[k])
            for k in ("support", "confidence", "node_depth")]
    four = trie_reduce_columns(*cols)
    five = trie_reduce_stats(*cols)
    want = ref.trie_reduce_ref(*cols)
    for a, b, c in zip(four, five, want):
        assert _bits(a) == _bits(b) == _bits(c)
    assert _bits(five[4]) == _bits(want[3] / want[0].clamp(min=1.0))
    op = TO.trie_reduce(fz, device="cpu")
    assert _bits(op["mean_conf"]) == _bits(five[4])
    assert _bits(op["confidence_max"]) == _bits(five[2])
    empty = trie_reduce_stats(*[c[:0] for c in cols])
    assert [float(x) for x in empty] == [0.0] * 5
