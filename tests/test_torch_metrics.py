"""Port parity: the shared metric math (rank scores, Eq. 1-4 lift).

The PyTorch functions must equal the reference's jnp ones bitwise, since
every kernel and plain version of the port scores through them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import metrics_inkernel as J  # noqa: E402
from repro_torch.kernels import metrics_inkernel as T  # noqa: E402

N = 1 << 16


def _columns(seed):
    """Random columns with the edge cases the selects guard: lift <= 0,
    confidence == 1, zero support."""
    rng = np.random.RandomState(seed)
    sup = rng.rand(N).astype(np.float32)
    conf = rng.rand(N).astype(np.float32)
    lift = (rng.rand(N) * 3 - 0.5).astype(np.float32)
    conf[::97] = 1.0
    lift[::89] = 0.0
    sup[::83] = 0.0
    return sup, conf, lift


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("metric", T.RANK_METRICS)
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_score_bitwise(metric, seed):
    cols = _columns(seed)
    want_eager = J.rank_score(metric, *map(jnp.asarray, cols))
    want_jit = jax.jit(lambda s, c, l: J.rank_score(metric, s, c, l))(*cols)
    got = T.rank_score(metric, *map(torch.from_numpy, cols)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want_eager))
    np.testing.assert_array_equal(_bits(got), _bits(want_jit))


def test_compound_lift_bitwise():
    rng = np.random.RandomState(2)
    found = rng.rand(N) < 0.7
    single = rng.rand(N) < 0.4
    node_lift = (rng.rand(N) * 2).astype(np.float32)
    conf = rng.rand(N).astype(np.float32)
    con_sup = rng.rand(N).astype(np.float32)
    con_sup[::5] = 0.0
    args = (found, single, node_lift, conf, con_sup)
    want = J.compound_lift(*map(jnp.asarray, args))
    got = T.compound_lift(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_metric_pad_dtype_and_ids():
    for dt in (torch.int32, torch.bfloat16, torch.int8):
        assert T.metric_pad_dtype(torch.zeros(2, dtype=dt)) == dt
    assert T.metric_pad_dtype(torch.zeros(2, dtype=torch.float64)) == \
        torch.float32
    assert T.RANK_METRICS == J.RANK_METRICS
    assert [T.metric_index(m) for m in T.RANK_METRICS] == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        T.metric_index("gini")
    with pytest.raises(ValueError):
        T.rank_score("gini", *map(torch.zeros, (1, 1, 1)))
