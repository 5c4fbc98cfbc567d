"""The LM serving path on the card against the CPU, at a reduced config
in float32.  Marked ``gpu``: it skips where no CUDA GPU is visible.
This module imports neither JAX nor the reference package, so on a GPU
host without JAX it runs alone:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \
        -m gpu tests/test_torch_lm_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test holds the card's answers "
                    "to the CPU's")
    return torch.device("cuda")


def test_lm_serving_on_gpu_equals_cpu(cuda):
    """The LM path on the card at a reduced config in float32 (TF32 off):
    prefill logits within 1e-4 of the CPU's, greedy tokens and the cache's
    positions equal, speculative decoding == greedy with drafts accepted
    and rejected, and the clamped cache write where the CPU puts it."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import NgramTrie
    from repro_torch.models import forward, init_cache, materialize_params
    from repro_torch.pytree import tree_map
    from repro_torch.serve.engine import greedy_generate
    from repro_torch.serve.spec_decode import speculative_generate

    cfg = get_reduced_config("smollm-360m").scaled(compute_dtype="float32")
    params, _ = materialize_params(cfg, torch.Generator().manual_seed(3),
                                   "cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, (1, 300))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want, _, _ = forward(cfg, params, {"tokens": torch.as_tensor(
                prompt, dtype=torch.int32)})
            got, _, _ = forward(cfg, on_card, {"tokens": torch.as_tensor(
                prompt, dtype=torch.int32, device=cuda)})
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=0, atol=1e-4)
        outs = {}
        for dev, p in (("cpu", params), (cuda, on_card)):
            toks, cache = greedy_generate(
                cfg, p, init_cache(cfg, 1, 320, torch.float32, dev),
                prompt[:, :40], 24)
            outs[str(dev)] = toks.cpu().numpy()
            assert cache["units"]["0"]["pos"].tolist() == [64, 64]
        assert np.array_equal(outs["cpu"], outs[str(cuda)])
        seq = list(prompt[0, :40]) + list(outs["cpu"][0])
        wrong = [seq[i - 3:i] + [(seq[i] + 1) % cfg.vocab_size]
                 for i in range(3, len(seq), 2)]
        for rows in ([seq], wrong):
            spec, stats = speculative_generate(
                cfg, on_card, init_cache(cfg, 1, 320, torch.float32, cuda),
                prompt[:, :40], NgramTrie(n=4).fit(rows), 24,
                min_confidence=0.0)
            assert np.array_equal(spec, outs["cpu"]), stats
            assert stats["proposed"] > 0
        # 4 positions written at pos 318 of 320 land at 316-319
        caches = {}
        for dev, p in (("cpu", params), (cuda, on_card)):
            c = init_cache(cfg, 1, 320, torch.float32, dev)
            c["units"]["0"]["pos"] += 318
            with torch.inference_mode():
                _, _, c = forward(cfg, p, {"tokens": torch.as_tensor(
                    prompt[:, :4], dtype=torch.int32, device=dev)}, cache=c)
            caches[str(dev)] = c["units"]["0"]["k"].cpu()
        assert bool((caches[str(cuda)][:, :, :, 316:] != 0).all())
        assert bool((caches[str(cuda)][:, :, :, :316] == 0).all())
        np.testing.assert_allclose(caches[str(cuda)].numpy(),
                                   caches["cpu"].numpy(), rtol=0, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
