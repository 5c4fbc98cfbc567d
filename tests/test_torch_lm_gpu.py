"""The LM serving and training paths on the card against the CPU, at
reduced configs (or reduced depth) in float32, and a checkpoint saved and
restored on the card.  Marked ``gpu``: it skips where no CUDA GPU is
visible.
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


def test_deepseek_two_layer_slice_on_gpu_equals_cpu(cuda):
    """DeepSeek-V2-Lite at full width, cut to two layers (the prefix
    MLA + MLP layer and one MLA + MoE unit, with the embedding and the
    head: 1,085,287,424 params) in float32, TF32 off: 64-token prefill
    logits on the card within 1e-3 of the CPU's, the MoE aux loss within
    1e-4 relative, and the absorbed prefill into a cache within 1e-3 of
    the expanded prefill on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_cache, materialize_params
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = get_config("deepseek-v2-lite-16b").scaled(
        n_units=1, compute_dtype="float32")
    params, _ = materialize_params(
        cfg, torch.Generator(device=cuda).manual_seed(5), cuda)
    assert sum(t.numel() for t in tree_leaves(params)) == 1_085_287_424
    on_cpu = tree_map(lambda t: t.cpu(), params)
    toks = torch.as_tensor(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (1, 64)), dtype=torch.int32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want, w_ex, _ = forward(cfg, on_cpu, {"tokens": toks})
            got, g_ex, _ = forward(cfg, params, {"tokens": toks.to(cuda)})
            absorbed, _, cache = forward(
                cfg, params, {"tokens": toks.to(cuda)},
                cache=init_cache(cfg, 1, 128, torch.float32, cuda))
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(float(g_ex["aux_loss"]),
                                   float(w_ex["aux_loss"]), rtol=1e-4)
        np.testing.assert_allclose(absorbed.cpu().numpy(),
                                   got.cpu().numpy(), rtol=0, atol=1e-3)
        assert cache["units"]["0"]["pos"].tolist() == [64]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _ssm_serve(cfg, params, dev, toks):
    """Logits of a no-cache prefill, a 16-token prefill into a float32
    cache (the chunked branch), a 5-token and a 1-token decode (the
    recurrence), 8 greedy tokens, and the final cache, on ``dev``."""
    from repro_torch.models import decode_step, forward, init_cache
    from repro_torch.serve.engine import greedy_generate

    t = torch.as_tensor(toks, dtype=torch.int32, device=dev)
    cache = init_cache(cfg, 2, 64, torch.float32, dev)
    with torch.inference_mode():
        outs = [forward(cfg, params, {"tokens": t[:, :16]})[0]]
        logits, extras, cache = forward(cfg, params, {"tokens": t[:, :16]},
                                        cache=cache)
        outs.append(logits)
        for lo, hi in ((16, 21), (21, 22)):
            logits, cache = decode_step(cfg, params, cache, t[:, lo:hi])
            outs.append(logits)
    greedy, _ = greedy_generate(cfg, params, init_cache(
        cfg, 2, 64, torch.float32, dev), toks[:, :16], 8)
    return ([o.cpu() for o in outs], float(extras["aux_loss"]),
            greedy.cpu(), cache)


def _ssm_on_gpu_equals_cpu(cuda, arch):
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import cache_position, materialize_params
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = get_reduced_config(arch).scaled(compute_dtype="float32")
    params, _ = materialize_params(cfg, torch.Generator().manual_seed(8),
                                   "cpu")
    gen = torch.Generator().manual_seed(9)
    for unit in params["units"].values():     # away from 0 / 0 / 1
        for k in ("a_log", "dt_bias", "d_skip"):
            if k in unit["mixer"]:
                unit["mixer"][k] += 0.3 * torch.randn(
                    unit["mixer"][k].shape, generator=gen)
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = np.random.RandomState(10).randint(0, cfg.vocab_size, (2, 22))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = _ssm_serve(cfg, params, "cpu", toks)
        got = _ssm_serve(cfg, on_card, cuda, toks)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
    assert torch.equal(got[2], want[2])
    for g, w in zip(tree_leaves(got[3]), tree_leaves(want[3])):
        assert g.dtype == w.dtype and g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=1e-4)
    return int(cache_position(got[3]))


def test_mamba2_on_gpu_equals_cpu(cuda):
    """Reduced mamba2-370m in float32, TF32 off, ``a_log`` / ``dt_bias`` /
    ``d_skip`` moved off their constants: every branch's logits on the
    card within 1e-4 of the CPU's, the greedy tokens equal, the SSM state
    and conv windows within 1e-4; the cache position of a pure-SSM cache
    is 0."""
    assert _ssm_on_gpu_equals_cpu(cuda, "mamba2-370m") == 0


def test_jamba_unit_on_gpu_equals_cpu(cuda):
    """Reduced Jamba (one unit: attention at layer 0, Mamba at 1-7, the
    dense MoE on odd layers) in float32: as above, the aux loss within
    1e-5 relative and the attention layer's ``pos`` 22."""
    assert _ssm_on_gpu_equals_cpu(cuda, "jamba-1.5-large-398b") == 22


def test_train_step_on_gpu_equals_cpu(cuda):
    """smollm-360m at full width (d_model 960, vocab 49,152) cut to two
    units, f32 compute, remat on as the config sets it, TF32 off: one
    AdamW ``make_train_step`` step on a pipeline batch (``segment_ids``,
    ``loss_mask``) on the card against its CPU copy: the loss and the
    grad norm within 1e-4 relative, the params within the reference
    test's tolerance (rtol 2e-2, atol 2e-4), the AdamW moments within
    1e-3 of each leaf's max."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (
        PipelineConfig, TokenPipeline, synthetic_corpus,
    )
    from repro_torch.models import materialize_params
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.train import OptConfig, make_train_step, pick_optimizer

    cfg = get_config("smollm-360m").scaled(n_units=2,
                                           compute_dtype="float32")
    params, _ = materialize_params(cfg, torch.Generator().manual_seed(12),
                                   "cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    batch = TokenPipeline(synthetic_corpus(64, seed=1), PipelineConfig(
        seq_len=64, global_batch=2)).batch_at(0)
    opt = pick_optimizer(cfg, OptConfig(lr=1e-3, warmup_steps=1))
    step = make_train_step(cfg, opt)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs = [step(p, opt.init(p), {k: torch.as_tensor(v, device=dev)
                                      for k, v in batch.items()}, 0)
                for p, dev in ((params, "cpu"), (on_card, cuda))]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (want_p, want_s, want_m), (got_p, got_s, got_m) = outs
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-4)
    for g, w in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=2e-2,
                                   atol=2e-4)
    for g, w in zip(tree_leaves(got_s), tree_leaves(want_s)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=1e-3 * float(w.abs().max()))


def test_checkpoint_save_restore_on_gpu(cuda, tmp_path):
    """A checkpoint of a tree on the card (f32 and bf16 leaves, an int32
    counter) saved through ``AsyncCheckpointer`` restores onto the card
    bitwise, and a CPU-written copy restores onto the card too."""
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.train.checkpoint import (
        AsyncCheckpointer, restore_latest, save,
    )

    gen = torch.Generator(device=cuda).manual_seed(13)
    tree = {"w": torch.randn(64, 33, generator=gen, device=cuda),
            "h": [torch.randn(7, generator=gen, device=cuda).bfloat16()],
            "n": torch.arange(5, dtype=torch.int32, device=cuda)}
    ck = AsyncCheckpointer(str(tmp_path / "card"))
    ck.save_async(3, tree)
    ck.wait()
    save(str(tmp_path / "host"), 4, tree_map(lambda t: t.cpu(), tree))
    for where in ("card", "host"):
        restored, _ = restore_latest(str(tmp_path / where), tree)
        for g, w in zip(tree_leaves(restored), tree_leaves(tree)):
            assert g.device == w.device and g.dtype == w.dtype
            assert torch.equal(g, w)
