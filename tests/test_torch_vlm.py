"""Port vs reference: the vlm family (``paligemma_3b``).

Smoke config (64-wide, MQA, head_dim 16, 8 patch tokens); parameters from
``repro`` with the norm scales drawn from a seed (``torch_family_pairs``),
both sides with ``attn_bf16_probs`` off.  The ``prefix`` mask equals the
reference's; the forward's text-only logits, prefill (with and without
``lengths``) and decode match within 1e-5 of the largest magnitude, and the
prefill's logits reproduce the forward's last text logit within 2e-4 (the
reference's own check).  ``generate(extras={"patches": ...})`` emits the
reference's greedy tokens.  The training attention under the prefix mask
(``_FlashAttention``) matches the reference's hand-written VJP, with the
bf16 probabilities on and off, and the chunked-prefill attend carries the
mask too; the loss matches and its gradients, of ``patch_proj`` too, agree
within 1e-3 of each leaf's largest (they are ill-conditioned at the patch
rows; see the test's witness).  The family is never paged, and the
scheduler refuses it: its requests carry no patches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pruning import prune_tree as ref_prune
from repro.models import layers as ref_layers
from repro.models.opt_flags import FLAGS as REF_FLAGS
from repro.serve import Engine as RefEngine
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.convert import params_to_numpy
from repro_torch.core.pruning import prune_tree
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers
from repro_torch.optim.adamw import tree_items
from repro_torch.serve import Engine, Scheduler, ServeConfig
from torch_family_pairs import Pair, close, fp32_attention_probs, np_  # noqa: F401

pytestmark = pytest.mark.usefixtures("fp32_attention_probs")


@pytest.fixture(scope="module")
def pair():
    return Pair("paligemma_3b")


def _batch(cfg, b=2, s=10, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    patches = rng.normal(0, 0.02, (b, cfg.patch_tokens, cfg.d_model)).astype(np.float32)
    return tokens, patches


def _ref_batch(tokens, patches):
    return {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)}


def _port_batch(tokens, patches):
    return {"tokens": torch.from_numpy(tokens).long(), "patches": torch.from_numpy(patches)}


def test_prefix_mask_matches_reference():
    mask = layers.MaskSpec("prefix", prefix_len=5)
    ref_mask = ref_layers.MaskSpec("prefix", prefix_len=5)
    q, k = np.arange(3, 12), np.arange(14)
    np.testing.assert_array_equal(mask(torch.from_numpy(q), torch.from_numpy(k)).numpy(),
                                  np.asarray(ref_mask(jnp.asarray(q), jnp.asarray(k))))
    # per-row query positions (B, 1), as the decode attend passes them
    rows = mask(torch.tensor([[2], [9]]), torch.from_numpy(k))
    assert rows.shape == (2, 1, 14)
    assert rows[0, 0, :5].all() and not rows[0, 0, 5:].any()
    assert rows[1, 0, :10].all() and not rows[1, 0, 10:].any()
    with pytest.raises(ValueError, match="sliding"):  # an unknown kind, as the reference
        layers.MaskSpec("sliding")(torch.arange(2), torch.arange(2))


def test_forward_gives_text_logits_and_matches(pair):
    tokens, patches = _batch(pair.cfg)
    want, _ = pair.ref_model.forward(pair.params, _ref_batch(tokens, patches))
    got, aux = pair.model(pair.tparams, _port_batch(tokens, patches))
    assert got.shape == (2, 10, pair.cfg.padded_vocab) and aux == 0.0
    close(got, want)


@pytest.mark.parametrize("use_lengths", [False, True])
def test_prefill_matches_forward_and_reference(pair, use_lengths):
    tokens, patches = _batch(pair.cfg, b=3, seed=1)
    lengths = np.array([10, 6, 3], np.int32) if use_lengths else None
    max_len = pair.cfg.patch_tokens + 16
    want, ref_cache = pair.ref_model.prefill(
        pair.params, _ref_batch(tokens, patches), max_len,
        lengths=None if lengths is None else jnp.asarray(lengths))
    got, cache = pair.model.prefill(
        pair.tparams, _port_batch(tokens, patches), max_len,
        lengths=None if lengths is None else torch.from_numpy(lengths).long())
    close(got, want)
    for n in ("k", "v"):
        close(cache[n], ref_cache[n], n)
    assert cache["pos"].tolist() == [pair.cfg.patch_tokens + 10] * 3
    if use_lengths:  # row r's logits are its unpadded prompt's
        for r, n in enumerate(lengths):
            one, _ = pair.model.prefill(pair.tparams, _port_batch(tokens[r : r + 1, :n],
                                                                  patches[r : r + 1]), max_len)
            close(got[r : r + 1], np_(one))
        return
    tf, _ = pair.model(pair.tparams, _port_batch(tokens, patches))
    close(got, np_(tf[:, -1]), tol=2e-4)
    step = jax.jit(pair.ref_model.decode_step)
    tok = np.full((3, 1), 7, np.int32)
    for i in range(3):
        want, ref_cache = step(pair.params, jnp.asarray(tok), ref_cache)
        lg, cache = pair.model.decode_step(pair.tparams, torch.from_numpy(tok).long(), cache)
        close(lg, want, f"step {i}")


def test_generate_with_patches_matches_reference_greedy(pair):
    params = ref_prune(pair.params, pair.cfg.sparsity)
    tparams = prune_tree(pair.tparams, pair.cfg.sparsity)
    tokens, patches = _batch(pair.cfg, b=2, s=6, seed=2)
    max_len = pair.cfg.patch_tokens + 6 + 12
    want = RefEngine(pair.ref_cfg, params, RefServeConfig(max_len=max_len)).generate(
        tokens, max_new=12, extras={"patches": patches})
    eng = Engine(pair.cfg, tparams, ServeConfig(max_len=max_len), device="cpu")
    got = eng.generate(tokens, max_new=12, extras={"patches": patches})
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert got["finite"]
    with pytest.raises(ValueError, match="patch rows"):
        eng.generate(tokens, max_new=13, extras={"patches": patches})


@pytest.mark.parametrize("bf16_probs", [True, False])
def test_flash_attention_prefix_vjp_matches_reference(bf16_probs):
    """``_FlashAttention`` under the prefix mask against the reference's
    ``_make_flash_vjp(MaskSpec("prefix"), ...)``: output and dq, dk, dv."""
    REF_FLAGS["attn_bf16_probs"] = layers.FLAGS["attn_bf16_probs"] = bf16_probs
    rng = np.random.default_rng(3)
    b, s, kvh, g, hd, prefix = 2, 24, 1, 4, 16, 8
    q = rng.standard_normal((b, s, kvh, g, hd), dtype=np.float32)
    k, v = (rng.standard_normal((b, s, kvh, hd), dtype=np.float32) for _ in range(2))
    dout = rng.standard_normal(q.shape, dtype=np.float32)
    flash = ref_layers._make_flash_vjp(ref_layers.MaskSpec("prefix", prefix_len=prefix), s, s)
    pos = jnp.arange(s)
    want_out, vjp = jax.vjp(lambda q, k, v: flash(q, k, v, pos, pos, jnp.ones((s,), bool)),
                            q, k, v)
    want = vjp(dout)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = layers.flash_attention_train(tq, tk, tv, torch.arange(s),
                                       layers.MaskSpec("prefix", prefix_len=prefix))
    out.backward(torch.from_numpy(dout))
    close(out, want_out)
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        close(got, w, f"d{name}")
    causal = layers.flash_attention_train(tq.detach(), tk.detach(), tv.detach(), torch.arange(s))
    assert float((causal - out.detach()).abs().max()) > 1e-3  # the prefix rows see ahead


def test_chunked_attend_carries_the_prefix_mask(pair):
    """``attention_chunk`` under the prefix mask, two chunks through a
    block table, equals the prefill attend of the whole sequence."""
    cfg = pair.cfg
    lp = {k: v[0] for k, v in pair.tparams["layers"]["attn"].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 16, cfg.d_model),
                                                                  dtype=np.float32))
    mask = layers.MaskSpec("prefix", prefix_len=cfg.patch_tokens)
    with torch.no_grad():
        want = layers.attention(lp, x, cfg, mask)
        arena = [torch.zeros((3, 8, cfg.kv_heads, cfg.hd)) for _ in range(2)]
        table = torch.tensor([2, 0])
        parts = []
        for start in (0, 8):
            y, k, v = layers.attention_chunk(lp, x[:, start : start + 8], cfg, *arena, table,
                                             start, 8, mask)
            for a, new in zip(arena, (k, v)):
                a[table[start // 8]] = new[0]
            parts.append(y)
    close(torch.cat(parts, dim=1), np_(want))


def test_model_grads_match_reference(pair):
    """Loss within 1e-5; gradients within 1e-3 of each leaf's largest.  The
    gradients are ill-conditioned at the patch rows (patches of std 0.02
    through ``patch_proj`` and an RMS norm): the reference's own embedding
    gradient moves by 5e-5 of its largest when the patches move by one ulp
    (the witness below); the port's gap measured 1.1e-4."""
    tokens, patches = _batch(pair.cfg, s=12, seed=4)
    grad = jax.value_and_grad(pair.ref_model.loss)
    want_loss, want = grad(pair.params, _ref_batch(tokens, patches))
    _, nudged = grad(pair.params, _ref_batch(tokens, patches * np.float32(1 + 2**-23)))
    witness = np.abs(np.asarray(nudged["embed"]) - np.asarray(want["embed"])).max()
    assert witness > 1e-5 * np.abs(np.asarray(want["embed"])).max()
    tparams = {}
    for path, leaf in tree_items(pair.tparams):
        node = tparams
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf.detach().clone().requires_grad_(True)
    loss = pair.model.loss(tparams, _port_batch(tokens, patches))
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    loss.backward()
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = tparams
        for key in path:
            node = node[key.key]
        w = np.asarray(w)
        err = float(np.abs(np_(node.grad) - w).max())
        assert err <= 1e-3 * float(np.abs(w).max()), ("/".join(k.key for k in path), err)
    assert float(tparams["patch_proj"].grad.abs().max()) > 0


def test_pruning_prunes_patch_proj_and_keeps_the_embedding(pair):
    got = params_to_numpy(prune_tree(pair.tparams, 0.85))
    want = jax.tree_util.tree_map(np.asarray, ref_prune(pair.params, 0.85))
    np.testing.assert_array_equal(got["patch_proj"], want["patch_proj"])
    np.testing.assert_array_equal(got["embed"], want["embed"])
    assert 0.84 < float((got["patch_proj"] == 0).mean()) < 0.86
    assert (got["embed"] != 0).all()


def test_never_paged_and_the_scheduler_refuses(pair):
    eng = Engine(pair.cfg, pair.tparams, ServeConfig(max_len=32, page_size=8), device="cpu")
    assert not eng.batched_prefill and not eng.paged_supported
    assert eng.model.paged_seq_len(32) is None
    with pytest.raises(ValueError, match="patch embeddings"):
        Scheduler(eng, slots=2)
    with pytest.raises(ValueError, match="dense family"):
        Engine(pair.cfg, pair.tparams, ServeConfig(max_len=32, packed_weights="all"),
               device="cpu")


def test_launcher_serves_the_vlm_with_stand_in_patches(capsys):
    out = launch_serve.main(["--arch", "paligemma_3b", "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "4", "--max-new", "4"])
    assert out["tokens"].shape == (2, 4) and out["finite"]
    assert "tok/s" in capsys.readouterr().out


def test_trainer_trains_the_vlm_and_its_checkpoint_crosses(pair, tmp_path):
    """The trainer on the vlm batch (the pipeline's patches): finite
    losses; its tree checkpoint, ``patch_proj`` included, restores in the
    reference bitwise."""
    from repro.checkpoint import ckpt as ref_ckpt
    from repro_torch.train import TrainConfig, Trainer, TrainHParams

    tc = TrainConfig(steps=2, global_batch=2, seq_len=16, ckpt_dir=str(tmp_path), ckpt_every=2,
                     token_range=256, hp=TrainHParams(lr=1e-3, warmup=1, total_steps=2))
    out = Trainer(pair.cfg, tc, device="cpu").train()
    assert np.isfinite(out["final_loss"]) and out["steps_run"] == 2
    like = {"params": jax.tree_util.tree_map(jnp.zeros_like, pair.params)}
    back = ref_ckpt.restore(tmp_path, 2, like)["params"]
    want = params_to_numpy(out["params"])
    assert "patch_proj" in back
    for path, w in jax.tree_util.tree_flatten_with_path(back)[0]:
        node = want
        for key in path:
            node = node[key.key]
        assert np.asarray(w).tobytes() == node.tobytes(), path
