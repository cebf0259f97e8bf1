"""Port vs reference: the ssm family (``mamba2_2_7b``, Mamba-2's SSD).

The smoke config (2 layers, d 64, 4 heads, state 16, chunks of 32) with
every zeros and ones leaf (``A_log``, ``D``, ``dt_bias``, ``conv_b``, the
norms) redrawn from a seed (``torch_family_pairs``).  Forward logits, loss
and every leaf's gradient against ``jax.grad`` at S = 70 (three chunks, the
last padded), the chunked scan itself with an initial state, each decode
step's logits and the cache leaves, greedy ``generate`` (also past
``max_len``) all within 1e-5 of the largest reference value; the port's
decode reproduces its teacher-forced forward within 2e-4
(``tests/test_models.py``'s check).  The scheduler's completions are
bitwise one-shot ``generate`` at B = 1, greedy and sampled, under either
admission and with a page size (ignored), and its greedy tokens equal the
reference scheduler's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.models import ssm
from torch_family_pairs import (  # noqa: F401
    Pair, check_cache, check_generate_matches_reference, check_graph_decode_in_chunks,
    check_loss_and_grads, check_pool_rows, check_prime_many_refused, check_reference_scheduler,
    check_scheduler_bitwise, check_slot_roundtrip, close, decode_both, fp32_attention_probs,
    np_, port_batch, ref_batch,
)

S = 70  # over chunks of 32: two whole chunks and a padded third


@pytest.fixture(scope="module")
def pair():
    return Pair("mamba2_2_7b")


def _tokens(pair, b=2, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, pair.cfg.vocab, (b, s)).astype(np.int32)


def test_config_and_param_layout(pair):
    assert pair.cfg.__dict__ == pair.ref_cfg.__dict__
    assert pair.cfg.ssm_chunk == 32 and S % pair.cfg.ssm_chunk
    mixer = pair.tparams["layers"]["mixer"]
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm"):  # redrawn: not constant
        assert float(mixer[name].std()) > 0.1, name


def test_forward_loss_and_grads_match(pair):
    batch = {"tokens": _tokens(pair)}
    want, _ = pair.ref_model.forward(pair.params, ref_batch(batch))
    got, aux = pair.model(pair.tparams, port_batch(batch))
    assert aux == 0.0
    close(got, want)
    check_loss_and_grads(pair, batch)


def test_ssd_chunked_with_state_and_segsum_grad():
    """The chunked scan with an initial state (y and the final state), and
    autograd through ``exp`` of the segment sums: zeros above the diagonal,
    no NaN."""
    rng = np.random.default_rng(1)
    b, h, p, n, chunk = 2, 3, 4, 5, 8
    x = rng.standard_normal((b, 21, h, p)).astype(np.float32)
    dt = rng.random((b, 21, h)).astype(np.float32)
    a = -rng.random(h).astype(np.float32)
    bm, cm = (rng.standard_normal((b, 21, n)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    want_y, want_s = ref_ssm._ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)), chunk,
                                          init_state=jnp.asarray(s0))
    got_y, got_s = ssm._ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, bm, cm)), chunk,
                                    init_state=torch.from_numpy(s0))
    close(got_y, want_y)
    close(got_s, want_s)
    seg = torch.from_numpy(dt[0, :chunk, 0]).requires_grad_(True)
    L = torch.exp(ssm._segsum(seg))
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    L.sum().backward()
    assert torch.isfinite(seg.grad).all()


def test_decode_matches_reference_and_forward(pair):
    tokens = _tokens(pair, seed=2)
    cache = pair.model.init_cache(2, 16, device="cpu")
    ref_cache = pair.ref_model.init_cache(2, 16)
    dec, cache, ref_cache = decode_both(pair, tokens, cache, ref_cache)
    check_cache(cache, ref_cache)
    tf, _ = pair.model(pair.tparams, port_batch({"tokens": tokens}))
    close(dec, np_(tf), tol=2e-4)


def test_generate_matches_reference_past_max_len(pair):
    check_generate_matches_reference(pair, prompt_len=10, max_new=20, max_len=16)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("admission", ["sequential", "batched"])
def test_scheduler_bitwise_one_shot_generate(pair, temperature, admission):
    check_scheduler_bitwise(pair, temperature, admission)


def test_scheduler_ignores_a_page_size(pair):
    check_scheduler_bitwise(pair, 0.0, "batched", page_size=8)


def test_scheduler_greedy_equals_reference_scheduler(pair):
    check_reference_scheduler(pair)


def test_slot_roundtrip_leaves_neighbours(pair):
    check_slot_roundtrip(pair)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_step_rows_equal_b1_steps(pair, dtype):
    check_pool_rows(pair, dtype)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_graph_decode_past_max_len_keeps_one_step_graph(pair, temperature):
    check_graph_decode_in_chunks(pair, temperature)


def test_prime_many_and_prefill_refused(pair):
    check_prime_many_refused(pair)
