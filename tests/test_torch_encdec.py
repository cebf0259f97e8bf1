"""Port vs reference: the encdec family (``whisper_tiny``: an encoder over
precomputed frame embeddings, a decoder with cross-attention).

The smoke config (2 + 2 layers, d 64, 16 frames) with every norm scale and
the encoder's position table redrawn from a seed (``torch_family_pairs``).
Forward logits, loss and every leaf's gradient against ``jax.grad`` at F
= 12 < ``enc_frames`` and at F = 16; the prefill's cross K/V (F rows) and
zero logits; each decode step's logits and cache leaves; greedy
``generate`` with frames: all within 1e-4 of the largest reference value.
The tied head's rows (std 1/sqrt(vocab)) make the logits about 30x
smaller than the decoder's states, whose fp32 rounding (amplified by the
init's wide attention weights, C6) shows at about 4e-5 of the largest
logit.  Gradients hold 5e-4: the reference's own embedding gradient moves
by 2.1e-4 of its largest when its params move by 1e-7 relative (about an
fp32 rounding), the port's differs from it by 2.0e-4 (both measured on
this batch).  The port's decode reproduces its teacher-forced forward within
2e-4.  As the reference, the prefill drops the prompt (ROADMAP C12): the
first token is 0 and decode starts at ``pos`` 0.  The scheduler refuses
the family: a request carries no frames.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as ref_common
from repro.serve import Engine as RefEngine
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.models import common
from repro_torch.serve import Engine, Scheduler, ServeConfig
from torch_family_pairs import (  # noqa: F401
    Pair, check_cache, check_loss_and_grads, close, decode_both, fp32_attention_probs, np_,
    port_batch, ref_batch,
)

pytestmark = pytest.mark.usefixtures("fp32_attention_probs")

TOL = 1e-4  # the tied head's small logits (module docstring)
GRAD_TOL = 5e-4  # the reference's own conditioning (module docstring)


@pytest.fixture(scope="module")
def pair():
    return Pair("whisper_tiny")


def _batch(pair, frames, b=2, s=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, pair.cfg.vocab, (b, s)).astype(np.int32),
            "frames": rng.normal(0, 0.02, (b, frames, pair.cfg.d_model)).astype(np.float32)}


def test_config_and_tied_head(pair):
    assert pair.cfg.__dict__ == pair.ref_cfg.__dict__
    assert "lm_head" not in pair.model.specs()
    assert float(pair.tparams["enc_pos"].std()) > 0.1  # redrawn, not the init's 0.02


@pytest.mark.parametrize("frames", [12, 16])
def test_forward_loss_and_grads_match(pair, frames):
    batch = _batch(pair, frames)
    want, _ = pair.ref_model.forward(pair.params, ref_batch(batch))
    got, aux = pair.model(pair.tparams, port_batch(batch))
    assert aux == 0.0
    close(got, want, tol=TOL)
    check_loss_and_grads(pair, batch, tol=TOL, grad_tol=GRAD_TOL)


def test_prefill_decode_and_teacher_forcing(pair):
    """The prefill at F = 12: zero logits, ``pos`` 0, 12 cross K/V rows equal
    to the reference's; ten decode steps against the reference's (logits
    and every cache leaf) and the port's forward on the same frames."""
    batch = _batch(pair, 12, seed=1)
    want, ref_cache = pair.ref_model.prefill(pair.params, ref_batch(batch), 16)
    got, cache = pair.model.prefill(pair.tparams, port_batch(batch), 16)
    assert not got.any() and not np.asarray(want).any() and got.shape == want.shape
    assert cache["xk"].shape[2] == 12 and not cache["pos"].any()
    check_cache(cache, ref_cache, tol=TOL)
    dec, cache, ref_cache = decode_both(pair, batch["tokens"], cache, ref_cache, tol=TOL)
    check_cache(cache, ref_cache, tol=TOL)
    tf, _ = pair.model(pair.tparams, port_batch(batch))
    close(dec, np_(tf), tol=2e-4)
    with pytest.raises(NotImplementedError, match="masked prefill"):
        pair.model.prefill(pair.tparams, port_batch(batch), 16, lengths=torch.tensor([4, 6]))


def test_generate_matches_reference_and_drops_the_prompt(pair):
    """Greedy ``generate`` with 12 frames equals the reference's tokens;
    the first is 0 and another prompt of the same length gives the same
    tokens (the prefill runs the frames only, C12)."""
    batch = _batch(pair, 12, s=6, seed=2)
    extras = {"frames": batch["frames"]}
    want = RefEngine(pair.ref_cfg, pair.params, RefServeConfig(max_len=24)).generate(
        batch["tokens"], max_new=10, extras={"frames": jnp.asarray(batch["frames"])})["tokens"]
    eng = Engine(pair.cfg, pair.tparams, ServeConfig(max_len=24), device="cpu")
    got = eng.generate(batch["tokens"], max_new=10, extras=extras)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want))
    assert not got["tokens"][:, 0].any()
    other = eng.generate(batch["tokens"][::-1].copy(), max_new=10, extras=extras)
    np.testing.assert_array_equal(other["tokens"], got["tokens"])
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.generate(batch["tokens"], max_new=20, extras=extras)


def test_scheduler_and_paging_refused(pair):
    eng = Engine(pair.cfg, pair.tparams, ServeConfig(max_len=24), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        Scheduler(eng, slots=2)
    assert not eng.batched_prefill and not eng.paged_supported
    assert pair.model.paged_seq_len(16) is None


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(3)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32) for s in ((3, 5, 64), 64, 64))
    want = ref_common.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    close(common.layer_norm(*(torch.from_numpy(t) for t in (x, scale, bias))), want)
